"""Kernel prewarm: build the kernels and run each hot path once per card
ahead of first use.

Port of ``tpu_orc/utils/prewarm.py``. There the cost paid at first use
is a Mosaic compile per kernel shape; here it is the ``nvcc`` build of
every kernel source (``_build.build_all``, seconds to a minute on a
fresh checkout) and, on each card, the CUDA context and the first load
of each kernel library. Deployments call ``python -m tpu_orc_torch.cli
prewarm`` (or :func:`prewarm`) once at startup so that the first real
batch runs at full speed. It runs the fused dual-round demux at the
standard read-length buckets and the dense Myers entry point at the
standard length buckets (short 512 / long 4096 / streamed 8192) on every
device of the mesh; on the CPU (plain versions, nothing to build) only
the demux, as ``tpu_orc`` does.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Optional, Sequence

import numpy as np


def prewarm(adapters_dir: str,
            demux_lens: Iterable[int] = (384, 512, 640),
            demux_batch: int = 2048,
            myers_lens: Iterable[int] = (512, 4096, 8192),
            devices: Optional[Sequence] = None,
            verbose: bool = True) -> dict:
    """Build and warm the production kernels on ``devices`` (default:
    every visible card); returns {step: seconds}."""
    from .. import _build
    from ..align import myers
    from ..demux.adapters import AdapterBank
    from ..demux.fused import FusedDemux
    from ..dist.sharded import device_of, make_mesh
    from ..io import encode

    devs = (list(make_mesh().devices.flat) if devices is None
            else [device_of(d) for d in devices])
    timings = {}

    def _t(name, fn):
        t0 = time.time()
        fn()
        timings[name] = round(time.time() - t0, 1)
        if verbose:
            print(f"[prewarm] {name}: {timings[name]}s", flush=True)

    if any(d.type == "cuda" for d in devs):
        _t("nvcc_build", _build.build_all)
    rng = np.random.default_rng(0)
    for dev in devs:
        sp5 = AdapterBank.from_fasta(
            os.path.join(adapters_dir, "M13_amplicon_indices_forward.fa"),
            0.1, str(dev))
        sp27 = AdapterBank.from_fasta(
            os.path.join(adapters_dir, "M13_amplicon_indices_reverse_rc.fa"),
            0.1, str(dev))
        # fused dual-round demux at each read-length bucket
        fd = FusedDemux(sp5, sp27)
        for L in demux_lens:
            masks = np.zeros((demux_batch, L), np.uint8)
            n = min(8, demux_batch)
            seqs = ["".join(rng.choice(list("ACGT"), size=min(L - 8, 300)))
                    for _ in range(n)]
            m8, l8 = encode.pack_batch(seqs, max_len=L, pad_multiple=1,
                                       encoder=encode.encode_read_masks,
                                       pad_value=0)
            masks[:n] = m8
            lens = np.ones(demux_batch, np.int32)
            lens[:n] = l8
            _t(f"fused_demux_L{L}_B{demux_batch}_{dev}",
               lambda: fd.decide(masks, lens))
        # the dense Myers entry point at each length bucket (the listed-
        # tile entry shares its library)
        if dev.type == "cuda":
            for L in myers_lens:
                n = 32
                pat = np.full((n, L), 4, np.uint8)
                pl_ = np.full(n, max(8, L // 2), np.int32)
                pat[:, :L // 2] = rng.integers(0, 4, (n, L // 2))
                _t(f"myers_NW_L{L}_{dev}",
                   lambda: myers.distances(pat, pl_, pat, pl_, "NW",
                                           device=dev, fetch_pos=False))
    return timings
