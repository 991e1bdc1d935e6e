"""Fused dual-round demux: both cutadapt rounds in ONE device program.

Copy of ``tpu_orc/demux/fused.py``; the device seam: ``_fused_body``
is torch ops on the banks' device around two launches of
``align/locate.py::locate_tiles`` (the CUDA kernel on a CUDA device, its
plain version on the CPU). ``decide_multi`` runs it on one stripe of the
batch per device, as in ``tpu_orc``; a batch is not padded to the
Pallas kernel's read tile (``TB``) here. ``tpu_orc``'s opt-in 2-bit
packed upload is not carried over: no run turned it on, and
``align/pack.py`` is the port's way to send fewer bytes up.

Replaces the host round-trip of the unfused path (demux.py), which for
each batch did: upload round-1 masks -> download trim points -> slice
strings on host -> re-encode -> upload round-2 masks.

Here a single uint8 [B, L] batch is uploaded once; on device we
  1. reverse-complement (gather) and score round 1 (FRONT, 12 SP5
     adapters, fwd+rc) with the locate kernel,
  2. pick the best (adapter, orientation) per read exactly like
     cutadapt --rc (max matches; forward wins ties; across adapters
     first-in-file wins ties),
  3. trim on device by left-shifting each read past its round-1
     querystop,
  4. score round 2 (BACK, 12 SP27-rc adapters, fwd+rc of the *trimmed*
     read) and pick again.
Only eight [B] int32 vectors return to host; host does string slicing
and file IO. Semantics are identical to running demux.assign_reads
twice.

Reference behavior replaced: the reference pipeline's scripts/02_cutadapt_loop.sh
round 1 (:64-72) + round 2 (:91-103), both `--rc -e 0.1 --action=trim`.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..align.spec import DEFAULT_MIN_OVERLAP
from ..io import encode
from ..io.fastq import Record

from ..align.locate import BankTables, locate_tiles
from ..utils.inflight import dispatch_ahead
from ..utils.profiling import count, span
from .adapters import AdapterBank


class FusedDecision(NamedTuple):
    """Per-read demux decisions, all [B] int32 numpy."""
    idx1: np.ndarray     # round-1 adapter index (-1 = unknown)
    rc1: np.ndarray      # 1 if round 1 chose the reverse complement
    qe1: np.ndarray      # round-1 trim point (keep seq[qe1:]) in oriented coords
    idx2: np.ndarray     # round-2 adapter index (-1 = unknown)
    rc2: np.ndarray      # 1 if round 2 chose the rc of the trimmed read
    qs2: np.ndarray      # round-2 trim point (keep trimmed[:qs2])
    err1: np.ndarray     # round-1 match error count (cutadapt JSON report)
    err2: np.ndarray     # round-2 match error count


def _shift_left(x, s):
    """Left-shift each row of x [B, L] by s [B] with wrap-around (one
    gather; values wrapped into the tail are garbage the locate kernel
    never reads because every acceptance test is gated on j <= len)."""
    L = x.shape[1]
    j = torch.arange(L, device=x.device)[None, :]
    return x.gather(1, (j + s.to(torch.int64)[:, None]) % L)


def _revcomp_rows(m, lens):
    """Reverse-complement mask rows [B, L] on device (flip + variable
    left-shift; complement permutes the ACGT mask bits)."""
    comp = (((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1)
            | ((m & 4) >> 1) | (m & 16))
    L = m.shape[1]
    return _shift_left(torch.flip(comp, dims=(1,)), L - lens)


def _best(m, q, o, A, c=None):
    """Across-adapter selection on [A, B] kernel outputs: max matches,
    first adapter in file order wins ties (taken as the smallest index
    holding the maximum, so it holds on any device). Returns (idx [B]
    with -1 for none, matches, querystop, origin[, errors])."""
    mm = torch.where(m[:A] >= 0, m[:A], -1)
    best_m = mm.max(dim=0).values
    iota = torch.arange(A, device=m.device, dtype=torch.int32)[:, None]
    idx = torch.where(mm == best_m[None, :], iota, A).min(dim=0).values
    pick = lambda x: x[:A].gather(0, idx.to(torch.int64)[None, :])[0]
    none = best_m < 0
    out = (torch.where(none, -1, idx), best_m, pick(q), pick(o))
    if c is not None:
        out = out + (pick(c),)
    return out


def _fused_body(t5, t27, masks, lens, A5: int, A27: int,
                locate=locate_tiles):
    """masks [B, L] uint8, lens [B] int32 on the tables' device ->
    [8, B] int32 decisions (FusedDecision order)."""
    B = masks.shape[0]
    lens = lens.to(torch.int32)
    rc = _revcomp_rows(masks, lens)
    both = torch.cat([masks, rc], dim=0)
    lens2 = torch.cat([lens, lens])

    # round 1: FRONT over SP5, fwd + rc in one kernel launch
    m, c, o, q, v = locate(t5, both.T.contiguous(), lens2, "front", A5)[:5]
    idx_b, m_b, qe_b, _, e_b = _best(torch.where(v > 0, m, -1), q, o, A5, c)
    f_idx, r_idx = idx_b[:B], idx_b[B:]
    f_m, r_m = m_b[:B], m_b[B:]
    f_qe, r_qe = qe_b[:B], qe_b[B:]
    f_e, r_e = e_b[:B], e_b[B:]
    use_rc1 = (r_m >= 0) & ((f_m < 0) | (r_m > f_m))
    idx1 = torch.where(use_rc1, r_idx, f_idx)
    qe1 = torch.where(idx1 >= 0, torch.where(use_rc1, r_qe, f_qe), 0)
    err1 = torch.where(use_rc1, r_e, f_e)

    # device trim: keep oriented[qe1:]
    oriented = torch.where(use_rc1[:, None], rc, masks)
    trimmed = _shift_left(oriented, qe1)
    lens_t = lens - qe1

    # round 2: BACK over SP27-rc, fwd + rc of the trimmed read
    rc_t = _revcomp_rows(trimmed, lens_t)
    both2 = torch.cat([trimmed, rc_t], dim=0)
    lens2t = torch.cat([lens_t, lens_t])
    m, c, o, q, v = locate(t27, both2.T.contiguous(), lens2t, "back",
                           A27)[:5]
    idx_b, m_b, _, qs_b, e_b = _best(torch.where(v > 0, m, -1), q, o,
                                     A27, c)
    f_idx, r_idx = idx_b[:B], idx_b[B:]
    f_m, r_m = m_b[:B], m_b[B:]
    f_qs, r_qs = qs_b[:B], qs_b[B:]
    f_e2, r_e2 = e_b[:B], e_b[B:]
    use_rc2 = (r_m >= 0) & ((f_m < 0) | (r_m > f_m))
    idx2 = torch.where(use_rc2, r_idx, f_idx)
    qs2 = torch.where(idx2 >= 0,
                      torch.clamp(torch.where(use_rc2, r_qs, f_qs), min=0), 0)
    err2 = torch.where(use_rc2, r_e2, f_e2)
    # ONE stacked [8, B] output -> one device->host transfer
    return torch.stack([idx1, use_rc1.to(torch.int32), qe1,
                        idx2, use_rc2.to(torch.int32), qs2, err1,
                        err2]).to(torch.int32)


class FusedDemux:
    """Reusable fused dual-round demuxer for one (SP5, SP27-rc) bank pair,
    on the banks' device.

    Precomputes threshold tables once; each call uploads one uint8 batch
    and downloads eight [B] vectors. ``locate`` is the locate
    implementation (default: the device-dispatching ``locate_tiles``); a
    check may pass the plain version to hold the kernel path against it
    on the same device.
    """

    def __init__(self, sp5: AdapterBank, sp27rc: AdapterBank,
                 min_overlap: int = DEFAULT_MIN_OVERLAP,
                 locate=locate_tiles):
        self.device = torch.device(sp5.device)
        if torch.device(sp27rc.device) != self.device:
            raise ValueError("SP5 and SP27-rc banks lie on different "
                             "devices")
        self.sp5, self.sp27 = sp5, sp27rc
        self.t5 = BankTables(sp5.masks, sp5.lens, sp5.k_table,
                             sp5.n_prefix, True, min_overlap)
        self.t27 = BankTables(sp27rc.masks, sp27rc.lens, sp27rc.k_table,
                              sp27rc.n_prefix, False, min_overlap)
        self._a5 = self.t5.tensors(self.device)
        self._a27 = self.t27.tensors(self.device)
        self._locate = locate

    def decide(self, masks: np.ndarray, lens: np.ndarray) -> FusedDecision:
        """masks [B0, L] uint8, lens [B0] -> FusedDecision (numpy)."""
        B0 = masks.shape[0]
        out = self._dispatch(masks, lens).cpu().numpy()
        return FusedDecision(*(out[k, :B0] for k in range(8)))

    def decide_multi(self, masks: np.ndarray, lens: np.ndarray,
                     devices) -> FusedDecision:
        """Multi-device demux decisions: batch rows striped over explicit
        devices (``ceil(B0 / len(devices))`` rows each, in row order),
        each stripe running the same fused program as ``decide`` on its
        device; every stripe is launched before any is fetched, so the
        devices compute together; the host concatenates. A device may be
        listed more than once."""
        from ..dist.sharded import device_of
        devices = [device_of(d) for d in devices]
        B0 = masks.shape[0]
        stripe = -(-B0 // len(devices))
        stripes = [(dev, slice(k * stripe, (k + 1) * stripe))
                   for k, dev in enumerate(devices) if k * stripe < B0]

        def launch(s):
            dev, rows = s
            # the bank tables replicate per device (memoized by
            # BankTables.tensors), SURVEY.md §2.4
            return _fused_body(
                self.t5.tensors(dev), self.t27.tensors(dev),
                _put(masks[rows], dev, np.uint8),
                _put(lens[rows], dev, np.int32), self.t5.A, self.t27.A,
                self._locate)

        outs = [o for _, o in dispatch_ahead(
            stripes, launch, lambda o: o.cpu().numpy(), depth=None)]
        if not outs:
            return FusedDecision(*(np.zeros(0, np.int32) for _ in range(8)))
        full = np.concatenate(outs, axis=1)
        return FusedDecision(*(full[k] for k in range(8)))

    def assign(self, records: Sequence[Record], batch_size: int = 2048,
               max_len: int = 256):
        """Yield (rec_index, sp5_name|None, trimmed1 Record, sp27_name|None,
        final Record) per read — the exact per-read decisions of running
        demux.assign_reads for round 1 then round 2. Host work is fully
        vectorized: one ascii gather per chunk in, one vectorized
        materialization out. A batch pads to ``encode.bucket_len`` of its
        longest read, and to at least ``max_len``. Batches go through
        the dispatch-ahead window (``utils/inflight.py``), so the host
        packs later batches while the card computes earlier ones;
        ``fused.pipeline_depth`` sums the batches in flight at each
        fetch."""
        from .demux import materialize_batch
        with span("fused.assign"):
            recs = list(records)
            out = []

            def pack_and_launch(s):
                chunk = recs[s:s + batch_size]
                count("fused.batches")
                with span("fused.pack"):
                    n = max((len(r.seq) for r in chunk), default=1)
                    amat, lens = encode.ascii_matrix(
                        [r.seq for r in chunk],
                        max_len=max(encode.bucket_len(n), max_len))
                    masks = encode.read_masks_matrix(amat, lens)
                return chunk, amat, lens, self._dispatch(masks, lens)

            def fetch(handle):
                chunk, amat, lens, lazy = handle
                with span("fused.fetch"):
                    return chunk, amat, lens, lazy.cpu().numpy()

            for s, (chunk, amat, lens, full) in dispatch_ahead(
                    range(0, len(recs), batch_size), pack_and_launch, fetch,
                    counter="fused.pipeline_depth"):
                with span("fused.materialize"):
                    d = FusedDecision(*(full[k, :len(chunk)]
                                        for k in range(8)))
                    mat = materialize_batch(chunk, self.sp5.names,
                                            self.sp27.names, d.idx1, d.rc1,
                                            d.qe1, d.idx2, d.rc2, d.qs2,
                                            amat=amat, lens=lens)
                    for i, dec in enumerate(mat):
                        out.append((s + i,) + dec
                                   + (bool(d.rc1[i]) and int(d.idx1[i]) >= 0,
                                      int(d.err1[i]),
                                      bool(d.rc2[i]) and int(d.idx2[i]) >= 0,
                                      int(d.err2[i])))
        return out

    def _dispatch(self, masks: np.ndarray, lens: np.ndarray):
        """Upload + launch the fused program; returns the [8, B] device
        tensor (no fetch)."""
        with span("fused.launch"):
            count("fused.h2d_bytes", masks.nbytes + 4 * len(lens))
            return _fused_body(self._a5, self._a27,
                               _put(masks, self.device, np.uint8),
                               _put(lens, self.device, np.int32), self.t5.A,
                               self.t27.A, self._locate)


def _put(x, dev, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)
