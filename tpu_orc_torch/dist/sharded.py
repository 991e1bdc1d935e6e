"""Multi-device data parallelism for demux and clustering.

Port of ``tpu_orc/dist/sharded.py``: ``make_mesh`` (:33),
``choose_best_jnp`` (:48, here :func:`choose_best`),
``sharded_demux_step`` (:61), ``sharded_dual_demux_step`` (:95),
``device_parallel_pairwise`` (:169) and ``sharded_pairwise_step``
(:251). ``tpu_orc`` runs the steps as ``shard_map`` programs over a
``jax.sharding.Mesh``; here a :class:`Mesh` is a grid of torch devices
and a step runs one stripe of rows on each device, through the
single-device entry points the port already has:

* the two demux steps through ``align/batched.py::batched_locate`` (the
  ``orc_locate_flags`` kernel on a CUDA device, its plain version on the
  CPU), the selection and the trim between rounds as torch ops on the
  stripe's device;
* the pairwise steps through ``align/myers.py``'s dense and listed-tile
  entry points.

Every stripe is launched before any result is fetched: a launch is
asynchronous, so the cards compute together while the host uploads the
next stripe (an upload from pageable memory returns when its copy is
done). A mesh may list one device several times; its stripes then run
one after another on that device's stream. The stripes' histograms are
summed on the host and, when a ``torch.distributed`` process group is
up (``dist/multihost.py``), summed across its processes: the ``psum``
of ``tpu_orc``'s steps (:85, :163-164).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..align import myers
from ..align.batched import batched_locate
from ..align.spec import BACK, FRONT


@dataclass(frozen=True)
class Mesh:
    """A 2-D grid of torch devices with axes ('data', 'pair'), read as
    ``jax.sharding.Mesh`` is: ``.shape`` maps an axis name to its size,
    ``.devices`` is the numpy object array of devices (``.flat``,
    ``.size``)."""
    devices: np.ndarray
    axis_names: Tuple[str, str] = ("data", "pair")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def device_of(dev) -> torch.device:
    """``dev`` as a torch.device with its index: ``cuda`` names the
    current card, which would make a stripe follow whatever card is
    current when it launches. A CUDA device raises where there is no
    card or no card of that index."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"device {dev}: {torch.cuda.device_count()} "
                           f"CUDA devices")
    return torch.device("cuda", index)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh ('data', 'pair'). Default: every visible card, all on
    'data'. ``devices`` may name a device more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the "
                               "devices to build a mesh without one")
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = [device_of(d) for d in devices]
    if shape is None:
        shape = (len(devs), 1)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape))


def all_reduce_sum(x: np.ndarray) -> np.ndarray:
    """``x`` summed over the processes of the ``torch.distributed`` group
    (through the card with "nccl", the host with "gloo";
    ``dist/multihost.py`` starts the group); ``x`` itself when no group
    of more than one process is up."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(t)
    return t.cpu().numpy()


def _stripes(n_rows: int, n_parts: int):
    """(r0, r1) of each of ``n_parts`` equal stripes of ``n_rows`` rows,
    which ``n_parts`` must divide (as ``shard_map`` requires)."""
    if n_rows % n_parts:
        raise ValueError(f"{n_rows} rows do not split over {n_parts} "
                         f"devices; pad them to a multiple")
    s = n_rows // n_parts
    return [(k * s, (k + 1) * s) for k in range(n_parts)]


# ---------------------------------------------------------------------------
# Demux step: striped reads x replicated bank -> assignments + histogram
# ---------------------------------------------------------------------------

def choose_best(res):
    """cutadapt across-adapter selection on a LocateResult of [B, A]
    tensors: max matches among valid locations, the first adapter wins
    ties (the smallest index holding the maximum, on any device).
    Returns (idx, matches, qstart, qstop, errors), [B] int32 tensors;
    idx -1 where no adapter is valid."""
    matches = torch.where(res.valid != 0, res.matches, -1)
    best_m = matches.max(dim=1).values
    A = matches.shape[1]
    iota = torch.arange(A, device=matches.device, dtype=matches.dtype)
    idx = torch.where(matches == best_m[:, None], iota, A).min(dim=1).values
    idx = torch.where(best_m < 0, -1, idx)
    at = torch.clamp(idx, min=0).to(torch.int64)[:, None]
    pick = lambda x: x.gather(1, at)[:, 0]
    return (idx.to(torch.int32), best_m, pick(res.querystart),
            pick(res.querystop), pick(res.errors))


def _histogram(idx, A: int):
    """[A+1] int32 counts of idx + 1 (slot 0 = unknown), as a one-hot sum:
    ``torch.bincount`` on a CUDA tensor reads its maximum back to the
    host, which would hold the launch of the next stripe."""
    slots = torch.arange(-1, A, device=idx.device, dtype=idx.dtype)
    return (idx[:, None] == slots[None, :]).sum(dim=0, dtype=torch.int32)


def sharded_demux_step(mesh: Mesh, bank, read_masks, read_lens,
                       flags: int = int(FRONT)):
    """One demux step over the mesh: returns (adapter_idx [B], matches [B],
    qstart [B], qstop [B], bin_histogram [A+1] summed over the stripes and
    the process group), numpy int32. Reads stripe over the 'data' axis;
    their rows must be divisible by its size."""
    from ..demux.demux import _bank_tensors
    from ..demux.fused import _put
    A = bank.masks.shape[0]
    read_masks = np.asarray(read_masks)
    read_lens = np.asarray(read_lens, np.int32)
    lazies = []
    for (r0, r1), dev in zip(_stripes(len(read_masks), mesh.shape["data"]),
                             mesh.devices[:, 0]):
        res = batched_locate(*_bank_tensors(bank, dev),
                             _put(read_masks[r0:r1], dev, np.uint8),
                             _put(read_lens[r0:r1], dev), int(flags))
        idx, best_m, qstart, qstop, _ = choose_best(res)
        lazies.append((torch.stack([idx, best_m, qstart, qstop]),
                       _histogram(idx, A)))
    outs = [(v.cpu().numpy(), h.cpu().numpy()) for v, h in lazies]
    vecs = np.concatenate([v for v, _ in outs], axis=1).astype(np.int32)
    hist = all_reduce_sum(sum(h for _, h in outs))
    return vecs[0], vecs[1], vecs[2], vecs[3], hist


# ---------------------------------------------------------------------------
# Dual-round demux step: the full 02-stage decision per read, striped
# ---------------------------------------------------------------------------

def _orient(res, B: int):
    """--rc selection over one round's [2B] result (reads, then their
    reverse complements): the rc wins on strictly more matches. Returns
    (idx, use_rc, qstart, qstop, errors) of the chosen orientation."""
    fi, fm, fqs, fqe, fe = (x[:B] for x in choose_best(res))
    ri, rm, rqs, rqe, re = (x[B:] for x in choose_best(res))
    use_rc = (rm >= 0) & ((fm < 0) | (rm > fm))
    pick = lambda r, f: torch.where(use_rc, r, f)
    return (pick(ri, fi), use_rc, pick(rqs, fqs), pick(rqe, fqe),
            pick(re, fe))


def sharded_dual_demux_step(mesh: Mesh, sp5, sp27rc, read_masks,
                            read_lens):
    """Both cutadapt rounds (SP5 FRONT + SP27-rc BACK, --rc each round,
    on-device trim between rounds) for a read batch striped over 'data';
    the multi-device form of demux.fused for any bank the batched locate
    takes.

    Returns per-read numpy int32 vectors (idx1, rc1, qe1, idx2, rc2, qs2,
    err1, err2), each [B], plus the histograms hist1 [A5+1] and hist2
    [A27+1] (slot 0 = unknown) summed over the stripes and the process
    group. Round 1 is launched on every stripe before round 2 on any, so
    a stripe's round 2 (whose batched locate reads its lengths back on
    the host) waits only for its own round 1.
    """
    from ..demux.demux import _bank_tensors
    from ..demux.fused import _put, _revcomp_rows, _shift_left
    A5 = sp5.masks.shape[0]
    A27 = sp27rc.masks.shape[0]
    read_masks = np.asarray(read_masks)
    read_lens = np.asarray(read_lens, np.int32)
    round1 = []
    for (r0, r1), dev in zip(_stripes(len(read_masks), mesh.shape["data"]),
                             mesh.devices[:, 0]):
        m = _put(read_masks[r0:r1], dev, np.uint8)
        rl = _put(read_lens[r0:r1], dev)
        rc = _revcomp_rows(m, rl)
        res = batched_locate(*_bank_tensors(sp5, dev), torch.cat([m, rc]),
                             torch.cat([rl, rl]), int(FRONT))
        round1.append((dev, m, rl, rc, res))
    lazies = []
    for dev, m, rl, rc, res in round1:
        B = m.shape[0]
        idx1, use_rc1, _, qe_b, err1 = _orient(res, B)
        qe1 = torch.where(idx1 >= 0, qe_b, 0)
        trimmed = _shift_left(torch.where(use_rc1[:, None], rc, m), qe1)
        lens_t = rl - qe1
        rc_t = _revcomp_rows(trimmed, lens_t)
        res2 = batched_locate(*_bank_tensors(sp27rc, dev),
                              torch.cat([trimmed, rc_t]),
                              torch.cat([lens_t, lens_t]), int(BACK))
        idx2, use_rc2, qs_b, _, err2 = _orient(res2, B)
        qs2 = torch.where(idx2 >= 0, torch.clamp(qs_b, min=0), 0)
        vecs = torch.stack([idx1, use_rc1.to(torch.int32), qe1, idx2,
                            use_rc2.to(torch.int32), qs2, err1, err2])
        lazies.append((vecs, _histogram(idx1, A5), _histogram(idx2, A27)))
    outs = [tuple(t.cpu().numpy() for t in lz) for lz in lazies]
    vecs = np.concatenate([v for v, _, _ in outs], axis=1).astype(np.int32)
    h1 = all_reduce_sum(sum(h for _, h, _ in outs))
    h2 = all_reduce_sum(sum(h for _, _, h in outs))
    return tuple(vecs) + (h1, h2)


# ---------------------------------------------------------------------------
# Per-device Myers dispatch (the production multi-device scoring path)
# ---------------------------------------------------------------------------

def device_parallel_pairwise(devices, pat_codes, pat_lens, txt_codes,
                             txt_lens, mode: str = "NW",
                             gate: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """All patterns vs all texts with pattern rows striped over explicit
    devices; each stripe runs the single-device Myers entry point on its
    device (the kernel on a CUDA device, its plain version on the CPU);
    every stripe is launched before any is fetched, so the devices
    compute together; results gather on the host, where the union-find
    consumer lives (SURVEY.md §7.4.4).

    gate: optional [P, T] bool. With it each stripe lists only the
    (TI, TJ) tiles holding a True for the listed-tile entry point (a
    stripe with none is skipped); un-gated entries of the result are
    unspecified (callers mask). Without it each stripe runs the dense
    entry point. Returns [P, T] int32 distances (numpy).
    """
    devices = [device_of(d) for d in devices]
    P0 = int(pat_codes.shape[0])
    T0 = int(txt_codes.shape[0])
    stripe = -(-P0 // len(devices))
    lazies = []  # (r0, r1, lazy [>= r1 - r0, >= T0] distances)
    for k, dev in enumerate(devices):
        r0, r1 = k * stripe, min((k + 1) * stripe, P0)
        if r0 >= r1:
            break
        d = pairwise_stripe(dev, pat_codes[r0:r1], pat_lens[r0:r1],
                            txt_codes, txt_lens, mode,
                            None if gate is None else gate[r0:r1])
        if d is not None:
            lazies.append((r0, r1, d))
    out = np.zeros((P0, T0), np.int32)
    for r0, r1, d in lazies:   # fetch AFTER all launches
        out[r0:r1] = d.cpu().numpy()[:r1 - r0, :T0]
    return out


def pairwise_stripe(dev, pat_codes, pat_lens, txt_codes, txt_lens,
                    mode: str = "NW", gate: Optional[np.ndarray] = None):
    """Upload and launch one stripe of :func:`device_parallel_pairwise`
    on ``dev``: the dense entry point, or with ``gate`` (the stripe's
    rows) the listed-tile entry point over the (TI, TJ) tiles holding a
    True. Returns the [>= P, >= T] int32 distances on ``dev`` without
    waiting for them, or None when the gate lists no tile."""
    pc = np.ascontiguousarray(pat_codes)
    pl = np.ascontiguousarray(pat_lens)
    T0 = int(txt_codes.shape[0])
    if gate is None:
        return myers.distances(pc, pl, txt_codes, txt_lens, mode,
                               device=dev, fetch_pos=False, lazy=True)[0]
    W = max(1, -(-int(pc.shape[1]) // myers.WORD))
    TI, TJ = myers.tile_shape(W)
    Pp = -(-gate.shape[0] // TI) * TI
    Tp = -(-T0 // TJ) * TJ
    gf = np.zeros((Pp, Tp), bool)
    gf[:gate.shape[0], :T0] = gate
    need = gf.reshape(Pp // TI, TI, Tp // TJ, TJ).any(axis=(1, 3))
    pairs = np.argwhere(need).astype(np.int32)
    if len(pairs) == 0:
        return None
    return myers.distances_pairs(pc, pl, txt_codes, txt_lens, pairs, mode,
                                 TI=TI, TJ=TJ, device=dev, fetch_pos=False,
                                 lazy=True)[0]


# ---------------------------------------------------------------------------
# Pairwise tile step: pattern stripe per device, texts replicated
# ---------------------------------------------------------------------------

def sharded_pairwise_step(mesh: Mesh, pat_codes, pat_lens, txt_codes,
                          txt_lens) -> np.ndarray:
    """All patterns vs all texts (NW), pattern rows striped over every
    device of the mesh ('data' x 'pair'; the rows must be divisible by
    the mesh's size): returns the [Ptot, T] distance matrix gathered on
    the host for the union-find merge."""
    if pat_codes.shape[0] % mesh.devices.size:
        raise ValueError(f"{pat_codes.shape[0]} patterns do not split over "
                         f"{mesh.devices.size} devices")
    return device_parallel_pairwise(list(mesh.devices.flat), pat_codes,
                                    pat_lens, txt_codes, txt_lens)
