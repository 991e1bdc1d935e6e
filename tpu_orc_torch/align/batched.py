"""Cutadapt-equivalent locate for every flag set and any adapter length:
one CUDA kernel and its plain PyTorch version.

Port of ``tpu_orc/align/batched.py``: ``batched_locate`` (:121),
``revcomp_masks_device`` (:315) and ``batched_locate_with_rc`` (:338).
The JAX function is an XLA ``fori_loop`` over read columns with a
Kogge-Stone (min,+) scan down each column; ``align/locate.py`` holds the
Pallas kernels, which take FRONT/BACK/INFIX on banks shorter than 63 bp
only. The device of the tensors picks the version:

* a CPU tensor goes to :func:`batched_locate_plain`, the JAX loop as
  torch ops over [B, A, M+1] planes (the column scan, tie to the larger
  row, as ``_prefix_min_scan`` :94-108);
* a CUDA tensor goes to :func:`batched_locate_cuda`, the hand-written
  kernel ``orc_locate_flags`` of ``csrc/batched.cu``: an anti-diagonal
  wavefront over the lanes of a warp (16 lanes a read and adapter, K
  rows a lane), the adapter's rows run in bands of 16K rows with each
  band's last row handed to the next, computing the sequential
  column DP of ``align/spec.py`` (the loop of ``native/oracle.cpp``),
  which is the same recurrence as the scan. A CUDA tensor always
  reaches the kernel, or the wrapper raises.

Both keep ``batched_locate``'s contract with one exception: its
STOP_WITHIN_SEQ1 final-column reduction packs the row into the low 8
bits of a key (:282-291), so rows of 256 and more spill into the cost
field and adapters of 256 bp or more get a wrong refstop and errors.
Both versions here reduce exactly (max matches, then min cost, then min
row) at every row, as the oracle does; below 256 bp the two agree.

START_WITHIN_SEQ1 together with STOP_WITHIN_SEQ1 raises
``NotImplementedError``, as in ``tpu_orc``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .spec import (Flag, FRONT, BACK, PREFIX, SUFFIX,
                   DEFAULT_MIN_OVERLAP)
from .tables import LocateResult

BIG = 1 << 28
#: output planes of both versions, in :class:`LocateResult`'s order
FIELDS = LocateResult._fields
#: bound on the kernel's global band handoff (16 B a column of each
#: alignment whose adapter takes more than one band); a launch takes as
#: many reads as fit
SCRATCH_BYTES = 256 << 20
#: shared memory a block may use (the H100's 227 KB)
MAX_SHARED = 232448

#: the flag sets of cutadapt's adapter types (``align/spec.py``) and
#: INFIX, by name; every other flag set counts as 'other'
MODE_NAMES = {int(FRONT): "front", int(BACK): "back", int(PREFIX): "prefix",
              int(SUFFIX): "suffix",
              int(Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2): "infix"}
#: kernel launches of ``orc_locate_flags`` (one per chunk of reads), by
#: :data:`MODE_NAMES`
LAUNCHES = _build.LaunchCounter(tuple(MODE_NAMES.values()) + ("other",))


def _check_flags(flags: int) -> int:
    flags = int(flags)
    if not 0 <= flags < 16:
        raise ValueError(f"flags {flags} outside the four-bit flag set")
    if flags & Flag.START_WITHIN_SEQ1 and flags & Flag.STOP_WITHIN_SEQ1:
        raise NotImplementedError(
            "START_WITHIN_SEQ1 + STOP_WITHIN_SEQ1 together are not used "
            "by any cutadapt adapter type (spec.py) and the snapshot "
            "evaluation assumes refstart==0 in the final-column scan")
    return flags


def _inputs(ref_masks, ref_lens, k_table, n_prefix, read_masks, read_lens):
    """The six inputs as tensors (numpy arrays become CPU tensors),
    checked for shape, type and device."""
    ts = [torch.as_tensor(x) for x in (ref_masks, ref_lens, k_table,
                                       n_prefix, read_masks, read_lens)]
    ref_masks, ref_lens, k_table, n_prefix, read_masks, read_lens = ts
    if ref_masks.dim() != 2 or read_masks.dim() != 2:
        raise ValueError("ref_masks must be [A, M] and read_masks [B, L]")
    A, M = ref_masks.shape
    B, L = read_masks.shape
    if ref_masks.dtype != torch.uint8 or read_masks.dtype != torch.uint8:
        raise ValueError("ref_masks and read_masks must be uint8")
    if ref_lens.shape != (A,) or read_lens.shape != (B,):
        raise ValueError("ref_lens must be [A] and read_lens [B]")
    if k_table.shape != (A, M + 1) or n_prefix.shape != (A, M + 1):
        raise ValueError("k_table and n_prefix must be [A, M+1]")
    if any(t.dtype.is_floating_point or t.dtype == torch.bool
           for t in (ref_lens, k_table, n_prefix, read_lens)):
        raise ValueError("lengths and tables must be integers")
    if any(t.device != read_masks.device for t in ts):
        raise ValueError("batched_locate inputs lie on more than one device")
    if A == 0:
        raise ValueError("empty adapter bank")
    if B and (int(read_lens.min()) < 0 or int(read_lens.max()) > L):
        raise ValueError("read lengths must lie in [0, L]")
    if int(ref_lens.min()) < 0 or int(ref_lens.max()) > M:
        raise ValueError("adapter lengths must lie in [0, M]")
    return ts


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _prefix_min_scan(v, src):
    """Inclusive prefix-min over the row axis (last), tie -> larger
    index; ``src`` travels with the minimum (``batched.py:94-108``, with
    the row index carried instead of matches and origin)."""
    R = v.shape[-1]
    d = 1
    while d < R:
        sv = torch.cat([torch.full_like(v[..., :d], BIG), v[..., :-d]], -1)
        ss = torch.cat([src[..., :d], src[..., :-d]], -1)
        take = sv < v      # strictly cheaper only: tie keeps the current
        v = torch.where(take, sv, v)
        src = torch.where(take, ss, src)
        d *= 2
    return v, src


def batched_locate_plain(ref_masks, ref_lens, k_table, n_prefix,
                         read_masks, read_lens, flags: int,
                         min_overlap: int = DEFAULT_MIN_OVERLAP
                         ) -> torch.Tensor:
    """``batched_locate``'s column loop as torch ops; int32 [9, B, A] in
    :data:`FIELDS` order. Inputs as :func:`batched_locate`, checked."""
    flags = _check_flags(flags)
    ref_masks, ref_lens, k_table, n_prefix, read_masks, read_lens = _inputs(
        ref_masks, ref_lens, k_table, n_prefix, read_masks, read_lens)
    start_in_ref = bool(flags & Flag.START_WITHIN_SEQ1)
    start_in_qry = bool(flags & Flag.START_WITHIN_SEQ2)
    stop_in_ref = bool(flags & Flag.STOP_WITHIN_SEQ1)
    stop_in_qry = bool(flags & Flag.STOP_WITHIN_SEQ2)
    dev = read_masks.device
    i32 = torch.int32
    A, M = ref_masks.shape
    B, L = read_masks.shape
    R = M + 1
    ref = ref_masks.to(i32).view(1, A, M)
    reads = read_masks.to(i32)
    m_row = ref_lens.to(i32).view(1, A)
    lens_b = read_lens.to(i32).view(B, 1)
    k_tab = k_table.to(i32)
    n_pre = n_prefix.to(i32)
    rows = torch.arange(R, dtype=i32, device=dev).view(1, 1, R)
    src0 = rows.expand(B, A, R)
    at_m = ref_lens.to(torch.int64).view(1, A, 1).expand(B, A, 1)
    n_pref_at_m = n_pre.gather(1, at_m[0]).view(1, A)
    kb = k_tab.view(1, A, R).expand(B, A, R)
    nb = n_pre.view(1, A, R).expand(B, A, R)

    # initial column (j = 0)
    zero = torch.zeros((B, A, R), dtype=i32, device=dev)
    if start_in_ref:
        cost, origin = zero, (-rows).expand(B, A, R)
    else:
        cost, origin = rows.expand(B, A, R), zero
    matches = zero

    def lookup(table, idx):
        """table [B, A, R] at idx [B, A] (int32)."""
        return table.gather(2, idx.to(torch.int64).unsqueeze(2)).squeeze(2)

    def row_m(cost, matches, origin):
        return tuple(x.gather(2, at_m).squeeze(2)
                     for x in (cost, matches, origin))

    def row_m_ok(c, og, j):
        """Acceptance of the row-m candidate at column j."""
        refstart = torch.clamp(-og, min=0)
        length = m_row - refstart
        eff = length - (n_pref_at_m - lookup(nb, refstart))
        kmax = lookup(kb, torch.clamp(eff, 0, M))
        ok = (length >= min_overlap) & (c <= kmax) & (j <= lens_b)
        if not stop_in_qry:
            ok = ok & (j == lens_b)
        return ok

    c, mt, og = row_m(cost, matches, origin)
    ok = row_m_ok(c, og, 0)
    b_valid = ok
    b_m = torch.where(ok, mt, -1)
    b_c = torch.where(ok, c, BIG)
    b_o = torch.where(ok, og, 0)
    b_q = torch.zeros((B, A), dtype=i32, device=dev)
    prev = ok.to(i32)
    nloc, nacc = prev, prev
    snap = (cost, matches, origin)
    n_cols = min(L, int(read_lens.max())) if B else 0
    for j in range(1, n_cols + 1):
        eq = (ref & reads[:, j - 1].view(B, 1, 1)) != 0      # [B, A, M]
        if start_in_qry:
            r0c, r0o = 0, j
        else:
            r0c, r0o = j, 0
        dc = torch.where(eq, cost[..., :M], cost[..., :M] + 1)
        dm = torch.where(eq, matches[..., :M] + 1, matches[..., :M])
        hc = cost[..., 1:] + 1
        use_h = hc < dc                          # diagonal wins ties
        full_c = torch.cat([torch.full_like(cost[..., :1], r0c),
                            torch.where(use_h, hc, dc)], -1)
        full_m = torch.cat([torch.zeros_like(cost[..., :1]),
                            torch.where(use_h, matches[..., 1:], dm)], -1)
        full_o = torch.cat([torch.full_like(cost[..., :1], r0o),
                            torch.where(use_h, origin[..., 1:],
                                        origin[..., :M])], -1)
        # vertical chain: inclusive min of cand[k] + (i - k), tie to the
        # larger k (a vertical step only when strictly cheaper)
        v, src = _prefix_min_scan(full_c - rows, src0)
        cost = v + rows
        src = src.to(torch.int64)
        matches = full_m.gather(2, src)
        origin = full_o.gather(2, src)
        c, mt, og = row_m(cost, matches, origin)
        ok = row_m_ok(c, og, j)
        better = ok & ((mt > b_m) | ((mt == b_m) & (c < b_c)))
        b_valid = b_valid | better
        b_m = torch.where(better, mt, b_m)
        b_c = torch.where(better, c, b_c)
        b_o = torch.where(better, og, b_o)
        b_q = torch.where(better, j, b_q)
        oki = ok.to(i32)
        nloc = nloc + oki * (1 - prev)
        nacc = nacc + oki
        prev = oki
        if stop_in_ref:
            at_end = (lens_b == j).view(B, 1, 1)
            snap = tuple(torch.where(at_end, new, old)
                         for new, old in zip((cost, matches, origin), snap))

    b_row = m_row.expand(B, A)
    if stop_in_ref:
        # every row of the column at j == len is a candidate: max
        # matches, then min cost, then min row, exactly at every row
        scost, smatches, sorigin = snap
        refstart = torch.clamp(-sorigin, min=0)
        length = rows - refstart
        eff = length - nb
        kmax = kb.gather(2, torch.clamp(eff, 0, M).to(torch.int64))
        okf = ((length >= min_overlap) & (scost <= kmax)
               & (rows <= m_row.view(1, A, 1)))
        f_m = torch.where(okf, smatches, -1).amax(2)
        okf = okf & (smatches == f_m.unsqueeze(2))
        f_c = torch.where(okf, scost, BIG).amin(2)
        okf = okf & (scost == f_c.unsqueeze(2))
        f_row = torch.where(okf, rows, R).amin(2)
        f_valid = f_row < R
        f_o = lookup(sorigin, torch.clamp(f_row, max=M))
        better = f_valid & ((f_m > b_m) | ((f_m == b_m) & (f_c < b_c)))
        b_valid = b_valid | better
        b_m = torch.where(better, f_m, b_m)
        b_c = torch.where(better, f_c, b_c)
        b_o = torch.where(better, f_o, b_o)
        b_q = torch.where(better, lens_b, b_q)
        b_row = torch.where(better, f_row, b_row)

    return torch.stack([b_valid.to(i32), b_m, b_c, torch.clamp(-b_o, min=0),
                        b_row, torch.clamp(b_o, min=0), b_q, nloc,
                        nacc]).to(i32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

#: lanes per (read, adapter) of ``orc_locate_flags`` (two reads of one
#: adapter a warp)
LANES = 16
#: the rows a lane of the kernel's instances: 4 holds the 59-mers, 5 a
#: 70 bp bank in one band, 8 runs longer banks in bands of 128 rows
ROWS_PER_LANE = (4, 5, 8)
#: bytes of one handoff column (cost, matches, origin and a pad word)
HAND_BYTES = 16


def table_bytes(M: int) -> int:
    """Shared memory of one block's tables: row m's budget by refstart
    and the final column's by row (4 B x (M+1) each), and the adapter's
    masks (M bytes)."""
    return 8 * (M + 1) + M


def n_bands(ref_lens, k: int) -> torch.Tensor:
    """Bands of each adapter (rows 0..m in bands of 16 k rows)."""
    return torch.as_tensor(ref_lens).to(torch.int64) // (LANES * k) + 1


def handoff_slots(ref_lens, k: int) -> torch.Tensor:
    """int32 [A]: each adapter's slot in the handoff scratch, in bank
    order, or -1 for an adapter that fits one band (no handoff)."""
    multi = n_bands(ref_lens, k) > 1
    return torch.where(multi, torch.cumsum(multi, 0) - 1,
                       -1).to(torch.int32)


def choose_k(max_len: int) -> int:
    """Rows a lane for a bank whose longest adapter has ``max_len`` bp:
    the fewest of :data:`ROWS_PER_LANE` that hold every adapter in one
    band, else 8: a band pads the rows past m up to its height, and
    every band costs a pipeline fill of 15 steps."""
    return next((k for k in ROWS_PER_LANE if LANES * k > max_len),
                ROWS_PER_LANE[-1])


def chunk_reads(n_slots: int, L: int, B: int) -> int:
    """Reads a launch takes: as many as keep the handoff scratch
    (``n_slots`` adapters of more than one band x L columns x 16 B per
    read) within :data:`SCRATCH_BYTES`, at least one; every read where no
    adapter needs the scratch."""
    per_read = n_slots * L * HAND_BYTES
    if per_read == 0:
        return B
    return max(1, min(B, SCRATCH_BYTES // per_read))


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("batched", "orc_locate_flags",
                       [vp] * 7 + [ci] * 9 + [vp, vp, vp]).orc_locate_flags


def batched_locate_cuda(ref_masks, ref_lens, k_table, n_prefix,
                        read_masks, read_lens, flags: int,
                        min_overlap: int = DEFAULT_MIN_OVERLAP
                        ) -> torch.Tensor:
    """Launch ``orc_locate_flags`` of ``csrc/batched.cu`` on the current
    stream with :func:`choose_k` rows a lane, in chunks of
    :func:`chunk_reads` reads; same contract and output as
    :func:`batched_locate_plain`. CUDA tensors only."""
    flags = _check_flags(flags)
    ref_masks, ref_lens, k_table, n_prefix, read_masks, read_lens = _inputs(
        ref_masks, ref_lens, k_table, n_prefix, read_masks, read_lens)
    A, M = ref_masks.shape
    B, L = read_masks.shape
    if table_bytes(M) > MAX_SHARED:
        raise ValueError(f"adapters of {M} bp: the kernel's tables take "
                         f"{table_bytes(M)} B of shared memory, over "
                         f"{MAX_SHARED}")
    dev = read_masks.device
    if dev.type != "cuda":
        raise ValueError(f"batched_locate_cuda takes CUDA tensors, not {dev}")
    lens_host = ref_lens.cpu()
    k = choose_k(int(lens_host.max()))
    i32 = torch.int32
    ref_masks = ref_masks.contiguous()
    ref_lens = ref_lens.to(i32).contiguous()
    k_table = k_table.to(i32).contiguous()
    n_prefix = n_prefix.to(i32).contiguous()
    read_lens = read_lens.to(i32).contiguous()
    reads_T = read_masks.t().contiguous()               # [L, B]
    out = torch.empty((len(FIELDS), B, A), dtype=i32, device=dev)
    if B == 0:
        return out
    slots = handoff_slots(lens_host, k)
    n_slots = int((slots >= 0).sum())
    nb = chunk_reads(n_slots, L, B)
    scratch = (torch.empty((n_slots * nb * L * HAND_BYTES,), dtype=torch.uint8,
                           device=dev) if n_slots else None)
    slots = slots.to(dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, B, nb):
            err = fn(reads_T.data_ptr(), read_lens.data_ptr(),
                     ref_masks.data_ptr(), ref_lens.data_ptr(),
                     k_table.data_ptr(), n_prefix.data_ptr(),
                     slots.data_ptr(), B, A, M, L, b0, min(nb, B - b0),
                     flags, min_overlap, k,
                     scratch.data_ptr() if scratch is not None else None,
                     out.data_ptr(), stream)
            _build.check(err, "batched locate kernel")
            LAUNCHES.add(MODE_NAMES.get(flags, "other"), dev)
    return out


def locate_stack(ref_masks, ref_lens, k_table, n_prefix, read_masks,
                 read_lens, flags: int,
                 min_overlap: int = DEFAULT_MIN_OVERLAP) -> torch.Tensor:
    """int32 [9, B, A] in :data:`FIELDS` order: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    dev = torch.as_tensor(read_masks).device
    if dev.type == "cpu":
        return batched_locate_plain(ref_masks, ref_lens, k_table, n_prefix,
                                    read_masks, read_lens, flags,
                                    min_overlap)
    if dev.type != "cuda":
        raise ValueError(f"no batched locate kernel for device {dev}")
    return batched_locate_cuda(ref_masks, ref_lens, k_table, n_prefix,
                               read_masks, read_lens, flags, min_overlap)


def batched_locate(ref_masks, ref_lens, k_table, n_prefix,
                   read_masks, read_lens, flags: int,
                   min_overlap: int = DEFAULT_MIN_OVERLAP) -> LocateResult:
    """Locate every adapter in every read.

    ref_masks [A, M] uint8, ref_lens [A], k_table/n_prefix [A, M+1],
    read_masks [B, L] uint8, read_lens [B] (tensors, or numpy arrays,
    which stay on the CPU). Returns :class:`LocateResult` of int32 [B, A]
    tensors on the inputs' device."""
    return LocateResult(*locate_stack(ref_masks, ref_lens, k_table,
                                      n_prefix, read_masks, read_lens,
                                      flags, min_overlap))


def revcomp_masks_device(read_masks, read_lens):
    """Reverse-complement match-mask rows on the tensors' device.

    Complement permutes mask bits (A1<->T8, C2<->G4; N16 fixed); reversal
    of the variable-length prefix is a flip and a per-row left shift,
    zero past each read's length (``batched.py:315-335``)."""
    read_masks = torch.as_tensor(read_masks)
    lens = torch.as_tensor(read_lens).to(torch.int64)
    m = read_masks.to(torch.int32)
    comp = (((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1)
            | ((m & 4) >> 1) | (m & 16))
    B, L = m.shape
    idx = (L - lens).view(B, 1) + torch.arange(L, device=m.device).view(1, L)
    out = torch.where(idx < L,
                      comp.flip(1).gather(1, torch.clamp(idx, max=L - 1)),
                      0)
    return out.to(read_masks.dtype)


def batched_locate_with_rc(ref_masks, ref_lens, k_table, n_prefix,
                           read_masks, read_lens, flags: int,
                           min_overlap: int = DEFAULT_MIN_OVERLAP):
    """Locate on each read and its reverse complement (the --rc path),
    the complement made on the reads' device; returns (fwd, rc)
    :class:`LocateResult`\\ s (``batched.py:338-352``)."""
    read_masks = torch.as_tensor(read_masks)
    read_lens = torch.as_tensor(read_lens)
    both = torch.cat([read_masks, revcomp_masks_device(read_masks,
                                                       read_lens)])
    res = locate_stack(ref_masks, ref_lens, k_table, n_prefix, both,
                       torch.cat([read_lens, read_lens]), flags,
                       min_overlap)
    B = read_masks.shape[0]
    return LocateResult(*res[:, :B]), LocateResult(*res[:, B:])


def to_numpy(res: LocateResult) -> LocateResult:
    """A :class:`LocateResult` of tensors as one of numpy arrays (one
    copy to the host)."""
    return LocateResult(*torch.stack(tuple(res)).cpu().numpy())
