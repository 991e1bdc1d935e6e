"""Cutadapt-equivalent locate over [reads x adapters]: CUDA kernel and its
plain PyTorch version.

Port of ``tpu_orc/align/pallas_locate.py``: ``BankTables`` (:461),
``tables_for_bank`` (:523), ``_mode_of`` (:545), ``locate_dispatch``
(:555), ``locate_collect`` (:589) and ``locate_pallas`` (:602, here
``locate_masks``). ``locate_tiles`` takes the place of the Pallas launch
(:394) and dispatches by the device of its tensors:

* a CPU tensor goes to :func:`locate_plain`, the anti-diagonal wavefront
  recurrence of ``_kernel_wf`` written as torch ops over [A, R, B]
  planes;
* a CUDA tensor goes to :func:`locate_cuda`, the hand-written kernel in
  ``csrc/locate.cu``, or the wrapper raises.

Supported modes are FRONT, BACK and INFIX (the demux, primer-clean and
reorient paths). Other flag sets belong to the XLA ``batched_locate``,
which is not ported yet; they raise ``NotImplementedError``. Adapters may
be up to ``MAX_ADAPTER`` bp (the Pallas tables stop at 62 bp).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_orc.align.spec import Flag, FRONT, BACK, DEFAULT_MIN_OVERLAP

from .. import _build
from .tables import LocateResult

INFIX = Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2

BIG = 1 << 28
MAX_ADAPTER = 127          # DP rows R <= 128 in csrc/locate.cu
MODES = {"front": 0, "back": 1, "infix": 2}

#: kernel launches per mode (csrc/locate.cu), counted by locate_cuda
LAUNCHES = _build.LaunchCounter(tuple(MODES))


def rows_for(M: int) -> int:
    """DP row count R for a bank of longest adapter M: 64 (the Pallas
    kernel's RP, so tables equal the reference's) or 128."""
    if M > MAX_ADAPTER:
        raise ValueError(f"adapter length {M} > {MAX_ADAPTER} bp, the "
                         f"locate kernel's limit")
    return 64 if M < 64 else 128


class BankTables:
    """Host-precomputed constant tables for one adapter bank + mode.

    All acceptance rules (error budget floor(e*eff) with N-wildcard
    corrections, min-overlap) are encoded as int32 thresholds; -1 means
    "never accept". Fields are numpy, laid out as the Pallas kernel's
    (``ref/kbyrs/kfin`` [Ap, R], ``mrow/kconst`` [Ap, 1]; its one-hot
    ``onem`` is not needed here); :meth:`tensors` gives the device copies
    the kernels take.
    """

    def __init__(self, bank_masks, bank_lens, k_table, n_prefix,
                 mode_front: bool, min_overlap: int):
        A, M = bank_masks.shape
        R = rows_for(M)
        Ap = max(8, A)
        k_table = np.asarray(k_table)
        n_prefix = np.asarray(n_prefix)
        bank_lens = np.asarray(bank_lens)
        ref = np.zeros((Ap, R), np.int32)
        ref[:A, 1:M + 1] = bank_masks
        # FRONT row-m thresholds keyed on candidate refstart
        kbyrs = np.full((Ap, R), -1, np.int32)
        # BACK final-column thresholds keyed on row (refstop)
        kfin = np.full((Ap, R), -1, np.int32)
        # BACK row-m threshold constant
        kconst = np.full((Ap, 1), -1, np.int32)
        for a in range(A):
            m = int(bank_lens[a])
            for rs in range(m + 1):
                length = m - rs
                if length < min_overlap:
                    continue
                eff = length - int(n_prefix[a, m] - n_prefix[a, rs])
                kbyrs[a, rs] = k_table[a, max(0, min(eff, M))]
            for row in range(min_overlap, m + 1):
                eff = row - int(n_prefix[a, row])
                kfin[a, row] = k_table[a, max(0, min(eff, M))]
            if m >= min_overlap:
                kconst[a, 0] = k_table[a, max(0, m - int(n_prefix[a, m]))]
        mrow = np.ones((Ap, 1), np.int32)
        mrow[:A, 0] = bank_lens
        self._set(A, Ap, M, mode_front, ref, kbyrs, kfin, mrow, kconst)

    def _set(self, A, Ap, M, mode_front, ref, kbyrs, kfin, mrow, kconst):
        self.A, self.Ap, self.M = A, Ap, M
        self.mode_front = mode_front
        self.ref, self.kbyrs, self.kfin = ref, kbyrs, kfin
        self.mrow, self.kconst = mrow, kconst
        self._dev = {}

    def tensors(self, device) -> tuple:
        """(ref, kbyrs, kfin, kconst, mrow) int32 tensors on ``device``
        (memoized: a run dispatches thousands of chunks against one
        bank)."""
        device = torch.device(device)
        got = self._dev.get(device)
        if got is None:
            got = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in (self.ref, self.kbyrs, self.kfin,
                                  self.kconst[:, 0], self.mrow[:, 0]))
            self._dev[device] = got
        return got


def tables_from_reference(tabs) -> BankTables:
    """The port's tables from a ``tpu_orc`` ``BankTables`` (its numpy
    fields, read by name), so both packages can run on one table set."""
    out = BankTables.__new__(BankTables)
    out._set(tabs.A, tabs.Ap, tabs.M, tabs.mode_front,
             *(np.ascontiguousarray(getattr(tabs, k), np.int32)
               for k in ("ref", "kbyrs", "kfin", "mrow", "kconst")))
    return out


def tables_for_bank(bank, mode: str, min_overlap: int) -> BankTables:
    """BankTables for an AdapterBank, cached on the bank instance —
    BankTables construction is a Python A x R double loop that the
    per-chunk hot paths must not repay (reorient dispatches one locate
    per 2048-read chunk)."""
    cache = getattr(bank, "_pl_tables", None)
    if cache is None:
        cache = {}
        bank._pl_tables = cache
    key = (mode, min_overlap)
    if key not in cache:
        # Copy the bank tables at cache time: BankTables (and its
        # memoized device tensors) freeze the thresholds for the life of
        # the bank, so a caller mutating bank.k_table after a locate has
        # run must not silently keep the stale copy alive inside the
        # cache while reading fresh values elsewhere.
        cache[key] = BankTables(bank.masks.copy(), bank.lens.copy(),
                                bank.k_table.copy(),
                                bank.n_prefix, mode == "front", min_overlap)
    return cache[key]


def _mode_of(flags: int) -> str:
    if int(flags) == int(FRONT):
        return "front"
    if int(flags) == int(BACK):
        return "back"
    if int(flags) == int(INFIX):
        return "infix"
    raise NotImplementedError(
        "locate supports FRONT/BACK/INFIX only; other flag sets are the "
        "XLA batched_locate's, not ported yet")


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def locate_plain(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                 mode: str, A: int) -> torch.Tensor:
    """``_kernel_wf``'s anti-diagonal recurrence as torch ops.

    tables = (ref, kbyrs, kfin, kconst, mrow) as from
    :meth:`BankTables.tensors`; reads_T [L, B] read match masks; lens [B].
    Returns int32 [8, A, B]: matches, errors, origin, querystop, valid,
    refstop row, nloc, nacc. On anti-diagonal d the cell (row i, column
    j = d - i) reads (i-1, j-1) from plane d-2 and (i, j-1), (i-1, j)
    from plane d-1; rows are the adapter positions 0..R-1 of every
    adapter at once. Works at any adapter length the tables hold.
    """
    ref, kbyrs, kfin, kconst, mrow = tables
    dev = reads_T.device
    i32 = torch.int32
    L, B = reads_T.shape
    R = ref.shape[1]
    front = mode == "front"
    back = mode == "back"
    rows = torch.arange(R, device=dev, dtype=i32).view(1, R, 1)
    refm = ref[:A].to(i32).view(A, R, 1)
    mlen = mrow[:A].to(torch.int64)
    lens_ = lens.to(i32).view(1, B)
    zpad = torch.zeros((R, B), dtype=i32, device=dev)
    # reversed, R-zero-padded read rows: win[i] = read[d-1-i] is one
    # ascending slice at offset L - d + R
    erev = torch.cat([zpad, reads_T.to(i32).flip(0), zpad])
    shape = (A, R, B)
    zero = torch.zeros(shape, dtype=i32, device=dev)
    big = torch.full(shape, BIG, dtype=i32, device=dev)
    # boundary column j = 0, written at row i == d
    if front:   # free ref-prefix skip: cost 0, origin -i
        bnd_c = torch.zeros((A, R), dtype=i32, device=dev)
        bnd_o = (-rows[0, :, 0]).expand(A, R)
    else:       # pay deletions: cost i
        bnd_c = rows[0, :, 0].expand(A, R)
        bnd_o = torch.zeros((A, R), dtype=i32, device=dev)
    is0 = rows == 0
    # plane d = 0 holds cell (0, 0); plane d = -1 is unreached (BIG)
    c1, m1, o1 = torch.where(is0, 0, big), zero, zero
    c2, m2, o2 = big, zero, zero
    if back:
        sc, sm, so = big, zero, zero

    out_v = torch.zeros((A, B), dtype=i32, device=dev)
    out_m = torch.full((A, B), -1, dtype=i32, device=dev)
    out_c = torch.full((A, B), BIG, dtype=i32, device=dev)
    out_o = torch.zeros((A, B), dtype=i32, device=dev)
    out_q = torch.zeros((A, B), dtype=i32, device=dev)
    out_r = mlen.to(i32).view(A, 1).expand(A, B).clone()
    nloc = torch.zeros((A, B), dtype=i32, device=dev)
    nacc = torch.zeros((A, B), dtype=i32, device=dev)
    pok = torch.zeros((A, B), dtype=i32, device=dev)
    at_m = mlen.view(A, 1, 1).expand(A, 1, B)
    kb = kbyrs[:A].to(torch.int64)
    kc = kconst[:A].to(i32).view(A, 1)
    for d in range(1, L + R):
        win = erev[L - d + R:L - d + 2 * R]                  # [R, B]
        eq = (refm & win.unsqueeze(0)) != 0
        diag_c = torch.roll(c2, 1, 1)
        diag_m = torch.roll(m2, 1, 1)
        diag_o = torch.roll(o2, 1, 1)
        dc = torch.where(eq, diag_c, diag_c + 1)
        dm = torch.where(eq, diag_m + 1, diag_m)
        hc = c1 + 1
        use_h = hc < dc                       # diag preferred on ties
        cc = torch.where(use_h, hc, dc)
        cm = torch.where(use_h, m1, dm)
        co = torch.where(use_h, o1, diag_o)
        vc = torch.roll(c1, 1, 1) + 1
        use_v = vc < cc                       # vertical only when cheaper
        cc = torch.where(use_v, vc, cc)
        cm = torch.where(use_v, torch.roll(m1, 1, 1), cm)
        co = torch.where(use_v, torch.roll(o1, 1, 1), co)
        # row 0 at column j = d: START_WITHIN_SEQ2 reset (0, m=0, o=j)
        cc[:, 0] = 0
        cm[:, 0] = 0
        co[:, 0] = d
        if d < R:   # column j = 0 boundary at row i == d
            cc[:, d] = bnd_c[:, d:d + 1]
            cm[:, d] = 0
            co[:, d] = bnd_o[:, d:d + 1]
        # row-m candidate of each adapter: column j_a = d - m_a
        cmv = cc.gather(1, at_m).squeeze(1)
        mmv = cm.gather(1, at_m).squeeze(1)
        omv = co.gather(1, at_m).squeeze(1)
        if front:
            rs = torch.clamp(-omv, 0, R - 1).to(torch.int64)
            kmax = kb.gather(1, rs).to(i32)
        else:
            kmax = kc
        ja = (d - mlen).to(i32).view(A, 1)
        ok = (cmv <= kmax) & (ja <= lens_)    # d < m rows hold BIG cost
        better = ok & ((mmv > out_m) | ((mmv == out_m) & (cmv < out_c)))
        out_v = torch.where(better, 1, out_v)
        out_m = torch.where(better, mmv, out_m)
        out_c = torch.where(better, cmv, out_c)
        out_o = torch.where(better, omv, out_o)
        out_q = torch.where(better, ja.expand(A, B), out_q)
        oki = ok.to(i32)
        nloc = nloc + oki * (1 - pok)
        nacc = nacc + oki
        pok = oki
        if back:
            at_end = (d - rows) == lens_.view(1, 1, B)
            sc = torch.where(at_end, cc, sc)
            sm = torch.where(at_end, cm, sm)
            so = torch.where(at_end, co, so)
        c2, m2, o2 = c1, m1, o1
        c1, m1, o1 = cc, cm, co

    if back:
        # final-column candidates from the snapshot: max matches, then
        # min cost, then min row; thresholds kfin per (adapter, row)
        okf = sc <= kfin[:A].to(i32).view(A, R, 1)
        key = torch.where(okf, ((R - sm) << 16)
                          + (torch.clamp(sc, max=255) << 8) + rows, BIG)
        kbest = key.min(dim=1).values
        okb = kbest < BIG
        fm = R - (kbest >> 16)
        fc = (kbest >> 8) & 255
        frow = kbest & 255
        fo = so.gather(1, torch.clamp(frow, 0, R - 1).to(torch.int64)
                       .unsqueeze(1)).squeeze(1)
        better = okb & ((fm > out_m) | ((fm == out_m) & (fc < out_c)))
        out_v = torch.where(better, 1, out_v)
        out_m = torch.where(better, fm, out_m)
        out_c = torch.where(better, fc, out_c)
        out_o = torch.where(better, fo, out_o)
        out_q = torch.where(better, lens_.expand(A, B), out_q)
        out_r = torch.where(better, frow, out_r)
    return torch.stack([out_m, out_c, out_o, out_q, out_v, out_r, nloc,
                        nacc]).to(i32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("locate", "orc_locate",
                       [vp] * 7 + [ci] * 4 + [vp, vp])


def locate_cuda(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                mode: str, A: int) -> torch.Tensor:
    """Launch ``csrc/locate.cu`` on the current stream; same contract
    and output as :func:`locate_plain`. Inputs are checked by
    :func:`locate_tiles`."""
    ref, kbyrs, kfin, kconst, mrow = tables
    L, B = reads_T.shape
    out = torch.empty((8, A, B), dtype=torch.int32, device=reads_T.device)
    if B == 0:
        return out                            # nothing to launch
    with torch.cuda.device(reads_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().orc_locate(
            reads_T.data_ptr(), lens.data_ptr(), ref.data_ptr(),
            kbyrs.data_ptr(), kfin.data_ptr(), kconst.data_ptr(),
            mrow.data_ptr(), ref.shape[1], B, A, MODES[mode],
            out.data_ptr(), stream)
    _build.check(err, f"locate kernel ({mode})")
    LAUNCHES.add(mode)
    return out


def locate_tiles(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                 mode: str, A: int) -> torch.Tensor:
    """Locate every bank adapter in every read; [8, A, B] int32.

    tables = (ref, kbyrs, kfin, kconst, mrow) int32; reads_T [L, B]
    uint8 read match masks; lens [B] int32 with 0 <= lens <= L. A CPU
    tensor goes to :func:`locate_plain`; a CUDA tensor to the kernel."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    ref, kbyrs, kfin, kconst, mrow = tables
    if reads_T.dim() != 2 or reads_T.dtype != torch.uint8:
        raise ValueError("reads_T must be [L, B] uint8")
    L, B = reads_T.shape
    if lens.shape != (B,) or lens.dtype != torch.int32:
        raise ValueError("lens must be [B] int32")
    Ap, R = ref.shape
    if (kbyrs.shape != (Ap, R) or kfin.shape != (Ap, R)
            or kconst.shape != (Ap,) or mrow.shape != (Ap,)):
        raise ValueError("bank tables do not share one [Ap, R] layout")
    if not 0 < A <= Ap or R > MAX_ADAPTER + 1:
        raise ValueError(f"A={A}, Ap={Ap}, R={R} out of range")
    ts = (reads_T, lens, ref, kbyrs, kfin, kconst, mrow)
    if any(t.device != reads_T.device for t in ts):
        raise ValueError("locate inputs lie on more than one device")
    if any(t.dtype != torch.int32 for t in ts[2:]):
        raise ValueError("bank tables must be int32")
    if reads_T.device.type == "cpu":
        return locate_plain(tables, reads_T, lens, mode, A)
    if reads_T.device.type != "cuda":
        raise ValueError(f"no locate kernel for device {reads_T.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("locate kernel inputs must be contiguous")
    return locate_cuda(tables, reads_T, lens, mode, A)


def locate_dispatch(tabs: BankTables, read_masks: np.ndarray,
                    read_lens: np.ndarray, mode: str, device):
    """Phase A of a pipelined locate: upload + launch, NO fetch.

    Returns (lazy [8, A, B] tensor on ``device``, A, B0) for
    locate_collect. On CUDA the launch is asynchronous, so host work on
    chunk k overlaps device compute for chunks k+1..."""
    B0, L = read_masks.shape
    read_lens = np.asarray(read_lens, np.int32)
    if B0 and (read_lens.min() < 0 or read_lens.max() > L):
        raise ValueError("read lengths must lie in [0, L]")
    device = torch.device(device)
    reads_T = torch.from_numpy(
        np.ascontiguousarray(read_masks.T, np.uint8)).to(device)
    lens = torch.from_numpy(np.ascontiguousarray(read_lens)).to(device)
    lazy = locate_tiles(tabs.tensors(device), reads_T, lens, mode, tabs.A)
    return lazy, tabs.A, B0


def locate_collect(lazy, A: int, B0: int) -> LocateResult:
    """Phase B: ONE stacked device->host transfer -> LocateResult."""
    stk = lazy.cpu().numpy()
    tr = lambda x: x[:A, :B0].T
    bo = tr(stk[2])
    return LocateResult(
        valid=tr(stk[4]), matches=tr(stk[0]), errors=tr(stk[1]),
        refstart=np.maximum(-bo, 0), refstop=tr(stk[5]),
        querystart=np.maximum(bo, 0), querystop=tr(stk[3]),
        nloc=tr(stk[6]), nacc=tr(stk[7]))


def locate_masks(bank_masks: np.ndarray, bank_lens: np.ndarray,
                 k_table: np.ndarray, n_prefix: np.ndarray,
                 read_masks: np.ndarray, read_lens: np.ndarray,
                 flags: int, min_overlap: int = DEFAULT_MIN_OVERLAP,
                 device="cpu") -> LocateResult:
    """Host wrapper producing LocateResult fields as numpy arrays
    [B, A] (``locate_pallas``'s contract). FRONT/BACK/INFIX only."""
    mode = _mode_of(flags)
    tabs = BankTables(bank_masks, bank_lens, k_table, n_prefix,
                      mode == "front", min_overlap)
    return locate_collect(*locate_dispatch(tabs, read_masks, read_lens,
                                           mode, device))
