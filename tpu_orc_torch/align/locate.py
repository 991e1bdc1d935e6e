"""Cutadapt-equivalent locate over [reads x adapters]: two CUDA kernels and
their plain PyTorch versions.

Port of ``tpu_orc/align/pallas_locate.py``: ``BankTables`` (:461),
``tables_for_bank`` (:523), ``_mode_of`` (:545), ``LOCATE_IMPL`` (:388),
``locate_dispatch`` (:555; and ``locate_dispatch_T``, its sibling for a
batch packed on its device), ``locate_collect`` (:589) and
``locate_pallas`` (:602, here ``locate_masks``). ``locate_tiles`` takes
the place of the Pallas launch (:394); ``impl`` (default
:data:`LOCATE_IMPL`, from ``TPU_ORC_LOCATE_IMPL``) picks the kernel it
replaces, and the device of its tensors picks the version:

* 'wf', Pallas ``_kernel_wf`` (:205): a CPU tensor goes to
  :func:`locate_plain`, the anti-diagonal wavefront as torch ops over
  [A, R, B] planes; a CUDA tensor to :func:`locate_cuda`, the
  hand-written kernel in ``csrc/locate.cu`` (the same wavefront, one warp
  per (read, adapter) with the rows over the lanes);
* 'ks', Pallas ``_kernel`` (:55): a CPU tensor goes to
  :func:`locate_plain_ks`, the per-column Kogge-Stone scan as torch ops;
  a CUDA tensor to :func:`locate_cuda_ks`, the KS instances of the same
  ``csrc/locate.cu`` template (the wavefront schedule with ``_kernel``'s
  contract, two alignments a warp). The kernel is so held against a
  different algorithm than its own.

A CUDA tensor always reaches a kernel, or the wrapper raises. The two
contracts differ in one place: BACK with ``min_overlap`` 0 on an empty
read (:func:`locate_plain_ks`). Both take reads of fewer than
:data:`MAX_COLUMNS` columns, as ``tpu_orc``'s ``locate_tiles`` does.

Supported modes are FRONT, BACK and INFIX (the demux, primer-clean and
reorient paths). Other flag sets belong to the XLA ``batched_locate``,
whose port is ``align/batched.py`` (the ``orc_locate_flags`` kernel of
``csrc/batched.cu``); here they raise ``NotImplementedError``, and
``demux/demux.py`` routes them there. Adapters may be up to
``MAX_ADAPTER`` bp (the Pallas tables stop at 62 bp).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .spec import Flag, FRONT, BACK, DEFAULT_MIN_OVERLAP

from .. import _build
from ..utils.profiling import count
from .tables import LocateResult

INFIX = Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2

BIG = 1 << 28
MAX_ADAPTER = 127          # DP rows R <= 128 in both kernels
#: reads must have fewer columns than this, in both implementations:
#: ``tpu_orc``'s ``locate_tiles`` refuses longer ones for both of its
#: kernels (``pallas_locate.py:411-413``, where ``_kernel``'s payload
#: packs origin into 20 bits). The port's kernels keep origin in a word
#: of its own and keep the limit only to keep the contract.
MAX_COLUMNS = (1 << 20) - 64
MODES = {"front": 0, "back": 1, "infix": 2}
#: (kernel source, C entry point) of each implementation
SOURCES = {"wf": ("locate", "orc_locate"), "ks": ("locate", "orc_locate_ks")}
#: lanes an alignment of the KS kernel's two designs (G in
#: ``csrc/locate.cu``): ``locate_cuda_ks(lanes=)`` forces one, for the
#: card's tests and ``chip_smoke.py``, which time both
KS_LANES = (16, 32)

#: locate implementation: 'wf' (the anti-diagonal wavefront of
#: ``_kernel_wf``, default) or 'ks' (the per-column Kogge-Stone scan of
#: ``_kernel``), from ``TPU_ORC_LOCATE_IMPL`` as in ``pallas_locate.py``
#: :387-388; read at each call, so tests may set the attribute
LOCATE_IMPL = os.environ.get("TPU_ORC_LOCATE_IMPL", "wf")

#: kernel launches per mode: 'front'/'back'/'infix' of orc_locate,
#: 'ks_front'/'ks_back'/'ks_infix' of orc_locate_ks (both of csrc/locate.cu)
LAUNCHES = _build.LaunchCounter(tuple(MODES)
                                + tuple(f"ks_{m}" for m in MODES))


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
        "locate supports FRONT/BACK/INFIX only; other flag sets go to "
        "align/batched.py (the XLA batched_locate's port)")


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


def locate_plain_ks(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                    mode: str, A: int) -> torch.Tensor:
    """``_kernel``'s per-column Kogge-Stone recurrence as torch ops.

    Same arguments and [8, A, B] output as :func:`locate_plain`. Column
    j of all R rows is one [A, R, B] plane: the diagonal and horizontal
    candidates, the row-0 reset, then the vertical chain as an inclusive
    (min,+) scan along rows in log2(R) steps on the key
    ``((cand - row + R) << log2(R)) | (R - 1 - row)``, whose low field
    makes ties go to the larger row (the sequential DP keeps a local
    candidate over an equal-cost vertical one). The key names the row a
    cell's value came from, so matches and origin are gathered from that
    row after the scan instead of travelling with it. Acceptance is
    gated on j <= len, so the columns stop at the longest read. BACK's
    final-column snapshot starts as column 0, row 0 included (``_kernel``
    :74-76): for an empty read with ``min_overlap`` 0 that row is a
    candidate, where the wavefront of :func:`locate_plain` never
    evaluates it.
    """
    ref, kbyrs, kfin, kconst, mrow = tables
    dev = reads_T.device
    i32 = torch.int32
    L, B = reads_T.shape
    R = ref.shape[1]
    sh = R.bit_length() - 1                 # log2(R): R is 64 or 128
    front = mode == "front"
    back = mode == "back"
    shape = (A, R, B)
    rows = torch.arange(R, device=dev, dtype=i32).view(1, R, 1)
    # key = (cand << sh) + kbase = ((cand - row + R) << sh) | (R - 1 - row)
    kbase = ((R - rows) << sh) | ((R - 1) - rows)
    refm = ref[:A, 1:].to(i32).view(A, R - 1, 1)
    mlen = mrow[:A].to(torch.int64)
    lens_ = lens.to(i32).view(1, B)
    # column j = 0: FRONT skips an adapter prefix for free (origin -i),
    # BACK/INFIX pay one deletion per adapter character
    zero = torch.zeros(shape, dtype=i32, device=dev)
    if front:
        cost, org = zero, (-rows).expand(shape)
    else:
        cost, org = rows.expand(shape), zero
    mat = zero
    if back:
        sc, sm, so = cost, mat, org
    at_m = mlen.view(A, 1, 1).expand(A, 1, B)
    kb = kbyrs[:A].to(torch.int64)
    kc = kconst[:A].to(i32).view(A, 1)
    z1 = torch.zeros((A, 1, B), dtype=i32, device=dev)

    def row_m(j):
        cm = cost.gather(1, at_m).squeeze(1)
        mm = mat.gather(1, at_m).squeeze(1)
        om = org.gather(1, at_m).squeeze(1)
        if front:   # threshold keyed on the candidate's refstart
            rs = torch.clamp(-om, 0, R - 1).to(torch.int64)
            kmax = kb.gather(1, rs).to(i32)
        else:
            kmax = kc
        return (cm <= kmax) & (j <= lens_), mm, cm, om

    ok, mm, cm, om = row_m(0)
    out_v = ok.to(i32)
    out_m = torch.where(ok, mm, -1)
    out_c = torch.where(ok, cm, BIG)
    out_o = torch.where(ok, om, 0)
    out_q = torch.zeros((A, B), dtype=i32, device=dev)
    out_r = mlen.to(i32).view(A, 1).expand(A, B).clone()
    pok = ok.to(i32)
    nloc, nacc = pok, pok
    for j in range(1, min(L, int(lens.max())) + 1 if B else 1):
        # rows 1..R-1: diagonal (row i-1 of column j-1, +1 on a
        # mismatch) against horizontal (row i of column j-1, +1); the
        # diagonal wins ties
        eq = ((refm & reads_T[j - 1].to(i32).view(1, 1, B)) != 0).to(i32)
        dc = cost[:, :-1] + 1 - eq
        hc = cost[:, 1:] + 1
        use_h = hc < dc
        # row 0: START_WITHIN_SEQ2 reset (cost 0, matches 0, origin j)
        cc = torch.cat([z1, torch.minimum(hc, dc)], 1)
        cm_ = torch.cat([z1, torch.where(use_h, mat[:, 1:],
                                         mat[:, :-1] + eq)], 1)
        co = torch.cat([z1 + j, torch.where(use_h, org[:, 1:],
                                            org[:, :-1])], 1)
        key = (cc << sh) + kbase
        d = 1
        while d < R:
            key = torch.cat([key[:, :d],
                             torch.minimum(key[:, d:], key[:, :-d])], 1)
            d *= 2
        src = ((R - 1) - (key & (R - 1))).to(torch.int64)
        cost = (key >> sh) - R + rows
        mat, org = cm_.gather(1, src), co.gather(1, src)
        ok, mm, cm, om = row_m(j)
        better = ok & ((mm > out_m) | ((mm == out_m) & (cm < out_c)))
        out_v = torch.where(better, 1, out_v)
        out_m = torch.where(better, mm, out_m)
        out_c = torch.where(better, cm, out_c)
        out_o = torch.where(better, om, out_o)
        out_q = torch.where(better, j, out_q)
        oki = ok.to(i32)
        nloc = nloc + oki * (1 - pok)
        nacc = nacc + oki
        pok = oki
        if back:
            at_end = (lens_ == j).view(1, 1, B)
            sc = torch.where(at_end, cost, sc)
            sm = torch.where(at_end, mat, sm)
            so = torch.where(at_end, org, so)

    if back:
        # STOP_WITHIN_SEQ1: every row of the snapshot column is a
        # candidate; max matches, then min cost, then min row
        okf = sc <= kfin[:A].to(i32).view(A, R, 1)
        key = torch.where(okf, ((R - sm) << 16)
                          + (torch.clamp(sc, max=255) << 8) + rows, BIG)
        kbest = key.min(dim=1).values
        fm = R - (kbest >> 16)
        fc = (kbest >> 8) & 255
        frow = kbest & 255
        fo = so.gather(1, torch.clamp(frow, 0, R - 1).to(torch.int64)
                       .unsqueeze(1)).squeeze(1)
        better = (kbest < BIG) & ((fm > out_m)
                                  | ((fm == out_m) & (fc < out_c)))
        out_v = torch.where(better, 1, out_v)
        out_m = torch.where(better, fm, out_m)
        out_c = torch.where(better, fc, out_c)
        out_o = torch.where(better, fo, out_o)
        out_q = torch.where(better, lens_.expand(A, B), out_q)
        out_r = torch.where(better, frow, out_r)
    return torch.stack([out_m, out_c, out_o, out_q, out_v, out_r, nloc,
                        nacc]).to(i32)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib(impl: str, lanes: int | None = None):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    name, symbol = SOURCES[impl]
    n_int = 4
    if lanes is not None:                     # the KS entry with a G
        symbol, n_int = "orc_locate_ks_lanes", 5
    return getattr(_build.load(name, symbol,
                               [vp] * 7 + [ci] * n_int + [vp, vp]), symbol)


def _launch(impl: str, tables, reads_T: torch.Tensor, lens: torch.Tensor,
            mode: str, A: int, lanes: int | None = None) -> torch.Tensor:
    ref, kbyrs, kfin, kconst, mrow = tables
    L, B = reads_T.shape
    out = torch.empty((8, A, B), dtype=torch.int32, device=reads_T.device)
    if B == 0:
        return out                            # nothing to launch
    extra = () if lanes is None else (lanes,)
    with torch.cuda.device(reads_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(impl, lanes)(
            reads_T.data_ptr(), lens.data_ptr(), ref.data_ptr(),
            kbyrs.data_ptr(), kfin.data_ptr(), kconst.data_ptr(),
            mrow.data_ptr(), ref.shape[1], B, A, MODES[mode], *extra,
            out.data_ptr(), stream)
    _build.check(err, f"locate {impl} kernel ({mode})")
    LAUNCHES.add(mode if impl == "wf" else f"ks_{mode}", reads_T.device)
    R = ref.shape[1]
    count(f"locate.launches/{impl}/{mode}/L{L}/A{A}/R{R}")
    count("locate.cells_launched", B * L * A * R)
    return out


def locate_cuda(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                mode: str, A: int) -> torch.Tensor:
    """Launch ``orc_locate`` of ``csrc/locate.cu`` on the current stream;
    same contract and output as :func:`locate_plain`. Inputs are checked
    by :func:`locate_tiles`."""
    return _launch("wf", tables, reads_T, lens, mode, A)


def locate_cuda_ks(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                   mode: str, A: int, lanes: int | None = None
                   ) -> torch.Tensor:
    """Launch ``orc_locate_ks`` of ``csrc/locate.cu`` on the current
    stream; same contract and output as :func:`locate_plain_ks`. Inputs
    are checked by :func:`locate_tiles`. ``lanes`` (one of
    :data:`KS_LANES`) forces the design of that many lanes an alignment;
    None runs the one ``orc_locate_ks`` keeps."""
    if lanes is not None and lanes not in KS_LANES:
        raise ValueError(f"lanes {lanes} not in {KS_LANES}")
    return _launch("ks", tables, reads_T, lens, mode, A, lanes)


#: (plain version, kernel) of each implementation
IMPLS = {"wf": (locate_plain, locate_cuda),
         "ks": (locate_plain_ks, locate_cuda_ks)}


def locate_tiles(tables, reads_T: torch.Tensor, lens: torch.Tensor,
                 mode: str, A: int, impl: str | None = None) -> torch.Tensor:
    """Locate every bank adapter in every read; [8, A, B] int32.

    tables = (ref, kbyrs, kfin, kconst, mrow) int32; reads_T [L, B]
    uint8 read match masks; lens [B] int32 with 0 <= lens <= L. impl:
    'wf' | 'ks' (None: :data:`LOCATE_IMPL`). A CPU tensor goes to the
    implementation's plain version; a CUDA tensor to its kernel."""
    impl = LOCATE_IMPL if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"locate impl {impl!r} not in {tuple(IMPLS)}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    ref, kbyrs, kfin, kconst, mrow = tables
    if reads_T.dim() != 2 or reads_T.dtype != torch.uint8:
        raise ValueError("reads_T must be [L, B] uint8")
    L, B = reads_T.shape
    if L >= MAX_COLUMNS:
        raise ValueError(f"reads of {L} columns: the locate takes fewer "
                         f"than {MAX_COLUMNS}")
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
    plain, kernel = IMPLS[impl]
    if reads_T.device.type == "cpu":
        return plain(tables, reads_T, lens, mode, A)
    if reads_T.device.type != "cuda":
        raise ValueError(f"no locate kernel for device {reads_T.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("locate kernel inputs must be contiguous")
    if R not in (64, 128):
        raise ValueError(f"the locate kernels take R 64 or 128 rows, not {R}")
    return kernel(tables, reads_T, lens, mode, A)


def check_read_lens(read_lens, L: int) -> np.ndarray:
    """``read_lens`` as int32, or ValueError where one lies outside
    [0, L]: checked on the host, before the lengths are uploaded."""
    read_lens = np.ascontiguousarray(read_lens, np.int32)
    if read_lens.size and (read_lens.min() < 0 or read_lens.max() > L):
        raise ValueError("read lengths must lie in [0, L]")
    return read_lens


def locate_dispatch(tabs: BankTables, read_masks: np.ndarray,
                    read_lens: np.ndarray, mode: str, device):
    """Phase A of a pipelined locate: upload + launch, NO fetch.

    Returns (lazy [8, A, B] tensor on ``device``, A, B0) for
    locate_collect. On CUDA the launch is asynchronous, so host work on
    chunk k overlaps device compute for chunks k+1..."""
    read_lens = check_read_lens(read_lens, read_masks.shape[1])
    device = torch.device(device)
    reads_T = torch.from_numpy(
        np.ascontiguousarray(read_masks.T, np.uint8)).to(device)
    return locate_dispatch_T(tabs, reads_T,
                             torch.from_numpy(read_lens).to(device), mode)


def locate_dispatch_T(tabs: BankTables, reads_T: torch.Tensor,
                      lens: torch.Tensor, mode: str):
    """:func:`locate_dispatch` for a batch already on its device:
    reads_T [L, B] uint8 read masks and lens [B] int32 there, as
    ``align/pack.py::pack_reads_T`` gives them, its lengths checked
    against [0, L] on the host before their upload. Same return."""
    lazy = locate_tiles(tabs.tensors(reads_T.device), reads_T, lens, mode,
                        tabs.A)
    return lazy, tabs.A, reads_T.shape[1]


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
                 device="cuda") -> LocateResult:
    """Host wrapper producing LocateResult fields as numpy arrays
    [B, A] (``locate_pallas``'s contract). FRONT/BACK/INFIX only."""
    mode = _mode_of(flags)
    tabs = BankTables(bank_masks, bank_lens, k_table, n_prefix,
                      mode == "front", min_overlap)
    return locate_collect(*locate_dispatch(tabs, read_masks, read_lens,
                                           mode, device))
