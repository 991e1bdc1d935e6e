"""Star-alignment majority consensus (amplicon_sorter-equivalent).

Behavioral port of the reference consensus builder
(amplicon_sorter.py:324-441: ``create_alignment`` + ``homopolymersort`` +
``create_consensus``), re-implemented on top of the native banded NW
traceback (tpu_orc/native) instead of edlib, with deterministic inputs.
Peculiarities of the original are reproduced deliberately where they affect
output (documented inline): vote counts include the draft-consensus row;
the homopolymer decay correction uses Python negative-index wraparound at
the first column; `b` run-length bookkeeping is only updated on appended
bases.

The reference's IUPAC additionalEqualities only matter when ambiguity
calling is enabled (off by default) — consensus drafts here are plain
ACGT/N, so literal code comparison is equivalent.

Copy of ``tpu_orc/cluster/consensus.py``; the device seam: the consensus
builders and ``pileup_counts``/``pileup_counts_multi`` take a torch
``device``, and the ``device`` backend's forward pass runs
``align/pileup.py`` on it (CUDA: the path-bits kernel of
``csrc/pileup.cu``; CPU: its plain version) where ``tpu_orc`` ran its
Pallas kernels through JAX. The traceback and the accumulation stay in
the native C++ (``native.pileup_from_bits``). The native and python
backends are unchanged, and ``ORC_PILEUP_BACKEND`` still selects the
backend, ``native`` by default.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..io import encode

GAP = 255  # gap marker in alignment matrices

# 'native' = fused threaded C++ pileup; 'python' = original _align_rows
# reference path (kept for parity tests and debugging).
PILEUP_BACKEND = os.environ.get("ORC_PILEUP_BACKEND", "native")


def _decode_ops(ops: np.ndarray, q: np.ndarray):
    """Vectorized decode of an NW op string (0=diag, 1=ins, 2=del) into
    (match_t_pos, match_vals, ins_t_pos, ins_vals, ins_rank) where
    positions are ORIGINAL consensus coordinates and ins_rank is the
    occurrence index within each same-position insertion run."""
    ops = np.asarray(ops, dtype=np.int8)
    consumes_t = ops != 1
    consumes_q = ops != 2
    t_pos = np.cumsum(consumes_t) - consumes_t   # ti before this op
    q_pos = np.cumsum(consumes_q) - consumes_q
    diag = ops == 0
    ins = ops == 1
    m_t = t_pos[diag]
    m_v = q[q_pos[diag]]
    i_t = t_pos[ins]
    i_v = q[q_pos[ins]]
    if len(i_t):
        # same-position inserts are consecutive in op order
        starts = np.r_[0, np.nonzero(np.diff(i_t))[0] + 1]
        run_id = np.zeros(len(i_t), dtype=np.int64)
        run_id[starts[1:]] = 1
        run_id = np.cumsum(run_id)
        rank = np.arange(len(i_t)) - starts[run_id]
    else:
        rank = np.zeros(0, dtype=np.int64)
    return m_t, m_v, i_t, i_v, rank


def _align_rows(consensus_codes: np.ndarray,
                reads: Sequence[np.ndarray]) -> np.ndarray:
    """Star alignment of reads against the consensus draft.

    Deviation from the reference's create_alignment (documented): the
    reference aligns each read against the *progressively gapped* draft and
    gives every insertion event its own column; we align every read against
    the original draft coordinates and merge insertions at the same
    position into shared columns (counts then reflect insertion support).
    This preserves strictly more signal for the majority vote; the output
    contract is consensus *equivalence* (SURVEY.md §7.4.3), not
    column-structure parity. Returns int16 matrix [n_reads+1, width],
    GAP=255, row 0 = draft."""
    t = np.asarray(consensus_codes, dtype=np.int16)
    n_t = len(t)
    decoded = []
    ins_count = np.zeros(n_t + 1, dtype=np.int64)
    all_ops = native.nw_path_batch(
        [np.asarray(q, dtype=np.uint8) for q in reads],
        np.asarray(consensus_codes, dtype=np.uint8))
    for q_arr, ops in zip(reads, all_ops):
        q = np.asarray(q_arr, dtype=np.int16)
        m_t, m_v, i_t, i_v, rank = _decode_ops(ops, q)
        decoded.append((m_t, m_v, i_t, i_v, rank))
        if len(i_t):
            per = np.bincount(i_t, minlength=n_t + 1)
            np.maximum(ins_count, per, out=ins_count)
    # column layout: [ins slots before pos 0][pos 0][ins before 1][pos 1]...
    col_of_t = np.cumsum(ins_count[:n_t]) + np.arange(n_t)
    width = int(ins_count.sum()) + n_t
    ins_base = np.empty(n_t + 1, dtype=np.int64)  # first ins col before p
    ins_base[:n_t] = col_of_t - ins_count[:n_t]
    ins_base[n_t] = width - ins_count[n_t]
    out = np.full((len(reads) + 1, width), GAP, dtype=np.int16)
    out[0, col_of_t] = t
    for ri, (m_t, m_v, i_t, i_v, rank) in enumerate(decoded, start=1):
        out[ri, col_of_t[m_t]] = m_v
        if len(i_t):
            # right-align inserted bases against the consensus position
            out[ri, ins_base[i_t] + ins_count[i_t] - 1 - rank] = i_v
    return out


def column_counts(aln: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column (top1, top2) base/count pairs, gaps excluded.

    Returns (bases [W, 2] int16 with -1 = none, counts [W, 2] int64).
    Ties between bases break toward the smaller code (A<C<G<T<N), matching
    a count-sort that is stable on first-seen order only approximately —
    the reference's dict ordering is insertion (read) order; documented
    deviation with no effect above the 10%/threshold cuts in practice.
    """
    W = aln.shape[1]
    counts = np.zeros((W, 5), dtype=np.int64)
    for sym in range(5):
        counts[:, sym] = (aln == sym).sum(axis=0)
    return top2_from_counts(counts)


def top2_from_counts(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(top1, top2) base/count pairs from a [W, 5] counts matrix (same
    tie-break as column_counts)."""
    order = np.argsort(-counts, axis=1, kind="stable")
    top_bases = order[:, :2].astype(np.int16)
    top_counts = np.take_along_axis(counts, order[:, :2], axis=1)
    top_bases[top_counts == 0] = -1
    return top_bases, top_counts


def pileup_counts(consensus_codes: np.ndarray,
                  reads: Sequence[np.ndarray],
                  backend: str = "native", device="cuda") -> np.ndarray:
    """Per-column base counts [W, 5] of the star alignment of ``reads``
    against the draft (draft row included). backend='native' runs the
    fused threaded C++ pileup (one crossing per group); 'device' runs
    the DP forward pass on the torch ``device`` (align/pileup.py
    path-bits kernel on CUDA, its plain version on the CPU) with only
    the O(m+n) traceback + accumulation on host; 'python' keeps the
    original _align_rows path. All three are parity-tested."""
    if backend == "device" and len(reads) > 0:
        from ..align.pileup import path_bits
        planes = path_bits(np.asarray(consensus_codes, dtype=np.uint8),
                           [np.ascontiguousarray(q, dtype=np.uint8)
                            for q in reads], device)
        return native.pileup_from_bits(
            planes, [np.ascontiguousarray(q, dtype=np.uint8)
                     for q in reads],
            np.asarray(consensus_codes, dtype=np.uint8)).astype(np.int64)
    if backend in ("native", "device"):
        return native.pileup_batch(
            [np.ascontiguousarray(q, dtype=np.uint8) for q in reads],
            np.asarray(consensus_codes, dtype=np.uint8)).astype(np.int64)
    aln = _align_rows(np.asarray(consensus_codes), list(reads))
    W = aln.shape[1]
    counts = np.zeros((W, 5), dtype=np.int64)
    for sym in range(5):
        counts[:, sym] = (aln == sym).sum(axis=0)
    return counts


def _homopolymersort(entries: List[Tuple[int, int, int, int]]):
    """Reference homopolymersort (:244-257): within runs of consecutive
    columns sharing the same top base, sort entries by top count desc."""
    if not entries:
        return entries
    out: List = []
    run = [entries[0]]
    for e in entries[1:]:
        if e[0] == run[0][0]:
            run.append(e)
        else:
            run.sort(key=lambda x: x[1], reverse=True)
            out.extend(run)
            run = [e]
    out.extend(run)
    return out


_IUPAC_PAIR = {frozenset((1, 3)): "Y", frozenset((0, 2)): "R",
               frozenset((0, 1)): "M", frozenset((2, 3)): "K",
               frozenset((2, 1)): "S", frozenset((0, 3)): "W"}


def build_consensus_iupac(read_codes: Sequence[np.ndarray],
                          thresholds=(0.45, 0.15, 0.5),
                          device="cuda") -> str:
    """Ambiguity-calling variant (reference -amb option,
    degenerate/ambiguity at :259-322): columns whose top base holds 35-65%
    support and whose top-2 together hold 75-120% emit the IUPAC code of
    the pair. Returns an ASCII string (may contain IUPAC letters)."""
    codes, amb = _build_consensus_impl(read_codes, thresholds,
                                       want_ambiguity=True, device=device)
    out = []
    for base, code2, is_amb in amb:
        if is_amb:
            out.append(_IUPAC_PAIR.get(frozenset((base, code2)),
                                       encode.decode(
                                           np.array([base], np.uint8))))
        else:
            out.append(encode.decode(np.array([base], np.uint8)))
    return "".join(out)


def build_consensus(read_codes: Sequence[np.ndarray],
                    thresholds=(0.45, 0.15, 0.5),
                    device="cuda") -> np.ndarray:
    """Reference create_consensus (:358-441): iterative column-majority with
    homopolymer handling. Input: list of code arrays. Output: codes."""
    return _build_consensus_impl(read_codes, thresholds,
                                 want_ambiguity=False, device=device)[0]


def _entries_from_counts(counts: np.ndarray, c: int, thr: float):
    """One consensus pass from pileup counts: top-2 extraction, 10%
    support keep, homopolymersort, threshold cut. Returns
    (entries, new consensus codes).

    Vectorized: homopolymersort = stable lexsort by (run id, count
    desc) — identical to the per-run Python sort (_homopolymersort,
    kept as the test reference); the per-column tuple list was ~45 ms
    of each 80-read bin's sort (24 consensus builds x 3 passes)."""
    tb, tc = top2_from_counts(counts)
    keep = (tb[:, 0] >= 0) & (tc[:, 0] > c * 0.10)
    b0 = tb[keep, 0]
    c0 = tc[keep, 0]
    b1 = tb[keep, 1]
    c1 = tc[keep, 1]
    if len(b0):
        runs = np.zeros(len(b0), np.int64)
        np.cumsum(b0[1:] != b0[:-1], out=runs[1:])
        # the reference flushes (sorts) a run only when the base
        # CHANGES — the trailing run is emitted unsorted; replicate by
        # zeroing its sort key (stable lexsort keeps input order)
        key = np.where(runs != runs[-1], -c0, 0)
        order = np.lexsort((key, runs))
        b0, c0, b1, c1 = b0[order], c0[order], b1[order], c1[order]
    consensus = b0[c0 > c * thr].astype(np.uint8)
    entries = list(zip(b0.tolist(), c0.tolist(),
                       b1.tolist(), c1.tolist()))
    return entries, consensus


def pileup_counts_multi(drafts: Sequence[np.ndarray],
                        reads_groups: Sequence[Sequence[np.ndarray]],
                        backend: str = "native",
                        device="cuda") -> List[np.ndarray]:
    """Per-group pileup counts; with backend='device' ALL groups run in
    ONE kernel launch on ``device`` (align/pileup.py path_bits_groups),
    paying one launch and one copy of the planes to the host per ladder
    pass instead of one per group.
    Other backends (and zero-read groups) route through pileup_counts
    per group. Output parity with per-group calls is tested."""
    G = len(drafts)
    out: List[Optional[np.ndarray]] = [None] * G
    live = [g for g in range(G) if len(reads_groups[g]) > 0]
    if backend == "device" and len(live) > 1:
        from ..align.pileup import path_bits_groups
        dl = [np.asarray(drafts[g], np.uint8) for g in live]
        rl = [[np.ascontiguousarray(q, np.uint8) for q in reads_groups[g]]
              for g in live]
        planes_l = path_bits_groups(dl, rl, device)
        for g, planes, d, rs in zip(live, planes_l, dl, rl):
            out[g] = native.pileup_from_bits(planes, rs, d).astype(
                np.int64)
    for g in range(G):
        if out[g] is None:
            out[g] = pileup_counts(np.asarray(drafts[g], np.uint8),
                                   reads_groups[g], backend=backend,
                                   device=device)
    return out  # type: ignore[return-value]


def build_consensus_multi(groups_codes: Sequence[Sequence[np.ndarray]],
                          thresholds=(0.45, 0.15, 0.5), device="cuda"
                          ) -> List[np.ndarray]:
    """build_consensus for MANY groups with each of the three passes
    batched into one device dispatch (pileup_counts_multi). Per-group
    results are identical to build_consensus (parity-tested); the
    per-pass batching is valid because groups are independent — only
    passes are sequential."""
    G = len(groups_codes)
    rls = [sorted(g, key=len, reverse=True) for g in groups_codes]
    cons = [np.asarray(rl[0], np.uint8) if rl else
            np.zeros(0, np.uint8) for rl in rls]
    entries_g: List[List[Tuple[int, int, int, int]]] = [
        [] for _ in range(G)]
    live = [g for g in range(G) if rls[g]]
    for pi, thr in enumerate(thresholds):
        reads_g = {g: (rls[g][1:] if pi == 0 else rls[g]) for g in live}
        for g in live:
            if len(cons[g]) == 0:
                cons[g] = np.asarray(rls[g][0], np.uint8)
        counts_l = pileup_counts_multi([cons[g] for g in live],
                                       [reads_g[g] for g in live],
                                       backend=PILEUP_BACKEND,
                                       device=device)
        for g, counts in zip(live, counts_l):
            entries_g[g], cons[g] = _entries_from_counts(
                counts, len(reads_g[g]) + 1, thr)
    return [_decay_tail(entries_g[g], len(rls[g]) + 1, thresholds[-1],
                        False)[0] if rls[g] else np.zeros(0, np.uint8)
            for g in range(G)]


def _build_consensus_impl(read_codes: Sequence[np.ndarray],
                          thresholds=(0.45, 0.15, 0.5),
                          want_ambiguity: bool = False, device="cuda"):
    if not read_codes:
        return np.zeros(0, dtype=np.uint8), []
    rl = sorted(read_codes, key=len, reverse=True)
    consensus = np.asarray(rl[0], dtype=np.uint8)
    first_pass_reads = rl[1:]
    entries: List[Tuple[int, int, int, int]] = []
    for pi, thr in enumerate(thresholds):
        reads = first_pass_reads if pi == 0 else rl
        if len(consensus) == 0:
            consensus = np.asarray(rl[0], dtype=np.uint8)
        counts = pileup_counts(consensus, reads, backend=PILEUP_BACKEND,
                               device=device)
        c = len(reads) + 1  # rows incl. draft (reference counts it too)
        entries, consensus = _entries_from_counts(counts, c, thr)
    return _decay_tail(entries, len(rl) + 1, thresholds[-1],
                       want_ambiguity)


def _decay_tail(entries, c: int, thr: float, want_ambiguity: bool):
    """Final homopolymer decay correction (:398-427) over the last
    pass's entries; threshold = last (0.5)."""
    out: List[int] = []
    amb: List[tuple] = []  # (base, top2_base, is_ambiguous) per kept column
    b = 1

    def emit(e):
        base, cnt, base2, cnt2 = e
        is_amb = (want_ambiguity and base2 >= 0 and base < 4 and base2 < 4
                  and c * 0.35 <= cnt <= c * 0.65
                  and c * 0.75 < cnt + cnt2 < c * 1.2)
        out.append(base)
        amb.append((base, base2, is_amb))

    for n, e in enumerate(entries):
        prev = entries[n - 1]  # n==0 wraps to last entry, as in the original
        base, cnt = e[0], e[1]
        if base == prev[0]:
            if base in (0, 3):  # A or T
                if b >= 4:
                    if cnt > c * 0.2:
                        emit(e); b += 1
                else:
                    if cnt > c * thr:
                        emit(e); b += 1
            elif base in (1, 2):  # C or G
                if b >= 3:
                    if prev[1] * 0.5 < cnt and cnt > c * 0.2:
                        emit(e); b += 1
                else:
                    if cnt > c * thr:
                        emit(e); b += 1
            else:  # N runs: treat as plain threshold
                if cnt > c * thr:
                    emit(e)
        else:
            if cnt > c * thr:
                emit(e); b = 1
    return np.asarray(out, dtype=np.uint8), amb


def consensus_direction(code_list: List[np.ndarray]) -> List[np.ndarray]:
    """Orient all sequences to the first by fwd-vs-revcomp NW similarity
    (amplicon_sorter.py:1826-1838). One batched native call per group."""
    if not code_list:
        return code_list
    first = np.asarray(code_list[0], dtype=np.uint8)
    rest = [np.asarray(c, dtype=np.uint8) for c in code_list[1:]]
    d_f, d_r = native.orient_batch(first, rest)
    out: List[np.ndarray] = [code_list[0]]
    for c, df, dr in zip(rest, d_f, d_r):
        # same-longer denominator for both -> compare distances directly;
        # ties keep forward (>= in the reference's similarity compare)
        out.append(c if df <= dr else encode.revcomp_codes(c))
    return out
