"""pychopper's reorientation of raw reads, in plain PyTorch and NumPy: the
reference that the stage-01 cell is held against.

Written for the benchmark from the pipeline's definition
(``scripts/01_pychopper.sh:45-57``: ``pychopper -b
M13_seqs_for_pychopper.fa -c M13_config_for_pychopper.txt -k LSK114 -Q
10 -m edlib -p -t 24``) and from the program's statement of pychopper's
semantics (the REORIENT SPEC of ``tpu_orc_torch/demux/reorient.py``'s
docstring, rules 1-8), not from the program's code. It imports nothing
of the program.

1. Hits: every primer and its reverse complement (``-NAME``) is aligned
   against the read in edlib's HW mode: the whole primer, the read's
   prefix and suffix free. An N of the primer matches any base; the
   mask character ``X`` of a read matches only an N. A cell of the
   table takes the diagonal where it is no dearer than left and up,
   else left where no dearer than up, else up; matches (an N counts as
   one) and the read position where the alignment started travel with
   the choice.
2. A location is acceptable with at most floor((1 - q) * len(primer))
   edits, the whole primer's length, N included. A primer's best
   location has the most matches, then the fewest edits, then the
   first end column.
3. q, when not given, is tuned on the first kept reads: each cutoff of
   0.95, 0.90, ..., 0.55 classifies the sample on its best locations,
   and the knee of those counts wins: the strictest cutoff that
   classifies at least half the grid's most and at least 95% of what
   the next looser cutoff classifies (the last cutoff is its own next).
   The knee and the grid are the program's own choice, not
   pychopper's, whose tuner is not specified further.
4. A configuration ``+:SP5,-SP27|-:SP27,-SP5`` pairs a 5' primer with a
   3' primer that starts where the 5' one ended or later; a '-'
   segment is written reverse-complemented, its qualities reversed.
5. ``-p``: a segment runs from its 5' primer's first read base to its 3'
   primer's last, primers kept.
6. ``-Q 10``: a read whose mean Phred quality (the arithmetic mean of
   its characters less 33) is below 10 goes to unclass as it came.
7. Routes: no segment, unclass (the read as it came); one, pass; two or
   more, every segment to rescued (a fused read); a segment under
   ``-z`` 50 bp to short instead. A first segment takes the read's id,
   segment k > 0 the id and ``|seg<k>``.
8. Every acceptable location is enumerated for every read that has a
   hit: the read is scanned again with every location found so far
   masked by ``X`` (up to ``max_segments`` scans in all, a read leaving
   when a scan finds nothing); a location is new when it overlaps none
   kept before that scan. The segments are chosen by weighted interval
   scheduling over every configured pair of kept locations: the chain,
   in order of end, that has the most matches, then the fewest edits,
   then the most segments, consecutive segments overlapping by at most
   the edits of the two primers at their junction; of equal chains the
   one whose last segment, then the one before it, comes first in the
   order of (end, start, configuration); at most ``max_segments``
   segments, the first ones kept. The junction tolerance and these tie
   orders are the program's own choices.

This reference has no shortcut: it enumerates every read with a hit,
where the program proves most reads complete by its kernel's
multiplicity outputs and skips their re-scans. The table is computed
one anti-diagonal after another, every (read, primer) pair and row at
once, for several cutoffs in one pass, in blocks of reads of like
length so that any sample fits.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

GRID = tuple(round(0.95 - 0.05 * k, 2) for k in range(9))
FILES = ("pass", "rescued", "unclass", "short")
MASK = "X"
_COMP = str.maketrans("ACGTN", "TGCAN")
#: read codes: A C G T 0-3, X 4, padding 5; primer codes: N 4
_READ = np.full(256, 255, np.uint8)
_READ[np.frombuffer(b"ACGTX", np.uint8)] = np.arange(5, dtype=np.uint8)
_PRIMER = np.full(256, 255, np.uint8)
_PRIMER[np.frombuffer(b"ACGTN", np.uint8)] = np.arange(5, dtype=np.uint8)


def knee(counts: Sequence[int]) -> float:
    """Rule 3's choice among ``GRID`` from the classified counts, one
    a cutoff, strictest first."""
    top = max(counts)
    nxt = list(counts[1:]) + [counts[-1]]
    return next(q for q, c, d in zip(GRID, counts, nxt)
                if 2 * c >= top and c >= 0.95 * d)


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def budget(q: float, length: int) -> int:
    """The edits a primer of ``length`` bases may take at cutoff ``q``."""
    return int(math.floor((1.0 - q) * float(length)))


def parse_config(text: str) -> List[Tuple[str, str, str]]:
    """'+:SP5,-SP27|-:SP27,-SP5' -> [('+', 'SP5', '-SP27'), ...]."""
    out = []
    for part in text.strip().split("|"):
        sign, pair = part.split(":")
        a, b = [x.strip() for x in pair.split(",")]
        out.append((sign.strip(), a, b))
    return out


def with_complements(primers: Sequence[Tuple[str, str]]
                     ) -> List[Tuple[str, str]]:
    """Each primer and, after it, its reverse complement as '-NAME'."""
    out = []
    for name, seq in primers:
        out += [(name, seq.upper()), ("-" + name, revcomp(seq.upper()))]
    return out


def mean_q(quals: Sequence[str]) -> np.ndarray:
    """Mean Phred quality of each quality string (0 for an empty one)."""
    out = np.zeros(len(quals))
    for k, q in enumerate(quals):
        if q:
            out[k] = int(np.frombuffer(q.encode("ascii"),
                                       np.uint8).sum(dtype=np.int64)) \
                / len(q) - 33.0
    return out


def _codes(seqs: Sequence[str], table: np.ndarray, pad: int) -> tuple:
    n = len(seqs)
    L = max([len(s) for s in seqs] + [1])
    out = np.full((n, L), pad, np.uint8)
    lens = np.zeros(n, np.int64)
    for k, s in enumerate(seqs):
        c = table[np.frombuffer(s.encode("ascii"), np.uint8)]
        if (c == 255).any():
            raise ValueError("a character outside the reference's alphabet")
        out[k, :len(c)] = c
        lens[k] = len(c)
    return out, lens


class Best(NamedTuple):
    """[K, R, P] numpy arrays: the best location of every primer in every
    read under each of K cutoffs; ``found`` False where none."""
    found: np.ndarray
    qstart: np.ndarray
    qstop: np.ndarray
    errors: np.ndarray
    matches: np.ndarray


def _scan_block(primers: Sequence[str], reads: Sequence[str],
                budgets: np.ndarray, dev) -> Best:
    pc, pl = _codes(primers, _PRIMER, 4)
    rc, rl = _codes(reads, _READ, 5)
    R, P, M = len(reads), len(primers), pc.shape[1]
    N, K = R * P, budgets.shape[0]
    i32 = torch.int32
    rd = torch.as_tensor(rc, device=dev)                       # [R, L]
    Lmax = rc.shape[1]
    # row i holds primer base i - 1 (row 0: none)
    prow = torch.as_tensor(np.concatenate([pc[:, :1], pc], 1),
                           device=dev).to(i32).repeat(R, 1)   # [N, M+1]
    m = torch.as_tensor(pl, device=dev).repeat(R)             # [N]
    n = torch.as_tensor(rl, device=dev).repeat_interleave(P)  # [N]
    kk = torch.as_tensor(budgets, device=dev, dtype=i32).repeat(1, R)
    rows = torch.arange(M + 1, device=dev)[None, :]           # [1, M+1]
    row0 = rows == 0
    big = 1 << 28
    cost = torch.full((N, M + 1), big, dtype=i32, device=dev)
    zero = torch.zeros((N, M + 1), dtype=i32, device=dev)
    prev2 = prev = (cost, zero, zero)
    bm = torch.full((K, N), -1, dtype=i32, device=dev)
    bc = torch.full((K, N), big, dtype=i32, device=dev)
    bo = torch.zeros((K, N), dtype=i32, device=dev)
    bq = torch.zeros((K, N), dtype=i32, device=dev)
    mcol = m[:, None]

    def down(x):                # row i - 1 of the same anti-diagonal
        return torch.cat([x[:, :1], x[:, :-1]], 1)

    for d in range(M + Lmax + 1):
        j = d - rows                                          # [1, M+1]
        jc = (j - 1).clamp(0, Lmax - 1).expand(R, M + 1)
        base = rd.gather(1, jc).repeat_interleave(P, 0).to(i32)
        eq = ((prow == 4) | (prow == base)).to(i32)
        dc, dm, do = (down(x) for x in prev2)
        uc, um, uo = (down(x) for x in prev)
        lc, lm, lo = prev
        cd, ch, cv = dc + 1 - eq, lc + 1, uc + 1
        take_d = (cd <= ch) & (cd <= cv)
        take_h = ~take_d & (ch <= cv)
        c = torch.where(take_d, cd, torch.where(take_h, ch, cv))
        mt = torch.where(take_d, dm + eq, torch.where(take_h, lm, um))
        og = torch.where(take_d, do, torch.where(take_h, lo, uo))
        jj = j.to(i32).expand(N, M + 1)
        col0 = (j == 0).expand(N, M + 1) & ~row0
        # row 0: the read's prefix is free (cost 0, the start at j);
        # column 0: every primer base deleted
        c = torch.where(row0, 0, torch.where(col0, rows.to(i32), c))
        mt = torch.where(row0 | col0, 0, mt)
        og = torch.where(row0, jj, torch.where(col0, 0, og))
        prev2, prev = prev, (c, mt, og)
        # row m at column d - m: the whole primer, ending there
        col = (d - m).to(i32)
        cm = c.gather(1, mcol)[:, 0]
        mm = mt.gather(1, mcol)[:, 0]
        om = og.gather(1, mcol)[:, 0]
        ok = ((col >= 0) & (col <= n))[None, :] & (cm[None, :] <= kk)
        better = ok & ((mm > bm) | ((mm == bm) & (cm < bc)))
        bm = torch.where(better, mm, bm)
        bc = torch.where(better, cm, bc)
        bo = torch.where(better, om, bo)
        bq = torch.where(better, col, bq)
    sh = lambda x: x.cpu().numpy().reshape(K, R, P)
    return Best(sh(bm) >= 0, np.maximum(sh(bo), 0), sh(bq), sh(bc), sh(bm))


def scan(primers: Sequence[str], reads: Sequence[str], budgets, device="cpu",
         block: int = 4096) -> Best:
    """The best location of every primer in every read under each row of
    ``budgets`` ([K, P] edits), in blocks of ``block`` reads of like
    length."""
    budgets = np.asarray(budgets, np.int64).reshape(-1, len(primers))
    K, R, P = budgets.shape[0], len(reads), len(primers)
    out = Best(np.zeros((K, R, P), bool),
               *(np.zeros((K, R, P), np.int64) for _ in range(4)))
    order = np.argsort([len(s) for s in reads], kind="stable")
    dev = torch.device(device)
    for s in range(0, R, block):
        idx = order[s:s + block]
        got = _scan_block(primers, [reads[k] for k in idx], budgets, dev)
        for field, v in zip(out, got):
            field[:, idx] = v
    return out


def _row_hits(best: Best, k: int, r: int) -> List[tuple]:
    """(primer, start, stop, edits, matches) of read ``r``'s found
    locations under cutoff row ``k``, in primer order."""
    return [(p, int(best.qstart[k, r, p]), int(best.qstop[k, r, p]),
             int(best.errors[k, r, p]), int(best.matches[k, r, p]))
            for p in np.flatnonzero(best.found[k, r])
            if best.qstop[k, r, p] > best.qstart[k, r, p]]


class Pychopper:
    """Stage 01 of the pipeline as the configuration states it."""

    def __init__(self, primers: Sequence[Tuple[str, str]], config_text: str,
                 qmin: float = 10.0, min_len: int = 50, max_segments: int = 4,
                 autotune_sample: int = 500, device="cpu",
                 block: int = 4096):
        both = with_complements(primers)
        self.names = [n for n, _ in both]
        self.seqs = [s for _, s in both]
        idx = {n: k for k, n in enumerate(self.names)}
        self.configs = [(sign, idx[a], idx[b])
                        for sign, a, b in parse_config(config_text)]
        self.qmin, self.min_len = qmin, min_len
        self.max_segments, self.sample = max_segments, autotune_sample
        self.device, self.block = device, block

    def budgets(self, q: float) -> List[int]:
        return [budget(q, len(s)) for s in self.seqs]

    def _classified(self, best: Best, k: int) -> np.ndarray:
        """Reads whose best locations under cutoff row ``k`` pair into a
        configuration."""
        ok = np.zeros(best.found.shape[1], bool)
        for _, a, b in self.configs:
            ok |= (best.found[k, :, a] & best.found[k, :, b]
                   & (best.qstop[k, :, a] <= best.qstart[k, :, b]))
        return ok

    def autotune(self, kept_seqs: Sequence[str]) -> float:
        """Rule 3 on the first ``autotune_sample`` kept reads."""
        sample = list(kept_seqs)[:self.sample]
        if not sample:
            return GRID[len(GRID) // 2]
        best = scan(self.seqs, sample, [self.budgets(q) for q in GRID],
                    self.device, self.block)
        return knee([int(self._classified(best, k).sum())
                     for k in range(len(GRID))])

    def locations(self, seqs: Sequence[str], q: float,
                  max_segments: Optional[int] = None) -> List[List[tuple]]:
        """Rule 8: every acceptable location of every primer in each
        read, found by masked re-scans."""
        rounds = self.max_segments if max_segments is None else max_segments
        k = [self.budgets(q)]
        first = scan(self.seqs, seqs, k, self.device, self.block)
        hits = [_row_hits(first, 0, r) for r in range(len(seqs))]
        active = {r: _masked(seqs[r], hits[r]) for r in range(len(seqs))
                  if hits[r]}
        for _ in range(1, rounds):
            if not active:
                break
            order = sorted(active)
            got = scan(self.seqs, [active[r] for r in order], k,
                       self.device, self.block)
            nxt = {}
            for b, r in enumerate(order):
                found = _row_hits(got, 0, b)
                if not found:
                    continue
                spans = [(h[1], h[2]) for h in hits[r]]
                hits[r] += [h for h in found
                            if not any(h[1] < e and s < h[2]
                                       for s, e in spans)]
                nxt[r] = _masked(active[r], found)
            active = nxt
        return hits

    def schedule(self, hits: Sequence[tuple]) -> List[Tuple[int, int, int]]:
        """Rule 8's weighted interval scheduling: [(configuration, start,
        stop)] of the chosen segments in read order."""
        cands = []
        for ci, (_, a, b) in enumerate(self.configs):
            for h5 in (h for h in hits if h[0] == a):
                for h3 in (h for h in hits if h[0] == b):
                    if h5[2] <= h3[1]:
                        cands.append((h5[1], h3[2], ci, h5, h3))
        if not cands:
            return []
        cands.sort(key=lambda c: (c[1], c[0], c[2]))
        score, prev = [], []
        for i, (s, _, _, h5, h3) in enumerate(cands):
            own = (h5[4] + h3[4], -(h5[3] + h3[3]), 1)
            choice = None
            for j in range(i):
                junction = cands[j][4][3] + h5[3]
                if cands[j][1] - junction <= s and (
                        choice is None or score[j] > score[choice]):
                    choice = j
            score.append(own if choice is None else
                         tuple(x + y for x, y in zip(score[choice], own)))
            prev.append(choice)
        i = max(range(len(cands)), key=score.__getitem__)
        chain = []
        while i is not None:
            chain.append(cands[i])
            i = prev[i]
        chain = chain[::-1][:self.max_segments]
        return [(ci, h5[1], h3[2]) for _, _, ci, h5, h3 in chain]

    def segment(self, rid: str, seq: str, qual: str,
                plan: Sequence[Tuple[int, int, int]]) -> List[tuple]:
        """(file, header, sequence, quality) of each segment of a read
        (rules 4, 5 and 7); a read with none goes to unclass as it
        came."""
        if not plan:
            return [("unclass", rid, seq, qual)]
        seq = seq.upper()
        out = []
        for k, (ci, s0, s1) in enumerate(plan):
            name = rid if k == 0 else f"{rid}|seg{k}"
            s, q = seq[s0:s1], qual[s0:s1]
            if self.configs[ci][0] == "-":
                s, q = revcomp(s), q[::-1]
            if len(s) < self.min_len:
                where = "short"
            else:
                where = "pass" if len(plan) == 1 else "rescued"
            out.append((where, name, s, q))
        return out

    def run(self, reads: Sequence[Tuple[str, str, str]], q: float,
            max_segments: Optional[int] = None) -> List[List[tuple]]:
        """The records each read (id, sequence, quality) comes out as, at
        cutoff ``q``: [(file, header, sequence, quality)]."""
        low = mean_q([r[2] for r in reads]) < self.qmin
        out: List[List[tuple]] = [[] for _ in reads]
        todo = [k for k in range(len(reads)) if not low[k]]
        for k in range(len(reads)):
            if low[k]:
                out[k] = [("unclass",) + tuple(reads[k])]
        hits = self.locations([reads[k][1].upper() for k in todo], q,
                              max_segments)
        for k, h in zip(todo, hits):
            rid, seq, qual = reads[k]
            out[k] = self.segment(rid, seq, qual, self.schedule(h))
        return out


def _masked(seq: str, hits: Sequence[tuple]) -> str:
    s = list(seq)
    for _, a, b, _, _ in hits:
        s[a:b] = MASK * (b - a)
    return "".join(s)


def route(records: Sequence[tuple]) -> Tuple[str, ...]:
    """The files a read's records landed in, in :data:`FILES` order."""
    got = {r[0] for r in records}
    return tuple(f for f in FILES if f in got)
