"""cutadapt's ``locate`` and the pipeline's dual-round demux decision, in
plain PyTorch: the reference that the demux cells are held against.

Written for the benchmark from the pipeline's definition (cutadapt 4.9's
semi-global aligner as ``scripts/02_cutadapt_loop.sh`` runs it: ``-g``
then ``-a``, ``-e 0.1``, ``--rc``, minimum overlap 3), not from the
program's code. It imports nothing of the program.

An alignment of adapter ``a`` (m bases, the rows) against read ``r``
(n bases, the columns) keeps, per cell, (cost, matches, origin); the
first column and the first row are free where the adapter type lets an
alignment start there (FRONT: both; BACK: the first row only). A cell
takes the diagonal on a match; else the cheapest of diagonal, left and
up, in that order on ties. Candidates are the last row at every column,
left to right, then (BACK) the last column from the top; one is
accepted when it covers at least ``min_overlap`` adapter bases with at
most ``e`` errors a base; the best has the most matches, then the fewest
errors, then comes first. Across adapters the most matches wins, the
first adapter on ties; of a read and its reverse complement the
complement wins only with strictly more matches.

The anti-diagonals of the table are computed one after another, each as
a few tensor operations over every (read, adapter) pair and every row at
once, on any torch device. Sequences hold A, C, G and T only.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

FRONT, BACK = "front", "back"
_LUT = np.full(256, 255, np.uint8)
_LUT[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _pack(seqs: Sequence[str], pad: int) -> tuple:
    """[N, max(len, 1)] codes padded with ``pad``, and lengths."""
    n = len(seqs)
    L = max([len(s) for s in seqs] + [1])
    out = np.full((n, L), pad, np.uint8)
    lens = np.zeros(n, np.int64)
    for k, s in enumerate(seqs):
        c = _LUT[np.frombuffer(s.encode("ascii"), np.uint8)]
        if (c == 255).any():
            raise ValueError("the reference takes A, C, G and T only")
        out[k, :len(c)] = c
        lens[k] = len(c)
    return out, lens


class Hits(NamedTuple):
    """[R, A] numpy arrays of the best location of each adapter in each
    read; ``found`` False where none is accepted."""
    found: np.ndarray
    refstart: np.ndarray
    refstop: np.ndarray
    qstart: np.ndarray
    qstop: np.ndarray
    matches: np.ndarray
    errors: np.ndarray


def locate(adapters: Sequence[str], reads: Sequence[str], kind: str,
           e: float, min_overlap: int = 3, device="cpu") -> Hits:
    """The best location of every adapter in every read."""
    dev = torch.device(device)
    ac, al = _pack(adapters, 4)
    rc, rl = _pack(reads, 5)           # pads match nothing
    R, A, M = len(reads), len(adapters), ac.shape[1]
    N = R * A
    ref = torch.as_tensor(ac, device=dev).repeat(R, 1)         # [N, M]
    rd = torch.as_tensor(rc, device=dev).repeat_interleave(A, 0)
    m = torch.as_tensor(al, device=dev).repeat(R)              # [N]
    n = torch.as_tensor(rl, device=dev).repeat_interleave(A)   # [N]
    Lmax = rc.shape[1]
    i = torch.arange(M + 1, device=dev)[None, :]               # rows
    i32 = i.to(torch.int32)
    big = torch.iinfo(torch.int32).max // 2

    def empty():
        return (torch.full((N, M + 1), big, dtype=torch.int32, device=dev),
                torch.zeros((N, M + 1), dtype=torch.int32, device=dev),
                torch.zeros((N, M + 1), dtype=torch.int32, device=dev))

    best = {"c": torch.full((N,), big, dtype=torch.int32, device=dev),
            "mt": torch.full((N,), -1, dtype=torch.int32, device=dev),
            "rs": torch.zeros(N, dtype=torch.int32, device=dev),
            "re": torch.zeros(N, dtype=torch.int32, device=dev),
            "qs": torch.zeros(N, dtype=torch.int32, device=dev),
            "qe": torch.zeros(N, dtype=torch.int32, device=dev)}

    def consider(row, col, c, mt, og, ok):
        refstart = torch.where(og < 0, -og, 0)
        length = row - refstart
        acc = ok & (length >= min_overlap) & (
            c.to(torch.float64) <= e * length.to(torch.float64))
        better = acc & ((mt > best["mt"])
                        | ((mt == best["mt"]) & (c < best["c"])))
        for k, v in (("c", c), ("mt", mt), ("rs", refstart), ("re", row),
                     ("qs", torch.where(og > 0, og, 0)), ("qe", col)):
            best[k] = torch.where(better, v.to(torch.int32), best[k])

    prev2, prev = empty(), empty()
    mcol = m[:, None].to(torch.int64)
    r = torch.cat([ref[:, :1], ref], 1)               # ref base i-1
    row0 = (i == 0).expand(N, M + 1)
    if kind == BACK:
        fin = empty()
    for d in range(M + Lmax + 1):
        j = d - i                                         # [1, M+1]
        jc = (j - 1).clamp(0, Lmax - 1).expand(N, M + 1)
        q = rd.gather(1, jc)                              # read base j-1
        match = (r == q)
        dc, dm, do = (torch.cat([x[:, :1], x[:, :-1]], 1) for x in prev2)
        uc, um, uo = (torch.cat([x[:, :1], x[:, :-1]], 1) for x in prev)
        lc, lm, lo = prev
        cd, ch, cv = dc + 1, lc + 1, uc + 1
        take_d = match | ((cd <= ch) & (cd <= cv))
        take_h = ~take_d & (ch <= cv)
        c = torch.where(match, dc, torch.where(take_d, cd,
                                               torch.where(take_h, ch, cv)))
        mt = torch.where(match, dm + 1, torch.where(
            take_d, dm, torch.where(take_h, lm, um)))
        og = torch.where(take_d, do, torch.where(take_h, lo, uo))
        # the free first row and first column
        jj = j.to(torch.int32).expand(N, M + 1)
        col0 = (j == 0).expand(N, M + 1)
        c = torch.where(row0, 0, c)
        mt = torch.where(row0, 0, mt)
        og = torch.where(row0, jj, og)
        if kind == FRONT:
            c = torch.where(col0 & ~row0, 0, c)
            og = torch.where(col0 & ~row0, -i32.expand(N, M + 1), og)
        else:
            c = torch.where(col0 & ~row0, i32.expand(N, M + 1), c)
            og = torch.where(col0 & ~row0, 0, og)
        mt = torch.where(col0, 0, mt)
        cur = (c, mt, og)
        # the last row, left to right
        col = d - m
        ok = (col >= 0) & (col <= n)
        consider(m.to(torch.int32), col.to(torch.int32),
                 *(x.gather(1, mcol)[:, 0] for x in cur), ok)
        if kind == BACK:
            # keep the last column (row d - n) for the scan down it
            rr = d - n
            okr = (rr >= 0) & (rr <= m)
            idx = rr.clamp(0, M)[:, None]
            for f, x in zip(fin, cur):
                f.scatter_(1, idx, torch.where(okr[:, None],
                                               x.gather(1, idx),
                                               f.gather(1, idx)))
        prev2, prev = prev, cur
    if kind == BACK:
        for row in range(M + 1):
            consider(torch.full((N,), row, dtype=torch.int32, device=dev),
                     n.to(torch.int32), fin[0][:, row], fin[1][:, row],
                     fin[2][:, row], row <= m)
    out = {k: v.cpu().numpy().reshape(R, A) for k, v in best.items()}
    return Hits(out["mt"] >= 0, out["rs"], out["re"], out["qs"], out["qe"],
                out["mt"], out["c"])


class Decision(NamedTuple):
    """One read's dual-round decision, as the pipeline writes it."""
    sp5: Optional[int]      # round-1 adapter, None = unknown
    rc1: bool
    sp27: Optional[int]     # round-2 adapter, None = unknown
    rc2: bool
    trimmed1: tuple         # (desc, seq, qual) of the round-1 output
    final: tuple            # (desc, seq, qual) of the round-2 output


def _pick(hits: Hits, k: int) -> tuple:
    """(adapter, matches) of read ``k``: most matches, first on ties;
    (-1, -1) when none."""
    mm = np.where(hits.found[k], hits.matches[k], -1)
    a = int(np.argmax(mm))
    return (a, int(mm[a])) if mm[a] >= 0 else (-1, -1)


def _round(adapters, seqs, kind, e, min_overlap, device):
    """Per read: (adapter or -1, chose rc, trim point) of one round."""
    both = list(seqs) + [revcomp(s) for s in seqs]
    h = locate(adapters, both, kind, e, min_overlap, device)
    B = len(seqs)
    out = []
    for k in range(B):
        fa, fm = _pick(h, k)
        ra, rm = _pick(h, B + k)
        use_rc = ra >= 0 and (fa < 0 or rm > fm)
        a = ra if use_rc else fa
        src = B + k if use_rc else k
        if a < 0:
            out.append((-1, False, 0))
            continue
        cut = (h.qstop[src, a] if kind == FRONT else h.qstart[src, a])
        out.append((a, use_rc, int(cut)))
    return out


def decide(reads: Sequence[tuple], sp5: Sequence[str], sp27rc: Sequence[str],
           e: float = 0.1, min_overlap: int = 3, device="cpu"
           ) -> List[Decision]:
    """The dual-round decision of every read (desc, seq, qual): round 1
    trims ``-g`` SP5 adapters (keeps what follows the match), round 2
    trims ``-a`` SP27-rc adapters from round 1's output (keeps what
    precedes it); a reverse-complemented output gets " rc" on its name."""
    r1 = _round(sp5, [s for _, s, _ in reads], FRONT, e, min_overlap,
                device)
    t1 = []
    for (desc, seq, qual), (a, rc, cut) in zip(reads, r1):
        if a < 0:
            t1.append((desc, seq, qual))
            continue
        if rc:
            desc, seq, qual = desc + " rc", revcomp(seq), qual[::-1]
        t1.append((desc, seq[cut:], qual[cut:]))
    todo = [k for k, (a, _, _) in enumerate(r1) if a >= 0]
    r2 = dict(zip(todo, _round(sp27rc, [t1[k][1] for k in todo], BACK, e,
                               min_overlap, device)))
    out = []
    for k, (a, rc, _) in enumerate(r1):
        if a < 0:
            out.append(Decision(None, False, None, False, t1[k], t1[k]))
            continue
        b, rc2, cut = r2[k]
        desc, seq, qual = t1[k]
        if b < 0:
            out.append(Decision(a, rc, None, False, t1[k], t1[k]))
            continue
        if rc2:
            desc, seq, qual = desc + " rc", revcomp(seq), qual[::-1]
        out.append(Decision(a, rc, b, rc2, t1[k],
                            (desc, seq[:cut], qual[:cut])))
    return out


def decide_blocks(reads, sp5, sp27rc, block: int = 2048, **kw
                  ) -> List[Decision]:
    """:func:`decide` over blocks of reads, so that any sample fits."""
    out: List[Decision] = []
    for s in range(0, len(reads), block):
        out += decide(reads[s:s + block], sp5, sp27rc, **kw)
    return out


