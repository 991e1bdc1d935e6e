"""Unit-cost global edit distance (edlib's NW mode, as amplicon_sorter's
``distance`` calls it) of many pairs at once, in plain PyTorch: the
reference that the sort cells are held against.

Written for the benchmark from the definition, not from the program's
code; it imports nothing of the program. D[i][j] is the distance of the
first i bases of ``a`` and the first j of ``b``: D[i][0] = i,
D[0][j] = j, D[i][j] = min(D[i-1][j-1] + (a[i-1] != b[j-1]),
D[i-1][j] + 1, D[i][j-1] + 1). The anti-diagonals are computed one after
another, each as a few tensor operations over every pair and every row.
``band`` keeps only the cells with |i - j| <= band, the shortcut of a
banded aligner; with it the result is no longer the edit distance, which
is what the sort cells' control uses.

amplicon_sorter's similarity of two reads is round(1 - d / longer, 3);
where it falls below 0.5 the reverse complement of the second read is
tried and the larger of the two kept (``scripts/auxiliary_code/
amplicon_sorter.py``'s ``similarity``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .cutadapt import _pack, revcomp

INF = 1 << 28


def distances(a: Sequence[str], b: Sequence[str], device="cpu",
              band: Optional[int] = None, block: int = 512) -> np.ndarray:
    """[P] int64 edit distances of the pairs (a[p], b[p])."""
    out = np.zeros(len(a), np.int64)
    for s in range(0, len(a), block):
        out[s:s + block] = _distances(a[s:s + block], b[s:s + block],
                                      device, band)
    return out


def _distances(a, b, device, band) -> np.ndarray:
    dev = torch.device(device)
    P = len(a)
    if P == 0:
        return np.zeros(0, np.int64)
    ac, al = _pack(a, 4)
    bc, bl = _pack(b, 5)
    A, B = ac.shape[1], bc.shape[1]
    ta = torch.as_tensor(ac, device=dev)
    tb = torch.as_tensor(bc, device=dev)
    la = torch.as_tensor(al, device=dev)
    lb = torch.as_tensor(bl, device=dev)
    i = torch.arange(A + 1, device=dev)[None, :]
    ra = torch.cat([ta[:, :1], ta], 1)            # a[i-1] at row i
    prev2 = torch.full((P, A + 1), INF, dtype=torch.int32, device=dev)
    prev = prev2.clone()
    res = torch.full((P,), -1, dtype=torch.int64, device=dev)
    last = la + lb
    rows = la[:, None]
    for d in range(int(last.max()) + 1):
        j = d - i
        q = tb.gather(1, (j - 1).clamp(0, B - 1).expand(P, A + 1))
        neq = (ra != q).to(torch.int32)
        diag = torch.cat([prev2[:, :1], prev2[:, :-1]], 1) + neq
        up = torch.cat([prev[:, :1], prev[:, :-1]], 1) + 1
        cur = torch.minimum(torch.minimum(diag, up), prev + 1)
        cur = torch.where(i == 0, j.to(torch.int32), cur)
        cur = torch.where(j == 0, i.to(torch.int32), cur)
        cur = torch.where(j < 0, INF, cur)
        if band is not None:
            cur = torch.where((i - j).abs() > band, INF, cur)
        cur = cur.clamp(max=INF)
        res = torch.where(last == d,
                          cur.gather(1, rows)[:, 0].to(torch.int64), res)
        prev2, prev = prev, cur
    return res.cpu().numpy()


def similarities(a: Sequence[str], b: Sequence[str], device="cpu",
                 band: Optional[int] = None) -> np.ndarray:
    """amplicon_sorter's similarity of each pair (a[p], b[p])."""
    longer = np.maximum([len(x) for x in a], [len(y) for y in b]
                        ).astype(np.float64)
    sf = np.round(1.0 - distances(a, b, device, band) / longer, 3)
    low = np.flatnonzero(sf < 0.5)
    if len(low):
        dr = distances([a[k] for k in low], [revcomp(b[k]) for k in low],
                       device, band)
        sf[low] = np.maximum(sf[low], np.round(1.0 - dr / longer[low], 3))
    return sf
