"""Union-find used for gene/species group merging.

Equivalent to the reference's greedy set-grouping + ``merge_groups``
transitive closure (amplicon_sorter.py:1022-1087): the final partition is
the connected components of the kept edge set, which union-find computes
directly and deterministically.

Copy of ``tpu_orc/cluster/unionfind.py``; the code is unchanged.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence


class UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True

    def components(self, members: Sequence[int] | None = None
                   ) -> List[List[int]]:
        """Components restricted to ``members`` (default: all), each sorted,
        ordered by smallest member for determinism."""
        out: Dict[int, List[int]] = {}
        it: Iterable[int] = members if members is not None else range(
            len(self.parent))
        for x in it:
            out.setdefault(self.find(x), []).append(x)
        comps = [sorted(v) for v in out.values()]
        comps.sort(key=lambda c: c[0])
        return comps
