"""Phylogenetic utilities: distance matrices, NJ trees, Faith's PD.

Replaces the ape/phangorn/FastTree stack used by
R_analysis/phylo_anchor_filter.Rmd:

  * dist.dna(model="raw"/"K80", pairwise.deletion=TRUE)  -> dist_matrix
  * FastTree ML tree (:72-92) -> external hook when a fasttree binary
    exists, else a neighbor-joining tree (documented substitution — the
    filter only consumes tree *branch lengths* for PD)
  * midpoint rooting, Faith's PD (:96-102)

Copy of ``tpu_orc/analysis/phylo.py`` (:1-370); the code is unchanged. FastTree is used
where a binary is present; the tree falls back to neighbour joining.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastq import Record, read_fasta

_VALID = set("ACGT")
_TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}


def aln_matrix(records: Sequence[Record]) -> Tuple[np.ndarray, List[str]]:
    """Aligned FASTA -> uint8 matrix (A/C/G/T as bytes, everything else
    = gap class) + labels."""
    labels = [r.desc for r in records]
    L = len(records[0].seq)
    M = np.frombuffer("".join(r.seq.upper() for r in records)
                      .encode(), dtype=np.uint8).reshape(len(records), L)
    return M, labels


def dist_matrix(M: np.ndarray, model: str = "raw") -> np.ndarray:
    """Pairwise-deletion distances. model: 'raw' (p-distance) or 'K80'."""
    n = M.shape[0]
    is_base = np.isin(M, np.frombuffer(b"ACGT", dtype=np.uint8))
    purine = np.isin(M, np.frombuffer(b"AG", dtype=np.uint8))
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            both = is_base[i] & is_base[j]
            nvalid = int(both.sum())
            if nvalid == 0:
                D[i, j] = D[j, i] = np.nan
                continue
            diff = both & (M[i] != M[j])
            if model == "raw":
                d = diff.sum() / nvalid
            else:  # K80
                ts = (diff & (purine[i] == purine[j])).sum() / nvalid
                tv = (diff & (purine[i] != purine[j])).sum() / nvalid
                with np.errstate(invalid="ignore"):
                    a = 1 - 2 * ts - tv
                    b = 1 - 2 * tv
                    d = (-0.5 * np.log(a) - 0.25 * np.log(b)
                         if a > 0 and b > 0 else np.nan)
            D[i, j] = D[j, i] = d
    return D


def overlap_matrix(M: np.ndarray, rows_a: Sequence[int],
                   rows_b: Sequence[int]) -> np.ndarray:
    """Shared ungapped (non '-'/'N') columns per pair (:181-199)."""
    ung = np.isin(M, np.frombuffer(b"ACGT", dtype=np.uint8))
    A = ung[list(rows_a)].astype(np.int32)
    B = ung[list(rows_b)].astype(np.int32)
    return A @ B.T


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

@dataclass
class Tree:
    """Rooted binary-ish tree. Node 0..n_tips-1 are tips; parent[root]=-1."""
    parent: np.ndarray          # [n_nodes] int
    length: np.ndarray          # [n_nodes] float, branch above node
    labels: List[str]           # per tip
    n_tips: int

    def tip_index(self) -> Dict[str, int]:
        return {l: i for i, l in enumerate(self.labels)}


def nj_tree(D: np.ndarray, labels: Sequence[str]) -> Tree:
    """Neighbor-joining (Saitou & Nei); NaNs replaced by the max distance."""
    n = len(labels)
    D = np.array(D, dtype=float)
    mx = np.nanmax(D) if np.isfinite(np.nanmax(D)) else 1.0
    D = np.where(np.isnan(D), mx, D)
    active = list(range(n))
    parent = [-1] * n
    length = [0.0] * n
    Dcur = {(i, j): D[i, j] for i in range(n) for j in range(n) if i != j}
    next_id = n
    while len(active) > 2:
        m = len(active)
        r = {i: sum(Dcur[(i, k)] for k in active if k != i) for i in active}
        best = None
        for ai in range(m):
            for aj in range(ai + 1, m):
                i, j = active[ai], active[aj]
                q = (m - 2) * Dcur[(i, j)] - r[i] - r[j]
                if best is None or q < best[0]:
                    best = (q, i, j)
        _, i, j = best
        u = next_id
        next_id += 1
        dij = Dcur[(i, j)]
        li = 0.5 * dij + (r[i] - r[j]) / (2 * (m - 2))
        lj = dij - li
        parent += [-1]
        length += [0.0]
        parent[i], length[i] = u, max(li, 0.0)
        parent[j], length[j] = u, max(lj, 0.0)
        for k in active:
            if k in (i, j):
                continue
            duk = 0.5 * (Dcur[(i, k)] + Dcur[(j, k)] - dij)
            Dcur[(u, k)] = Dcur[(k, u)] = max(duk, 0.0)
        active = [k for k in active if k not in (i, j)] + [u]
    # join the last two under a root
    i, j = active
    root = next_id
    parent += [-1]
    length += [0.0]
    d = Dcur.get((i, j), 0.0)
    parent[i], length[i] = root, max(d / 2, 0.0)
    parent[j], length[j] = root, max(d / 2, 0.0)
    return Tree(np.array(parent), np.array(length), list(labels), n)


def _adjacency(tree: Tree) -> Dict[int, List[Tuple[int, float]]]:
    """Undirected adjacency with branch lengths (treat tree as unrooted)."""
    adj: Dict[int, List[Tuple[int, float]]] = {
        v: [] for v in range(len(tree.parent))}
    for v, p in enumerate(tree.parent):
        if p >= 0:
            w = float(tree.length[v])
            adj[v].append((int(p), w))
            adj[int(p)].append((v, w))
    return adj


def _farthest(adj, start: int, restrict_tips: Optional[int] = None
              ) -> Tuple[int, float, Dict[int, Tuple[int, float]]]:
    """Dijkstra-free DFS (trees have unique paths). Returns the farthest
    node (a tip if restrict_tips is the tip count), its distance, and a
    back-pointer map node -> (prev, edge_len)."""
    dist = {start: 0.0}
    prev: Dict[int, Tuple[int, float]] = {}
    stack = [start]
    while stack:
        u = stack.pop()
        for v, w in adj[u]:
            if v not in dist:
                dist[v] = dist[u] + w
                prev[v] = (u, w)
                stack.append(v)
    cands = ((d, n) for n, d in dist.items()
             if restrict_tips is None or n < restrict_tips)
    best_d, best_n = max(cands)
    return best_n, best_d, prev


def midpoint_root(tree: Tree) -> Tree:
    """Re-root at the midpoint of the longest tip-to-tip path
    (phangorn::midpoint, used by phylo_anchor_filter.Rmd before PD)."""
    n_tips = tree.n_tips
    if n_tips < 2:
        return tree
    adj = _adjacency(tree)
    a, _, _ = _farthest(adj, 0, n_tips)
    b, diam, prev = _farthest(adj, a, n_tips)
    if diam <= 0:
        return tree
    # walk back from b toward a accumulating length until >= diam/2
    path = [b]
    while path[-1] != a:
        path.append(prev[path[-1]][0])
    half = diam / 2.0
    acc = 0.0
    for k in range(len(path) - 1):
        u, v = path[k], path[k + 1]          # edge u-v, walking b -> a
        w = next(wt for nb, wt in adj[u] if nb == v)
        if acc + w >= half - 1e-12:
            # root lies on edge (u, v), at (half - acc) from u
            du = half - acc
            return _reroot_on_edge(tree, adj, u, v, du, w)
        acc += w
    return tree


def _reroot_on_edge(tree: Tree, adj, u: int, v: int, du: float,
                    w: float) -> Tree:
    """New root node splits edge (u,v): dist(root,u)=du, dist(root,v)=w-du."""
    n_nodes = len(tree.parent)
    root = n_nodes
    parent = np.full(n_nodes + 1, -1, dtype=tree.parent.dtype)
    length = np.zeros(n_nodes + 1, dtype=float)
    # BFS from the new root over the unrooted topology
    visited = {u, v}
    parent[u], length[u] = root, max(du, 0.0)
    parent[v], length[v] = root, max(w - du, 0.0)
    stack = [u, v]
    while stack:
        x = stack.pop()
        for y, wy in adj[x]:
            if y in visited or (x in (u, v) and y in (u, v)):
                continue
            visited.add(y)
            parent[y], length[y] = x, wy
            stack.append(y)
    return Tree(parent, length, list(tree.labels), tree.n_tips)


def faith_pd(tree: Tree, tip_labels: Sequence[str]) -> float:
    """Sum of branch lengths of the minimal subtree spanning the tips
    (unrooted interpretation: edges on paths between selected tips)."""
    idx = tree.tip_index()
    sel = [idx[t] for t in tip_labels if t in idx]
    if len(sel) < 2:
        return 0.0
    n_nodes = len(tree.parent)
    below = np.zeros(n_nodes, dtype=np.int64)
    for t in sel:
        below[t] = 1
    # accumulate counts up the tree in post-order (children before
    # parents); node ids carry no order guarantee after re-rooting or
    # newick parsing, so derive the order from depths.
    depth = np.zeros(n_nodes, dtype=np.int64)
    for v in range(n_nodes):
        d, p = 0, tree.parent[v]
        while p >= 0:
            d += 1
            p = tree.parent[p]
        depth[v] = d
    for v in np.argsort(-depth, kind="stable"):
        p = tree.parent[v]
        if p >= 0:
            below[p] += below[v]
    total = len(sel)
    pd = 0.0
    for v in range(n_nodes):
        if tree.parent[v] >= 0 and 0 < below[v] < total:
            pd += float(tree.length[v])
    return pd


def parse_newick(text: str) -> Tree:
    """Parse a newick string (FastTree output shape: unquoted labels,
    ``(a:1,b:2)0.95:0.1;`` with optional internal support values) into a
    Tree. Tips get ids 0..n_tips-1 in file order; internal nodes follow."""
    text = text.strip()
    if text.endswith(";"):
        text = text[:-1]
    pos = 0

    def parse_clade():
        nonlocal pos
        children = []
        label = ""
        if pos < len(text) and text[pos] == "(":
            pos += 1
            while True:
                children.append(parse_clade())
                if text[pos] == ",":
                    pos += 1
                    continue
                if text[pos] == ")":
                    pos += 1
                    break
        # label (tip name, or internal support value — ignored for internal)
        start = pos
        while pos < len(text) and text[pos] not in ":,()":
            pos += 1
        label = text[start:pos].strip()
        blen = 0.0
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",()":
                pos += 1
            blen = float(text[start:pos])
        return {"children": children, "label": label, "length": blen}

    root = parse_clade()
    tips: List[dict] = []
    internals: List[dict] = []

    def collect(node):
        if node["children"]:
            internals.append(node)
            for c in node["children"]:
                collect(c)
        else:
            tips.append(node)

    collect(root)
    n_tips = len(tips)
    ids: Dict[int, int] = {}
    for k, t in enumerate(tips):
        ids[id(t)] = k
    for k, nd in enumerate(internals):
        ids[id(nd)] = n_tips + k
    n_nodes = n_tips + len(internals)
    parent = np.full(n_nodes, -1, dtype=np.int64)
    length = np.zeros(n_nodes, dtype=float)

    def wire(node):
        for c in node["children"]:
            parent[ids[id(c)]] = ids[id(node)]
            length[ids[id(c)]] = c["length"]
            wire(c)

    wire(root)
    length[ids[id(root)]] = root["length"]
    return Tree(parent, length, [t["label"] for t in tips], n_tips)


def write_newick(tree: Tree, path: str):
    children: Dict[int, List[int]] = {}
    root = -1
    for v, p in enumerate(tree.parent):
        if p < 0:
            if v >= tree.n_tips:
                root = v
            continue
        children.setdefault(int(p), []).append(v)
    if root < 0:
        root = len(tree.parent) - 1

    def rec(v):
        if v < tree.n_tips:
            return f"{tree.labels[v]}:{tree.length[v]:.6f}"
        subs = ",".join(rec(c) for c in children.get(v, []))
        return f"({subs}):{tree.length[v]:.6f}"

    with open(path, "w") as fh:
        fh.write(rec(root) + ";\n")


def build_tree(aligned_fasta: str, out_prefix: str,
               fasttree_bin: Optional[str] = None) -> Tree:
    """FastTree when available (run_fasttree equivalent,
    phylo_anchor_filter.Rmd:72-92) — its newick is parsed and
    midpoint-rooted so PD consumes the ML branch lengths; else NJ on raw
    distances (documented substitution)."""
    recs = list(read_fasta(aligned_fasta))
    exe = fasttree_bin or shutil.which("fasttree") or shutil.which(
        "FastTree")
    if exe:
        out = f"{out_prefix}.nwk"
        with open(aligned_fasta) as fin, open(out, "w") as fout:
            subprocess.run([exe, "-nt", "-gtr"], stdin=fin, stdout=fout,
                           check=True)
        with open(out) as fh:
            tree = midpoint_root(parse_newick(fh.read()))
        return tree
    M, labels = aln_matrix(recs)
    D = dist_matrix(M, "raw")
    tree = midpoint_root(nj_tree(D, labels))
    write_newick(tree, f"{out_prefix}_nj.nwk")
    return tree
