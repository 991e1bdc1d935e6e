"""Amplicon-sorter-equivalent clustering engine (deterministic, device-hot).

Copy of ``tpu_orc/cluster/engine.py``; the imports are this package's,
and the device seam: ``AmpliconSorter(..., device=)`` names the torch
device of every consensus pileup (``cluster/consensus.py``: with the
``device`` backend, the path-bits kernel on CUDA or its plain version on
the CPU). The device is not a field of ``SorterConfig`` (its fields are
echoed into ``results.txt``) and is not taken from the scorer (small
bins score on the native backend whatever the device). The seeded numpy
RNG stays numpy: byte-identical consensus depends on it.

Orchestrates the algorithm of the reference's amplicon_sorter.py
(SURVEY.md §2.2/§3.2) with the same thresholds and stage structure, but:

* all O(N^2)/ladder similarity scoring runs on TPU tiles
  (cluster/scoring.py) instead of a multiprocessing pool over edlib;
* grouping is connected components via union-find (equivalent to
  greedy-set + merge_groups transitive closure);
* every sampling step uses a seeded ``numpy`` Generator — the reference
  uses unseeded ``random.sample`` in 7+ places and is not run-reproducible
  (SURVEY.md §2.2 determinism warning); the contract here is *equivalent*
  consensus output, bit-reproducible across runs.

Stage map (reference lines):
  gene stage     sort_genes:2026-2067, process_list/similarity:648-808
  ssg estimate   SSG:810-836
  gene groups    update_list:967-1056 (+ comp_consensus_groups:1206-1339)
  species seeds  read_indexes:1341-1461
  ladder         rest_reads:1962-2023, process_consensuslist/
                 similarity_species:1628-1716, update_groups:1718-1824,
                 compare_consensus:1840-1960, finetune:838-965
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..io import encode
from ..io.fastq import Record
from . import consensus as _consensus_mod
from .consensus import (build_consensus, build_consensus_iupac,
                        build_consensus_multi, consensus_direction)
from .scoring import DeviceScorer, PairHits
from .unionfind import UnionFind


@dataclass
class SorterConfig:
    """Mirrors amplicon_sorter CLI defaults (:126-191)."""
    min_length: int = 300            # -min
    max_length: Optional[int] = None  # -max
    max_reads: int = 10000           # -maxr
    random_selection: bool = True    # -ar (sample across whole file)
    similar_genes: float = 0.80      # -sg
    similar_species_groups: Optional[float] = None  # -ssg (None = estimate)
    similar_species: float = 0.85    # -ss
    similar_consensus: float = 0.96  # -sc
    length_diff_consensus: float = 8.0  # -ldc -> 1 + ldc/100 final gate
    sub_block: int = 1000            # comparison block size (:571-623)
    seed: int = 42
    tile: int = 256
    # finetune purity cut (reference hardcodes 0.95, :926,:942 — assumes
    # Q10+ reads at >=95% accuracy; lower for noisier chemistry)
    finetune_identity: float = 0.95
    ambiguous: bool = False          # -amb: IUPAC ambiguity calls
    # -a/--all (:172-174, :576-612): compare ALL selected reads with
    # each other in one block instead of 1000-read sub-blocks
    compare_all: bool = False


@dataclass
class SpeciesGroup:
    members: List[int]          # global read indices
    consensus: str


@dataclass
class SortResult:
    skipped: bool
    n_reads: int
    gene_groups: List[List[int]] = field(default_factory=list)
    species: List[List[SpeciesGroup]] = field(default_factory=list)
    nogroup: List[int] = field(default_factory=list)
    ssg: Optional[float] = None
    pairs_scored: int = 0


def estimate_ssg(sims: np.ndarray) -> float:
    """Reference N6 estimator (:810-836): walk unique similarity values in
    descending order, accumulating sim*count until 6% of the total
    similarity mass; that value (as int percent / 100) is the ssg."""
    if len(sims) == 0:
        return 0.85
    total = float(sims.sum())
    b = int(total * 0.06)
    vals, counts = np.unique(np.round(sims, 3), return_counts=True)
    acc = 0.0
    for v, c in zip(vals[::-1], counts[::-1]):
        acc += v * c
        if acc >= b:
            return int(v * 100) / 100.0
    return float(vals[0])


class AmpliconSorter:
    def __init__(self, config: SorterConfig = SorterConfig(),
                 scorer: Optional[DeviceScorer] = None, device="cuda"):
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)
        # the default scorer and the consensus pileup's device backend
        # run on one torch device
        self.scorer = scorer or DeviceScorer(tile=config.tile, device=device)
        self.device = device

    # ------------------------------------------------------------------
    def sort_records(self, records: Sequence[Record]) -> SortResult:
        cfg = self.cfg
        reads: List[Tuple[str, str]] = []
        for r in records:
            L = len(r.seq)
            if L < cfg.min_length:
                continue
            if cfg.max_length is not None and L > cfg.max_length:
                continue
            reads.append((r.id, r.seq.upper()))
        if len(reads) < 5:  # degenerate-input guard (:557-560)
            return SortResult(skipped=True, n_reads=len(reads))
        if len(reads) > cfg.max_reads:
            if cfg.random_selection:
                sel = sorted(self.rng.choice(len(reads), cfg.max_reads,
                                             replace=False))
                reads = [reads[i] for i in sel]
            else:
                reads = reads[:cfg.max_reads]

        self.ids = [r[0] for r in reads]
        self.seqs = [r[1] for r in reads]
        self.codes = [encode.encode_codes(s) for s in self.seqs]
        n = len(reads)

        # ---- gene stage: blocked all-vs-all ---------------------------
        edges = self._gene_stage_edges()
        ssg = (cfg.similar_species_groups if cfg.similar_species_groups
               else estimate_ssg(edges.sim))
        gene_groups = self._gene_groups(edges, n)
        gene_groups = self._merge_gene_groups_by_consensus(gene_groups)

        # ---- species stage per gene group -----------------------------
        all_species: List[List[SpeciesGroup]] = []
        grouped: set = set()
        for g in gene_groups:
            sg = self._species_stage(g, edges, ssg)
            all_species.append(sg)
            for s in sg:
                grouped.update(s.members)
        nogroup = [i for i in range(n) if i not in grouped]
        return SortResult(skipped=False, n_reads=n,
                          gene_groups=gene_groups, species=all_species,
                          nogroup=nogroup, ssg=ssg,
                          pairs_scored=self.scorer.pairs_scored)

    # ------------------------------------------------------------------
    def _gene_stage_edges(self) -> PairHits:
        cfg = self.cfg
        n = len(self.codes)
        all_i, all_j, all_s, all_r = [], [], [], []
        block = n if cfg.compare_all else cfg.sub_block
        for b0 in range(0, n, max(block, 1)):
            idx = list(range(b0, min(b0 + block, n)))
            idx.sort(key=lambda i: len(self.codes[i]))  # :676 sort by length
            hits = self.scorer.allvsall_effective_sims(
                [self.codes[i] for i in idx], band=1.05,
                keep_threshold=cfg.similar_genes)
            gi = np.asarray(idx)
            all_i.append(gi[hits.i])
            all_j.append(gi[hits.j])
            all_s.append(hits.sim)
            all_r.append(hits.reverse)
        return PairHits(np.concatenate(all_i) if all_i else np.zeros(0, int),
                        np.concatenate(all_j) if all_j else np.zeros(0, int),
                        np.concatenate(all_s) if all_s else np.zeros(0),
                        np.concatenate(all_r) if all_r else np.zeros(0, bool))

    def _best_hit_filter(self, edges: PairHits, mask: np.ndarray
                         ) -> List[Tuple[int, int, float]]:
        """Per target j keep the max-sim edge (ties -> larger i), the
        reference's best-hit dedup (:1010-1021, :1392-1407)."""
        ii, jj, ss = edges.i[mask], edges.j[mask], edges.sim[mask]
        if len(jj) == 0:
            return []
        # lexsort: primary j asc, then sim asc, then i asc -> the last row
        # of each j-run is its (max sim, max i) winner
        order = np.lexsort((ii, ss, jj))
        ii, jj, ss = ii[order], jj[order], ss[order]
        last = np.r_[jj[1:] != jj[:-1], True]
        return [(int(i), int(j), float(s))
                for i, j, s in zip(ii[last], jj[last], ss[last])]

    def _gene_groups(self, edges: PairHits, n: int) -> List[List[int]]:
        kept = self._best_hit_filter(edges,
                                     edges.sim >= self.cfg.similar_genes)
        uf = UnionFind(n)
        touched = set()
        for i, j, _ in kept:
            uf.union(i, j)
            touched.update((i, j))
        return [c for c in uf.components(sorted(touched)) if len(c) > 1]

    # ------------------------------------------------------------------
    def _sample_members(self, members: Sequence[int],
                        sample_n: int) -> List[int]:
        """Deterministic <=sample_n member subsample (the reference's
        random.sample at :1238/:1435/:1792, seeded)."""
        mem = list(members)
        if len(mem) > sample_n:
            mem = sorted(self.rng.choice(len(mem), sample_n, replace=False))
            mem = [members[k] for k in mem]
        return mem

    def _group_consensus(self, members: Sequence[int], sample_n: int) -> str:
        mem = self._sample_members(members, sample_n)
        codes = consensus_direction([self.codes[i] for i in mem])
        if self.cfg.ambiguous:
            return build_consensus_iupac(codes, device=self.device)
        return encode.decode(build_consensus(codes, device=self.device))

    def _group_consensus_multi(self, member_lists: Sequence[Sequence[int]],
                               sample_n: int) -> List[str]:
        """Batched _group_consensus over many groups: with the device
        pileup backend every consensus pass becomes ONE kernel launch
        for all groups (build_consensus_multi / path_bits_groups), so a
        ladder step's dirty-group rebuild pays 3 dispatch round trips
        instead of 3*G. Samples members in list order, consuming the
        engine RNG exactly as the sequential loop would (byte-identical
        output on every backend)."""
        if (_consensus_mod.PILEUP_BACKEND != "device"
                or self.cfg.ambiguous or len(member_lists) <= 1):
            return [self._group_consensus(m, sample_n)
                    for m in member_lists]
        groups_codes = [
            consensus_direction(
                [self.codes[i] for i in self._sample_members(m, sample_n)])
            for m in member_lists]
        return [encode.decode(c)
                for c in build_consensus_multi(groups_codes,
                                               device=self.device)]

    def _hw_sim(self, a: str, b: str) -> float:
        """Reference distance(a, b, 'HW') incl. fwd/rc max
        (iden_consensus:1140-1159)."""
        ca, cb = encode.encode_codes(a), encode.encode_codes(b)
        short, lng = (ca, cb) if len(ca) <= len(cb) else (cb, ca)
        d = native.edit_distance(short, lng, "HW")
        rc = encode.revcomp_codes(lng)
        dr = native.edit_distance(short, rc, "HW")
        L = max(len(ca), len(cb), 1)
        return max(round(1 - d / L, 3), round(1 - dr / L, 3))

    def _hw_sims_pairs(self, cons: List[str], pairs) -> np.ndarray:
        """All consensus-pair HW sims in ONE threaded native crossing
        (VERDICT r2 next#7 — was one crossing per pair in the G^2 merge
        loops). pairs: list of (a, b) index tuples into ``cons``.
        Returns sims [K] matching _hw_sim per pair."""
        if not pairs:
            return np.zeros(0)
        codes = [encode.encode_codes(c) for c in cons]
        pa = np.fromiter((p[0] for p in pairs), np.int32, len(pairs))
        pb = np.fromiter((p[1] for p in pairs), np.int32, len(pairs))
        d_f, d_r = native.hw_pairs(codes, pa, pb)
        la = np.fromiter((len(codes[a]) for a in pa), np.int64, len(pa))
        lb = np.fromiter((len(codes[b]) for b in pb), np.int64, len(pb))
        L = np.maximum(np.maximum(la, lb), 1).astype(np.float64)
        return np.maximum(np.round(1 - d_f / L, 3),
                          np.round(1 - d_r / L, 3))

    def _merge_gene_groups_by_consensus(self, groups: List[List[int]]
                                        ) -> List[List[int]]:
        """comp_consensus_groups (:1206-1339): merge gene groups whose
        50-read consensuses reach HW sim >= 0.60 (default ldc<=8 path),
        loop until stable, drop groups <= 5 reads."""
        ldc = self.cfg.length_diff_consensus / 100 + 1
        prev = -1
        while len(groups) != prev:
            prev = len(groups)
            if len(groups) <= 1:
                break
            cons = self._group_consensus_multi(groups, 50)
            uf = UnionFind(len(groups))
            pairs = [(a, b)
                     for a in range(len(groups) - 1)
                     for b in range(a + 1, len(groups))
                     if not (len(cons[a]) * ldc < len(cons[b])
                             or len(cons[b]) * ldc < len(cons[a])
                             or not len(cons[a]) or not len(cons[b]))]
            sims = self._hw_sims_pairs(cons, pairs)
            for (a, b), s in zip(pairs, sims):
                if s >= 0.60:
                    uf.union(a, b)
            groups = [sorted(sum((groups[k] for k in comp), []))
                      for comp in uf.components()]
        return [g for g in groups if len(g) > 5]

    # ------------------------------------------------------------------
    def _species_stage(self, gmembers: List[int], edges: PairHits,
                       ssg: float) -> List[SpeciesGroup]:
        cfg = self.cfg
        gm = np.asarray(gmembers)
        # Both endpoints must be inside this gene group: the reference's
        # read_indexes (:1341-1461) re-filters the stored similarities
        # strictly within one gene group, so a read from another (or a
        # dropped <=5-read) group that shares one >=ssg edge must not be
        # unioned into this group's species components.
        mask = ((edges.sim >= ssg) & np.isin(edges.i, gm)
                & np.isin(edges.j, gm))
        kept = self._best_hit_filter(edges, mask)
        uf = UnionFind(len(self.codes))
        touched = set()
        for i, j, _ in kept:
            uf.union(i, j)
            touched.update((i, j))
        comps = [c for c in uf.components(sorted(touched)) if len(c) > 3]
        comp_cons = self._group_consensus_multi(comps, 100)
        groups: List[Dict] = [
            {"members": list(c), "consensus": cc}
            for c, cc in zip(comps, comp_cons)]
        if not groups:
            return []

        grouped_now = set()
        for g in groups:
            grouped_now.update(g["members"])
        unassigned = [i for i in gmembers if i not in grouped_now]
        assigned: Dict[int, int] = {}

        similar = 0.95  # ladder start (:2129)
        while similar >= cfg.similar_species - 1e-9:
            for _ in range(2):  # <= 2 assignment rounds per level
                added = self._ladder_round(groups, unassigned, assigned,
                                           similar)
                if added:
                    self._rebuild_consensuses(groups)
                    if len(groups) > 1:
                        self._compare_consensus(groups, 1.08)
                else:
                    break
            if round(similar, 2) in (0.94, 0.88):
                self._finetune(groups)
                groups = [g for g in groups if g["members"]]
            similar = round(similar - 0.01, 2)
        if len(groups) > 1:
            self._compare_consensus(
                groups, self.cfg.length_diff_consensus / 100 + 1)
        return [SpeciesGroup(sorted(g["members"]), g["consensus"])
                for g in groups if len(g["members"]) > 3]

    def _ladder_round(self, groups, unassigned: List[int],
                      assigned: Dict[int, int], similar: float) -> bool:
        """process_consensuslist + update_groups at one ladder level."""
        pool = [i for i in unassigned if i not in assigned]
        if not pool or not groups:
            return False
        cons_codes = [encode.encode_codes(g["consensus"]) for g in groups]
        if any(len(c) == 0 for c in cons_codes):
            return False
        sims = self.scorer.reads_vs_consensus_sims(
            [self.codes[i] for i in pool], cons_codes, band=1.05)
        added = False
        for r, i in enumerate(pool):
            row = sims[r]
            if np.all(np.isnan(row)):
                continue
            gbest = int(np.nanargmax(row))
            if row[gbest] >= similar:
                groups[gbest]["members"].append(i)
                groups[gbest]["_dirty"] = True
                assigned[i] = gbest
                added = True
        return added

    def _rebuild_consensuses(self, groups):
        dirty = [g for g in groups if g.pop("_dirty", False)]
        if dirty:
            cons = self._group_consensus_multi(
                [g["members"] for g in dirty], 200)
            for g, c in zip(dirty, cons):
                g["consensus"] = c

    def _compare_consensus(self, groups, ldc: float, max_cycles: int = 3):
        """compare_consensus (:1840-1960): merge groups whose consensuses
        reach HW sim >= similar_consensus; <= 3 cycles until stable."""
        thr = self.cfg.similar_consensus
        for _ in range(max_cycles):
            if len(groups) <= 1:
                return
            uf = UnionFind(len(groups))
            merged_any = False
            cons = [g["consensus"] for g in groups]
            pairs = [(a, b)
                     for a in range(len(groups) - 1)
                     for b in range(a + 1, len(groups))
                     if cons[a] and cons[b]
                     and not (len(cons[a]) * ldc < len(cons[b])
                              or len(cons[b]) * ldc < len(cons[a]))]
            sims = self._hw_sims_pairs(cons, pairs)
            for (a, b), s in zip(pairs, sims):
                if s >= thr:
                    uf.union(a, b)
                    merged_any = True
            if not merged_any:
                return
            mlists = [sorted(sum((groups[k]["members"] for k in comp), []))
                      for comp in uf.components()]
            groups[:] = [{"members": m, "consensus": c}
                         for m, c in zip(mlists,
                                         self._group_consensus_multi(
                                             mlists, 200))]

    # ------------------------------------------------------------------
    def _finetune(self, groups):
        """finetune (:838-965): per group, test single-species-ness with
        close/distant seed consensuses; trim members below 0.95 identity
        to the final consensus; split off a second species when the two
        seed consensuses do not converge."""
        add_groups = []
        for g in groups:
            members = g["members"]
            if len(members) < 6:
                continue
            codes = consensus_direction([self.codes[i] for i in members])
            sample_idx = list(range(len(members)))
            if len(sample_idx) > 100:
                sample_idx = sorted(self.rng.choice(len(members), 100,
                                                    replace=False))
            first = codes[sample_idx[0]]
            rest_k = sample_idx[1:]
            scored = list(zip(self._nw_sim_batch(first,
                                                 [codes[k] for k in rest_k]),
                              rest_k))
            scored.sort(key=lambda x: x[0])
            if len(scored) < 4:
                continue
            seed1 = codes[scored[int(len(scored) // 1.25)][1]]  # close
            seed2 = codes[scored[int(len(scored) // 5)][1]]     # distant
            c1, s1 = self._converge_consensus(seed1, codes)
            c2, s2 = self._converge_consensus(seed2, codes)
            iden3 = self._nw_sim(c1, c2)
            final_scores = s1
            ft = self.cfg.finetune_identity
            keep = [i for i, sc in zip(members, final_scores) if sc >= ft]
            if iden3 >= 1.0:
                if len(keep) >= 5:
                    g["members"] = keep
                    g["consensus"] = self._group_consensus(keep, 150)
                else:
                    g["members"] = []
            else:
                rest = [i for i, sc in zip(members, final_scores)
                        if sc < ft]
                if len(keep) >= 5:
                    g["members"] = keep
                    g["consensus"] = self._group_consensus(keep, 150)
                # re-score the remainder against the second consensus
                if len(rest) > 5:
                    rest_codes = [self.codes[i] for i in rest]
                    rs = self._nw_sim_batch(c2, rest_codes)
                    keep2 = [i for i, sc in zip(rest, rs) if sc >= ft]
                    if len(keep2) >= 5:
                        add_groups.append(
                            {"members": keep2,
                             "consensus": self._group_consensus(keep2, 150)})
        groups.extend(add_groups)

    def _converge_consensus(self, seed_codes, member_codes,
                            max_cycles: int = 10):
        """check_consensus iteration (:875-890): rebuild from reads >= 0.94
        sim to the current consensus until stable."""
        consensus = seed_codes
        scores = [0.0] * len(member_codes)
        for _ in range(max_cycles):
            scores = self._nw_sim_batch(consensus, member_codes)
            order = np.argsort(scores, kind="stable")
            good = [k for k in order if scores[k] > 0.94]
            if len(good) < 20:
                good = list(order[-20:])
            sample = good[-50:]
            new_c = build_consensus([member_codes[k] for k in sample],
                                    device=self.device)
            iden = self._nw_sim(new_c, consensus)
            consensus = new_c
            if iden >= 1.0:
                break
        scores = self._nw_sim_batch(consensus, member_codes)
        return consensus, scores

    def _nw_sim(self, a_codes, b_codes) -> float:
        if len(a_codes) == 0 or len(b_codes) == 0:
            return 0.0
        d = native.edit_distance(np.asarray(a_codes, np.uint8),
                                 np.asarray(b_codes, np.uint8))
        return round(1 - d / max(len(a_codes), len(b_codes)), 3)

    def _nw_sim_batch(self, a_codes, codes_list) -> List[float]:
        """One-vs-many _nw_sim in a single threaded native crossing."""
        if len(a_codes) == 0 or not codes_list:
            return [0.0] * len(codes_list)
        d = native.nw_dist_batch(np.asarray(a_codes, np.uint8),
                                 [np.asarray(c, np.uint8)
                                  for c in codes_list])
        la = len(a_codes)
        return [0.0 if len(c) == 0
                else round(1 - di / max(la, len(c)), 3)
                for di, c in zip(d, codes_list)]
