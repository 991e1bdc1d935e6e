"""Anchor selection filter (phylo_anchor_filter.Rmd equivalent).

Pipeline (:159-531): distance matrix -> divergent-anchor flagging
(median + 3*MAD of each anchor's min distance to any sample) ->
whitelist (distance <= threshold to some sample, with optional overlap
floor) -> dedup (drop anchors within dedup-distance of a kept anchor
unless they are sole cover for a sample) -> greedy Faith's-PD fill of the
remaining subset slots with non-whitelisted anchors.

Note: the reference Rmd computes ``anchor_min_dist`` from the *overlap*
matrix (:209), which contradicts its own messages and threshold units —
we implement the evident intent (min of the distance matrix).

Copy of ``tpu_orc/analysis/anchors.py`` (:1-175); the code is unchanged.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastq import read_fasta
from .phylo import (Tree, aln_matrix, dist_matrix, faith_pd, nj_tree,
                    overlap_matrix, write_newick)


@dataclass
class AnchorFilterConfig:
    threshold: float = 0.25      # whitelist distance (Rmd opt$threshold)
    dedup: float = 0.02          # dedup distance (opt$dedup, :385)
    subset: int = 50             # target anchor count (opt$subset)
    min_overlap: Optional[int] = None  # shared ungapped columns floor
    distance_model: str = "raw"  # 'raw' or 'K80' (opt$distance)


@dataclass
class AnchorFilterResult:
    whitelisted: List[str]
    non_whitelisted: List[str]
    divergent: List[str]
    dedup_dropped: List[Tuple[str, str]]   # (dropped, kept_closest)
    final_anchors: List[str]
    final_pd: float
    threshold_divergence: float


def run_anchor_filter(aligned_fasta: str, metadata_csv: str, outdir: str,
                      cfg: AnchorFilterConfig = AnchorFilterConfig()
                      ) -> AnchorFilterResult:
    """metadata_csv: label,type rows from stage 09
    (prep_anchor_selection)."""
    os.makedirs(outdir, exist_ok=True)
    recs = list(read_fasta(aligned_fasta))
    M, labels = aln_matrix(recs)
    lab_idx = {l: i for i, l in enumerate(labels)}
    types: Dict[str, str] = {}
    with open(metadata_csv) as fh:
        for row in csv.DictReader(fh):
            types[row["label"]] = row["type"]
    anchors = [l for l in labels if types.get(l) == "anchor"]
    samples = [l for l in labels if types.get(l) == "sample"]
    if not anchors or not samples:
        raise ValueError("need both anchors and samples in metadata")

    D = dist_matrix(M, cfg.distance_model)
    with open(os.path.join(outdir, "distance_matrix.csv"), "w") as fh:
        fh.write("," + ",".join(labels) + "\n")
        for i, l in enumerate(labels):
            fh.write(l + "," + ",".join(f"{D[i, j]:.6f}"
                                        for j in range(len(labels))) + "\n")

    a_rows = [lab_idx[a] for a in anchors]
    s_rows = [lab_idx[s] for s in samples]
    AS = D[np.ix_(a_rows, s_rows)]
    ov = (overlap_matrix(M, a_rows, s_rows)
          if cfg.min_overlap is not None else None)

    # -- divergence flagging (median + 3*MAD of per-anchor min dist) -----
    min_dist = np.nanmin(AS, axis=1)
    med = float(np.nanmedian(min_dist))
    mad = float(np.nanmedian(np.abs(min_dist - med))) * 1.4826  # R mad()
    thr_div = med + 3 * mad
    divergent = [a for a, d in zip(anchors, min_dist) if d > thr_div]

    # -- whitelist: any sample within threshold (+ overlap floor) --------
    whitelisted: List[str] = []
    for ai, a in enumerate(anchors):
        ok = False
        for si in range(len(samples)):
            d = AS[ai, si]
            if np.isnan(d) or d > cfg.threshold:
                continue
            if ov is not None and ov[ai, si] < cfg.min_overlap:
                continue
            ok = True
            break
        if ok:
            whitelisted.append(a)
    non_whitelisted = [a for a in anchors if a not in whitelisted]

    # -- dedup with sole-cover protection (:381-446) ---------------------
    wl_rows = [lab_idx[a] for a in whitelisted]
    AA = D[np.ix_(wl_rows, wl_rows)]
    wl_AS = D[np.ix_(wl_rows, s_rows)]
    sample_cover = {
        s: [whitelisted[ai] for ai in range(len(whitelisted))
            if not np.isnan(wl_AS[ai, si]) and wl_AS[ai, si] <= cfg.threshold]
        for si, s in enumerate(samples)}
    kept: List[str] = []
    dropped: List[Tuple[str, str]] = []
    for ai, a in enumerate(whitelisted):
        if not kept:
            kept.append(a)
            continue
        dists = [AA[ai, whitelisted.index(k)] for k in kept]
        too_similar = any(not np.isnan(d) and d <= cfg.dedup for d in dists)
        if not too_similar:
            kept.append(a)
            continue
        covers = [s for s in samples if a in sample_cover[s]]
        sole = False
        for s in covers:
            remaining = sum(1 for k in kept if k != a and
                            k in sample_cover[s])
            if remaining < min(3, len(sample_cover[s])):
                sole = True
                break
        if sole:
            kept.append(a)
        else:
            closest = kept[int(np.nanargmin(dists))]
            dropped.append((a, closest))
    if dropped:
        with open(os.path.join(outdir, "dedup_log.csv"), "w",
                  newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["dropped_anchor", "kept_anchor"])
            w.writerows(dropped)
    whitelisted = kept

    # -- greedy Faith's PD fill (:449-531) -------------------------------
    tree = nj_tree(D, labels)
    write_newick(tree, os.path.join(outdir, "pd_subset_nj.nwk"))
    slots = max(0, cfg.subset - len(whitelisted))
    final = list(whitelisted)
    if slots > 0 and non_whitelisted:
        fixed = samples + whitelisted
        selected: List[str] = []
        remaining = list(non_whitelisted)
        while len(selected) < slots and remaining:
            best_pd, best_tip = -np.inf, None
            for cand in remaining:
                pd = faith_pd(tree, fixed + selected + [cand])
                if pd > best_pd:
                    best_pd, best_tip = pd, cand
            selected.append(best_tip)
            remaining.remove(best_tip)
        final = whitelisted + selected

    final_pd = faith_pd(tree, samples + final)
    res = AnchorFilterResult(whitelisted, non_whitelisted, divergent,
                             dropped, final, final_pd, thr_div)
    with open(os.path.join(outdir, "anchor_filter_result.csv"), "w",
              newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["anchor", "status", "divergent"])
        for a in anchors:
            status = ("final_whitelisted" if a in whitelisted and
                      a in final else
                      "final_nonwhitelisted" if a in final else
                      "dropped_dedup" if any(a == d for d, _ in dropped)
                      else "excluded")
            w.writerow([a, status, a in divergent])
    return res
