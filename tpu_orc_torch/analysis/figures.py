"""NanoPlot-style figures of stage 00.

Copy of the part of ``tpu_orc/analysis/figures.py`` that
``pipeline/qc.py::write_stats`` reaches: ``_ax`` and ``_save`` (:28-41),
``plot_length_histogram`` (:141) and ``plot_length_vs_quality`` (:152);
the code is unchanged. The notebook figures of that module belong to CLI
subcommands that are not ported. Matplotlib (Agg) is imported when a
figure is drawn; ``write_stats`` skips the figures where it is absent.
"""
from __future__ import annotations

import os
from typing import Sequence


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
