"""Read QC statistics (NanoPlot-equivalent, stage 00).

Replaces the reference pipeline's scripts/00_nanoplot.sh:47-55 (NanoPlot
--huge --N50 --tsv_stats): computes the summary statistics NanoPlot
reports and writes the TSV stats file + a length histogram. Plot
rendering is out of scope (no display); the numbers are the QC contract.

Copy of ``tpu_orc/pipeline/qc.py``; the code is unchanged (its imports
are relative, and resolve to this package's ``io`` and ``analysis``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, asdict
from typing import Dict, Iterable, Optional

import numpy as np

from ..io.fastq import Record


@dataclass
class ReadStats:
    number_of_reads: int
    number_of_bases: int
    mean_read_length: float
    median_read_length: float
    read_length_stdev: float
    n50: int
    mean_qual: Optional[float]
    median_qual: Optional[float]
    longest_read: int
    shortest_read: int


def n50(lengths: np.ndarray) -> int:
    if len(lengths) == 0:
        return 0
    s = np.sort(lengths)[::-1]
    half = s.sum() / 2
    c = np.cumsum(s)
    return int(s[np.searchsorted(c, half)])


def compute_stats(records: Iterable[Record]) -> ReadStats:
    lengths = []
    quals = []
    for r in records:
        lengths.append(len(r.seq))
        if r.qual:
            quals.append(r.mean_q())
    L = np.array(lengths) if lengths else np.zeros(0, int)
    q = np.array(quals) if quals else None
    return ReadStats(
        number_of_reads=len(L),
        number_of_bases=int(L.sum()),
        mean_read_length=float(L.mean()) if len(L) else 0.0,
        median_read_length=float(np.median(L)) if len(L) else 0.0,
        read_length_stdev=float(L.std()) if len(L) else 0.0,
        n50=n50(L),
        mean_qual=float(q.mean()) if q is not None and len(q) else None,
        median_qual=float(np.median(q)) if q is not None and len(q) else None,
        longest_read=int(L.max()) if len(L) else 0,
        shortest_read=int(L.min()) if len(L) else 0,
    )


def write_stats(records, outdir: str, name: str) -> ReadStats:
    """NanoPlot-style output dir: <name>_nanoplot/ with NanoStats.tsv +
    length histogram TSV."""
    records = list(records)
    stats = compute_stats(records)
    d = os.path.join(outdir, f"{name}_nanoplot")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "NanoStats.tsv"), "w") as fh:
        fh.write("Metrics\tdataset\n")
        for k, v in asdict(stats).items():
            fh.write(f"{k}\t{v}\n")
    lengths = np.array([len(r.seq) for r in records]) if records else \
        np.zeros(0, int)
    hist, edges = np.histogram(lengths, bins=50) if len(lengths) else \
        (np.zeros(1, int), np.array([0, 1]))
    with open(os.path.join(d, "LengthHistogram.tsv"), "w") as fh:
        fh.write("bin_start\tbin_end\tcount\n")
        for i, c in enumerate(hist):
            fh.write(f"{edges[i]:.0f}\t{edges[i + 1]:.0f}\t{c}\n")
    # rendered NanoPlot-style figures (lengths histogram + the
    # length x mean-quality scatter) when matplotlib is available
    try:
        from ..analysis import figures as figs
        if len(lengths):
            figs.plot_length_histogram(
                lengths, os.path.join(d, "LengthHistogram.png"))
            lq = [(len(r.seq), r.mean_q()) for r in records if r.qual]
            if lq:
                figs.plot_length_vs_quality(
                    [a for a, _ in lq], [b for _, b in lq],
                    os.path.join(d, "LengthVsQuality.png"))
    except ImportError:  # plotting backend absent: TSVs remain the contract
        pass
    return stats
