"""Per-plate amplicon summary (amplicon_summary.R equivalent).

Replaces scripts/auxiliary_code/amplicon_summary.R:84-259: for each
barcode's consensus FASTA, report whether an amplicon was found, how many
contigs, and the best hit by readcount; back-fill the full expected
12 x 8 = 96 barcode grid with ``amplicon_found=no`` rows (:208-244) —
the pipeline's completeness oracle (SURVEY.md §4).

Copy of ``tpu_orc/pipeline/summary.py``; the code is unchanged.
"""
from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence

from ..io.fastq import read_fasta
from .extractors import get_readcount

BARCODE_RE = re.compile(r"(SP27_\d+)_(SP5_\d+)")


def expected_barcodes(n_sp5: int = 12, n_sp27: int = 8) -> List[str]:
    """The 96-well grid: 12 SP5 x SP27 001..008 (02_cutadapt_loop.sh:114)."""
    out = []
    for s27 in range(1, n_sp27 + 1):
        for s5 in range(1, n_sp5 + 1):
            out.append(f"SP27_{s27:03d}_SP5_{s5:03d}")
    return out


def summarize_barcode_dir(indir: str, out_tsv: str,
                          expected: Optional[Sequence[str]] = None,
                          pattern: str = "*_consensus_*.fasta") -> List[Dict]:
    """Scan per-barcode consensus FASTAs under ``indir``; one row per
    expected barcode."""
    import glob as _glob
    rows: Dict[str, Dict] = {}
    for path in sorted(_glob.glob(os.path.join(indir, "**", pattern),
                                  recursive=True)):
        base = os.path.basename(path)
        m = BARCODE_RE.search(base)
        barcode = m.group(0) if m else os.path.splitext(base)[0]
        recs = list(read_fasta(path))
        if not recs:
            rows[barcode] = dict(sample=barcode, amplicon_found="no",
                                 num_hits=0, best_hit_readcount=0,
                                 best_hit_header="")
            continue
        best = max(recs, key=lambda r: get_readcount(r.desc))
        rows[barcode] = dict(sample=barcode, amplicon_found="yes",
                             num_hits=len(recs),
                             best_hit_readcount=get_readcount(best.desc),
                             best_hit_header=best.desc)
    grid = list(expected) if expected is not None else expected_barcodes()
    for bc in grid:
        if bc not in rows:
            rows[bc] = dict(sample=bc, amplicon_found="no", num_hits=0,
                            best_hit_readcount=0, best_hit_header="")
    ordered = [rows[bc] for bc in grid] + [
        rows[k] for k in sorted(rows) if k not in set(grid)]
    os.makedirs(os.path.dirname(os.path.abspath(out_tsv)), exist_ok=True)
    with open(out_tsv, "w", newline="") as fh:
        w = csv.DictWriter(fh, ["sample", "amplicon_found", "num_hits",
                                "best_hit_readcount", "best_hit_header"],
                           delimiter="\t")
        w.writeheader()
        w.writerows(ordered)
    return ordered
