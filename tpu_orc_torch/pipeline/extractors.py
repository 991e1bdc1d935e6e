"""Max-readcount extractors (auxiliary_code equivalents).

Replaces:
  * ribo_maxread_extractor.py (:26-94,172-269): walk per-sample 18S/28S
    FASTAs, pick the record with the highest ``readcount_N`` per file,
    append to consolidated <gene>_max_readcount.fa + a log.
  * CO1_splitter_maxread_extractor.py (:66-115,207-298): same for COI but
    length-split first: >=600 bp -> moorea.fa (Moorea primer set),
    <350 bp -> sauron.fa (Sauron set), 350-599 bp discarded.

Copy of ``tpu_orc/pipeline/extractors.py`` (:1-112); the code is unchanged.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..io.fastq import Record, read_fasta, write_records

_READCOUNT = re.compile(r"readcount_(\d+)")


def get_readcount(header: str) -> int:
    """readcount from a ``..._readcount_N`` header; 0 if absent
    (ribo_maxread_extractor.py:26-41)."""
    m = _READCOUNT.search(header)
    return int(m.group(1)) if m else 0


def find_max_readcount_entry(records: Sequence[Record]) -> Optional[Record]:
    best = None
    best_rc = -1
    for r in records:
        rc = get_readcount(r.desc)
        if rc > best_rc:  # strict: first max wins ties, as in the reference
            best, best_rc = r, rc
    return best


def extract_ribo_max(indir: str, outdir: str,
                     genes=("18S", "28S")) -> Dict[str, List[Record]]:
    """Walk <indir>/*/ for per-sample <gene> FASTAs; consolidate the max-
    readcount record per file into <gene>_max_readcount.fa + log."""
    os.makedirs(outdir, exist_ok=True)
    out: Dict[str, List[Record]] = {g: [] for g in genes}
    log_lines = []
    for root, _dirs, files in sorted(os.walk(indir)):
        for fn in sorted(files):
            for gene in genes:
                if f"_{gene}" in fn and fn.endswith((".fa", ".fasta")):
                    recs = list(read_fasta(os.path.join(root, fn)))
                    best = find_max_readcount_entry(recs)
                    if best is not None:
                        out[gene].append(best)
                        log_lines.append(
                            f"{fn}\t{gene}\t{best.id}\t"
                            f"{get_readcount(best.desc)}")
                    else:
                        log_lines.append(f"{fn}\t{gene}\tNO_ENTRIES\t0")
    for gene in genes:
        write_records(os.path.join(outdir, f"{gene}_max_readcount.fa"),
                      out[gene], fmt="fasta")
    with open(os.path.join(outdir, "extraction_log.tsv"), "w") as fh:
        fh.write("file\tgene\trecord\treadcount\n")
        fh.write("\n".join(log_lines) + ("\n" if log_lines else ""))
    return out


def categorize_by_length(records: Sequence[Record],
                         moorea_min: int = 600, sauron_max: int = 350
                         ) -> Tuple[List[Record], List[Record], List[Record]]:
    """COI length split (CO1_splitter...py:66-89): >=600 -> moorea,
    <350 -> sauron, [350, 600) discarded."""
    moorea, sauron, discarded = [], [], []
    for r in records:
        n = len(r.seq)
        if n >= moorea_min:
            moorea.append(r)
        elif n < sauron_max:
            sauron.append(r)
        else:
            discarded.append(r)
    return moorea, sauron, discarded


def extract_coi_max(indir: str, outdir: str) -> Dict[str, List[Record]]:
    """Per COI FASTA file: length-split then take the max-readcount entry
    of each category; consolidate into moorea.fa / sauron.fa + log."""
    os.makedirs(outdir, exist_ok=True)
    out: Dict[str, List[Record]] = {"moorea": [], "sauron": []}
    log_lines = []
    for root, _dirs, files in sorted(os.walk(indir)):
        for fn in sorted(files):
            if "_COI" in fn and fn.endswith((".fa", ".fasta")):
                recs = list(read_fasta(os.path.join(root, fn)))
                moorea, sauron, discarded = categorize_by_length(recs)
                for cat, lst in (("moorea", moorea), ("sauron", sauron)):
                    best = find_max_readcount_entry(lst)
                    if best is not None:
                        out[cat].append(best)
                        log_lines.append(
                            f"{fn}\t{cat}\t{best.id}\t"
                            f"{get_readcount(best.desc)}")
                if discarded:
                    log_lines.append(
                        f"{fn}\tdiscarded_350_599\t{len(discarded)}\t-")
    for cat in ("moorea", "sauron"):
        write_records(os.path.join(outdir, f"{cat}.fa"), out[cat],
                      fmt="fasta")
    with open(os.path.join(outdir, "coi_extraction_log.tsv"), "w") as fh:
        fh.write("file\tcategory\trecord\treadcount\n")
        fh.write("\n".join(log_lines) + ("\n" if log_lines else ""))
    return out
