"""Reporting/wrangling equivalents of the remaining R notebooks.

  * :func:`wrangle_metadata` — Metadata_wrangling.Rmd:28-90: join manual-
    BLAST verdict CSVs with the sample-name CSV; derive final group /
    readcount / primer set by hit1/hit2 expectation preference; emit the
    names_samples_for_treenames table consumed by stage 08.
  * :func:`success_metrics` — Amplicon_visualisation.Rmd:219-276 success
    categories per sample: max-readcount-contig match, alternative-contig
    match, off-target, no contig.
  * :func:`stage_read_flow` — barcode_summary_figS2.Rmd:41-120: per-stage
    read/contig-count conservation table (the alluvial's data).

Copy of ``tpu_orc/analysis/reports.py`` (:1-112); the code is unchanged.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence


def _yes(v) -> bool:
    return str(v).strip().lower() == "y"


def wrangle_metadata(blast_rows: Sequence[Dict], name_rows: Sequence[Dict],
                     out_csv: Optional[str] = None) -> List[Dict]:
    """blast_rows columns (per manual-BLAST CSV): plate, SP27, SP5,
    barcode, max_readcount_group, max_readcount, hit1_expect,
    hit1_primer_set, hit2_group, hit2_readcount, hit2_expect,
    final_expect. name_rows columns: plate, sample, barcode, new_code,
    expected_taxon."""
    out = []
    names = {}
    for r in name_rows:
        barcode = "COI" if r.get("barcode") == "CO1" else r.get("barcode")
        key = (f"{r.get('sample')}_{r.get('plate')}", barcode)
        nm = (r.get("new_code") or "").replace("cf. ", "").replace(
            "aff. ", "").replace(" ", "_")
        names[key] = (nm, r.get("expected_taxon"))
    for r in blast_rows:
        barcode = "COI" if r.get("barcode") == "CO1" else r.get("barcode")
        if _yes(r.get("hit1_expect")):
            grp, rc = r.get("max_readcount_group"), r.get("max_readcount")
            pset = r.get("hit1_primer_set")
        elif _yes(r.get("hit2_expect")):
            grp, rc = r.get("hit2_group"), r.get("hit2_readcount")
            pset = r.get("hit2_primer_set")
        else:
            grp, rc = r.get("max_readcount_group"), r.get("max_readcount")
            pset = None
        adapter = (f"SP27_{int(r['SP27']):03d}_SP5_{int(r['SP5']):03d}"
                   if r.get("SP27") and r.get("SP5") else "")
        sample = f"{adapter}_{r.get('plate')}"
        if not _yes(r.get("final_expect")):
            continue
        nm, taxon = names.get((sample, barcode), (None, None))
        if nm is None:
            continue
        out.append({
            "sample": sample,
            "barcode": barcode,
            "fasta_headers": f"{sample}_pass_group{grp}_readcount_{rc}",
            "expected_taxon": taxon,
            "name": nm,
            "final_primer_set": pset,
        })
    if out_csv and out:
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)),
                    exist_ok=True)
        with open(out_csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, list(out[0].keys()))
            w.writeheader()
            w.writerows(out)
    return out


def success_metrics(rows: Sequence[Dict]) -> Dict[str, int]:
    """Categorise each manual-BLAST row (Amplicon_visualisation.Rmd
    success_metric): MRC_match (hit1 expected), AC_match (hit2 expected),
    off_target (contig found, neither expected), no_contig."""
    counts = {"MRC_match": 0, "AC_match": 0, "off_target": 0,
              "no_contig": 0}
    for r in rows:
        if not r.get("max_readcount_group"):
            counts["no_contig"] += 1
        elif _yes(r.get("hit1_expect")):
            counts["MRC_match"] += 1
        elif _yes(r.get("hit2_expect")):
            counts["AC_match"] += 1
        else:
            counts["off_target"] += 1
    return counts


def stage_read_flow(stage_counts: Dict[str, Dict[str, int]],
                    out_tsv: Optional[str] = None) -> List[Dict]:
    """stage_counts: {stage_name: {sample: n_reads}}. Produces the
    long-format per-stage table used for the alluvial read-conservation
    figure (stages ordered as given)."""
    rows = []
    stages = list(stage_counts.keys())
    samples = sorted({s for d in stage_counts.values() for s in d})
    for sample in samples:
        for st in stages:
            rows.append({"sample": sample, "stage": st,
                         "reads": stage_counts[st].get(sample, 0)})
    if out_tsv:
        with open(out_tsv, "w", newline="") as fh:
            w = csv.DictWriter(fh, ["sample", "stage", "reads"],
                               delimiter="\t")
            w.writeheader()
            w.writerows(rows)
    return rows
