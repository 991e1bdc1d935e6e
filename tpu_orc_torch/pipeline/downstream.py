"""Downstream identification / tree-prep stages (06-09 equivalents).

  * BLAST batching + top-5-by-evalue filter (06_BLASTing.sh:36-71). The
    blastn invocation itself needs the external NCBI nt DB (optional per
    README.md:55) — invoked when a ``blastn`` binary + db are available,
    otherwise the caller supplies a result TSV and only the filter runs.
  * gene-fetch anchor download (07_*.sh) — network tool, CLI-compatible
    stub that records the request (zero-egress environment).
  * Barcode-per-taxon reorganisation (08_reorganise_barcodes_per_taxon.sh
    :37-117): curated CSV -> wanted headers -> filter + rename + split
    into trees/<taxon>/<gene>.fasta.
  * Anchor-selection prep (09_prep_for_anchor_selection.sh:20-45): header
    sanitisation + label,type metadata CSV.

Copy of ``tpu_orc/pipeline/downstream.py`` (:1-189); the code is unchanged. BLAST and
gene-fetch stay hooks, as there.
"""
from __future__ import annotations

import csv
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

from ..io.fastq import Record, read_fasta, write_records


# ---------------------------------------------------------------------------
# Stage 06: BLAST batching + top-5 filter
# ---------------------------------------------------------------------------

def concat_gene_fastas(dataset_dir: str, gene: str, out_path: str) -> int:
    """find <dataset>/<gene> -mindepth 2 -maxdepth 2 -name '*.fa*' | cat
    (06_BLASTing.sh:36-45). Returns number of records written."""
    n = 0
    recs: List[Record] = []
    base = os.path.join(dataset_dir, gene)
    for sub in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        subdir = os.path.join(base, sub)
        if not os.path.isdir(subdir):
            continue
        for fn in sorted(os.listdir(subdir)):
            if fn.endswith((".fa", ".fasta")):
                recs.extend(read_fasta(os.path.join(subdir, fn)))
    n = len(recs)
    write_records(out_path, recs, fmt="fasta")
    return n


def blast_top5_filter(in_tsv: str, out_tsv: str, k: int = 5) -> int:
    """sort -k1,1 -k4,4g | awk 'count<=5 per qseqid'
    (06_BLASTing.sh:69-71). Column 4 (1-based) is evalue."""
    rows = []
    with open(in_tsv) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            f = line.split("\t")
            rows.append(f)
    rows.sort(key=lambda f: (f[0], float(f[3])))
    out = []
    prev = None
    count = 0
    for f in rows:
        if f[0] != prev:
            prev, count = f[0], 0
        count += 1
        if count <= k:
            out.append(f)
    with open(out_tsv, "w") as fh:
        for f in out:
            fh.write("\t".join(f) + "\n")
    return len(out)


def run_blastn(query_fasta: str, out_tsv: str, db: str,
               max_target_seqs: int = 500, threads: int = 2) -> bool:
    """External blastn (C++/NCBI) when present; returns False otherwise."""
    exe = shutil.which("blastn")
    if exe is None:
        return False
    cmd = [exe, "-max_target_seqs", str(max_target_seqs), "-out", out_tsv,
           "-outfmt", "6 qseqid qlen sseqid evalue bitscore pident staxids",
           "-db", db, "-num_threads", str(threads), "-query", query_fasta]
    subprocess.run(cmd, check=True)
    return True


# ---------------------------------------------------------------------------
# Stage 07: anchor-fetch stub (network OOS)
# ---------------------------------------------------------------------------

def gene_fetch_stub(gene: str, taxid: str, outdir: str,
                    max_sequences: int = 5000) -> str:
    """Zero-egress stand-in for gene-fetch: records the request so a user
    with network access can fulfil it; returns the request file path."""
    os.makedirs(outdir, exist_ok=True)
    p = os.path.join(outdir, f"gene_fetch_request_{gene}_{taxid}.txt")
    with open(p, "w") as fh:
        fh.write(f"gene-fetch --gene {gene} -s {taxid} "
                 f"--max-sequences {max_sequences}\n"
                 "# network disabled in this environment; run externally\n")
    return p


# ---------------------------------------------------------------------------
# Stage 08: reorganise barcodes per taxon
# ---------------------------------------------------------------------------

def _strip_header(h: str) -> str:
    """Reference awk normalisation (08:88-90): drop ':<digit>...' suffix,
    the '<gene>_rRNA::' prefix and the 'consensus_' prefix."""
    h = re.sub(r":[0-9].*$", "", h)
    h = re.sub(r"^[^:]*::", "", h)
    h = re.sub(r"^consensus_", "", h)
    return h


def reorganise_barcodes(csv_path: str, fastas: Dict[str, str],
                        outdir: str) -> Dict[str, int]:
    """08_reorganise_barcodes_per_taxon.sh:37-117.

    CSV columns (1-based, as in the reference awk): 1=sample (…_dataset),
    2=fasta_header, 3=barcode/gene (18S|28S|COI), 4=expected_taxon,
    5=name. Output: trees/<taxon>/<gene>.fasta with headers
    name|adapter|dataset.
    """
    lookup: Dict[Tuple[str, str], Tuple[str, str]] = {}
    with open(csv_path) as fh:
        rdr = csv.reader(fh)
        next(rdr, None)  # header
        for f in rdr:
            if len(f) < 5:
                continue
            sample, fasta_header, gene, taxon, name = (
                f[0].strip(), f[1].strip(), f[2].strip(), f[3].strip(),
                f[4].strip())
            parts = sample.split("_")
            dataset = parts[-1]
            adapter = "_".join(parts[:-1])
            lookup[(gene, fasta_header)] = (f"{name}|{adapter}|{dataset}",
                                            taxon)
    counts: Dict[str, int] = {}
    for gene, fasta in fastas.items():
        if not os.path.exists(fasta):
            continue
        for rec in read_fasta(fasta):
            key = (gene, _strip_header(rec.desc))
            if key not in lookup:
                continue
            new_header, taxon = lookup[key]
            tdir = os.path.join(outdir, "trees", taxon)
            os.makedirs(tdir, exist_ok=True)
            with open(os.path.join(tdir, f"{gene}.fasta"), "a") as fh:
                fh.write(f">{new_header}\n{rec.seq}\n")
            counts[f"{taxon}/{gene}"] = counts.get(f"{taxon}/{gene}", 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Stage 09: anchor-selection prep
# ---------------------------------------------------------------------------

def sanitize_header(h: str) -> str:
    return re.sub(r"[^A-Za-z0-9._]", "_", h)


def prep_anchor_selection(aligned_fasta: str, samples_fasta: str,
                          gene: str, outdir: Optional[str] = None
                          ) -> Tuple[str, str]:
    """09_prep_for_anchor_selection.sh:20-45: sanitise headers, write
    <gene>_cleaned.fa + <gene>_metadata.csv (label,type in
    {sample, anchor})."""
    outdir = outdir or os.path.join(os.path.dirname(aligned_fasta), gene)
    os.makedirs(outdir, exist_ok=True)
    clean_path = os.path.join(outdir, f"{gene}_cleaned.fa")
    recs = []
    for r in read_fasta(aligned_fasta):
        h = sanitize_header(r.desc)
        recs.append(Record(h, h, r.seq))
    write_records(clean_path, recs, fmt="fasta")
    sample_ids = {sanitize_header(r.desc) for r in read_fasta(samples_fasta)}
    meta_path = os.path.join(outdir, f"{gene}_metadata.csv")
    with open(meta_path, "w") as fh:
        fh.write("label,type\n")
        for r in recs:
            t = "sample" if r.desc in sample_ids else "anchor"
            fh.write(f"{r.desc},{t}\n")
    return clean_path, meta_path
