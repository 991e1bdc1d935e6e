"""BLAST LCA analysis (BLAST_LCA_amplicons.Rmd equivalent).

Replaces R_analysis/BLAST_LCA_amplicons.Rmd:77-221 without the taxonomizr
SQLite dependency: the caller supplies a taxonomy table mapping taxid ->
lineage (domain..species). Implements:

  * top-5 BLAST TSV parsing (outfmt "6 qseqid qlen sseqid evalue bitscore
    pident staxids");
  * metadata derivation from contig headers (:95-119): readcount regex,
    SP27_xxx_SP5_yyy sample id, gene from header, primer set from length
    (COI <=499 -> Sauron, >=500 -> Moorea; 28S <=2499 -> 18S+, >=2500 ->
    28S_solo; 18S -> 18S+);
  * per-qseqid LCA across domain->phylum->...->species: the deepest rank
    on which all hits agree (:151-178) and the matching_rank (:180-201).

Copy of ``tpu_orc/analysis/lca.py`` (:1-134); the code is unchanged.
"""
from __future__ import annotations

import csv
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

RANKS = ["domain", "phylum", "class", "order", "family", "genus",
         "species"]

_READCOUNT = re.compile(r"readcount_([0-9]+)")
_SAMPLE = re.compile(r"SP27_[0-9]+_SP5_[0-9]+")


@dataclass
class BlastHit:
    qseqid: str
    qlen: int
    sseqid: str
    evalue: float
    bitscore: float
    pident: float
    staxids: str

    @property
    def first_taxid(self) -> Optional[str]:
        return self.staxids.split(";")[0] if self.staxids else None


def read_blast_tsv(path: str) -> List[BlastHit]:
    out = []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 7:
                continue
            out.append(BlastHit(f[0], int(f[1]), f[2], float(f[3]),
                                float(f[4]), float(f[5]), f[6]))
    return out


def read_taxonomy_table(path: str) -> Dict[str, Dict[str, str]]:
    """TSV/CSV with columns: taxid, domain, phylum, class, order, family,
    genus, species (the flat equivalent of the taxonomizr lineage join)."""
    out: Dict[str, Dict[str, str]] = {}
    delim = "\t" if path.endswith((".tsv", ".txt")) else ","
    with open(path) as fh:
        rdr = csv.DictReader(fh, delimiter=delim)
        for row in rdr:
            out[str(row["taxid"]).strip()] = {
                r: (row.get(r) or "").strip() or None for r in RANKS}
    return out


def derive_metadata(qseqid: str, qlen: int) -> Dict[str, object]:
    """Header-derived fields (:95-119)."""
    m = _READCOUNT.search(qseqid)
    sm = _SAMPLE.search(qseqid)
    if "28S" in qseqid:
        gene = "28S"
        primer_set = "18S+" if qlen <= 2499 else "28S_solo"
    elif "18S" in qseqid:
        gene, primer_set = "18S", "18S+"
    else:
        gene = "COI"
        primer_set = "Sauron" if qlen <= 499 else "Moorea"
    return {
        "readcount": int(m.group(1)) if m else 0,
        "sample": sm.group(0) if sm else qseqid,
        "barcode": gene,
        "primer_set": primer_set,
    }


def compute_lca(lineages: Sequence[Dict[str, Optional[str]]]
                ) -> Dict[str, Optional[str]]:
    """Per-rank agreement: a rank contributes iff all non-missing values
    agree; the LCA is the deepest agreeing rank's value (:161-178)."""
    agreed: Dict[str, Optional[str]] = {}
    for r in RANKS:
        vals = {l.get(r) for l in lineages if l.get(r)}
        agreed[r] = vals.pop() if len(vals) == 1 else None
    lca = None
    lca_rank = None
    for r in RANKS:
        if agreed[r] is not None:
            lca, lca_rank = agreed[r], r
    return {"lca": lca, "lca_rank": lca_rank, **{f"agreed_{r}": agreed[r]
                                                 for r in RANKS}}


def lca_table(blast_tsv: str, taxonomy: Dict[str, Dict[str, str]],
              out_csv: Optional[str] = None) -> List[Dict]:
    """Full analysis: one row per qseqid with metadata + LCA."""
    hits = read_blast_tsv(blast_tsv)
    by_q: Dict[str, List[BlastHit]] = {}
    for h in hits:
        by_q.setdefault(h.qseqid, []).append(h)
    rows = []
    for q, hs in sorted(by_q.items()):
        lineages = []
        for h in hs:
            tid = h.first_taxid
            if tid and tid in taxonomy:
                lineages.append(taxonomy[tid])
        meta = derive_metadata(q, hs[0].qlen)
        lca = compute_lca(lineages) if lineages else {
            "lca": None, "lca_rank": None}
        best = min(hs, key=lambda h: h.evalue)
        rows.append({"qseqid": q, "n_hits": len(hs),
                     "best_evalue": best.evalue,
                     "best_pident": best.pident, **meta, **lca})
    if out_csv:
        keys = list(rows[0].keys()) if rows else ["qseqid"]
        with open(out_csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, keys)
            w.writeheader()
            w.writerows(rows)
    return rows
