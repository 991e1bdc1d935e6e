"""Cluster result writers (amplicon_sorter filter_seq equivalent).

Copy of ``tpu_orc/cluster/output.py``; only the imports change (its
``SortResult`` is this package's engine's).

Reproduces the output contract of amplicon_sorter.py:1463-1626,2089-2098:
  <stem>_<gene>_<k>.fasta          member reads + '>consensus' per species
  <stem>_consensussequences.fasta  all consensuses for the input file
  consensusfile.fasta              run-level, headers
                                   >consensus_<stem>_<gene>_<k>(<nreads>)
  results.csv / results.txt        per-group read counts + parameters
  <stem>_nogroup.fasta             unassigned reads
plus the 03_amplicon_sorter.sh:183-215 post-step: a
<barcode>_consensus_<prefix>.fasta with `_group<N>_readcount_<M>` headers.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

from tpu_orc.io.fastq import Record, write_records

from .engine import SortResult


def write_sort_outputs(result: SortResult, records: Sequence[Record],
                       outdir: str, stem: str,
                       params: Dict | None = None,
                       save_fastq: bool = False,
                       compressed: bool = False,
                       alignment: bool = False) -> Dict[str, str]:
    """Write all reference-layout outputs; returns path map.

    save_fastq: also write per-group .fastq with original quality
    strings (amplicon_sorter -sfq); compressed: gzip every group file
    (-c); alignment: per-group <tag>_alignment.fasta with the star
    alignment used for the consensus (-aln, amplicon_sorter.py:175-176
    — NOTE the reference's own file write at :429-441 is commented-out
    dead code, so this output is a working superset: '>consensus' row
    first, then one gapped row per member read)."""
    os.makedirs(outdir, exist_ok=True)
    gz = ".gz" if compressed else ""
    paths: Dict[str, str] = {}
    consensus_records: List[Record] = []
    run_consensus: List[Record] = []
    rows = []
    if not result.skipped:
        for gi, species in enumerate(result.species):
            for ki, grp in enumerate(species):
                tag = f"{stem}_{gi}_{ki}"
                members = [records[i] for i in grp.members]
                out = [Record(r.id, r.desc, r.seq, r.qual) for r in members]
                out.append(Record("consensus", "consensus", grp.consensus))
                p = os.path.join(outdir, f"{tag}.fasta{gz}")
                write_records(p, out, fmt="fasta")
                paths[tag] = p
                if save_fastq and any(r.qual for r in members):
                    pq = os.path.join(outdir, f"{tag}.fastq{gz}")
                    write_records(pq, [r for r in members if r.qual],
                                  fmt="fastq")
                    paths[tag + ".fastq"] = pq
                if alignment:
                    pa = os.path.join(outdir, f"{tag}_alignment.fasta")
                    _write_alignment(pa, grp.consensus, members)
                    paths[tag + "_alignment"] = pa
                consensus_records.append(
                    Record(tag, f"{tag}({len(grp.members)})",
                           grp.consensus))
                run_consensus.append(Record(
                    f"consensus_{tag}",
                    f"consensus_{tag}({len(grp.members)})",
                    grp.consensus))
                rows.append({"gene_group": gi, "species_group": ki,
                             "reads": len(grp.members),
                             "consensus_len": len(grp.consensus)})
        if result.nogroup:
            p = os.path.join(outdir, f"{stem}_nogroup.fasta")
            write_records(p, [records[i] for i in result.nogroup],
                          fmt="fasta")
            paths["nogroup"] = p
    p = os.path.join(outdir, f"{stem}_consensussequences.fasta")
    write_records(p, consensus_records, fmt="fasta")
    paths["consensussequences"] = p
    p = os.path.join(outdir, "consensusfile.fasta")
    write_records(p, run_consensus, fmt="fasta")
    paths["consensusfile"] = p

    # results.csv: the reference's matrix layout (amplicon_sorter.py:
    # 1574-1579, 2061-2067, 2171-2177) — one column per input file
    # (header ', <file>'), a 'Total, <used_reads>' row, then one
    # '<consensusname>, <readcount>' row per species group.
    with open(os.path.join(outdir, "results.csv"), "w") as fh:
        fh.write(f", {stem}\n")
        fh.write(f"Total, {result.n_reads}\n")
        for r, rc in zip(rows, run_consensus):
            fh.write(f"{rc.id.replace('consensus_', '')}, {r['reads']}\n")
    # richer per-group table kept alongside
    with open(os.path.join(outdir, "results_detail.csv"), "w",
              newline="") as fh:
        w = csv.DictWriter(fh, ["gene_group", "species_group", "reads",
                                "consensus_len"])
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(outdir, "results.txt"), "w") as fh:
        fh.write(f"input: {stem}\nreads: {result.n_reads}\n"
                 f"skipped: {result.skipped}\nssg: {result.ssg}\n"
                 f"pairs_scored: {result.pairs_scored}\n")
        for pkey, pval in (params or {}).items():
            fh.write(f"{pkey}: {pval}\n")
        for r in rows:
            fh.write(f"gene {r['gene_group']} species {r['species_group']}"
                     f": {r['reads']} reads, consensus "
                     f"{r['consensus_len']} bp\n")
    return paths


def _write_alignment(path: str, consensus: str,
                     members: Sequence[Record]) -> None:
    """Star-alignment FASTA of one species group (-aln): row 0 the
    consensus, then each member read gapped into the consensus's merged
    column space (cluster/consensus._align_rows semantics)."""
    import numpy as np

    from tpu_orc.cluster.consensus import GAP, _align_rows
    from tpu_orc.io import encode
    codes = [encode.encode_codes(r.seq.upper()) for r in members]
    aln = _align_rows(encode.encode_codes(consensus.upper()), codes)
    sym = np.array(list("ACGTN"), dtype="<U1")

    def row_str(row):
        out = np.full(len(row), "-", dtype="<U1")
        keep = row != GAP
        out[keep] = sym[np.minimum(row[keep], 4)]
        return "".join(out)

    with open(path, "w") as fh:
        fh.write(f">consensus\n{row_str(aln[0])}\n")
        for r, row in zip(members, aln[1:]):
            fh.write(f">{r.id}\n{row_str(row)}\n")


def write_barcode_consensus(result: SortResult, outdir: str, barcode: str,
                            prefix: str) -> str:
    """03_amplicon_sorter.sh:183-215 header rewrite:
    <barcode>_consensus_<prefix>.fasta with
    >{barcode}_group{N}_readcount_{M} headers (group counter is global
    across gene groups, 1-based)."""
    os.makedirs(outdir, exist_ok=True)
    out = []
    n = 0
    if not result.skipped:
        for species in result.species:
            for grp in species:
                n += 1
                h = f"{barcode}_group{n}_readcount_{len(grp.members)}"
                out.append(Record(h, h, grp.consensus))
    p = os.path.join(outdir, f"{barcode}_consensus_{prefix}.fasta")
    write_records(p, out, fmt="fasta")
    return p
