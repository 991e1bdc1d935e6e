"""Primer cleanup with linked-adapter semantics + residual-primer failsafe.

Copy of ``tpu_orc/demux/primer_clean.py``; the device seam: the FRONT/
BACK locates reach ``demux.py`` of this package, and the primer banks
are built on the torch ``device`` the caller names.

Replaces the reference pipeline's scripts/04_cleaning_primers.sh:

  Round 1 (:366-392): cutadapt -g FWD_A...REV_A -g FWD_B...REV_B
      --untrimmed-output U -o P  (linked trim; both primers required)
  Failsafe (:395-455): seqkit subseq 1:100 / -100:-1 + seqkit locate -d
      --pattern-file (degenerate exact match, both strands); any contig
      with a residual primer hit in its terminal 100 bp is DROPPED
      (seqkit grep -v).
  Round 2 (:463-522, optional): unlinked -g FWD / -a REV on the untrimmed
      set.

Primer pairing follows the reference's FASTA header convention
(:184-359): headers like ``>jgLCO1490|Moorea_Forward_A`` — the trailing
``_A``/``_B`` selects the pair, ``Forward``/``Reverse`` the side; a
``Reverse_A_B`` header contributes to both pairs.

Linked-match semantics: FWD located with FRONT rules, REV with BACK rules
in the post-FWD remainder, both required (non-anchored -g linked
adapters); pair selection = most FWD matches, first pair wins ties.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_orc.align.spec import FRONT, BACK
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record, read_fasta, write_records

from .adapters import AdapterBank
from .demux import assign_reads, _best_per_read, locate_batch


@dataclass
class PrimerPair:
    pair_id: str
    fwd: str
    rev: str


def parse_primer_pairs(fasta_path: str) -> List[PrimerPair]:
    fwd: Dict[str, str] = {}
    rev: Dict[str, str] = {}
    for rec in read_fasta(fasta_path):
        header = rec.desc
        ids = re.findall(r"_([A-Z])(?=_|$)", header)
        side = ("Forward" if "Forward" in header
                else "Reverse" if "Reverse" in header else None)
        if side is None or not ids:
            continue
        for pid in ids:
            (fwd if side == "Forward" else rev)[pid] = rec.seq.upper()
    pairs = []
    for pid in sorted(set(fwd) & set(rev)):
        pairs.append(PrimerPair(pid, fwd[pid], rev[pid]))
    return pairs


@dataclass
class CleanReport:
    total: int = 0
    trimmed: int = 0
    untrimmed: int = 0
    failsafe_dropped: int = 0
    round2_trimmed: int = 0
    dropped_ids: List[str] = field(default_factory=list)


def linked_trim(records: Sequence[Record], pairs: Sequence[PrimerPair],
                e: float = 0.1, match_read_wildcards: bool = False,
                device: str = "cpu"
                ) -> Tuple[List[Record], List[Record]]:
    """Round-1 linked trimming. Returns (trimmed, untrimmed).

    match_read_wildcards: IUPAC codes in the contig (e.g. from -amb
    consensus) match their base set (cutadapt --match-read-wildcards)."""
    if not records:
        return [], []
    enc = (encode.encode_read_masks_iupac if match_read_wildcards
           else encode.encode_read_masks)
    fwd_bank = AdapterBank.from_pairs(
        [(p.pair_id, p.fwd) for p in pairs], e, device)
    recs = list(records)
    res = locate_batch(fwd_bank, [r.seq.upper() for r in recs], FRONT,
                       encoder=enc)
    f_idx, f_m, f_qs, f_qe, _ = _best_per_read(res)
    trimmed: List[Record] = []
    untrimmed: List[Record] = []
    # group by chosen pair for the REV round
    by_pair: Dict[int, List[Tuple[int, Record, int]]] = {}
    for k, r in enumerate(recs):
        if f_idx[k] < 0:
            untrimmed.append(r)
        else:
            by_pair.setdefault(int(f_idx[k]), []).append(
                (k, r, int(f_qe[k])))
    for pi, items in sorted(by_pair.items()):
        rev_bank = AdapterBank.from_pairs(
            [(pairs[pi].pair_id, pairs[pi].rev)], e, device)
        mids = [r.seq.upper()[cut:] for _, r, cut in items]
        rres = locate_batch(rev_bank, mids, BACK, encoder=enc)
        r_idx, r_m, r_qs, r_qe, _ = _best_per_read(rres)
        for (k, r, cut), ok, qs in zip(items, r_idx, r_qs):
            if ok < 0:
                untrimmed.append(r)
            else:
                seq = r.seq[cut:cut + int(qs)]
                qual = r.qual[cut:cut + int(qs)] if r.qual else None
                trimmed.append(Record(r.id, r.desc, seq, qual))
    return trimmed, untrimmed


def _iupac_exact_hits(seq_masks: np.ndarray, primer_masks: np.ndarray) -> bool:
    """Degenerate exact occurrence (seqkit locate -d semantics)."""
    n, m = len(seq_masks), len(primer_masks)
    if m > n:
        return False
    # sliding window: all positions must intersect
    for off in range(n - m + 1):
        if np.all(seq_masks[off:off + m] & primer_masks):
            return True
    return False


def residual_primer_failsafe(records: Sequence[Record],
                             primer_seqs: Sequence[str],
                             window: int = 100,
                             match_read_wildcards: bool = False
                             ) -> Tuple[List[Record], List[str]]:
    """Drop any contig with a degenerate-exact primer hit (either strand)
    within its first/last ``window`` bp (04_cleaning_primers.sh:395-455)."""
    enc = (encode.encode_read_masks_iupac if match_read_wildcards
           else encode.encode_read_masks)
    pm = []
    for p in primer_seqs:
        pm.append(encode.encode_ref_masks(p.upper()))
        pm.append(encode.encode_ref_masks(encode.revcomp(p.upper())))
    clean, dropped = [], []
    for r in records:
        s = r.seq.upper()
        ends = [s[:window], s[-window:]] if len(s) > window else [s]
        sm = [enc(e_) for e_ in ends]
        hit = any(_iupac_exact_hits(m, p) for m in sm for p in pm)
        if hit:
            dropped.append(r.id)
        else:
            clean.append(r)
    return clean, dropped


def unlinked_round2(records: Sequence[Record], pairs: Sequence[PrimerPair],
                    e: float = 0.1, match_read_wildcards: bool = False,
                    device: str = "cpu"
                    ) -> Tuple[List[Record], int]:
    """Round 2 (:463-508): independent -g FWD and -a REV trims; neither
    required. Returns (records, n_modified)."""
    if not records:
        return [], 0
    enc = (encode.encode_read_masks_iupac if match_read_wildcards
           else encode.encode_read_masks)
    fwd_bank = AdapterBank.from_pairs(
        [(p.pair_id, p.fwd) for p in pairs], e, device)
    rev_bank = AdapterBank.from_pairs(
        [(p.pair_id, p.rev) for p in pairs], e, device)
    out = []
    n_mod = 0
    a1 = assign_reads(list(records), fwd_bank, "front", rc=False,
                      encoder=enc)
    a2 = assign_reads([a.trimmed for a in a1], rev_bank, "back", rc=False,
                      encoder=enc)
    for orig, s1, s2 in zip(records, a1, a2):
        rec = s2.trimmed
        if s1.adapter is not None or s2.adapter is not None:
            n_mod += 1
        out.append(Record(orig.id, orig.desc, rec.seq, rec.qual))
    return out, n_mod


def clean_primers(records: Sequence[Record], r1_primer_fasta: str,
                  r2_primer_fasta: Optional[str] = None,
                  outdir: Optional[str] = None, name: str = "sample",
                  e: float = 0.1, do_round2: bool = True,
                  match_read_wildcards: bool = False,
                  device: str = "cpu"
                  ) -> Tuple[List[Record], CleanReport]:
    """Full stage-04 pipeline for one sample's consensus FASTA.

    match_read_wildcards: enable when the consensus was called with -amb
    (IUPAC ambiguity codes) so primers still match over ambiguous bases
    at the same e=0.1 budget (cutadapt --match-read-wildcards)."""
    pairs = parse_primer_pairs(r1_primer_fasta)
    if not pairs:
        raise ValueError(f"no Forward/Reverse primer pairs in "
                         f"{r1_primer_fasta}")
    rep = CleanReport(total=len(records))
    mrw = match_read_wildcards
    trimmed, untrimmed = linked_trim(records, pairs, e,
                                     match_read_wildcards=mrw,
                                     device=device)
    rep.trimmed, rep.untrimmed = len(trimmed), len(untrimmed)
    all_primers = [p.fwd for p in pairs] + [p.rev for p in pairs]
    if r2_primer_fasta:
        for p2 in parse_primer_pairs(r2_primer_fasta):
            all_primers += [p2.fwd, p2.rev]
    clean, dropped = residual_primer_failsafe(trimmed, all_primers,
                                              match_read_wildcards=mrw)
    rep.failsafe_dropped = len(dropped)
    rep.dropped_ids = dropped
    if do_round2 and untrimmed:
        r2, n_mod = unlinked_round2(untrimmed, pairs, e,
                                    match_read_wildcards=mrw,
                                    device=device)
        rep.round2_trimmed = n_mod
    else:
        r2 = []
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        write_records(os.path.join(outdir, f"cleaned_{name}.fasta"),
                      clean, fmt="fasta")
        write_records(os.path.join(outdir, f"untrimmed_{name}.fasta"),
                      untrimmed, fmt="fasta")
        if r2:
            write_records(os.path.join(outdir, f"round2_{name}.fasta"),
                          r2, fmt="fasta")
    return clean, rep
