"""barrnap ``-k euk --incseq``'s profile search as stage 05a defines it, in
plain PyTorch: the reference that the stage-05a cell is held against.

Written for the benchmark from the pipeline's definition
(``scripts/05a_barrnap_rRNA_extract.sh:70-98``: ``barrnap -k euk
--incseq`` on a sample's cleaned contigs, then ``seqkit grep`` of the
18S and 28S hits into ``<sample>_18S.fa`` and ``<sample>_28S.fa``) and
from the program's statement of its semantics (the docstrings of
``tpu_orc_torch/rrna/hmm.py::viterbi_host`` and ``rrna/extract.py``),
not from the program's code. It imports nothing of the program, and
reads the model file with its own reader.

1. Scores: HMMER3 stores negative natural logs; a match emission's score
   is its log-odds against a background of 0.25 a base, a transition's
   its log. '*' is a score of -1e9. An N (code 4) emits 0.
2. Plan7 local Viterbi, one position at a time over [B, K] planes in
   float64: M[k] = max(0, M[k-1] + MM[k-1], I[k-1] + IM[k-1], D[k-1] +
   DM[k-1]) + e_k (the previous position's states; node 0 has only the
   free start 0); I[k] = max(M[k] + MI[k], I[k] + II[k]); D[k] =
   max(M[k-1] + MD[k-1], D[k-1] + DD[k-1]) (the previous position's M,
   no emission), DD clamped below at -30. The D chain is resolved as a
   prefix max: D[k] = max_{k' <= k} (M[k'-1] + MD[k'-1] - S[k']) + S[k]
   with S the exclusive prefix sums of the clamped DD. The best M
   anywhere ends the hit: its score, and the first position (1-based)
   where the best is reached.
3. Both strands of every contig are scanned. A hit's start comes from a
   second scan of the reversed sequence against the profile with its
   node rows reversed (emissions and transitions alike, as the program
   reverses them): start = length - that scan's end.
4. Per gene and contig, the strand with the higher score (+ first on a
   tie) among those scoring at least ``min_score`` (50) with start <
   end. A '-' hit's interval is mapped back to the + strand and its
   sequence reverse-complemented.
5. Files: ``<name>_<gene>.fa``, one record a hit in contig order, header
   ``<gene>_rRNA::<contig>:<start>-<end>(<strand>)`` (0-based start,
   exclusive end); ``barrnap_outs/<name>_euk.gff3`` with a
   ``##gff-version 3`` line and a row a hit sorted by contig, start and
   end (1-based start, score to one decimal, ``Name=<gene>_rRNA;
   product=<gene> ribosomal RNA``), and ``<name>_euk.fa``, the hits in
   the rows' order.

The planes stay float64 on the device the check runs on (TF32 is
switched off; no matrix product is taken anyway).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG = -1e9
DD_FLOOR = -30.0
COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")
_CODE = np.full(256, 4, np.uint8)
_CODE[np.frombuffer(b"ACGTacgt", np.uint8)] = [0, 1, 2, 3, 0, 1, 2, 3]


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def codes(s: str) -> np.ndarray:
    return _CODE[np.frombuffer(s.encode("ascii"), np.uint8)]


@dataclass
class Profile:
    """``match`` [K, 4] log-odds (A C G T), ``t`` [K, 7] log transitions
    (MM MI MD IM II DM DD), float64."""
    name: str
    match: np.ndarray
    t: np.ndarray

    def reversed(self) -> "Profile":
        return Profile(self.name, self.match[::-1].copy(), self.t[::-1].copy())


def read_hmmer3(path: str) -> Dict[str, Profile]:
    """{NAME: profile} of every model of a HMMER3/f DNA file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    val = lambda tok: NEG if tok == "*" else -float(tok)
    out: Dict[str, Profile] = {}
    i = 0
    while i < len(lines):
        if not lines[i].startswith("HMMER3"):
            i += 1
            continue
        head = {}
        while not lines[i].startswith("HMM "):
            k, _, v = lines[i].partition(" ")
            head[k] = v.strip()
            i += 1
        i += 2                                   # alphabet, transition names
        if lines[i].split()[0] == "COMPO":
            i += 1
        i += 2                                   # node 0
        K = int(head["LENG"])
        match = np.empty((K, 4))
        t = np.empty((K, 7))
        for k in range(K):
            tok = lines[i].split()
            if tok[0] != str(k + 1):
                raise ValueError(f"{path}: node {k + 1} expected: "
                                 f"{lines[i]!r}")
            match[k] = [val(x) - math.log(0.25) for x in tok[1:5]]
            t[k] = [val(x) for x in lines[i + 2].split()[:7]]
            i += 3
        out[head["NAME"]] = Profile(head["NAME"], match, t)
        while not lines[i].startswith("//"):
            i += 1
        i += 1
    return out


@dataclass
class Scan:
    """Per sequence: ``best`` score, ``end`` (1-based position of the first
    best), and ``row`` [B, L] the best M of each position (-inf past the
    sequence's end), on the host."""
    best: np.ndarray
    end: np.ndarray
    row: np.ndarray


def viterbi(p: Profile, seqs: Sequence[np.ndarray], device,
            dtype=torch.float64) -> Scan:
    """Rule 2 over every sequence at once, the planes in ``dtype``
    (float64; a lower precision only to show that the check fails it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    f64 = dtype
    neg = max(NEG, torch.finfo(dtype).min)     # -1e9, or the type's least
    B, K = len(seqs), len(p.match)
    lens = np.array([len(s) for s in seqs], np.int64)
    L = int(lens.max()) if B else 0
    pad = np.full((B, max(L, 1)), 4, np.int64)
    for b, s in enumerate(seqs):
        pad[b, :len(s)] = s
    T = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=f64,
                                  device=dev)
    MM, MI, MD, IM, II, DM, DD = (T(p.t[:, c]) for c in range(7))
    DDc = torch.clamp(DD, min=DD_FLOOR)
    S = torch.cat([torch.zeros(1, dtype=f64, device=dev),
                   torch.cumsum(DDc[:-1], 0)])
    em_rows = torch.cat([T(p.match).t(), torch.zeros(1, K, dtype=f64,
                                                     device=dev)])
    cod = torch.as_tensor(pad, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    lo = torch.full((B, 1), neg, dtype=f64, device=dev)
    sh = lambda x: torch.cat([lo, x[:, :-1]], dim=1)   # x[k-1], NEG at 0
    M = torch.full((B, K), neg, dtype=f64, device=dev)
    I = M.clone()
    best = torch.full((B,), -math.inf, dtype=f64, device=dev)
    end = torch.zeros(B, dtype=torch.int64, device=dev)
    row = torch.full((B, max(L, 1)), -math.inf, dtype=f64, device=dev)
    for j in range(1, L + 1):
        e = em_rows[cod[:, j - 1]]
        D = torch.cummax(sh(M + MD) - S, dim=1).values + S
        cand = torch.maximum(torch.maximum(sh(M + MM), sh(I + IM)),
                             sh(D + DM)).clamp(min=0.0)
        Mn = cand + e
        In = torch.maximum(M + MI, I + II)
        ok = (j <= ln)[:, None]
        M = torch.where(ok, Mn, M)
        I = torch.where(ok, In, I)
        r = torch.where(ok[:, 0], Mn.max(dim=1).values,
                        torch.full_like(best, -math.inf))
        row[:, j - 1] = r
        up = r > best
        best = torch.where(up, r, best)
        end = torch.where(up, j, end)
    return Scan(best.double().cpu().numpy(), end.cpu().numpy(),
                row.double().cpu().numpy())


@dataclass
class Hit:
    gene: str
    contig: str
    start: int
    end: int
    strand: str
    score: float
    seq: str


@dataclass
class GeneScans:
    """One gene's forward and reversed scans of contigs' both strands:
    sequence 2c is contig c's + strand, 2c + 1 its - strand."""
    fwd: Scan
    rev: Scan


def scan_gene(p: Profile, contigs: Sequence[str], device) -> GeneScans:
    seqs = []
    for c in contigs:
        up = c.upper()
        seqs += [codes(up), codes(revcomp(up))]
    return GeneScans(viterbi(p, seqs, device),
                     viterbi(p.reversed(), [s[::-1] for s in seqs], device))


def hit_of(gene: str, name: str, contig: str, g: GeneScans, c: int,
           min_score: float) -> Optional[Hit]:
    """Rule 4 for contig ``c`` (index into the scans) named ``name``."""
    n = len(contig)
    best = None
    for k, strand in ((2 * c, "+"), (2 * c + 1, "-")):
        sc = float(g.fwd.best[k])
        if sc < min_score:
            continue
        e = int(g.fwd.end[k])
        s = max(0, n - int(g.rev.end[k]))
        if s >= e:
            continue
        if best is None or sc > best[0]:
            best = (sc, strand, s, e)
    if best is None:
        return None
    return place(gene, name, contig, best[1], best[2], best[3], best[0])


def place(gene: str, name: str, contig: str, strand: str, qs: int, qe: int,
          score: float) -> Hit:
    """A hit on ``strand`` at [qs, qe) of that strand, mapped to the +
    strand (rule 4)."""
    n = len(contig)
    if strand == "-":
        s, e = n - qe, n - qs
        return Hit(gene, name, s, e, strand, score, revcomp(contig[s:e]))
    return Hit(gene, name, qs, qe, strand, score, contig[qs:qe])


def header(h: Hit) -> str:
    return f"{h.gene}_rRNA::{h.contig}:{h.start}-{h.end}({h.strand})"


def gene_fasta(hits: Sequence[Hit]) -> List[Tuple[str, str]]:
    """Rule 5's ``<name>_<gene>.fa`` records (header, sequence)."""
    return [(header(h), h.seq) for h in hits]


def sidecars(hits: Sequence[Hit]) -> Tuple[List[List[str]],
                                            List[Tuple[str, str]]]:
    """Rule 5's GFF3 rows (columns as strings) and ``<name>_euk.fa``
    records, from every gene's hits."""
    rows = sorted(hits, key=lambda h: (h.contig, h.start, h.end))
    gff = [[h.contig, "tpu_orc:rrna", "rRNA", str(h.start + 1), str(h.end),
            f"{h.score:.1f}", h.strand, ".",
            f"Name={h.gene}_rRNA;product={h.gene} ribosomal RNA"]
           for h in rows]
    return gff, [(header(h), h.seq) for h in rows]
