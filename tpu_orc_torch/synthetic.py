"""SYNTHETIC adapter/primer banks and plate reads, made from a seed.

None of the sequences here is a real M13 index, pychopper primer or COI
primer: they are random, with the STRUCTURE of the reference pipeline's
configuration files, so that tests and ``chip_smoke.py`` can drive the
main path without the real files:

* 12 SP5 59-mers: a shared 25 bp M13F-like prefix, a 17 bp index and a
  shared 17 bp tail ending in ``GGCCAG`` (all 12 real SP5 adapters share
  that suffix, so 3 bp cross-adapter ties occur as on real data);
* 12 SP27-rc 59-mers in read orientation: a shared 17 bp head, a 17 bp
  index and a shared 25 bp M13R-like tail;
* the pychopper FASTA (SP5 and SP27 with their index as N17) and its
  config line ``+:SP5,-SP27|-:SP27,-SP5``;
* COI and RNA primer pairs with IUPAC codes, in the header convention
  that ``parse_primer_pairs`` reads (``..._Forward_A``, ``..._Reverse_A_B``).

Not reachable from the CLI. :func:`make_plate` follows ``bench.py``'s
plate generator: each bin holds reads of one (or, for the enlarged bin,
two) planted COI templates between the primers, half reverse-
complemented. :func:`make_rrna_plate` does the same with rDNA templates
(18S | ITS1 | 5.8S | ITS2 | 28S, after ``tests/test_rrna_accuracy.py``'s
``make_rdna_contig``) between the RNA primers.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np

from .io import encode
from .io.fastq import Record

FILES = ("M13_amplicon_indices_forward.fa",
         "M13_amplicon_indices_reverse_rc.fa",
         "M13_seqs_for_pychopper.fa", "M13_config_for_pychopper.txt",
         "COI_primers.fa", "RNA_primers.fa")
CONFIG = "+:SP5,-SP27|-:SP27,-SP5"
_IUPAC = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT",
          "M": "AC", "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
          "N": "ACGT"}


def _rand(rnd: random.Random, n: int) -> str:
    return "".join(rnd.choice("ACGT") for _ in range(n))


def _degenerate(rnd: random.Random, n: int, k: int) -> str:
    """Random primer of n bp with k IUPAC positions."""
    s = list(_rand(rnd, n))
    for p in rnd.sample(range(2, n - 2), k):
        s[p] = rnd.choice("RYSWKMN")
    return "".join(s)


def concretize(rnd: random.Random, s: str) -> str:
    """One concrete realization of a degenerate primer."""
    return "".join(rnd.choice(_IUPAC.get(c, c)) for c in s)


def mutate(rnd: random.Random, s: str, rate: float) -> str:
    """Nanopore-like noise: deletions, substitutions, insertions."""
    out = []
    for ch in s:
        r = rnd.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rnd.choice("ACGT"))
        elif r < rate:
            out.append(ch)
            out.append(rnd.choice("ACGT"))
        else:
            out.append(ch)
    return "".join(out)


def banks(seed: int = 5, head: int = 0) -> Dict[str, object]:
    """The synthetic sequences: {'sp5': [(name, seq)], 'sp27rc': [...],
    'pychopper': [...], 'coi': [...], 'rna': [...]}. ``head`` > 0 puts a
    shared random head of that many bp before every SP5 and SP27-rc
    adapter, so that the banks reach past the 62 bp of the Pallas tables
    (59 + 11 = 70 bp: the batched locate's route); the other sequences
    stay as they are."""
    rnd = random.Random(seed)
    pre5, tail5 = _rand(rnd, 25), _rand(rnd, 11) + "GGCCAG"
    head27, tail27 = _rand(rnd, 17), _rand(rnd, 25)
    idx = set()
    while len(idx) < 24:
        idx.add(_rand(rnd, 17))
    idx = sorted(idx)
    rnd.shuffle(idx)
    sp5 = [(f"SP5_{k + 1:03d}", pre5 + idx[k] + tail5) for k in range(12)]
    sp27rc = [(f"SP27_{k + 1:03d}", head27 + idx[12 + k] + tail27)
              for k in range(12)]
    if head:
        h = _rand(random.Random(seed + 7), head)
        sp5 = [(n, h + s) for n, s in sp5]
        sp27rc = [(n, h + s) for n, s in sp27rc]
    pychopper = [("SP5", pre5 + "N" * 17 + tail5),
                 ("SP27", encode.revcomp(head27 + "N" * 17 + tail27))]
    coi_f, coi_fb = _degenerate(rnd, 25, 4), _degenerate(rnd, 26, 5)
    coi_r = _degenerate(rnd, 26, 4)
    coi = [("synLCO|Synthetic_Forward_A", coi_f),
           ("synLCOb|Synthetic_Forward_B", coi_fb),
           ("synHCO|Synthetic_and_Other_Reverse_A_B", coi_r)]
    rna = [("synSSU|Synthetic_Forward_A", _degenerate(rnd, 20, 2)),
           ("synLSU|Synthetic_Reverse_A", _degenerate(rnd, 20, 2))]
    return {"sp5": sp5, "sp27rc": sp27rc, "pychopper": pychopper,
            "coi": coi, "rna": rna}


def _write_fasta(path: str, pairs) -> None:
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in pairs))


def write_adapter_dir(dirpath: str, seed: int = 5, head: int = 0) -> str:
    """Write the six adapter/primer files into ``dirpath``; returns it.
    ``head`` as in :func:`banks`."""
    b = banks(seed, head)
    os.makedirs(dirpath, exist_ok=True)
    _write_fasta(os.path.join(dirpath, FILES[0]), b["sp5"])
    _write_fasta(os.path.join(dirpath, FILES[1]), b["sp27rc"])
    _write_fasta(os.path.join(dirpath, FILES[2]), b["pychopper"])
    with open(os.path.join(dirpath, FILES[3]), "w") as fh:
        fh.write(CONFIG + "\n")
    _write_fasta(os.path.join(dirpath, FILES[4]), b["coi"])
    _write_fasta(os.path.join(dirpath, FILES[5]), b["rna"])
    return dirpath


def make_plate(n_per_bin: int, n5: int = 12, n27: int = 8, seed: int = 11,
               big_bin: Tuple[int, int] | None = None, big_reads: int = 1000,
               insert_len: int = 450, error_rate: float = 0.02,
               bank_seed: int = 5, head: int = 0):
    """Plate reads (raw-read structure: SP5 + COI primer + template + COI
    primer + SP27-rc, half reverse-complemented), shuffled; the adapters
    of ``banks(bank_seed, head)``.

    Each (SP5, SP27) bin holds ``n_per_bin`` reads of one template; the
    ``big_bin`` holds ``big_reads`` reads of two templates. Returns
    (records, planted) with planted[(sp5_name, sp27_name)] the list of
    planted inserts (primers plus template) of that bin."""
    b = banks(bank_seed, head)
    rnd = random.Random(seed)
    coi_f = concretize(rnd, b["coi"][0][1])
    coi_r = concretize(rnd, b["coi"][2][1])
    recs: List[Record] = []
    planted: Dict[Tuple[str, str], List[str]] = {}
    for i5 in range(n5):
        for i27 in range(n27):
            big = big_bin == (i5, i27)
            tmpls = [_rand(rnd, insert_len) for _ in range(2 if big else 1)]
            key = (b["sp5"][i5][0], b["sp27rc"][i27][0])
            planted[key] = [coi_f + t + coi_r for t in tmpls]
            for r in range(big_reads if big else n_per_bin):
                tmpl = tmpls[r % len(tmpls)]
                ins = coi_f + mutate(rnd, tmpl, error_rate) + coi_r
                s = b["sp5"][i5][1] + ins + b["sp27rc"][i27][1]
                if (i5 + i27 + r) % 2:
                    s = encode.revcomp(s)
                rid = f"p{i5}_{i27}_{r}"
                recs.append(Record(rid, rid, s, "I" * len(s)))
    rnd.shuffle(recs)
    return recs, planted


def rdna_template(rnd: random.Random) -> str:
    """One synthetic rDNA amplicon template of about 3.2-3.6 kb: 18S with
    the four conserved SSU blocks (ending with the ITS1 site), ITS1, a
    5.8S with the ITS3 site, ITS2, and 28S (an unconserved leader of the
    documented lead length, then the three LSU blocks), the blocks from
    ``rrna/profiles.py`` with their IUPAC codes made concrete and the
    variable regions random, of random length."""
    from .rrna.profiles import EUK_LSU_BLOCKS, EUK_SSU_BLOCKS
    var = lambda n: _rand(rnd, int(n * rnd.uniform(0.9, 1.1)))
    ssu = [concretize(rnd, b[1]) for b in EUK_SSU_BLOCKS]
    lsu = [concretize(rnd, b[1]) for b in EUK_LSU_BLOCKS]
    s18 = (var(59) + ssu[0] + var(470) + ssu[1] + var(1030) + ssu[2]
           + var(130) + ssu[3])
    s58 = var(40) + "GCATCGATGAAGAACGCAGC" + var(95)
    s28 = (_rand(rnd, EUK_LSU_BLOCKS[0][2]) + lsu[0] + var(540) + lsu[1]
           + var(290) + lsu[2] + var(90))
    return s18 + var(220) + s58 + var(200) + s28


def make_rrna_plate(n_per_bin: int, n5: int = 12, n27: int = 8,
                    seed: int = 13, enlarged: Tuple[int, int] | None = None,
                    enlarged_reads: int = 400, error_rate: float = 0.05,
                    bank_seed: int = 5):
    """rRNA plate reads: SP5 + RNA forward primer + rDNA template (5%
    nanopore-like noise) + RNA reverse primer + SP27-rc, half reverse-
    complemented, shuffled. Each (SP5, SP27) bin holds ``n_per_bin``
    reads of one template; the ``enlarged`` bin holds ``enlarged_reads``
    reads of two. Returns (records, planted) as :func:`make_plate`."""
    b = banks(bank_seed)
    rnd = random.Random(seed)
    rna_f = concretize(rnd, b["rna"][0][1])
    rna_r = concretize(rnd, b["rna"][1][1])
    recs: List[Record] = []
    planted: Dict[Tuple[str, str], List[str]] = {}
    for i5 in range(n5):
        for i27 in range(n27):
            big = enlarged == (i5, i27)
            tmpls = [rdna_template(rnd) for _ in range(2 if big else 1)]
            key = (b["sp5"][i5][0], b["sp27rc"][i27][0])
            planted[key] = [rna_f + t + rna_r for t in tmpls]
            for r in range(enlarged_reads if big else n_per_bin):
                tmpl = tmpls[r % len(tmpls)]
                ins = rna_f + mutate(rnd, tmpl, error_rate) + rna_r
                s = b["sp5"][i5][1] + ins + b["sp27rc"][i27][1]
                if (i5 + i27 + r) % 2:
                    s = encode.revcomp(s)
                rid = f"r{i5}_{i27}_{r}"
                recs.append(Record(rid, rid, s, "I" * len(s)))
    rnd.shuffle(recs)
    return recs, planted


def read_masks(seqs, max_len: int):
    """(match masks [B, max_len] uint8, lengths [B] int32) of reads, as
    the demux packs them."""
    amat, lens = encode.ascii_matrix(list(seqs), max_len=max_len)
    return encode.read_masks_matrix(amat, lens), lens


def codes(seqs, width: int):
    """(codes [N, width] uint8 padded with 4, lengths [N] int32), as the
    scorer packs them; sequences are cut at ``width``."""
    out = np.full((len(seqs), width), 4, np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        c = encode.encode_codes(s)[:width]
        out[i, :len(c)] = c
        lens[i] = len(c)
    return out, lens


def identity(a: str, b: str) -> float:
    """1 - NW edit distance / longer length (the native C++ oracle)."""
    from . import native
    d = native.edit_distance(encode.encode_codes(a), encode.encode_codes(b))
    return 1.0 - d / max(len(a), len(b), 1)


def fused_read(i5: int = 0, i27: int = 0, seed: int = 3,
               bank_seed: int = 5) -> Record:
    """One fused read: two full units (SP5 + insert + SP27-rc) back to
    back. Reorient must route it as fused_reads 1, rescued_segments 2."""
    b = banks(bank_seed)
    rnd = random.Random(seed)
    units = [b["sp5"][i5][1] + _rand(rnd, 300) + b["sp27rc"][i27][1]
             for _ in range(2)]
    s = "".join(units)
    return Record("fused0", "fused0", s, "I" * len(s))
