"""The benchmark's one traffic generator: every input of a cell, from the
configuration, the traffic mix and ``--seed``.

The benchmark's own copy of the shapes of ``tpu_orc_torch/synthetic.py``
(``banks``, ``make_plate``, ``make_rrna_plate``, ``mutate``), rewritten
as vectorised numpy so that a quarter of a million reads take a second,
and kept here so that a change to the program's generator cannot change
the benchmark. Nothing here imports the program.

Sequences are codes 0-3 (A, C, G, T) while they are made; a read is a
(sequence, quality) pair of ASCII strings when it is handed out.

* :func:`banks`: the synthetic adapter and primer banks. 12 SP5 59-mers
  (a shared 25 bp prefix, a 17 bp index, a shared 17 bp tail ending in
  GGCCAG) and 12 SP27-rc 59-mers (a shared 17 bp head, a 17 bp index, a
  shared 25 bp tail), and degenerate COI and RNA primer pairs. Made from
  the configuration's ``bank_seed``, not from ``--seed``: the banks are
  the deployment's adapter files.
* :func:`mutate`: nanopore-like noise. Each base is deleted, replaced by
  a random base or followed by a random inserted base, each with a third
  of the read's error rate (``synthetic.mutate``'s rule).
* :func:`demux_pool`: a stream of raw reads over a plate
  (``make_plate`` / ``make_rrna_plate``): SP5 + forward primer +
  the bin's template + reverse primer + SP27-rc, noise over the whole
  read, half reverse-complemented, a fixed share of reads on index pairs
  that the pipeline deletes.
* :func:`sort_bins`: demultiplexed bins of two species each: forward
  primer + template + reverse primer, noise per read.

Every seed gives the same sizes (reads per bin, template lengths, the
share of invalid pairs and of reverse complements); the seed changes the
sequences, the noise and the order only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC = {"R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
         "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT"}
GOLDEN = 0.6180339887498949
BLOCK = 16384  # reads made at once: bounds the generator's memory


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def to_str(codes: np.ndarray) -> str:
    return ACGT[codes].tobytes().decode("ascii")


def to_codes(s: str) -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    out = lut[np.frombuffer(s.encode("ascii"), np.uint8)]
    if (out == 255).any():
        raise ValueError("sequence holds a character other than ACGT")
    return out


def _random(rng, n: int) -> np.ndarray:
    return rng.integers(0, 4, n, dtype=np.uint8)


def _degenerate(rng, n: int, k: int) -> str:
    """A primer of ``n`` bp with ``k`` IUPAC codes away from its ends."""
    s = list(to_str(_random(rng, n)))
    for p in rng.choice(np.arange(2, n - 2), k, replace=False):
        s[int(p)] = "RYSWKMN"[int(rng.integers(0, 7))]
    return "".join(s)


def concretize(rng, primer: str) -> str:
    """One concrete realisation of a degenerate primer."""
    return "".join(IUPAC[c][int(rng.integers(0, len(IUPAC[c])))]
                   if c in IUPAC else c for c in primer)


def banks(bank_seed: int) -> Dict[str, List[Tuple[str, str]]]:
    """{'sp5', 'sp27rc', 'coi', 'rna'}: lists of (name, sequence)."""
    rng = rng_for(bank_seed, 0)
    pre5 = to_str(_random(rng, 25))
    tail5 = to_str(_random(rng, 11)) + "GGCCAG"
    head27, tail27 = to_str(_random(rng, 17)), to_str(_random(rng, 25))
    idx: List[str] = []
    while len(idx) < 24:
        s = to_str(_random(rng, 17))
        if s not in idx:
            idx.append(s)
    sp5 = [(f"SP5_{k + 1:03d}", pre5 + idx[k] + tail5) for k in range(12)]
    sp27 = [(f"SP27_{k + 1:03d}", head27 + idx[12 + k] + tail27)
            for k in range(12)]
    coi = [("synLCO|Synthetic_Forward_A", _degenerate(rng, 25, 4)),
           ("synHCO|Synthetic_and_Other_Reverse_A_B",
            _degenerate(rng, 26, 4))]
    rna = [("synSSU|Synthetic_Forward_A", _degenerate(rng, 20, 2)),
           ("synLSU|Synthetic_Reverse_A", _degenerate(rng, 20, 2))]
    return {"sp5": sp5, "sp27rc": sp27, "coi": coi, "rna": rna}


def mutate(rng, flat: np.ndarray, lens: np.ndarray, rates: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Noise on many sequences at once: ``flat`` holds the sequences end
    to end (codes), ``lens`` their lengths, ``rates`` each one's error
    rate. Returns (flat, lens) of the noisy sequences."""
    rates = np.asarray(rates, np.float32)
    thr = (rates[0] if (rates == rates[0]).all()
           else np.repeat(rates, lens))
    u = rng.random(flat.size, dtype=np.float32)
    ev = np.flatnonzero(u < thr)                   # a base with an event
    t = thr if np.ndim(thr) == 0 else thr[ev]
    kind = np.minimum((u[ev] / t * 3).astype(np.int8), 2)
    out = flat.copy()
    sub, dele, ins = ev[kind == 1], ev[kind == 0], ev[kind == 2]
    out[sub] = _random(rng, sub.size)
    keep = np.ones(flat.size, bool)
    keep[dele] = False
    # an inserted base follows its own base: it goes before the kept
    # base that comes next
    at = ins + 1 - np.searchsorted(dele, ins, "right")
    out = np.insert(out[keep], at, _random(rng, ins.size))
    starts = np.cumsum(lens) - lens
    n = len(lens)
    new_lens = (np.asarray(lens, np.int64)
                - np.bincount(np.searchsorted(starts, dele, "right") - 1,
                              minlength=n)
                + np.bincount(np.searchsorted(starts, ins, "right") - 1,
                              minlength=n))
    return out, new_lens


def _as_strings(flat: np.ndarray, lens: np.ndarray, rc: np.ndarray
                ) -> List[str]:
    """The sequences (codes end to end) as strings, those flagged in
    ``rc`` reverse-complemented: a read's reverse complement is a slice
    of the complemented, reversed whole."""
    fwd = ACGT[flat].tobytes().decode("ascii")
    rev = ACGT[3 - flat[::-1]].tobytes().decode("ascii")
    T = flat.size
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    return [rev[T - e:T - s] if r else fwd[s:e]
            for s, e, r in zip(starts, ends, rc.tolist())]


#: 256 Phred+33 characters drawn once from a normal of mean 18 and
#: deviation 6, clipped to 2-40; a base takes one of them, by a byte
_Q = np.clip(np.rint(np.sort(np.random.default_rng(0).normal(18.0, 6.0,
                                                             256))),
             2, 40).astype(np.uint8) + np.uint8(33)


def qualities(rng, n: int) -> np.ndarray:
    """Phred+33 characters of nanopore-like base qualities."""
    return _Q[rng.integers(0, 256, n, dtype=np.uint8)]


def split(flat_ascii: bytes, lens: np.ndarray) -> List[str]:
    s = flat_ascii.decode("ascii")
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    return [s[a:b] for a, b in zip(starts, ends)]


@dataclass
class Pool:
    """Reads of a demux stream: ``seqs``/``quals`` strings, the bin each
    came from (``sp5``/``sp27`` indices into the banks) and whether it
    was reverse-complemented."""
    seqs: List[str]
    quals: List[str]
    sp5: np.ndarray
    sp27: np.ndarray
    rc: np.ndarray


def fixed_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths spread over [lo, hi] by a rule that takes no seed."""
    return lo + np.rint(((np.arange(n) * GOLDEN) % 1.0) * (hi - lo)
                        ).astype(np.int64)


def demux_pool(seed: int, cfg: Dict, mix: Dict) -> Pool:
    """The read pool of a demux stream: ``mix['reads']`` reads over the
    plate's ``sp5_used`` x ``sp27_used`` bins, ``mix['invalid_share']``
    of them on SP5 x SP27_009-012 pairs (deleted by the pipeline), one
    template a bin of ``cfg['insert_length']`` (or lengths over
    ``cfg['insert_range']``), ``cfg['error_rate']`` per base over the
    whole read, half of the reads reverse-complemented."""
    b = banks(cfg["bank_seed"])
    rng = rng_for(seed, 1)
    n = int(mix["reads"])
    n5, n27 = cfg["sp5_used"], cfg["sp27_used"]
    inval = list(range(n27, len(b["sp27rc"])))
    n_bad = int(round(n * mix["invalid_share"]))
    # the same number of reads on every valid bin, then on every invalid
    # pair, whatever the seed
    good = np.arange(n - n_bad) % (n5 * n27)
    bad = np.arange(n_bad) % (n5 * len(inval))
    sp5 = np.concatenate([good // n27, bad // len(inval)])
    sp27 = np.concatenate([good % n27,
                           np.asarray(inval)[bad % len(inval)]])
    order = rng.permutation(n)
    sp5, sp27 = sp5[order], sp27[order]
    rc = np.zeros(n, bool)
    rc[rng.permutation(n)[: n // 2]] = True

    amp = "coi" if cfg["amplicon"] == "COI" else "rna"
    fwd = to_codes(concretize(rng, b[amp][0][1]))
    rev = to_codes(concretize(rng, b[amp][-1][1]))
    n_bins = len(b["sp5"]) * len(b["sp27rc"])
    if "insert_range" in cfg:
        tl = fixed_lengths(n_bins, *cfg["insert_range"])
    else:
        tl = np.full(n_bins, int(cfg["insert_length"]))
    tmpl = _random(rng, int(tl.sum()))
    tstart = np.cumsum(tl) - tl
    sp5c = [to_codes(s) for _, s in b["sp5"]]
    sp27c = [to_codes(s) for _, s in b["sp27rc"]]
    n27b = len(b["sp27rc"])
    # each bin's read before noise: SP5 + primer + template + primer +
    # SP27-rc
    clean_bin = [np.concatenate([sp5c[t // n27b], fwd,
                                 tmpl[tstart[t]:tstart[t] + tl[t]], rev,
                                 sp27c[t % n27b]])
                 for t in range(n_bins)]
    bin_id = sp5 * n27b + sp27
    seqs: List[str] = []
    quals: List[str] = []
    for s0 in range(0, n, BLOCK):
        ids = bin_id[s0:s0 + BLOCK]
        clean = np.concatenate([clean_bin[t] for t in ids.tolist()])
        lens = np.array([clean_bin[t].size for t in ids.tolist()])
        noisy, nl = mutate(rng, clean, lens,
                           np.full(len(ids), float(cfg["error_rate"])))
        seqs += _as_strings(noisy, nl, rc[s0:s0 + BLOCK])
        quals += split(qualities(rng, noisy.size).tobytes(), nl)
    return Pool(seqs, quals, sp5, sp27, rc)


@dataclass
class SortBin:
    """One demultiplexed bin: reads (id, seq, qual), the species
    template each read was made from, and the templates with their
    primers (the planted amplicons)."""
    ids: List[str]
    seqs: List[str]
    quals: List[str]
    species: np.ndarray
    planted: List[str]


def sort_bins(seed: int, cfg: Dict, mix: Dict, n_bins: int,
              first: int = 0) -> List[SortBin]:
    """Bins ``first`` .. ``first + n_bins - 1`` of a sort mix: each of
    ``mix['reads_per_bin']`` reads, evenly over ``mix['species']``
    templates. Template 0 of bin k has the length ``fixed_lengths``
    gives bin k over ``cfg['insert_range']`` (or ``insert_length``); the
    others are template 0 under ``mix['species_divergence']`` noise.
    Each read: forward primer + template + reverse primer, under its own
    error rate, drawn evenly from ``mix['read_error']``."""
    b = banks(cfg["bank_seed"])
    amp = "coi" if cfg["amplicon"] == "COI" else "rna"
    n_all = first + n_bins
    if "insert_range" in cfg:
        tl = fixed_lengths(n_all, *cfg["insert_range"])
    else:
        tl = np.full(n_all, int(cfg["insert_length"]))
    out = []
    for k in range(first, n_all):
        rng = rng_for(seed, 1000 + k)
        fwd = concretize(rng, b[amp][0][1])
        rev = concretize(rng, b[amp][-1][1])
        t0 = _random(rng, int(tl[k]))
        ts = [t0]
        for _ in range(1, mix["species"]):
            t, _ = mutate(rng, t0, np.array([t0.size]),
                          np.array([mix["species_divergence"]]))
            ts.append(t)
        planted = [fwd + to_str(t) + rev for t in ts]
        n = int(mix["reads_per_bin"])
        species = np.arange(n) % mix["species"]
        species = species[rng.permutation(n)]
        pc = [to_codes(p) for p in planted]
        clean = np.concatenate([pc[s] for s in species.tolist()])
        lens = np.array([pc[s].size for s in species.tolist()])
        lo, hi = mix["read_error"]
        rates = rng.uniform(lo, hi, n)
        noisy, nl = mutate(rng, clean, lens, rates)
        out.append(SortBin(
            [f"b{k}_r{i}" for i in range(n)],
            _as_strings(noisy, nl, np.zeros(n, bool)),
            split(qualities(rng, noisy.size).tobytes(), nl),
            species, planted))
    return out
