"""barrnap's euk models and a plate's cleaned rRNA contigs for stage 05a,
from the configuration, the traffic mix and ``--seed``.

The models are drawn at the configuration's lengths (its ``models``;
barrnap's euk.hmm itself is not in the repository) and written in
HMMER3/f's text layout, as ``tests/fixtures/gen_euk_hmm_fixture.py``
writes its fixture: every header line barrnap's entries carry, a COMPO
line, node 0's insert and transition lines, and per node a match line
with its MAP, CONS, RF, MM and CS columns, an insert line and a
transition line, each value a negative natural log to 5 decimals, '*'
for a probability of 0 (the last node's m->d and d->d). A node's draws
(the configuration's ``draws``): a consensus base; its match emission
``p_consensus`` uniform on the configuration's range, the other three
bases sharing the rest by a flat Dirichlet; m->m uniform on its range,
m->i and m->d sharing the rest by a uniform split; i->m and d->m uniform
on theirs, i->i and d->d the rest. Inserts emit the background.

A contig is what stage 04 leaves of one rDNA amplicon's consensus: the
end of an 18S sequence emitted along the 18S model's match path (each
node's base drawn from its match emission), a random ITS, and the start
of a 28S emission, 3,200-3,600 bp in all, noise over the whole contig,
half of them reverse-complemented. Fixed shares lack the 28S part or
are random sequence with no gene. A sample holds 1-3 contigs, as many
samples each count. Every seed gives the same counts and contig
lengths; the seed changes the models, the sequences, the noise and the
order. Nothing here imports the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import gen

BASES = "ACGT"
NORMAL, NO_LSU, NO_GENE = range(3)


@dataclass
class Model:
    """One profile as probabilities: ``match`` [K, 4] (A C G T), ``trans``
    [K, 7] (m->m m->i m->d i->m i->i d->m d->d), ``cons`` its consensus
    codes [K]."""
    name: str
    acc: str
    desc: str
    cons: np.ndarray
    match: np.ndarray
    trans: np.ndarray

    @property
    def K(self) -> int:
        return len(self.cons)


def euk_models(seed: int, cfg: Dict) -> List[Model]:
    """The configuration's models, in its order, drawn from ``seed``."""
    rng = gen.rng_for(seed, 31)
    d = cfg["draws"]
    out = []
    for m in cfg["models"]:
        K = int(m["leng"])
        cons = rng.integers(0, 4, K)
        pc = rng.uniform(*d["p_consensus"], K)
        rest = rng.dirichlet(np.ones(3), K) * (1.0 - pc)[:, None]
        match = np.empty((K, 4))
        others = (cons[:, None] + np.arange(1, 4)[None, :]) % 4
        match[np.arange(K), cons] = pc
        match[np.arange(K)[:, None], others] = rest
        mm = rng.uniform(*d["mm"], K)
        split = rng.uniform(0.2, 0.8, K)
        mi, md = (1.0 - mm) * split, (1.0 - mm) * (1.0 - split)
        im = rng.uniform(*d["im"], K)
        dm = rng.uniform(*d["dm"], K)
        trans = np.stack([mm, mi, md, im, 1.0 - im, dm, 1.0 - dm], axis=1)
        # the last node: no delete state after it
        trans[-1] = [1.0 - mi[-1], mi[-1], 0.0, im[-1], 1.0 - im[-1], 1.0,
                     0.0]
        out.append(Model(m["name"], m["acc"], m["desc"], cons, match,
                         trans))
    return out


def _nl(p: float) -> str:
    return "*" if p <= 0 else f"{-math.log(p):.5f}"


def hmmer3_text(m: Model) -> str:
    """One model in HMMER3/f's layout."""
    K = m.K
    bg = _nl(0.25)
    cons = "".join(BASES[c] for c in m.cons)
    out = ["HMMER3/f [3.1b2 | February 2015]", f"NAME  {m.name}",
           f"ACC   {m.acc}", f"DESC  {m.desc}", f"LENG  {K}",
           f"MAXL  {K + K // 4}", "ALPH  DNA", "RF    no", "MM    no",
           "CONS  yes", "CS    no", "MAP   yes",
           "DATE  Mon Oct 19 00:00:00 2026", "NSEQ  100",
           "EFFN  10.000000", "CKSUM 1234567890", "GA    50.00;",
           "TC    55.00;", "NC    45.00;",
           "STATS LOCAL MSV      -10.1234  0.70000",
           "STATS LOCAL VITERBI  -11.2345  0.70000",
           "STATS LOCAL FORWARD   -4.5678  0.70000",
           "HMM          A        C        G        T",
           "            m->m     m->i     m->d     i->m     i->i"
           "     d->m     d->d",
           "  COMPO   " + "  ".join(_nl(p) for p in m.match.mean(axis=0)),
           f"          {bg}  {bg}  {bg}  {bg}",
           "          " + "  ".join(_nl(p) for p in m.trans[0, :5])
           + f"  {_nl(0.0)}  {_nl(0.0)}"]
    for k in range(K):
        ems = "  ".join(_nl(p) for p in m.match[k])
        out.append(f"{k + 1:7d}   {ems} {k + 1:7d} {cons[k].lower()} - - -")
        out.append(f"          {bg}  {bg}  {bg}  {bg}")
        out.append("          " + "  ".join(_nl(p) for p in m.trans[k]))
    out.append("//")
    return "\n".join(out) + "\n"


def write_hmmer3(path: str, models: List[Model]) -> None:
    with open(path, "w") as fh:
        fh.write("".join(hmmer3_text(m) for m in models))


def emit(rng, m: Model, n: int) -> np.ndarray:
    """``n`` sequences of K codes, each node's base drawn from its match
    emission (the model's match path, no insert or delete)."""
    cum = np.cumsum(m.match, axis=1)
    u = rng.random((n, m.K, 1))
    return (u > cum[None, :, :3]).sum(axis=2).astype(np.uint8)


@dataclass
class ContigPool:
    """``samples[i]``: sample i's contigs; ``kind`` and ``rc`` of every
    contig, samples in order."""
    samples: List[List[str]]
    kind: np.ndarray
    rc: np.ndarray


def contig_pool(seed: int, cfg: Dict, mix: Dict,
                models: List[Model]) -> ContigPool:
    """``mix['samples']`` samples of cleaned contigs."""
    rng = gen.rng_for(seed, 32)
    by = {m.name: m for m in models}
    ssu, lsu = by[cfg["genes"]["18S"]], by[cfg["genes"]["28S"]]
    S = int(mix["samples"])
    # every seed gives the same number of samples with each count of
    # contigs, and the same contig lengths, in its own order
    lo, hi = mix["contigs"]
    per = rng.permutation(lo + np.arange(S) % (hi - lo + 1))
    n = int(per.sum())
    kind = np.full(n, NORMAL, np.int8)
    order = rng.permutation(n)
    n_lsu = int(round(n * mix["no_lsu_share"]))
    n_gene = int(round(n * mix["no_gene_share"]))
    kind[order[:n_lsu]] = NO_LSU
    kind[order[n_lsu:n_lsu + n_gene]] = NO_GENE
    rc = np.zeros(n, bool)
    rc[rng.permutation(n)[: n // 2]] = True
    # lengths: the whole contig, then its 18S tail and 28S head inside
    # their ranges with the ITS inside its own
    (s0, s1), (i0, i1), (l0, l1) = mix["ssu_tail"], mix["its"], \
        mix["lsu_head"]
    T = rng.permutation(gen.fixed_lengths(n, *mix["contig_len"]))
    a = np.maximum(s0, T - l1 - i1)
    b = np.minimum(s1, T - l0 - i0)
    n18 = a + (rng.random(n) * (b - a + 1)).astype(np.int64)
    a = np.maximum(l0, T - n18 - i1)
    b = np.minimum(l1, T - n18 - i0)
    n28 = a + (rng.random(n) * (b - a + 1)).astype(np.int64)
    n_its = T - n18 - n28
    e18 = emit(rng, ssu, n)
    e28 = emit(rng, lsu, n)
    parts = []
    for c in range(n):
        if kind[c] == NO_GENE:
            parts.append(gen._random(rng, int(T[c])))
            continue
        p = [e18[c, ssu.K - n18[c]:], gen._random(rng, int(n_its[c]))]
        if kind[c] == NORMAL:
            p.append(e28[c, :n28[c]])
        parts.append(np.concatenate(p))
    lens = np.array([len(p) for p in parts], np.int64)
    flat, lens = gen.mutate(rng, np.concatenate(parts), lens,
                            np.full(n, mix["noise"], np.float32))
    seqs = gen._as_strings(flat, lens, rc)
    ends = np.cumsum(per)
    samples = [seqs[e - k:e] for e, k in zip(ends.tolist(), per.tolist())]
    return ContigPool(samples, kind, rc)
