"""Raw reads of a flow cell for stage 01, from the configuration, the
traffic mix and ``--seed``: the reads as the sequencer writes them,
before pychopper has turned or cut any of them.

Built from :mod:`orc_bench.gen`'s pieces (its banks, primers, templates,
noise and qualities), vectorised over blocks of reads; nothing here
imports the program. A read is one amplicon unit between random flanks
(what the ligation adapter leaves at the read's ends):

    flank + SP5 + forward primer + insert + reverse primer + SP27-rc + flank

the unit reverse-complemented in half of the reads, the bins laid out as
:func:`orc_bench.gen.demux_pool` lays them out (a fixed share on the
SP27_009-012 pairs that the pipeline deletes), noise over the whole read.
On top of that, fixed shares of special reads, each kind its own reads:

* fused: two units, each in its own orientation and from its own bin,
  a random gap between them (pychopper's rescued reads);
* low quality: a normal read whose every base quality is below 10, so
  that its mean is too (the ``-Q 10`` filter's unclassified reads);
* no primer: random sequence as long as a normal read would be;
* truncated: the unit stops inside its insert, before the 3' primer.

Every seed gives the same counts of each kind, the same bins and the
same template lengths; the seed changes the sequences, the noise, the
flanks and the order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import gen

NORMAL, FUSED, LOW_Q, NO_PRIMER, TRUNCATED = range(5)
KINDS = ("normal", "fused", "low_q", "no_primer", "truncated")
#: the share key of each special kind in a mix
SHARES = {FUSED: "fused_share", LOW_Q: "low_q_share",
          NO_PRIMER: "no_primer_share", TRUNCATED: "truncated_share"}

#: 256 Phred+33 characters below Q 10 (a normal of mean 5 and deviation
#: 2.5, clipped to 2-9): every base of a low-quality read takes one
_Q_LOW = np.clip(np.rint(np.sort(np.random.default_rng(1).normal(5.0, 2.5,
                                                                 256))),
                 2, 9).astype(np.uint8) + np.uint8(33)


def pychopper_primers(bank_seed: int) -> List[Tuple[str, str]]:
    """The primers of ``-b``: SP5 as the SP5 adapters' shared 25 bp head,
    N17 and their shared 17 bp tail; SP27 the same of the SP27-rc
    adapters (17 bp head, N17, 25 bp tail), reverse-complemented."""
    b = gen.banks(bank_seed)
    s5, s27 = b["sp5"][0][1], b["sp27rc"][0][1]
    sp5 = s5[:25] + "N" * 17 + s5[42:]
    sp27rc = s27[:17] + "N" * 17 + s27[34:]
    comp = str.maketrans("ACGTN", "TGCAN")
    return [("SP5", sp5), ("SP27", sp27rc.translate(comp)[::-1])]


@dataclass
class RawPool:
    """Raw reads: ``seqs``/``quals`` strings, each read's kind (an index
    into :data:`KINDS`), its unit's bin (``sp5``/``sp27`` indices into
    the banks; the first unit of a fused read) and whether that unit was
    reverse-complemented."""
    seqs: List[str]
    quals: List[str]
    kind: np.ndarray
    sp5: np.ndarray
    sp27: np.ndarray
    rc: np.ndarray


def _units(rng, cfg: Dict) -> Tuple[List[np.ndarray], int, int]:
    """Each bin's unit before noise (SP5 + primer + template + primer +
    SP27-rc, codes), and where its insert starts and how long its 3'
    end (reverse primer + SP27-rc) is."""
    b = gen.banks(cfg["bank_seed"])
    fwd = gen.to_codes(gen.concretize(rng, b["rna"][0][1]))
    rev = gen.to_codes(gen.concretize(rng, b["rna"][-1][1]))
    n5, n27 = len(b["sp5"]), len(b["sp27rc"])
    tl = gen.fixed_lengths(n5 * n27, *cfg["insert_range"])
    tmpl = gen._random(rng, int(tl.sum()))
    ts = np.cumsum(tl) - tl
    sp5c = [gen.to_codes(s) for _, s in b["sp5"]]
    sp27c = [gen.to_codes(s) for _, s in b["sp27rc"]]
    units = [np.concatenate([sp5c[t // n27], fwd, tmpl[ts[t]:ts[t] + tl[t]],
                             rev, sp27c[t % n27]])
             for t in range(n5 * n27)]
    return units, len(sp5c[0]) + len(fwd), len(rev) + len(sp27c[0])


def _bins(rng, n: int, cfg: Dict, mix: Dict) -> Tuple[np.ndarray, ...]:
    """(sp5, sp27) of ``n`` units, laid out as ``gen.demux_pool``'s."""
    n5, n27 = cfg["sp5_used"], cfg["sp27_used"]
    inval = np.arange(n27, 12)
    n_bad = int(round(n * mix["invalid_share"]))
    good = np.arange(n - n_bad) % (n5 * n27)
    bad = np.arange(n_bad) % (n5 * len(inval))
    sp5 = np.concatenate([good // n27, bad // len(inval)])
    sp27 = np.concatenate([good % n27, inval[bad % len(inval)]])
    order = rng.permutation(n)
    return sp5[order], sp27[order]


def kinds(rng, n: int, mix: Dict) -> np.ndarray:
    """Each read's kind: the mix's share of each special kind, rounded,
    on reads drawn from the seed; normal reads the rest."""
    kind = np.full(n, NORMAL, np.int8)
    order = rng.permutation(n)
    at = 0
    for k in (FUSED, LOW_Q, NO_PRIMER, TRUNCATED):
        m = int(round(n * mix[SHARES[k]]))
        kind[order[at:at + m]] = k
        at += m
    return kind


def raw_pool(seed: int, cfg: Dict, mix: Dict) -> RawPool:
    """``mix['reads']`` raw reads of the configuration's plate."""
    rng = gen.rng_for(seed, 21)
    n = int(mix["reads"])
    units, head, tail = _units(rng, cfg)
    rc_units = [(3 - u[::-1]).astype(np.uint8) for u in units]
    n27b = 12
    sp5, sp27 = _bins(rng, n, cfg, mix)
    kind = kinds(rng, n, mix)
    rc = np.zeros(n, bool)
    rc[rng.permutation(n)[: n // 2]] = True
    # the second unit of a fused read: another read's bin, its own
    # orientation, a gap before it
    other = rng.permutation(n)
    rc2 = rng.random(n) < 0.5
    gap = rng.integers(mix["fused_gap"][0], mix["fused_gap"][1] + 1, n)
    fl = rng.integers(mix["flank"][0], mix["flank"][1] + 1, (n, 2))
    lo, hi = mix["truncated_insert"]
    cut_at = rng.uniform(lo, hi, n)
    seqs: List[str] = []
    quals: List[str] = []
    for s0 in range(0, n, gen.BLOCK):
        parts: List[np.ndarray] = []
        for r in range(s0, min(s0 + gen.BLOCK, n)):
            t = int(sp5[r]) * n27b + int(sp27[r])
            u = rc_units[t] if rc[r] else units[t]
            k = kind[r]
            if k == FUSED:
                t2 = int(sp5[other[r]]) * n27b + int(sp27[other[r]])
                u = np.concatenate([u, gen._random(rng, int(gap[r])),
                                    rc_units[t2] if rc2[r] else units[t2]])
            elif k == NO_PRIMER:
                u = gen._random(rng, u.size)
            elif k == TRUNCATED:
                ins = units[t].size - head - tail
                u = units[t][:head + int(ins * cut_at[r])]
                if rc[r]:
                    u = (3 - u[::-1]).astype(np.uint8)
            parts += [gen._random(rng, int(fl[r, 0])), u,
                      gen._random(rng, int(fl[r, 1]))]
        lens = np.array([sum(p.size for p in parts[i:i + 3])
                         for i in range(0, len(parts), 3)])
        noisy, nl = gen.mutate(rng, np.concatenate(parts), lens,
                               np.full(lens.size, float(cfg["error_rate"])))
        seqs += gen._as_strings(noisy, nl, np.zeros(nl.size, bool))
        q = gen.qualities(rng, noisy.size)
        low = np.repeat(kind[s0:s0 + nl.size] == LOW_Q, nl)
        q[low] = _Q_LOW[rng.integers(0, 256, int(low.sum()), dtype=np.uint8)]
        quals += gen.split(q.tobytes(), nl)
    return RawPool(seqs, quals, kind, sp5, sp27, rc)
