"""The plain reference against the port's definitional oracle and its
plain CPU paths, at small sizes (the reference itself imports nothing of
the port)."""
import random

import pytest

from orc_bench import gen
from orc_bench.reference import cutadapt, nw
from tpu_orc_torch.align import oracle
from tpu_orc_torch.align.spec import BACK, FRONT

RND = random.Random(11)


def _rs(n):
    return "".join(RND.choice("ACGT") for _ in range(n))


def _noisy(s, r):
    out = []
    for ch in s:
        u = RND.random()
        if u < r / 3:
            continue
        if u < 2 * r / 3:
            out.append(RND.choice("ACGT"))
        elif u < r:
            out += [ch, RND.choice("ACGT")]
        else:
            out.append(ch)
    return "".join(out)


ADAPTERS = [_rs(RND.randint(3, 30)) for _ in range(5)]
READS = []
for _k in range(60):
    _a = RND.choice(ADAPTERS)
    READS.append([
        _rs(RND.randint(0, 10)) + _noisy(_a, 0.1) + _rs(RND.randint(0, 40)),
        _noisy(_a[RND.randint(0, len(_a) - 1):], 0.1) + _rs(20),
        _rs(RND.randint(0, 20)) + _noisy(_a[:RND.randint(1, len(_a))], 0.1),
        _rs(RND.randint(0, 50))][_k % 4])


@pytest.mark.parametrize("kind", ["front", "back"])
@pytest.mark.parametrize("e", [0.1, 0.2])
def test_locate_equals_the_oracle(kind, e):
    h = cutadapt.locate(ADAPTERS, READS, kind, e, 3)
    flag = FRONT if kind == "front" else BACK
    for r, read in enumerate(READS):
        for a, ad in enumerate(ADAPTERS):
            loc = oracle.locate(ad, read, e, flag, 3)
            got = ((h.refstart[r, a], h.refstop[r, a], h.qstart[r, a],
                    h.qstop[r, a], h.matches[r, a], h.errors[r, a])
                   if h.found[r, a] else None)
            assert got == (loc.astuple() if loc else None), (read, ad)


def test_decisions_equal_the_ports_plain_dual_round():
    """The reference's dual-round decisions against the port's unfused
    two-round demux on CPU banks (its plain locate)."""
    from conftest import load
    from tpu_orc_torch.demux.adapters import AdapterBank
    from tpu_orc_torch.demux.demux import _decisions_unfused
    from tpu_orc_torch.io.fastq import Record
    cfg = dict(load("configs", "coi_plate96.json"), insert_length=40)
    mix = dict(load("traffic", "plate_coi.json"), reads=120)
    p = gen.demux_pool(21, cfg, mix)
    b = gen.banks(cfg["bank_seed"])
    recs = [Record(f"r{i}", f"r{i}", s, q)
            for i, (s, q) in enumerate(zip(p.seqs, p.quals))]
    sp5 = AdapterBank.from_pairs(b["sp5"], 0.1, "cpu")
    sp27 = AdapterBank.from_pairs(b["sp27rc"], 0.1, "cpu")
    port = _decisions_unfused(recs, sp5, sp27, 256)
    ref = cutadapt.decide([(r.desc, r.seq, r.qual) for r in recs],
                          [s for _, s in b["sp5"]],
                          [s for _, s in b["sp27rc"]])
    names5 = [n for n, _ in b["sp5"]]
    names27 = [n for n, _ in b["sp27rc"]]
    for (s5, t1, s27, fin, rc1, _, rc2, _), d in zip(port, ref):
        assert s5 == (names5[d.sp5] if d.sp5 is not None else None)
        assert s27 == (names27[d.sp27] if d.sp27 is not None else None)
        assert (t1.desc, t1.seq, t1.qual) == d.trimmed1
        assert (fin.desc, fin.seq, fin.qual) == d.final
        assert bool(rc1) == d.rc1
        if d.sp27 is not None:
            assert bool(rc2) == d.rc2
    assert sum(d.sp27 is not None for d in ref) > 90


def test_nw_equals_the_oracle():
    a = [_rs(RND.randint(0, 60)) for _ in range(50)]
    b = [x[:RND.randint(0, len(x))] + _rs(RND.randint(0, 20)) if k % 2
         else _rs(RND.randint(0, 60)) for k, x in enumerate(a)]
    assert nw.distances(a, b).tolist() == [
        oracle.edit_distance(x, y, "NW") for x, y in zip(a, b)]
    # a band cuts the alignments that leave it
    assert (nw.distances(a, b, band=2) >= nw.distances(a, b)).all()


def test_similarities_round_and_retry_the_complement():
    a = [_rs(200) for _ in range(6)]
    b = [a[0], _noisy(a[1], 0.1), cutadapt.revcomp(a[2]),
         cutadapt.revcomp(_noisy(a[3], 0.1)), _rs(200), a[5][:150]]
    s = nw.similarities(a, b)
    for x, y, got in zip(a, b, s):
        d = oracle.edit_distance(x, y, "NW")
        L = max(len(x), len(y))
        want = round(1 - d / L, 3)
        if want < 0.5:
            dr = oracle.edit_distance(x, cutadapt.revcomp(y), "NW")
            want = max(want, round(1 - dr / L, 3))
        assert got == want
    assert s[0] == 1.0 and s[2] == 1.0 and s[3] > 0.8
