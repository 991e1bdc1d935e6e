"""The traffic generator repeats for a seed and makes what the mixes
ask for."""
import numpy as np

from conftest import load
from orc_bench import gen


def test_mutate_keeps_lengths_and_rates():
    rng = np.random.default_rng(1)
    flat = rng.integers(0, 4, 400_000, dtype=np.uint8)
    lens = np.full(400, 1000)
    out, nl = gen.mutate(rng, flat, lens, np.full(400, 0.06))
    assert nl.sum() == out.size
    # deletions and insertions a third each: lengths stay about even
    assert abs(nl.mean() - 1000) < 2
    out0, nl0 = gen.mutate(rng, flat, lens, np.zeros(400))
    assert np.array_equal(out0, flat) and np.array_equal(nl0, lens)


def test_mutate_insertion_follows_its_base():
    # rate 1: every base gets an event; with one base, the read holds
    # 0 (deleted), 1 (replaced) or 2 bases (kept, then one inserted)
    for s in range(20):
        out, nl = gen.mutate(np.random.default_rng(s),
                             np.array([2], np.uint8), np.array([1]),
                             np.array([1.0]))
        assert nl[0] == out.size <= 2
        if out.size == 2:
            assert out[0] == 2


def test_demux_pool_repeats_and_matches_the_mix():
    cfg = load("configs", "coi_plate96.json")
    mix = dict(load("traffic", "plate_coi.json"), reads=2000)
    a = gen.demux_pool(2**40 + 3, cfg, mix)
    b = gen.demux_pool(2**40 + 3, cfg, mix)
    c = gen.demux_pool(2**40 + 4, cfg, mix)
    assert a.seqs == b.seqs and a.quals == b.quals
    assert a.seqs != c.seqs
    assert len(a.seqs) == 2000
    assert all(len(s) == len(q) for s, q in zip(a.seqs, a.quals))
    bad = a.sp27 >= cfg["sp27_used"]
    assert bad.sum() == round(2000 * mix["invalid_share"])
    assert a.rc.sum() == 1000
    # the same number of reads on every valid bin, whatever the seed
    counts = np.bincount(a.sp5[~bad] * 12 + a.sp27[~bad], minlength=144)
    assert counts.max() - counts[counts > 0].min() <= 1
    assert np.array_equal(np.sort(counts), np.sort(np.bincount(
        c.sp5[c.sp27 < 8] * 12 + c.sp27[c.sp27 < 8], minlength=144)))
    # ~59 + 25 + 658 + 26 + 59 bases
    mean = np.mean([len(s) for s in a.seqs])
    assert abs(mean - 827) < 5


def test_demux_pool_reads_carry_their_adapters():
    cfg = load("configs", "coi_plate96.json")
    mix = dict(load("traffic", "plate_coi.json"), reads=200)
    b = gen.banks(cfg["bank_seed"])
    p = gen.demux_pool(9, dict(cfg, error_rate=0.0), mix)
    for s, i5, i27, rc in zip(p.seqs, p.sp5, p.sp27, p.rc):
        fwd = gen.to_str(3 - gen.to_codes(s)[::-1]) if rc else s
        assert fwd.startswith(b["sp5"][i5][1])
        assert fwd.endswith(b["sp27rc"][i27][1])


def test_sort_bins_repeat_and_match_the_mix():
    cfg = load("configs", "rrna_plate96.json")
    mix = dict(load("traffic", "bins_rrna_1k.json"), reads_per_bin=100)
    a = gen.sort_bins(5, cfg, mix, 3)
    b = gen.sort_bins(5, cfg, mix, 3)
    c = gen.sort_bins(6, cfg, mix, 3)
    assert [x.seqs for x in a] == [x.seqs for x in b]
    assert a[0].seqs != c[0].seqs
    for x, y in zip(a, c):
        assert len(x.ids) == 100
        assert np.bincount(x.species).tolist() == [50, 50]
        # template lengths are fixed by the bin, not by the seed
        assert len(x.planted[0]) == len(y.planted[0])
        lo, hi = cfg["insert_range"]
        assert lo + 40 <= len(x.planted[0]) <= hi + 40
    # the last of a pool is the first of the next ones
    assert gen.sort_bins(5, cfg, mix, 1, first=2)[0].seqs == a[2].seqs
