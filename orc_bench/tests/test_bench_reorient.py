"""The stage-01 cell ``rrna.reorient``: its generator of raw reads, the
work count behind its roofline, its reference on cases made by hand, and
a whole run on the CPU at a tiny size with the sound program, each
planted fault and the control."""
import random

import numpy as np
import pytest

from conftest import load
from orc_bench import gen_raw, peaks
from orc_bench.reference import pychopper as P
from orc_bench.run import Ctx, Spans, run_cell
from orc_bench.stages import reorient_stream as RS

CFG = load("configs", "rrna_pychopper96.json")
MIX = load("traffic", "raw_rrna_stream.json")
PRIMERS = gen_raw.pychopper_primers(CFG["bank_seed"])
CONFIG = CFG["orientation_config"]


def _rand(rnd, n):
    return "".join(rnd.choice("ACGT") for _ in range(n))


def _fill(primer, rnd):
    return "".join(rnd.choice("ACGT") if c == "N" else c for c in primer)


def test_raw_pool_repeats_and_meets_the_mix():
    mix = dict(MIX, reads=2000)
    a = gen_raw.raw_pool(2**40 + 3, CFG, mix)
    b = gen_raw.raw_pool(2**40 + 3, CFG, mix)
    c = gen_raw.raw_pool(2**40 + 4, CFG, mix)
    assert a.seqs == b.seqs and a.quals == b.quals
    assert a.seqs != c.seqs
    for k, key in gen_raw.SHARES.items():
        assert (a.kind == k).sum() == (c.kind == k).sum() == round(
            2000 * MIX[key])
    assert a.rc.sum() == 1000
    L = np.array([len(s) for s in a.seqs])
    assert all(len(s) == len(q) for s, q in zip(a.seqs, a.quals))
    unit = (59 + 20 + np.array(CFG["insert_range"]) + 20 + 59)
    for k in (gen_raw.NORMAL, gen_raw.LOW_Q, gen_raw.NO_PRIMER):
        m = L[a.kind == k]
        # noise moves a read's length by a few percent at most
        assert unit[0] * 0.97 < m.min() and m.max() < (unit[1] + 120) * 1.03
    fused = L[a.kind == gen_raw.FUSED]
    assert fused.min() > 2 * unit[0] * 0.97 and fused.max() < 8192
    assert L[a.kind == gen_raw.TRUNCATED].max() < unit[1] + 120
    mq = P.mean_q(a.quals)
    assert (mq[a.kind == gen_raw.LOW_Q] < 10).all()
    assert (mq[a.kind != gen_raw.LOW_Q] >= 10).all()
    # the bins as the demux stream lays them out: 10% on SP27_009-012
    assert round(2000 * MIX["invalid_share"]) == (a.sp27 >= 8).sum()


def test_pychopper_primers_carry_n17():
    (n5, sp5), (n27, sp27) = PRIMERS
    assert (n5, n27) == ("SP5", "SP27")
    assert len(sp5) == len(sp27) == 59
    assert sp5[25:42] == "N" * 17 and sp27[25:42] == "N" * 17
    assert sp5.endswith("GGCCAG")


def test_infix_work_counts_reads_by_primer_bases():
    ctx = Ctx("w", 1, 1.0, True, {}, {}, {}, "/nonexistent",
              spans=Spans(trace=True, active=True))

    class Bank:
        lens = np.array([59, 59, 59, 59])
    RS.Capture(ctx).take(Bank, ["A" * 100, "C" * 50])
    # 150 read bases x 236 primer bases, 16 a cell; 150 bytes in, and
    # 8 int32 out for each of 2 reads x 4 primers
    assert ctx.spans.counts["locate_ops"] == 150 * 236 * 16
    assert ctx.spans.counts["locate_bytes"] == 150 + 8 * 4 * 4 * 2
    assert peaks.OPS_PER_LOCATE_CELL == 16


def test_reference_finds_an_n17_hit_exactly():
    rnd = random.Random(1)
    sp5 = PRIMERS[0][1]
    read = _rand(rnd, 40) + _fill(sp5, rnd) + _rand(rnd, 300)
    chopper = P.Pychopper(PRIMERS, CONFIG)
    best = P.scan(chopper.seqs, [read], [chopper.budgets(0.9)])
    assert chopper.budgets(0.9) == [5] * 4
    assert best.found[0, 0].tolist() == [True, False, False, False]
    assert (best.qstart[0, 0, 0], best.qstop[0, 0, 0]) == (40, 99)
    assert (best.errors[0, 0, 0], best.matches[0, 0, 0]) == (0, 59)
    # two substitutions outside the N17: two edits, still found
    bad = read[:45] + ("A" if read[45] != "A" else "C") + read[46:90] + (
        "A" if read[90] != "A" else "C") + read[91:]
    best = P.scan(chopper.seqs, [bad], [chopper.budgets(0.9)])
    assert (best.errors[0, 0, 0], best.matches[0, 0, 0]) == (2, 57)


def test_reference_masked_rescan_finds_the_second_location():
    rnd = random.Random(2)
    sp5 = PRIMERS[0][1]
    read = (_rand(rnd, 20) + _fill(sp5, rnd) + _rand(rnd, 200)
            + _fill(sp5, rnd) + _rand(rnd, 20))
    chopper = P.Pychopper(PRIMERS, CONFIG)
    one = chopper.locations([read], 0.9, max_segments=1)[0]
    assert [h[:3] for h in one] == [(0, 20, 79)]
    both = chopper.locations([read], 0.9)[0]
    assert [h[:3] for h in both] == [(0, 20, 79), (0, 279, 338)]
    # the mask matches only the primer's N17: a masked span is not found
    masked = P._masked(read, both)
    best = P.scan(chopper.seqs, [masked], [chopper.budgets(0.9)])
    assert not best.found[0, 0].any()


def test_reference_rescues_a_fused_read_into_two_segments():
    rnd = random.Random(3)
    sp5, sp27 = PRIMERS[0][1], PRIMERS[1][1]
    unit = lambda: _fill(sp5, rnd) + _rand(rnd, 300) + P.revcomp(
        _fill(sp27, rnd))
    u1, u2 = unit(), unit()
    read = _rand(rnd, 30) + u1 + _rand(rnd, 10) + P.revcomp(u2) + _rand(
        rnd, 30)
    qual = "".join(chr(33 + 20 + k % 10) for k in range(len(read)))
    chopper = P.Pychopper(PRIMERS, CONFIG)
    got = chopper.run([("f", read, qual)], 0.9)[0]
    s2 = 30 + len(u1) + 10
    assert got == [("rescued", "f", u1, qual[30:30 + len(u1)]),
                   ("rescued", "f|seg1", u2,
                    qual[s2:s2 + len(u2)][::-1])]
    assert P.route(got) == ("rescued",)


def test_reference_sends_a_low_q_read_to_unclass_as_it_came():
    rnd = random.Random(4)
    read = _fill(PRIMERS[0][1], rnd) + _rand(rnd, 200) + P.revcomp(
        _fill(PRIMERS[1][1], rnd))
    low = "+" * len(read)                  # Phred 10: kept
    lower = "*" * len(read)                # Phred 9: filtered
    chopper = P.Pychopper(PRIMERS, CONFIG)
    got = chopper.run([("a", read, low), ("b", read, lower)], 0.9)
    assert got[0] == [("pass", "a", read, low)]
    assert got[1] == [("unclass", "b", read, lower)]


def test_reference_autotune_takes_the_strictest_q_near_the_top():
    rnd = random.Random(5)
    sp5, sp27 = PRIMERS[0][1], PRIMERS[1][1]
    reads = []
    for k in range(20):
        s = _fill(sp5, rnd) + _rand(rnd, 100) + P.revcomp(_fill(sp27, rnd))
        # read k carries k // 4 substitutions at the SP5 head
        s = "".join(("A" if c != "A" else "C") if i < k // 4 * 2
                    and i % 2 == 0 else c for i, c in enumerate(s))
        reads.append(s)
    chopper = P.Pychopper(PRIMERS, CONFIG)
    # edits 0..4 a read (4 reads each): all 20 within 5 at q 0.9, 12
    # within 2 at q 0.95, under the 95% knee; the first 12 all at 0.95
    assert chopper.autotune(reads) == 0.9
    assert chopper.autotune(reads[:12]) == 0.95
    assert chopper.autotune([]) == P.GRID[4]


@pytest.mark.parametrize("counts,q", [
    # seed 4420000001's first 500 kept reads: junk classifies from 0.70
    ([396, 465, 465, 465, 466, 490, 492, 490, 490], 0.9),
    ([424, 469, 469, 469, 469, 490, 494, 495, 495], 0.9),
    ([0, 0, 0, 450, 470, 480, 480, 490, 495], 0.8),
    ([19, 20, 20, 20, 20, 20, 20, 20, 20], 0.95),
    ([0] * 9, 0.95)])
def test_reference_knee_is_the_plateau_not_the_top(counts, q):
    assert P.knee(counts) == q


def _tiny_ctx(tmp_path, seed=2**40 + 11):
    cfg = dict(CFG, insert_range=[100, 400])
    mix = dict(MIX, reads=160, block=64, warm_reads=16, check_reads=160,
               check_block=256)
    lim = dict(load("limits", "rrna.reorient.json"), reads_checked_min=16)
    return Ctx("rrna.reorient", seed, 0.5, False, cfg, mix, lim,
               str(tmp_path), device="cpu")


@pytest.mark.parametrize("fault", [None] + sorted(RS.FAULTS))
def test_check_catches_the_fault(fault, tmp_path):
    if fault is None:
        out = run_cell(_tiny_ctx(tmp_path))
        assert out.correct, out.checks
        assert out.attempted > 0 and out.failed == 0
        return
    with RS.FAULTS[fault]():
        out = run_cell(_tiny_ctx(tmp_path))
    assert not out.correct, out.checks
    assert out.failed > 0


def test_control_fails(tmp_path):
    ctx = _tiny_ctx(tmp_path)
    with RS.control(ctx):
        out = run_cell(ctx)
    # the control's fused reads come out whole, and nothing else differs
    got = {k: c["value"] for k, c in out.checks.items()}
    assert not out.correct and got["records_wrong"] > 0, got
    assert got["q_wrong"] == got["reads_unaccounted"] == 0, got
