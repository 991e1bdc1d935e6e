"""The stage-05a cell ``rrna.extract``: its models and the HMMER3 writer,
its pool of contigs, its reference against the program's float64 host
Viterbi, the readers of its metrics, and whole runs on the CPU at a tiny
size (K 48 and 96, 6 samples) with the sound program, the control and
each planted fault."""
import math

import numpy as np
import pytest

from conftest import load
from orc_bench import gen_euk, peaks_fp32
from orc_bench.reference import barrnap as ref
from orc_bench.run import Ctx, load_reader, run_cell
from orc_bench.stages import rrna_extract as RE

CFG = load("configs", "rrna_barrnap_euk.json")
MIX = load("traffic", "rrna_cleaned_contigs.json")
LIM = load("limits", "rrna.extract.json")


def tiny_cfg():
    """The configuration at K 48 / 20 / 96, peaked enough that a whole
    18S or a 28S part scores over the program's fixed min_score 50."""
    cfg = dict(CFG, models=[dict(m, leng=k) for m, k in
                            zip(CFG["models"], (48, 20, 96))])
    cfg["draws"] = dict(CFG["draws"], p_consensus=[0.92, 0.99])
    return cfg


def tiny_mix():
    return dict(MIX, samples=6, contig_len=[150, 190], ssu_tail=[44, 48],
                its=[20, 40], lsu_head=[70, 96], check_samples=6)


def _tiny_ctx(tmp_path, seed=2**40 + 25):
    lim = dict(LIM, samples_checked_min=1)
    return Ctx("rrna.extract", seed, 1.0, False, tiny_cfg(), tiny_mix(), lim,
               str(tmp_path), device="cpu")


def test_models_follow_the_configuration():
    a = gen_euk.euk_models(2**40 + 1, CFG)
    b = gen_euk.euk_models(2**40 + 1, CFG)
    assert [(m.name, m.K) for m in a] == [("18S_rRNA", 1831),
                                          ("5_8S_rRNA", 154),
                                          ("28S_rRNA", 3401)]
    for m, n in zip(a, b):
        assert np.array_equal(m.match, n.match)
        np.testing.assert_allclose(m.match.sum(axis=1), 1.0)
        np.testing.assert_allclose(m.trans[:, :3].sum(axis=1), 1.0)
        np.testing.assert_allclose(m.trans[:, 3:5].sum(axis=1), 1.0)
        np.testing.assert_allclose(m.trans[:, 5:].sum(axis=1), 1.0)
        pc = m.match[np.arange(m.K), m.cons]
        assert (pc >= 0.55).all() and (pc <= 0.97).all()
        assert m.trans[-1, 2] == m.trans[-1, 6] == 0.0


@pytest.mark.parametrize("K", [48, 96])
def test_hmmer3_writer_round_trips_through_both_readers(tmp_path, K):
    """The file the cell writes reads back, through the program's
    ``parse_hmmer3`` and the reference's own reader, as the drawn
    probabilities' scores to the 5 decimals written; '*' as -1e9."""
    from tpu_orc_torch.rrna.hmm import parse_hmmer3
    cfg = dict(CFG, models=[dict(m, leng=K + i) for i, m in
                            enumerate(CFG["models"])])
    models = gen_euk.euk_models(2**40 + K, cfg)
    path = str(tmp_path / "euk.hmm")
    gen_euk.write_hmmer3(path, models)
    port = {m.name: m for m in parse_hmmer3(path)}
    mine = ref.read_hmmer3(path)
    assert list(port) == list(mine) == [m.name for m in models]
    for m in models:
        want_m = np.log(m.match) - math.log(0.25)
        with np.errstate(divide="ignore"):
            want_t = np.where(m.trans > 0, np.log(m.trans), -1e9)
        for got in (port[m.name], mine[m.name]):
            ms = getattr(got, "match_scores", getattr(got, "match", None))
            np.testing.assert_allclose(ms, want_m, atol=1e-5, rtol=0)
            np.testing.assert_allclose(got.t, want_t, atol=1e-5, rtol=0)
        assert np.array_equal(port[m.name].match_scores, mine[m.name].match)
        assert np.array_equal(port[m.name].t, mine[m.name].t)


def test_pool_repeats_and_meets_the_mix():
    models = gen_euk.euk_models(2**40 + 5, CFG)
    mix = dict(MIX, samples=200)
    a = gen_euk.contig_pool(2**40 + 5, CFG, mix, models)
    b = gen_euk.contig_pool(2**40 + 5, CFG, mix, models)
    c = gen_euk.contig_pool(2**40 + 6, CFG, mix, models)
    assert a.samples == b.samples and a.samples != c.samples
    per = np.array([len(s) for s in a.samples])
    assert sorted(np.bincount(per)) == [0, 66, 67, 67]
    n = per.sum()
    assert (a.kind == gen_euk.NO_LSU).sum() == round(n * MIX["no_lsu_share"])
    assert (a.kind == gen_euk.NO_GENE).sum() == round(n * MIX["no_gene_share"])
    assert a.rc.sum() == n // 2
    L = np.array([len(s) for s in sum(a.samples, [])])
    full = L[a.kind != gen_euk.NO_LSU]
    # 0.01 noise moves a contig's length by a few bases
    assert full.min() > 3200 * 0.98 and full.max() < 3600 * 1.02
    assert set("".join(sum(a.samples, []))) <= set("ACGT")


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_scan_equals_the_program_host_viterbi(seed):
    """The reference's planes give viterbi_host's float64 score and end
    position on every sequence, forward and on the reversed profile."""
    from tpu_orc_torch.rrna.hmm import ProfileHMM, viterbi_host
    rng = np.random.default_rng(seed)
    K = 40
    match = rng.normal(-1.0, 0.8, (K, 4))
    match[np.arange(K), rng.integers(0, 4, K)] = 1.3
    t = rng.normal(-2.0, 0.8, (K, 7))
    t[rng.random(K) < 0.1, 6] = -1e9
    p = ref.Profile("p", match, t)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (1, 30, 90, 61)]
    seqs[2][10:10 + K] = match.argmax(axis=1)
    for prof in (p, p.reversed()):
        sc = ref.viterbi(prof, seqs, "cpu")
        for b, s in enumerate(seqs):
            best, pos, _ = viterbi_host(ProfileHMM("p", prof.match, prof.t),
                                        s)
            assert abs(sc.best[b] - best) < 1e-9
            assert sc.end[b] == pos
            assert sc.row[b, pos - 1] == sc.best[b]


def test_readers_of_the_cell():
    layer = {"trace": {"window_s": 10.0, "busy_s": 2.5,
                       "kernel_s": {"viterbi_kernel<16>": 1.0,
                                    "viterbi_kernel<8>": 1.0,
                                    "Memcpy HtoD ": 0.5}},
             "counts": {"viterbi_cells": 4.0e9},
             "program": {"counters": {"viterbi.cells_launched": 5.0e9}}}
    least = 4.0e9 * 15 / (132 * 128 * 1.98e9)
    assert peaks_fp32.viterbi_least_seconds(4.0e9) == pytest.approx(least)
    assert load_reader("viterbi_roofline.extract")(layer) == pytest.approx(
        100 * least / 2.0)
    assert load_reader("viterbi_useful.extract")(layer) == pytest.approx(80)
    assert load_reader("device_idle.extract")(layer) == pytest.approx(75)
    # the parent's program has no counters, the CPU no kernels
    bare = {"trace": dict(layer["trace"], kernel_s={}), "counts": {},
            "program": {}}
    assert load_reader("viterbi_roofline.extract")(bare) is None
    assert load_reader("viterbi_useful.extract")(bare) is None


def test_check_passes_the_sound_program(tmp_path):
    out = run_cell(_tiny_ctx(tmp_path))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.e2e["demux_reads_per_s"] > 0


def test_check_passes_the_control(tmp_path):
    """A float32 scan with the D->D prefix in a running order: sound."""
    with RE.control():
        out = run_cell(_tiny_ctx(tmp_path))
    assert out.correct, out.checks


@pytest.mark.parametrize("fault", sorted(RE.FAULTS))
def test_check_catches_the_fault(fault, tmp_path):
    with RE.FAULTS[fault]():
        out = run_cell(_tiny_ctx(tmp_path))
    assert not out.correct, out.checks
    assert out.failed > 0
    assert out.checks["sample_short"]["value"] == 0
