"""A whole run of each cell on the CPU at a tiny size, past the look for
a card: the sound program checks correct, and every fault of
``orc_bench/faults.py`` planted under the timed path makes ``correct``
false. The controls fail their comparison too."""
import pytest

from conftest import tiny
from orc_bench import control, faults
from orc_bench.run import Ctx, run_cell

CELLS = {"coi.demux": "demux_stream", "coi.sort": "sort_bins"}
CASES = [(w, f) for w, d in CELLS.items()
         for f in [None] + sorted(faults.FAULTS[d])]


def _run(workload, tmp_path, seed=8):
    cfg, mix, lim = tiny(workload)
    ctx = Ctx(workload, seed, 0.5, False, cfg, mix, lim, str(tmp_path),
              device="cpu")
    return run_cell(ctx)


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f or 'sound'}" for w, f in CASES])
def test_check_catches_the_fault(workload, fault, tmp_path, cpu_fused):
    if fault is None:
        out = _run(workload, tmp_path)
        assert out.correct, out.checks
        assert out.attempted > 0 and out.failed == 0
        return
    with faults.FAULTS[CELLS[workload]][fault]():
        out = _run(workload, tmp_path)
    assert not out.correct, out.checks
    assert out.failed > 0


def test_demux_control_fails():
    cfg, mix, _ = tiny("coi.demux")
    got = control.demux_control(8, cfg, mix, "cpu")
    assert got["decisions_wrong"] > 0 and got["reads"] == 300


def test_sort_control_fails():
    cfg, mix, _ = tiny("coi.sort")
    got = control.sort_control(8, cfg, dict(mix, check_pairs_per_bin=6),
                               "cpu", 2)
    assert got["sims_wrong"] > 0 and got["pairs"] == 12
