"""The work counts behind the rooflines, on cases worked by hand."""
import numpy as np
import pytest

from orc_bench import peaks
from orc_bench.stages.demux_stream import Capture as DemuxCapture
from orc_bench.stages.sort_bins import Capture as SortCapture, _gate
from orc_bench.run import Ctx, Spans


def _ctx():
    ctx = Ctx("w", 1, 1.0, True, {}, {}, {}, "/nonexistent",
              spans=Spans(trace=True, active=True))
    return ctx


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(1.67e13 * 64 / 64, 0) == pytest.approx(
        1.67e13 / peaks.INT_OPS_PER_S)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.INT_OPS_PER_S == pytest.approx(1.6727e13, rel=1e-4)


def test_gene_stage_gate():
    g = _gate(np.array([100, 104, 106, 200]), 1.05)
    # 100-104 and 104-106 within 5%, 100-106 not, nothing with 200
    assert np.argwhere(g).tolist() == [[0, 1], [1, 2]]


def test_myers_work_counts_text_by_pattern_words():
    ctx = _ctx()
    cap = SortCapture(ctx)
    pl = np.array([[33], [64]])           # patterns of 2 and 2 words
    tl = np.array([[100, 10]])
    gate = np.array([[True, False], [True, True]])
    cap.myers(pl, tl, gate)
    # word steps: 100 * 2 + 100 * 2 + 10 * 2 = 420
    assert ctx.spans.counts["myers_ops"] == 420 * 20
    # bytes: sequences (33+100) + (64+100) + (64+10), 4 out a pair
    assert ctx.spans.counts["myers_bytes"] == 133 + 164 + 74 + 12


def test_locate_work_counts_reads_by_adapter_bases():
    class R:
        def __init__(self, seq):
            self.seq, self.id = seq, "x"
    ctx = _ctx()
    banks = {"sp5": [("a", "A" * 10), ("b", "A" * 20)],
             "sp27rc": [("c", "A" * 5)]}
    cap = DemuxCapture(ctx, 2, np.zeros(2, bool), banks)
    recs = [R("A" * 100), R("A" * 50)]
    # read 0 kept (round 2 on its 40 trimmed bases), read 1 not
    out = [(0, "a", R("A" * 40), None, None, 0, 0, 0, 0),
           (1, None, R("A" * 50), None, None, 0, 0, 0, 0)]
    cap.take(recs, out)
    # round 1: 2 x 150 x 30 cells; round 2: 2 x 40 x 5
    assert ctx.spans.counts["locate_ops"] == (2 * 150 * 30 + 2 * 40 * 5) * 16
    assert ctx.spans.counts["locate_bytes"] == (2 * (150 + 40)
                                                + 2 * 5 * 4 * (2 * 2 + 1))
