"""The host pipeline shared by stages 01 and 02 of tpu_orc_torch: the
dispatch-ahead window (``utils/inflight.py``), the record formatter
(``io/fastq.py::format_records``) and the length-bucket rule
(``io/encode.py::bucket_len``), each held against the code it replaced,
copied here: the hand-rolled windows of ``FusedDemux.assign`` and
``Reorienter.run`` and the dispatch-all loops of the autotune and the
enumeration, the f-strings of the three writers, and the two bucket
tables of ``demux.py`` and ``fused.py``.
"""
from collections import deque

import pytest

from tpu_orc_torch.io import encode
from tpu_orc_torch.io.fastq import Record, format_records
from tpu_orc_torch.utils.inflight import MAX_INFLIGHT, dispatch_ahead
from tpu_orc_torch.utils.profiling import recording


def old_window(items, dispatch, collect, use, depth):
    """The loops the window replaced: depth MAX_INFLIGHT as in
    ``FusedDemux.assign`` and ``Reorienter.run``, None as in the
    autotune and each enumeration round."""
    if depth is None:
        handles = [dispatch(x) for x in items]
        for x, h in zip(items, handles):
            use(x, collect(h))
        return
    pend = deque()

    def _drain_one():
        x, h = pend.popleft()
        use(x, collect(h))

    for x in items:
        pend.append((x, dispatch(x)))
        if len(pend) >= depth:
            _drain_one()
    while pend:
        _drain_one()


class Log:
    """Dispatches, collects and uses in the order they happen."""

    def __init__(self):
        self.events = []

    def dispatch(self, x):
        self.events.append(("dispatch", x))
        return ("handle", x)

    def collect(self, h):
        self.events.append(("collect", h[1]))
        return h[1] * 10

    def use(self, x, r):
        assert r == x * 10
        self.events.append(("use", x))


@pytest.mark.parametrize("n", [0, 1, 8, 9, 20])
@pytest.mark.parametrize("depth", [1, 3, 8, None])
def test_dispatch_ahead_order_and_depth(depth, n):
    """Results in item order; never more than ``depth`` items in flight
    (None: every item dispatched before the first collect); the same
    dispatches, collects and uses, in the same order, as the old loop;
    the counter sums the items in flight at each collect."""
    items = list(range(n))
    new, old = Log(), Log()
    with recording() as rec:
        got = []
        for x, r in dispatch_ahead(items, new.dispatch, new.collect, depth,
                                   counter="t.depth"):
            got.append(x)
            new.use(x, r)
    old_window(items, old.dispatch, old.collect, old.use, depth)
    assert got == items
    assert new.events == old.events
    inflight, most, summed = 0, 0, 0
    for kind, _ in new.events:
        if kind == "dispatch":
            inflight += 1
            most = max(most, inflight)
        elif kind == "collect":
            summed += inflight
            inflight -= 1
    assert inflight == 0
    assert most == min(n, depth or n)
    assert rec.counters().get("t.depth", 0) == summed
    if depth is None and n:
        first = new.events.index(("collect", 0))
        assert new.events[:first] == [("dispatch", x) for x in items]


def test_dispatch_ahead_default_depth_is_the_window():
    log = Log()
    for x, r in dispatch_ahead(range(20), log.dispatch, log.collect):
        log.use(x, r)
    first = log.events.index(("collect", 0))
    assert first == MAX_INFLIGHT == 8


@pytest.mark.parametrize("depth", [1, 8, None])
def test_dispatch_ahead_collect_error_reaches_caller(depth):
    """An exception raised in ``collect`` reaches the caller, after the
    results before it, and nothing is collected after it."""
    collected, used = [], []

    def collect(h):
        collected.append(h)
        if h == 4:
            raise ValueError("fetch failed")
        return h

    with pytest.raises(ValueError, match="fetch failed"):
        for x, r in dispatch_ahead(range(12), lambda x: x, collect, depth):
            used.append(r)
    assert used == [0, 1, 2, 3]
    assert collected == [0, 1, 2, 3, 4]


def old_text(records, fmt):
    """The f-strings of ``write_records``, ``_BinWriters.write`` and
    ``reorient_stream`` before they shared ``format_records``."""
    if fmt == "fastq":
        return "".join(f"@{r.desc}\n{r.seq}\n+\n{r.qual or ''}\n"
                       for r in records)
    return "".join(f">{r.desc}\n{r.seq}\n" for r in records)


@pytest.mark.parametrize("qual", ["IIII5", None, ""])
@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_format_records_byte_equal(fmt, qual):
    recs = [Record("r1", "r1 rc", "ACGTN", qual),
            Record("r2", "r2 x=1", "", "" if qual is not None else None),
            Record("", "", "AC", qual and qual[:2])]
    assert format_records(recs, fmt) == old_text(recs, fmt)
    assert format_records(iter(recs), fmt) == old_text(recs, fmt)
    assert format_records([], fmt) == ""


def old_bucket_pad(n: int) -> int:
    """``demux.py::_bucket_pad`` before ``bucket_len``."""
    for cap in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096,
                8192):
        if n <= cap:
            return cap
    return encode.pad_to(n, 8192)


def old_pick_len(n: int, default_cap: int) -> int:
    """``fused.py::_pick_len`` before ``bucket_len``."""
    for cap in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096,
                8192):
        if n <= cap:
            return max(cap, default_cap) if cap <= default_cap else cap
    return encode.pad_to(n, 8192)


def test_bucket_len_equals_both_old_tables():
    """For every n from 1 to 20,000: ``bucket_len`` is the old
    ``_bucket_pad``, and ``assign``'s floor over it is the old
    ``_pick_len`` (floor 256, ``assign``'s default, and others up to
    8,192)."""
    for n in range(1, 20001):
        L = encode.bucket_len(n)
        assert L == old_bucket_pad(n), n
        for floor in (1, 256, 640, 8192):
            assert max(L, floor) == old_pick_len(n, floor), (n, floor)
