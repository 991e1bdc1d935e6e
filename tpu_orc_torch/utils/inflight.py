"""The dispatch-ahead window of stages 01 and 02.

CUDA launches are asynchronous: a dispatch (pack, upload, launch)
returns a handle on work the card runs while the host goes on, and a
collect (the copy back) waits for it. Stage 01's primer scans
(``demux/reorient.py``) and stage 02's fused demux (``demux/fused.py``)
run their batches through :func:`dispatch_ahead`, so that the host packs
later batches while the card computes earlier ones.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional

from .profiling import count

#: the most batches dispatched and not yet collected: a million-read
#: input must not stage all its read matrices on the card at once, and 8
#: keep the host packing while the card computes
MAX_INFLIGHT = 8


def dispatch_ahead(items: Iterable, dispatch: Callable, collect: Callable,
                   depth: Optional[int] = MAX_INFLIGHT,
                   counter: Optional[str] = None) -> Iterator[tuple]:
    """Yield ``(item, collect(dispatch(item)))`` for each of ``items``, in
    order, with at most ``depth`` items dispatched and not yet collected:
    dispatch 0 to depth - 1, collect 0, dispatch depth, collect 1, and so
    on; item k + depth is dispatched only once the caller has taken item
    k's result. ``depth=None`` dispatches every item before the first
    collect. ``counter`` names a counter that sums, at each collect, the
    items in flight (that one included)."""
    pending: deque = deque()

    def _collect_one():
        if counter is not None:
            count(counter, len(pending))
        item, handle = pending.popleft()
        return item, collect(handle)

    for item in items:
        pending.append((item, dispatch(item)))
        if depth is not None and len(pending) >= depth:
            yield _collect_one()
    while pending:
        yield _collect_one()
