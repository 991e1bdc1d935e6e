"""Run metrics, spans and counters, and device tracing.

Copy of ``tpu_orc/utils/profiling.py``: :class:`Metrics` with its
:class:`StageMetric` and :class:`StageTimer` (:25-97), and
:func:`device_trace` (:100-111), whose ``jax.profiler`` trace becomes a
``torch.profiler`` one; the port adds spans and counters inside the
stages (:func:`span`, :func:`count`, :func:`recording`), which
``tpu_orc`` has not.

:class:`Metrics` accumulates one ``metrics.json`` per run and narrates
each stage to the log as it finishes; :func:`device_trace` records the
host's and the card's activity of a run into a Chrome/TensorBoard trace
when a trace directory is given (argument or ``TPU_ORC_TRACE``), and
does nothing otherwise.

Spans and counters record only inside a :func:`recording` block (which
:func:`device_trace` opens when it traces). Outside one, :func:`span`
costs a check of one module-level name and returns a shared null
context, and :func:`count` returns at once. Inside one, a span takes the
host clock at entry and exit, knows its parent (the enclosing span on
its thread), and is a ``torch.profiler.record_function`` annotation, so
that a profiler trace shows it on the clock of the card's kernels and
copies. The recorder keeps, per span name, the calls ``n``, ``total_s``,
``self_s`` (the total less the time its child spans cover) and
``parent`` (the enclosing span's name at its first call, None at the top
of a thread), and per counter name its sum.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StageMetric:
    stage: str
    wall_s: float
    counters: Dict[str, float]

    def as_dict(self) -> Dict:
        d = {"stage": self.stage, "wall_s": round(self.wall_s, 4)}
        d.update({k: round(v, 4) for k, v in self.counters.items()})
        for unit, n in self.counters.items():
            if unit.startswith("n_") and self.wall_s > 0:
                d[f"{unit[2:]}_per_s"] = round(n / self.wall_s, 1)
        return d


@dataclass
class Metrics:
    """Accumulates per-stage timings/counters; writes metrics.json."""
    run: str = "run"
    stages: List[StageMetric] = field(default_factory=list)
    verbose: bool = True

    def stage(self, name: str) -> "StageTimer":
        return StageTimer(self, name)

    def add(self, m: StageMetric):
        self.stages.append(m)
        if self.verbose:
            extras = " ".join(f"{k}={v}" for k, v in m.as_dict().items()
                              if k not in ("stage",))
            print(f"[tpu_orc] {self.run}/{m.stage}: {extras}", flush=True)

    def total_wall_s(self) -> float:
        return sum(m.wall_s for m in self.stages)

    def as_dict(self) -> Dict:
        return {"run": self.run,
                "total_wall_s": round(self.total_wall_s(), 4),
                "stages": [m.as_dict() for m in self.stages]}

    def write(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=2)


class StageTimer:
    """Context manager: times a stage and collects ``n_<unit>`` counters.

        with metrics.stage("demux") as st:
            ...
            st.count(n_reads=len(reads))

    The stage is also the span ``stage.<name>``.
    """

    def __init__(self, metrics: Metrics, name: str):
        self._metrics = metrics
        self._name = name
        self._counters: Dict[str, float] = {}

    def count(self, **counters: float):
        for k, v in counters.items():
            self._counters[k] = self._counters.get(k, 0.0) + float(v)

    def __enter__(self):
        self._span = span(f"stage.{self._name}")
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self._metrics.add(StageMetric(self._name, wall,
                                          dict(self._counters)))
        return False


class Recorder:
    """The spans and counters of one :func:`recording` block; safe to
    feed from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: Dict[str, list] = {}   # name -> [n, total, child, parent]
        self._counters: Dict[str, float] = {}

    def _thread(self):
        """This thread's open spans and its last span argument."""
        t = self._local
        if not hasattr(t, "stack"):
            t.stack, t.arg = [], None
        return t

    def _add(self, name: str, parent: Optional[str], total: float,
             child: float) -> None:
        with self._lock:
            e = self._spans.get(name)
            if e is None:
                self._spans[name] = [1, total, child, parent]
            else:
                e[0] += 1
                e[1] += total
                e[2] += child

    def _count(self, name: str, n: float) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> Dict[str, Dict]:
        """{name: {n, total_s, self_s, parent}}."""
        with self._lock:
            return {k: {"n": n, "total_s": tot, "self_s": tot - child,
                        "parent": parent}
                    for k, (n, tot, child, parent) in self._spans.items()}

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def as_dict(self) -> Dict:
        return {"spans": self.spans(), "counters": self.counters()}

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=2, sort_keys=True)


class _Span:
    __slots__ = ("rec", "name", "arg", "stack", "parent", "child", "rf",
                 "t0")

    def __init__(self, rec: Recorder, name: str, arg: Optional[str]):
        self.rec, self.name, self.arg = rec, name, arg

    def __enter__(self):
        t = self.rec._thread()
        if self.arg is None:
            self.arg = t.arg
        else:
            t.arg = self.arg
        self.stack = t.stack
        self.parent = t.stack[-1] if t.stack else None
        t.stack.append(self)
        self.child = 0.0
        from torch.profiler import record_function
        self.rf = record_function(self.name, self.arg)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(exc_type, exc, tb)
        self.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child += dt
        self.rec._add(self.name, parent and parent.name, dt, self.child)
        return False


#: the active recorder (None: spans and counters record nothing)
_REC: Optional[Recorder] = None
_NULL = contextlib.nullcontext()


def span(name: str, arg: Optional[str] = None):
    """Context manager: the span ``name`` inside a :func:`recording`
    block, the shared null context outside one. ``arg`` is the profiler
    annotation's argument (a chunk's number, say); a span given none
    carries the last one given on its thread."""
    rec = _REC
    if rec is None:
        return _NULL
    return _Span(rec, name, arg)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` inside a :func:`recording` block."""
    rec = _REC
    if rec is not None:
        rec._count(name, n)


@contextmanager
def recording():
    """Record spans and counters for the block; yields the
    :class:`Recorder`, read when the block ends. An inner block records
    into its own recorder, and the outer one resumes after it."""
    global _REC
    rec = Recorder()
    outer, _REC = _REC, rec
    try:
        yield rec
    finally:
        _REC = outer


@contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """``torch.profiler`` trace when a directory is given (argument or
    ``TPU_ORC_TRACE``); no-op otherwise. Records CPU activity, and CUDA
    activity where a CUDA device is present, and writes one gzipped
    Chrome trace (``<host>_<pid>.<ns>.pt.trace.json.gz``, TensorBoard's
    layout) and the block's spans and counters (:func:`recording`) as
    ``spans.json`` into the directory when the block ends. Yields the
    directory, or None."""
    trace_dir = trace_dir or os.environ.get("TPU_ORC_TRACE")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording() as rec:
        try:
            with profile(activities=activities,
                         on_trace_ready=tensorboard_trace_handler(
                             trace_dir, use_gzip=True)):
                yield trace_dir
        finally:
            rec.write(os.path.join(trace_dir, "spans.json"))
