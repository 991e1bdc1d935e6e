"""Run metrics and device tracing.

Copy of ``tpu_orc/utils/profiling.py``: :class:`Metrics` with its
:class:`StageMetric` and :class:`StageTimer` (:25-97), the code
unchanged, and :func:`device_trace` (:100-111), whose ``jax.profiler``
trace becomes a ``torch.profiler`` one.

:class:`Metrics` accumulates one ``metrics.json`` per run and narrates
each stage to the log as it finishes; :func:`device_trace` records the
host's and the card's activity of a run into a Chrome/TensorBoard trace
when a trace directory is given (argument or ``TPU_ORC_TRACE``), and
does nothing otherwise.
"""
from __future__ import annotations

import json
import os
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
    """

    def __init__(self, metrics: Metrics, name: str):
        self._metrics = metrics
        self._name = name
        self._counters: Dict[str, float] = {}

    def count(self, **counters: float):
        for k, v in counters.items():
            self._counters[k] = self._counters.get(k, 0.0) + float(v)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        if exc_type is None:
            self._metrics.add(StageMetric(self._name, wall,
                                          dict(self._counters)))
        return False


@contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """``torch.profiler`` trace when a directory is given (argument or
    ``TPU_ORC_TRACE``); no-op otherwise. Records CPU activity, and CUDA
    activity where a CUDA device is present, and writes one gzipped
    Chrome trace (``<host>_<pid>.<ns>.pt.trace.json.gz``, TensorBoard's
    layout) into the directory when the block ends. Yields the
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
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     trace_dir, use_gzip=True)):
        yield trace_dir
