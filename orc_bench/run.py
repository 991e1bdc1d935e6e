"""Run one benchmark cell: ``python3 -m orc_bench.run --workload NAME
--seed N --seconds S --trace 0|1`` from the root of a checkout.

The cell is looked up in ``BENCHMARK.json``; its configuration in
``orc_bench/configs/<config>.json``, its traffic mix in
``orc_bench/traffic/<traffic>.json`` (which names the module in
``orc_bench/stages/`` that runs it), the limits of its correctness
check in ``orc_bench/limits/<workload>.json`` and each per-layer metric's
reader in ``orc_bench/metrics/<metric>.py``. A run makes its inputs from
``--seed``, loads and warms up, measures for ``--seconds`` seconds,
checks what the measured window produced against the plain reference in
``orc_bench/reference/``, and prints one JSON line last on standard
output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace of
the window. Each number checked is printed with its limit on the last
lines of standard error and under ``checks``, the line's last key.

Exit codes: 0 with a result line; 2 without a CUDA card (or with fewer
than the cell needs), 3 when JAX or the JAX package was loaded, 4 when
an input file is missing: no result line in those cases.
"""
from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import contextlib  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, List, Optional, Sequence  # noqa: E402

from orc_bench import nojax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start() -> float:
    """The wall-clock time at which this process started (from /proc;
    the import of this module where that cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(ln.split()[1]) for ln in fh
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


@dataclass
class Spans:
    """Host seconds and counts per name, summed over the window; with
    ``trace`` each span is also a profiler annotation."""
    trace: bool = False
    seconds: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    active: bool = False

    @contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        rf = None
        if self.trace:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def count(self, name: str, n: float) -> None:
        if self.active:
            self.counts[name] = self.counts.get(name, 0.0) + n


@dataclass
class Ctx:
    """What a stage module gets: the cell and its files, the run's
    arguments, a work directory that the run deletes, and the spans."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    cfg: Dict
    mix: Dict
    limits: Dict
    workdir: str
    device: str = "cuda"
    spans: Spans = field(default_factory=Spans)
    t_start: float = field(default_factory=process_start)


@dataclass
class Outcome:
    """What a stage module returns: the window's end-to-end numbers, the
    check, and what the per-layer readers read."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int = 0
    layer: Dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


def note(ctx: Ctx, msg: str) -> None:
    """A line of progress on standard error, with the seconds since the
    process started."""
    print(f"orc_bench: {time.time() - ctx.t_start:8.3f} s  {msg}",
          file=sys.stderr, flush=True)


def tree_bytes(path: str) -> int:
    """The bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def sync(ctx: Ctx) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(ctx: Ctx) -> int:
    """The process's peak of device memory so far (0 on the CPU), then
    the allocator's cache handed back, so that the check after it runs
    on a free card."""
    import torch
    if torch.device(ctx.device).type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return int(peak)


def measure(ctx: Ctx, body: Callable[[float], object],
            inner: Sequence[str], outer: Sequence[str]):
    """Run ``body(t0)`` as the measured window, ``t0`` its start on the
    ``perf_counter`` clock, the card synchronised at its end. Returns
    (body's value, window seconds, set-up seconds, layer): set-up is
    from process start to the window's start; traced, ``layer`` holds
    the trace's summary (:func:`orc_bench.trace.summarize` with the
    annotations ``inner`` and ``outer``) and the spans' seconds and
    counts."""
    import torch
    from . import trace
    prof = None
    if ctx.trace:
        act = torch.profiler.ProfilerActivity
        acts = [act.CPU] + ([act.CUDA] if torch.device(ctx.device).type
                            == "cuda" else [])
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    # what set-up made lives to the end: keep the collector off it
    gc.collect()
    gc.freeze()
    ctx.spans.active = True
    with (torch.profiler.record_function(trace.WINDOW) if ctx.trace
          else contextlib.nullcontext()):
        setup_s = time.time() - ctx.t_start
        t0 = time.perf_counter()
        value = body(t0)
        sync(ctx)
        window = time.perf_counter() - t0
    ctx.spans.active = False
    layer: Dict = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(ctx.workdir, "trace.json")
        prof.export_chrome_trace(path)
        layer = {"trace": trace.summarize(trace.load(path), inner, outer),
                 "spans": dict(ctx.spans.seconds),
                 "counts": dict(ctx.spans.counts), "window_s": window}
        os.unlink(path)
    print(f"orc_bench: set-up {setup_s:.3f} s, window {window:.3f} s",
          file=sys.stderr, flush=True)
    return value, window, setup_s, layer


def read_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_reader(name: str):
    """The reader of per-layer metric ``name``
    (``orc_bench/metrics/<name>.py``'s ``read``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"orc_bench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_env() -> None:
    """Every compile cache inside the checkout, at fixed paths (the
    port's kernels build into ``build/tpu_orc_torch`` by themselves)."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv_cache")


def device_line(torch, peak: int, layer: Optional[Dict]) -> Dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1, "memory_peak_bytes": int(peak)}
    if layer is not None:
        d["busy_s"] = layer["trace"]["busy_s"]
        d["window_s"] = layer["trace"]["window_s"]
    return d


def run_cell(ctx: Ctx) -> Outcome:
    drv = importlib.import_module(f"orc_bench.stages.{ctx.mix['stage']}")
    return drv.run(ctx)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m orc_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = read_json(ROOT, "BENCHMARK.json")
        cell = next(w for w in bench["workloads"]
                    if w["name"] == args.workload)
        cfg = read_json(HERE, "configs", f"{cell['config']}.json")
        mix = read_json(HERE, "traffic", f"{cell['traffic']}.json")
        limits = read_json(HERE, "limits", f"{args.workload}.json")
    except (OSError, StopIteration, KeyError) as exc:
        print(f"orc_bench: no such cell or file: {exc!r}", file=sys.stderr)
        return 4
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"orc_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {cards}", file=sys.stderr)
        return 2
    cache_env()
    # one process with few threads: no pool of CPU threads spins beside
    # the host work that the cells measure
    torch.set_num_threads(1)
    work = tempfile.mkdtemp(prefix="orc_bench_")
    try:
        ctx = Ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                  cfg, mix, limits, work)
        ctx.spans.trace = ctx.trace
        out = run_cell(ctx)
        print(f"orc_bench: {args.workload} seed {args.seed}: whole run "
              f"{time.time() - ctx.t_start:.3f} s", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = nojax.forbidden_loaded()
    if bad:
        print(f"orc_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if args.workload in m.get("workloads", [args.workload]):
                v = load_reader(m["name"])(out.layer)
                if v is not None:      # a reader that found nothing
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.e2e.items() if k in units}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": device_line(torch, out.memory_peak_bytes,
                                  out.layer if args.trace else None)}
    if args.trace:
        line["breakdown"] = {"device_ops": out.layer["trace"]["device_ops"],
                             "idle_gaps": out.layer["trace"]["idle_gaps"]}
    line["checks"] = out.checks
    for k, c in out.checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
