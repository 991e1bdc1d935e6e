"""Reading a ``torch.profiler`` Chrome trace of the measured window.

The harness marks the window with the annotation :data:`WINDOW`, and
the calls into the program's layers with its own annotations (the
stages name them); the device's work is every kernel, copy and set
event. From those, :func:`summarize` gives the window's length, the
seconds in which the device was busy (the union of its events inside
the window), device seconds by kernel name, and the idle gaps of the
device by the host annotation they fell in.
"""
from __future__ import annotations

import bisect
import gzip
import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

WINDOW = "orc_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.split("(", 1)[0]
    return name[5:] if name.startswith("void ") else name


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(a: float, b: float, spans: List[Tuple[float, float]],
             starts: List[float]) -> float:
    """Length of [a, b] covered by ``spans`` (disjoint, sorted; their
    starts in ``starts``)."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0.0
    while k < len(spans) and spans[k][0] < b:
        x, y = spans[k]
        tot += max(0.0, min(b, y) - max(a, x))
        k += 1
    return tot


def load(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def summarize(events: Sequence[dict], inner: Sequence[str] = (),
              outer: Sequence[str] = ()) -> Dict:
    """{window_s, busy_s, kernel_s: {name: s}, device_ops, idle_gaps}.
    An idle gap's share inside an ``inner`` annotation goes to that
    name, the rest inside an ``outer`` one to that name, the rest to
    "harness". Times in seconds."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if not win:
        raise ValueError("the trace holds no measured window")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = defaultdict(float)
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                by_name[short_name(e["name"])] += (b - a) * 1e-6
        elif e.get("cat") == "user_annotation" and (
                e["name"] in inner or e["name"] in outer):
            spans[e["name"]].append((a, b))
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle: Dict[str, float] = defaultdict(float)
    cover = {n: _union(spans[n]) for n in (*inner, *outer)}
    starts = {n: [x for x, _ in sp] for n, sp in cover.items()}
    for a, b in gaps:
        ins = 0.0
        for n in inner:
            o = _overlap(a, b, cover[n], starts[n])
            idle[n] += o * 1e-6
            ins += o
        outs = 0.0
        for n in outer:   # the inner annotations lie inside an outer one
            o = max(_overlap(a, b, cover[n], starts[n]) - ins, 0.0)
            idle[n] += o * 1e-6
            outs += o
        idle["harness"] += max(b - a - ins - outs, 0.0) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items() if v > 0),
                           key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernel_s": dict(by_name),
            "device_ops": top(by_name),
            "idle_gaps": top(idle)}
