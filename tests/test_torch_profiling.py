"""tpu_orc_torch ``utils/profiling.py``: ``device_trace``, the spans and
counters, and ``run_all``'s ``trace_dir``.

The two cases of ``tests/test_profiling.py`` for tpu_orc's
``jax.profiler`` trace, for the port's ``torch.profiler`` one: a no-op
without a directory, a trace file with one. ``TPU_ORC_TRACE`` names the
directory as it does in tpu_orc. ``run_all`` with a trace directory
writes a trace, ``spans.json`` and the same files as without one
(timings aside). Spans and counters record nothing outside
``recording()``; inside it, stage 02's stream and the fused demux (its
plain locate on the CPU) record every span with its parent (stage 02's
bin writer threads their own), and write what an unrecorded run
writes.
"""
import gzip
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_orc.io.fastq import write_records
from tpu_orc_torch import synthetic
from tpu_orc_torch.demux import demux as port_demux
from tpu_orc_torch.demux import fused as port_fused
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.demux.demux import dual_round_demux_stream
from tpu_orc_torch.io import encode
from tpu_orc_torch.pipeline import stages as port_stages
from tpu_orc_torch.utils import profiling
from tpu_orc_torch.utils.profiling import (count, device_trace, recording,
                                           span)

from test_torch_stages import assert_same_tree, fields_of

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

TIMED = ("metrics.json", "run_report.json")


def _traces(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith(".pt.trace.json.gz")]


def test_device_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("TPU_ORC_TRACE", raising=False)
    with device_trace(None) as d:
        assert d is None


def test_device_trace_writes_profile(tmp_path):
    with device_trace(str(tmp_path / "tr")) as d:
        assert d is not None
        (torch.ones((8, 8)) @ torch.ones((8, 8))).sum()
    found = _traces(tmp_path / "tr")
    assert len(found) == 1, "no profiler artifacts written"
    with gzip.open(found[0], "rt") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::mm" in names


def test_device_trace_reads_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_ORC_TRACE", str(tmp_path / "env"))
    with device_trace() as d:
        assert d == str(tmp_path / "env")
        torch.ones(4).sum()
    assert len(_traces(tmp_path / "env")) == 1


@pytest.fixture(scope="module")
def traced_run_all(tmp_path_factory):
    """The COI plate of test_torch_stages (36 reads) through run_all
    with and without ``trace_dir``: (root, plain report, traced report,
    trace events)."""
    tmp_path = tmp_path_factory.mktemp("run_all")
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_plate(3, n5=4, n27=3, seed=21, insert_len=300)
    fq = str(tmp_path / "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    cfg = port_stages.PipelineConfig(adapters, device="cpu", bin_workers=1)
    with pytest.MonkeyPatch.context() as mp:   # three bin writer threads
        mp.setattr(port_demux, "_usable_cpus", lambda: 4)
        plain = port_stages.run_all(fq, str(tmp_path / "plain"), "plate",
                                    "COI", cfg)
        traced = port_stages.run_all(fq, str(tmp_path / "traced"), "plate",
                                     "COI", cfg,
                                     trace_dir=str(tmp_path / "tr"))
    found = _traces(tmp_path / "tr")
    assert len(found) == 1
    with gzip.open(found[0], "rt") as fh:
        events = json.load(fh)["traceEvents"]
    os.unlink(found[0])          # a CPU trace of every plain-version op
    return tmp_path, plain, traced, events


def test_run_all_trace_dir_writes_trace_and_same_files(traced_run_all):
    """run_all with and without ``trace_dir`` writes the same files; the
    trace holds the run's stage work."""
    tmp_path, plain, traced, events = traced_run_all
    assert traced["barcodes"] == plain["barcodes"]
    assert plain["demux"]["bins"] == 12
    assert_same_tree(str(tmp_path / "traced"), str(tmp_path / "plain"),
                     skip=TIMED)
    assert sum(e.get("cat") == "cpu_op" for e in events) > 1000


def test_run_all_trace_dir_writes_spans(traced_run_all):
    """``spans.json`` beside the trace: the stages as ``stage.<name>``
    spans, stage 02's spans under ``stage.02_demux``, ``demux.gzip`` at
    the top of the bin writer threads, the reads counted; each span of
    the profiling thread an annotation of the trace (the profiler
    records no other thread's); ``metrics.json`` keeps its keys."""
    tmp_path, plain, _, events = traced_run_all
    with open(tmp_path / "tr" / "spans.json") as fh:
        got = json.load(fh)
    spans, counters = got["spans"], got["counters"]
    assert spans["stage.02_demux"]["parent"] is None
    for name in ("demux.input", "demux.decide", "demux.tally",
                 "demux.write", "demux.finish"):
        assert spans[name]["parent"] == "stage.02_demux", name
    for name in ("demux.format", "demux.write_wait"):
        assert spans[name]["parent"] == "demux.write", name
    assert spans["demux.drain"]["parent"] == "demux.finish"
    assert spans["demux.gzip"]["parent"] is None
    assert spans["demux.gzip"]["n"] == spans["demux.format"]["n"] > 0
    assert (counters["demux.write_offloaded_bytes"]
            == counters["demux.text_bytes"] > 0)
    with open(tmp_path / "traced" / "metrics.json") as fh:
        traced_m = json.load(fh)
    demux_m = next(m for m in traced_m["stages"]
                   if m["stage"] == "02_demux")
    assert counters["demux.reads"] == demux_m["n_reads"] > 0
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert {"stage.00_qc", "stage.02_demux", "demux.tally",
            "demux.format", "demux.write_wait"} <= annotated
    assert "demux.gzip" not in annotated
    with open(tmp_path / "plain" / "metrics.json") as fh:
        plain_m = json.load(fh)
    assert ([sorted(m) for m in traced_m["stages"]]
            == [sorted(m) for m in plain_m["stages"]])



def test_run_all_trace_dir_writes_reorient_spans(traced_run_all):
    """Stage 01's spans and counters in ``spans.json``: the stream's under
    ``stage.01_reorient``, ``Reorienter.run``'s under ``reorient.block``,
    every raw read and the tuned q counted as the report has them."""
    tmp_path, plain, _, _ = traced_run_all
    with open(tmp_path / "tr" / "spans.json") as fh:
        got = json.load(fh)
    spans, counters = got["spans"], got["counters"]
    for name in ("reorient.input", "reorient.block", "reorient.write",
                 "reorient.finish"):
        assert spans[name]["parent"] == "stage.01_reorient", name
    for name in ("reorient.qfilter", "reorient.autotune", "reorient.scan",
                 "reorient.fetch", "reorient.classify", "reorient.enumerate",
                 "reorient.schedule", "reorient.segment"):
        assert spans[name]["parent"] == "reorient.block", name
    assert counters["reorient.blocks"] == spans["reorient.block"]["n"] == 1
    assert counters["reorient.reads"] == plain["qc"]["reads"] > 0
    assert counters["reorient.q_x100"] == \
        plain["reorient"]["autotuned_q_x100"]
    assert counters["reorient.fused"] == plain["reorient"]["fused_reads"]

def test_spans_and_counters_off_outside_recording(tmp_path):
    """Outside ``recording()``: the shared null context, nothing kept,
    and no annotation in a profiler trace."""
    assert span("off.a") is span("off.b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("off.outer"):
            with span("off.inner", "chunk 0"):
                torch.ones(4).sum()
        count("off.counter", 3)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert not {n for n in names if n and n.startswith("off.")}
    assert profiling._REC is None
    with recording() as rec:
        pass
    assert rec.as_dict() == {"spans": {}, "counters": {}}


def test_self_time_is_total_less_children():
    with recording() as rec:
        for _ in range(2):
            with span("t.outer"):
                time.sleep(0.01)
                with span("t.a"):
                    time.sleep(0.02)
                    with span("t.deep"):
                        time.sleep(0.01)
                with span("t.b"):
                    time.sleep(0.01)
        count("t.n", 2)
        count("t.n")
    s = rec.spans()
    assert {k: v["n"] for k, v in s.items()} == {
        "t.outer": 2, "t.a": 2, "t.deep": 2, "t.b": 2}
    assert s["t.outer"]["parent"] is None
    assert s["t.a"]["parent"] == "t.outer"
    assert s["t.deep"]["parent"] == "t.a"
    assert s["t.b"]["parent"] == "t.outer"
    for name, kids in (("t.outer", ("t.a", "t.b")), ("t.a", ("t.deep",)),
                       ("t.deep", ()), ("t.b", ())):
        want = s[name]["total_s"] - sum(s[k]["total_s"] for k in kids)
        assert s[name]["self_s"] == pytest.approx(want, abs=1e-9), name
    assert s["t.outer"]["self_s"] >= 0.02
    assert s["t.a"]["self_s"] >= 0.04
    assert rec.counters() == {"t.n": 3}


def test_spans_and_counters_from_threads():
    """More threads than cores, switching as often as the interpreter
    allows: every call kept, each thread's spans under its own parent."""
    tags = [f"t{k}" for k in range(2 * (os.cpu_count() or 1) + 2)]

    def work(tag):
        for _ in range(200):
            with span("th.outer"):
                with span(f"th.inner.{tag}"):
                    count("th.calls")
                    count(f"th.{tag}", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            ts = [threading.Thread(target=work, args=(t,)) for t in tags]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    s = rec.spans()
    assert s["th.outer"]["n"] == 200 * len(tags)
    assert s["th.outer"]["parent"] is None
    for tag in tags:
        assert s[f"th.inner.{tag}"]["n"] == 200
        assert s[f"th.inner.{tag}"]["parent"] == "th.outer"
    assert rec.counters() == {"th.calls": 200 * len(tags),
                              **{f"th.{t}": 400 for t in tags}}


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    d = synthetic.write_adapter_dir(str(tmp_path_factory.mktemp("adapters")))
    f = lambda n: os.path.join(d, synthetic.FILES[n])
    return (AdapterBank.from_fasta(f(0), 0.1, "cpu"),
            AdapterBank.from_fasta(f(1), 0.1, "cpu"))


def test_demux_stream_spans_under_recording(banks, tmp_path, monkeypatch):
    """Stage 02's stream on the CPU (the unfused path), with three bin
    writer threads, under ``recording()``: each stream-level span with
    its parent, ``demux.gzip`` at the top of the writer threads, the
    reads, chunks and writes counted, and the files of an unrecorded
    run."""
    sp5, sp27 = banks
    monkeypatch.setattr(port_demux, "_usable_cpus", lambda: 4)
    recs, _ = synthetic.make_plate(2, n5=3, n27=3, seed=3, insert_len=200)
    plain = dual_round_demux_stream(iter(recs), sp5, sp27, "p",
                                    str(tmp_path / "plain"), chunk_size=7)
    with recording() as rec:
        with span("stage.02_demux"):
            got = dual_round_demux_stream(iter(recs), sp5, sp27, "p",
                                          str(tmp_path / "rec"),
                                          chunk_size=7)
    assert got == plain
    assert_same_tree(str(tmp_path / "rec"), str(tmp_path / "plain"))
    s, c = rec.spans(), rec.counters()
    chunks = -(-len(recs) // 7)
    for name, parent, n in (("demux.input", "stage.02_demux", chunks + 1),
                            ("demux.decide", "stage.02_demux", chunks),
                            ("demux.tally", "stage.02_demux", chunks),
                            ("demux.write", "stage.02_demux", chunks),
                            ("demux.format", "demux.write", None),
                            ("demux.write_wait", "demux.write", chunks),
                            ("demux.gzip", None, None),
                            ("demux.finish", "stage.02_demux", 1),
                            ("demux.drain", "demux.finish", 1)):
        assert s[name]["parent"] == parent, name
        assert n is None or s[name]["n"] == n, name
    assert s["demux.format"]["n"] == s["demux.gzip"]["n"] >= chunks
    assert c["demux.write_jobs"] == s["demux.format"]["n"]
    assert c["demux.write_backlog"] >= c["demux.write_jobs"]
    assert c["demux.reads"] == plain["total_reads"] == len(recs)
    assert c["demux.chunks"] == chunks
    written = 0
    for d, _, fs in os.walk(tmp_path / "rec"):
        for f in fs:
            if f.endswith(".gz"):
                with gzip.open(os.path.join(d, f), "rb") as fh:
                    written += len(fh.read())
    assert c["demux.text_bytes"] == written
    assert c["demux.write_offloaded_bytes"] == written
    assert not any(k.startswith(("fused.", "locate.")) for k in (*s, *c))


def test_fused_assign_spans_under_recording(banks):
    """``FusedDemux.assign`` on CPU banks (the plain locate): its spans
    under ``fused.assign``, one batch counted per batch, the pipeline
    depth summed at each fetch, and the decisions of an unrecorded
    call; no locate counter (no kernel launched)."""
    sp5, sp27 = banks
    recs, _ = synthetic.make_plate(2, n5=3, n27=2, seed=4, insert_len=150)
    fd = port_fused.FusedDemux(sp5, sp27)
    plain = fd.assign(recs, batch_size=4)
    with recording() as rec:
        got = fd.assign(recs, batch_size=4)
    assert fields_of(got) == fields_of(plain)
    s, c = rec.spans(), rec.counters()
    batches = -(-len(recs) // 4)
    assert s["fused.assign"] == {**s["fused.assign"], "n": 1, "parent": None}
    for name in ("fused.pack", "fused.launch", "fused.fetch",
                 "fused.materialize"):
        assert s[name]["parent"] == "fused.assign", name
        assert s[name]["n"] == batches, name
    assert c["fused.batches"] == batches
    depth = [min(8, batches - k) for k in range(batches)]
    assert c["fused.pipeline_depth"] == sum(depth)
    L = [max(encode.bucket_len(max(len(r.seq) for r in recs[k:k + 4])), 256)
         for k in range(0, len(recs), 4)]
    assert c["fused.h2d_bytes"] == sum(
        len(recs[k * 4:k * 4 + 4]) * (l + 4) for k, l in enumerate(L))
    assert not any(k.startswith("locate.") for k in c)
