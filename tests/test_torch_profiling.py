"""tpu_orc_torch ``utils/profiling.py::device_trace`` and ``run_all``'s
``trace_dir``, held to tpu_orc's cases.

The two cases of ``tests/test_profiling.py`` for tpu_orc's
``jax.profiler`` trace, for the port's ``torch.profiler`` one: a no-op
without a directory, a trace file with one. ``TPU_ORC_TRACE`` names the
directory as it does in tpu_orc. ``run_all`` with a trace directory
writes a trace and the same files as without one (timings aside).
"""
import gzip
import json
import os

import torch

from tpu_orc.io.fastq import write_records
from tpu_orc_torch import synthetic
from tpu_orc_torch.pipeline import stages as port_stages
from tpu_orc_torch.utils.profiling import device_trace

from test_torch_stages import assert_same_tree

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


def test_run_all_trace_dir_writes_trace_and_same_files(tmp_path):
    """The COI plate of test_torch_stages (36 reads): run_all with and
    without ``trace_dir`` writes the same files; the trace holds the
    run's stage work."""
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_plate(3, n5=4, n27=3, seed=21, insert_len=300)
    fq = str(tmp_path / "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    cfg = port_stages.PipelineConfig(adapters, device="cpu", bin_workers=1)
    plain = port_stages.run_all(fq, str(tmp_path / "plain"), "plate", "COI",
                                cfg)
    traced = port_stages.run_all(fq, str(tmp_path / "traced"), "plate",
                                 "COI", cfg, trace_dir=str(tmp_path / "tr"))
    assert traced["barcodes"] == plain["barcodes"]
    assert plain["demux"]["bins"] == 12
    assert_same_tree(str(tmp_path / "traced"), str(tmp_path / "plain"),
                     skip=TIMED)
    found = _traces(tmp_path / "tr")
    assert len(found) == 1
    with gzip.open(found[0], "rt") as fh:
        events = json.load(fh)["traceEvents"]
    assert sum(e.get("cat") == "cpu_op" for e in events) > 1000
    os.unlink(found[0])          # a CPU trace of every plain-version op
