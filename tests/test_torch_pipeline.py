"""tpu_orc_torch ``run_all`` (COI) against tpu_orc's, and the port without
JAX.

The port's whole COI main path on the CPU (plain locate and Myers) and
tpu_orc's run on one synthetic plate of 98 reads; the output trees must
be byte-identical, except the timings (and the completion order of the
concurrent bins) in metrics.json and run_report.json. The CLI's demux
subcommand is held against tpu_orc's stage the same way. Another test
runs the port in a fresh interpreter where ``import jax`` fails, as on
the GPU host, which has no JAX.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_orc.io.fastq import write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import cli, synthetic
from tpu_orc_torch.pipeline import stages as port_stages

from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = ("metrics.json", "run_report.json")


def _untimed(path):
    """A metrics/run_report JSON without wall times and rates, stages in
    name order."""
    with open(path) as fh:
        d = json.load(fh)
    met = d.get("metrics", d)
    met.pop("total_wall_s", None)
    for st in met["stages"]:
        for k in [k for k in st if k == "wall_s" or k.endswith("_per_s")]:
            del st[k]
    met["stages"].sort(key=lambda st: st["stage"])
    return d


def test_run_all_equals_reference(tmp_path):
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_plate(12, n5=4, n27=2, seed=31)
    recs.append(synthetic.fused_read(2, 1))
    recs.append(recs[0].__class__("junk", "junk", "ACGT" * 100, "I" * 400))
    fq = str(tmp_path / "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    got = port_stages.run_all(fq, str(tmp_path / "port"), "plate", "COI",
                              port_stages.PipelineConfig(adapters,
                                                         device="cpu"))
    want = ref_stages.run_all(fq, str(tmp_path / "ref"), "plate", "COI",
                              ref_stages.PipelineConfig(adapters_dir=adapters))
    assert got["demux"] == want["demux"] == {"bins": 8, "binned_reads": 96}
    assert got["reorient"]["fused_reads"] == 1
    assert got["barcodes"] == want["barcodes"]
    assert sum(b["species_groups"] for b in got["barcodes"].values()) >= 6
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"),
                     skip=TIMED)
    for name in TIMED:
        assert (_untimed(str(tmp_path / "port" / name))
                == _untimed(str(tmp_path / "ref" / name))), name


def test_run_all_refuses_unported_paths(tmp_path):
    cfg = port_stages.PipelineConfig(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError):
        port_stages.run_all("x.fastq", str(tmp_path), "d", "RNA", cfg)
    cfg.use_mesh = True
    with pytest.raises(NotImplementedError):
        port_stages.run_all("x.fastq", str(tmp_path), "d", "COI", cfg)


def test_cli_demux_equals_reference_stage(tmp_path, capsys):
    """``tpu_orc_torch.cli demux --device cpu`` writes the same bins and
    reports as tpu_orc's stage_demux."""
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_plate(3, n5=3, n27=2, seed=5, insert_len=150)
    fq = str(tmp_path / "pass.fastq")
    write_records(fq, recs, fmt="fastq")
    assert cli.main(["demux", fq, "-o", str(tmp_path / "port"), "-n", "ds",
                     "--adapters-dir", adapters, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = ref_stages.stage_demux(fq, str(tmp_path / "ref"), "ds",
                                  ref_stages.PipelineConfig(adapters))
    assert got["final_bins"] == want["final_bins"]
    assert len(got["final_bins"]) == 6
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_cli_refuses_absent_cuda(tmp_path, monkeypatch):
    """``--device cuda`` (the default) without a CUDA device is an error,
    never a silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["demux", "x.fastq", "-o", str(tmp_path), "-n", "ds",
                  "--adapters-dir", str(tmp_path)])


JAX_FREE = r"""
import json, os, sys, tempfile
sys.modules["jax"] = None          # any import of jax now fails
from tpu_orc_torch import synthetic
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.demux.demux import dual_round_demux_stream
import tpu_orc_torch.cli, tpu_orc_torch.pipeline.stages  # the whole path
d = synthetic.write_adapter_dir(tempfile.mkdtemp())
recs, _ = synthetic.make_plate(3, n5=3, n27=2, seed=2, insert_len=120)
sp5 = AdapterBank.from_fasta(os.path.join(d, synthetic.FILES[0]), 0.1)
sp27 = AdapterBank.from_fasta(os.path.join(d, synthetic.FILES[1]), 0.1)
rep = dual_round_demux_stream(iter(recs), sp5, sp27, "x", tempfile.mkdtemp())
print(json.dumps({"bins": rep["final_bins"],
                  "jax": sorted(m for m in sys.modules
                                if m.split(".")[0] == "jax"
                                and sys.modules[m] is not None)}))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", JAX_FREE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    assert len(res["bins"]) == 6 and set(res["bins"].values()) == {3}
