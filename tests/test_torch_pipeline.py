"""tpu_orc_torch ``run_all`` (COI) against tpu_orc's, and the port without
JAX (``run_all -a RNA`` against tpu_orc's is in test_torch_rrna_run.py).

The port's whole COI main path on the CPU (plain locate and Myers) and
tpu_orc's run on one synthetic plate of 98 reads; the output trees must
be byte-identical, except the timings (and the completion order of the
concurrent bins) in metrics.json and run_report.json. The CLI's demux
subcommand is held against tpu_orc's stage the same way. Another test
imports every module of the port in a fresh interpreter where neither
``import jax`` nor ``import tpu_orc`` works (the GPU host has no JAX, and
the port imports nothing of tpu_orc); the port's ``run_all`` runs in such
an interpreter in test_torch_nojax_{coi,mesh,rrna}.py.
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
from tpu_orc_torch.cluster import consensus as port_consensus
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


def test_run_all_refuses_unported_paths(tmp_path, monkeypatch):
    cfg = port_stages.PipelineConfig(str(tmp_path), device="cpu")
    # the rRNA path and the device pileup backend are ported: run_all
    # goes on to read its input
    with pytest.raises(FileNotFoundError):
        port_stages.run_all(str(tmp_path / "x.fastq"), str(tmp_path), "d",
                            "RNA", cfg)
    monkeypatch.setattr(port_consensus, "PILEUP_BACKEND", "device")
    with pytest.raises(FileNotFoundError):
        port_stages.run_all(str(tmp_path / "x.fastq"), str(tmp_path), "d",
                            "COI", cfg)
    # so is the multi-device path (dist/): run_all builds its mesh and
    # goes on to read its input
    cfg.use_mesh = True
    with pytest.raises(FileNotFoundError):
        port_stages.run_all(str(tmp_path / "x.fastq"), str(tmp_path), "d",
                            "COI", cfg)


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


def test_entry_points_default_to_cuda():
    """Every public entry point of the port that takes a device runs on
    the card unless the caller names the CPU; the sorter's default scorer
    takes the sorter's device."""
    import inspect

    from tpu_orc_torch.align import locate, myers
    from tpu_orc_torch.cluster import engine, scoring
    from tpu_orc_torch.demux import adapters, primer_clean, reorient
    from tpu_orc_torch.rrna import anchors, extract, hmm, profiles

    def default(fn, name="device"):
        return inspect.signature(fn).parameters[name].default

    fns = [adapters.AdapterBank, adapters.AdapterBank.from_fasta,
           adapters.AdapterBank.from_pairs, reorient.ReorientConfig,
           reorient.build_primer_bank, primer_clean.linked_trim,
           primer_clean.unlinked_round2, primer_clean.clean_primers,
           scoring.DeviceScorer, engine.AmpliconSorter, locate.locate_masks,
           myers.distances, myers.distances_pairs, myers.distances_with_pos,
           hmm.viterbi_scan, hmm.profile_from_seqs, profiles.find_rrna_default,
           anchors.find_rrna_by_anchors, extract.find_gene_exemplar,
           extract.find_gene_profile, extract.extract_rrna,
           port_stages.PipelineConfig]
    assert {f.__qualname__: default(f) for f in fns} == \
        {f.__qualname__: "cuda" for f in fns}
    assert engine.AmpliconSorter().scorer.device == "cuda"
    assert engine.AmpliconSorter(device="cpu").scorer.device == "cpu"
    # the multi-device path: a mesh is every card unless devices are
    # named, a scorer given a one-device mesh scores on the card, and
    # the process group's collectives run on the cards (nccl)
    from tpu_orc_torch.dist import multihost, sharded
    assert default(sharded.make_mesh, "devices") is None
    assert default(multihost.init_multihost, "backend") == "nccl"
    one = scoring.DeviceScorer(mesh=sharded.make_mesh(devices=["cpu"]))
    assert (one.backend, one.device) == ("kernel", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_stages.PipelineConfig("x", use_mesh=True).mesh()


def test_cli_refuses_absent_cuda(tmp_path, monkeypatch):
    """``--device cuda`` (the default) without a CUDA device is an error,
    never a silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["demux", "x.fastq", "-o", str(tmp_path), "-n", "ds",
                  "--adapters-dir", str(tmp_path)])


JAX_FREE_MODULES = r"""
import contextlib, importlib, io, json, os, pkgutil, sys, tempfile
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["tpu_orc"] = None      # and so does any import of tpu_orc
import numpy as np
import torch
torch.set_num_threads(1)
import tpu_orc_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    tpu_orc_torch.__path__, "tpu_orc_torch."))
for n in names:
    importlib.import_module(n)
from tpu_orc_torch import cli
from tpu_orc_torch.align import batched, oracle
from tpu_orc_torch.align.spec import FRONT
from tpu_orc_torch.align.tables import make_k_table, make_n_prefix
from tpu_orc_torch.utils.profiling import device_trace
rm = np.array([[1, 2, 4, 8, 1, 2]], np.uint8)
rl = np.array([6], np.int32)
qm = np.array([[8, 1, 2, 4, 8, 1, 2, 0]], np.uint8)
ql = np.array([7], np.int32)
res = batched.batched_locate(rm, rl, make_k_table(0.1, rm, rl),
                             make_n_prefix(rm), qm, ql, 2)
loc = oracle.locate("ACGTACGT", "TTTACGTACGTGG", 0.1, FRONT)
tdir = tempfile.mkdtemp()
with device_trace(tdir):
    torch.ones(3).sum()
d = tempfile.mkdtemp()
tsv = os.path.join(d, "b.tsv")
with open(tsv, "w") as fh:
    fh.write("q\t1\ts\t1e-5\t1\t1\t1\n")
with contextlib.redirect_stdout(io.StringIO()) as log:
    cli.main(["blast-top5", tsv, "-o", os.path.join(d, "o.tsv")])
print(json.dumps({"modules": len(names),
                  "valid": int(res.valid[0, 0]),
                  "refstop": int(res.refstop[0, 0]),
                  "oracle": list(loc.astuple()),
                  "trace": sorted(f if f == "spans.json" else "trace"
                                  for f in os.listdir(tdir)),
                  "cli": json.loads(log.getvalue().splitlines()[-1]),
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "tpu_orc")
                                   and sys.modules[m] is not None)}))
"""


def test_every_port_module_imports_without_jax():
    """Every module of the port, the batched locate, the Python oracle's
    locate, ``device_trace`` and the stage 06-09 CLI in a fresh
    interpreter where neither ``import jax`` nor ``import tpu_orc``
    works."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", JAX_FREE_MODULES], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["modules"] >= 46
    assert res["valid"] == 1 and res["refstop"] == 6
    assert res["oracle"] == [0, 8, 3, 11, 8, 0]
    assert res["trace"] == ["spans.json", "trace"]
    assert res["cli"] == {"kept": 1}
