"""tpu_orc_torch's ``run_all`` and ``cli run-all --mesh`` on a mesh,
against tpu_orc's ``run_all`` on its mesh (moved out of
test_torch_dist_run.py, which keeps the demux stream and the scorer, so
that pytest-xdist can run the two files on two workers).

The port's mesh is the CPU device listed several times; tpu_orc's is
conftest's virtual 8-device CPU mesh. Every file must be byte-identical
to tpu_orc's, results.txt's pairs_ lines included (both score every bin
on the mesh), except the timings in metrics.json and run_report.json.
Banks and plates come from ``tpu_orc_torch.synthetic`` and seeded numpy.
"""
import json

import numpy as np
import pytest
import torch

from tpu_orc.io import encode
from tpu_orc.io.fastq import Record as RefRecord
from tpu_orc.io.fastq import write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import cli
from tpu_orc_torch.pipeline import stages as port_stages

from test_torch_dist import adapters, banks, cpu_mesh  # noqa
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

TIMED = ("metrics.json", "run_report.json")


@pytest.fixture(scope="module")
def mesh_plate(banks, adapters, tmp_path_factory):
    """test_dist.py's 40-read plate (two templates, three SP5 and two
    SP27 adapters, every 4th read reverse-complemented) and tpu_orc's
    ``run_all(use_mesh=True)`` of it: (fastq, tree, report)."""
    (sp5, sp27), _ = banks
    tmp = tmp_path_factory.mktemp("mesh_plate")
    rng = np.random.default_rng(17)
    t1 = "".join(rng.choice(list("ACGT"), size=400))
    t2 = "".join(rng.choice(list("ACGT"), size=400))

    def noisy(t, k):
        s = list(t)
        for _ in range(k):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        return "".join(s)

    recs = []
    for i in range(40):
        s = sp5.seqs[i % 3] + noisy(t1 if i % 2 else t2, 12) + \
            sp27.seqs[i % 2]
        if i % 4 == 0:
            s = encode.revcomp(s)
        recs.append(RefRecord(f"r{i}", f"r{i}", s, "I" * len(s)))
    fq = str(tmp / "in.fastq")
    write_records(fq, recs, fmt="fastq")
    rep = ref_stages.run_all(
        fq, str(tmp / "ref"), "ds", "COI",
        ref_stages.PipelineConfig(adapters_dir=adapters, use_mesh=True))
    return fq, str(tmp / "ref"), rep


def test_run_all_mesh_equals_reference(mesh_plate, adapters, tmp_path,
                                       monkeypatch):
    """run_all with use_mesh on the port's 4-entry CPU mesh: every file
    byte-identical to tpu_orc's run_all with use_mesh on its 8-device
    mesh."""
    fq, ref_tree, want = mesh_plate
    monkeypatch.setattr(port_stages.PipelineConfig, "mesh",
                        lambda self: cpu_mesh(4) if self.use_mesh else None)
    got = port_stages.run_all(
        fq, str(tmp_path / "port"), "ds", "COI",
        port_stages.PipelineConfig(adapters, device="cpu", use_mesh=True))
    assert got["demux"] == want["demux"]
    assert got["demux"]["bins"] == 6
    assert got["barcodes"] == want["barcodes"]
    assert_same_tree(str(tmp_path / "port"), ref_tree, skip=TIMED)


def test_cli_run_all_mesh_equals_reference(mesh_plate, adapters, tmp_path,
                                           monkeypatch, capsys):
    """``cli run-all --mesh --device cpu`` (its mesh monkeypatched to 3
    CPU entries, one bin worker): the same files as tpu_orc's mesh run."""
    fq, ref_tree, want = mesh_plate
    monkeypatch.setattr(port_stages.PipelineConfig, "mesh",
                        lambda self: cpu_mesh(3) if self.use_mesh else None)
    assert cli.main(["run-all", fq, "-o", str(tmp_path / "cli"), "-n", "ds",
                     "-a", "COI", "--adapters-dir", adapters, "--device",
                     "cpu", "--mesh", "--bin-workers", "1"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["demux"] == want["demux"]
    assert rep["barcodes"] == want["barcodes"]
    assert_same_tree(str(tmp_path / "cli"), ref_tree, skip=TIMED)
