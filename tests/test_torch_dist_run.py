"""tpu_orc_torch's demux stream, sorter scoring, run_all and ``cli
run-all --mesh`` on a mesh, against tpu_orc's on its mesh.

The port's mesh is the CPU device listed several times; tpu_orc's is
conftest's virtual 8-device CPU mesh. Every file must be byte-identical
to tpu_orc's, results.txt's pairs_ lines included (both score every bin
on the mesh), except the timings in metrics.json and run_report.json.
Banks and plates come from ``tpu_orc_torch.synthetic`` and seeded numpy.
The steps themselves are held against tpu_orc's in test_torch_dist.py.
"""
import json

import jax
import numpy as np
import pytest
import torch

from tpu_orc.demux import demux as ref_demux
from tpu_orc.dist import sharded as ref_sharded
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record as RefRecord
from tpu_orc.io.fastq import write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import cli
from tpu_orc_torch.cluster.scoring import DeviceScorer
from tpu_orc_torch.demux import demux as port_demux
from tpu_orc_torch.io.fastq import Record
from tpu_orc_torch.pipeline import stages as port_stages

from test_torch_dist import adapters, banks, cpu_mesh, demux_seqs  # noqa
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

TIMED = ("metrics.json", "run_report.json")


def test_dual_round_demux_stream_mesh_equals_reference(banks, tmp_path):
    """The port streams 20-read chunks over a 4-entry mesh (a chunk of
    20, 20 and 10 rows, padded to 20, 20 and 12), tpu_orc the one chunk
    over its 8 devices: the same bins and reports."""
    (sp5, sp27), (r5, r27) = banks
    seqs = demux_seqs(12, sp5, sp27, 50)
    recs = [Record(f"r{i}", f"r{i}", s, "I" * len(s))
            for i, s in enumerate(seqs)]
    rrecs = [RefRecord(r.id, r.desc, r.seq, r.qual) for r in recs]
    got = port_demux.dual_round_demux_stream(
        iter(recs), sp5, sp27, "ds", str(tmp_path / "port"),
        chunk_size=20, mesh=cpu_mesh(4))
    want = ref_demux.dual_round_demux_stream(
        iter(rrecs), r5, r27, "ds", str(tmp_path / "ref"),
        mesh=ref_sharded.make_mesh())
    assert got == want
    assert got["total_reads"] == 50 and got["final_bins"]
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))
    # a mesh of one device takes the single-device path: same files
    port_demux.dual_round_demux(recs, sp5, sp27, "ds",
                                str(tmp_path / "one"), mesh=cpu_mesh(1))
    assert_same_tree(str(tmp_path / "one"), str(tmp_path / "ref"))


def test_device_scorer_mesh_backend():
    assert DeviceScorer(mesh=cpu_mesh(2)).backend == "mesh"
    one = DeviceScorer(mesh=cpu_mesh(1), device="cpu")
    assert one.backend == "kernel" and one.mesh is None
    assert DeviceScorer(backend="native", mesh=cpu_mesh(2)).backend == \
        "native"


def test_mesh_scorer_equals_reference_scorer():
    """The gene stage's gated block and the ladder's dense tiles on a
    mesh: the same edges, similarities and pairs_scored as tpu_orc's
    mesh scorer."""
    from tpu_orc.cluster.scoring import DeviceScorer as RefScorer
    rng = np.random.default_rng(13)
    base = rng.integers(0, 4, 300)
    codes = []
    for i in range(20):
        c = base[:300 - int(rng.integers(0, 12))].copy()
        if i % 5 == 0:
            c = rng.integers(0, 4, len(c))            # a stranger
        c[rng.integers(0, len(c), 15)] = rng.integers(0, 4, 15)
        codes.append(c.astype(np.uint8))
    got_s = DeviceScorer(mesh=cpu_mesh(4))
    want_s = RefScorer(mesh=ref_sharded.make_mesh((4, 1), jax.devices()[:4]))
    assert want_s.backend == "mesh"
    g = got_s.allvsall_effective_sims(codes)
    w = want_s.allvsall_effective_sims(codes)
    for name in ("i", "j", "sim", "reverse"):
        np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    gl = got_s.reads_vs_consensus_sims(codes, codes[:3])
    wl = want_s.reads_vs_consensus_sims(codes, codes[:3])
    np.testing.assert_array_equal(gl, wl)
    assert got_s.pairs_scored == want_s.pairs_scored


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
