"""tpu_orc_torch's demux stream and sorter scoring on a mesh, against
tpu_orc's on its mesh (``run_all`` and ``cli run-all --mesh`` on a mesh
are in test_torch_dist_run_all.py).

The port's mesh is the CPU device listed several times; tpu_orc's is
conftest's virtual 8-device CPU mesh. Every file must be byte-identical
to tpu_orc's. Banks and plates come from ``tpu_orc_torch.synthetic`` and
seeded numpy. The steps themselves are held against tpu_orc's in
test_torch_dist.py.
"""
import jax
import numpy as np
import pytest
import torch

from tpu_orc.demux import demux as ref_demux
from tpu_orc.dist import sharded as ref_sharded
from tpu_orc.io.fastq import Record as RefRecord
from tpu_orc_torch.cluster.scoring import DeviceScorer
from tpu_orc_torch.demux import demux as port_demux
from tpu_orc_torch.io.fastq import Record

from test_torch_dist import adapters, banks, cpu_mesh, demux_seqs  # noqa
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


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
