"""tpu_orc_torch consensus with the device pileup backend, on the CPU,
against tpu_orc.

The port's ``cluster/consensus.py`` with ``backend="device"`` runs the
plain path-bits version (align/pileup.py) and the native traceback; its
counts and consensus strings must equal tpu_orc's, on the shapes of
tests/test_cluster.py:295-359: per-group counts of a multi-group call
(drafts of different word counts, a group across the 128-read tile),
and ``build_consensus_multi`` with an empty and a 1-read group. Then the
port's ``run_all`` with ``ORC_PILEUP_BACKEND=device`` must write the
same tree as tpu_orc's ``run_all`` on the plate of
tests/test_torch_pipeline.py. (The whole sort of one bin against
tpu_orc's device backend is in tests/test_torch_pileup.py.)
Tolerance: none. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc.cluster import consensus as ref_c
from tpu_orc.io.fastq import write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import synthetic
from tpu_orc_torch.cluster import consensus as C
from tpu_orc_torch.pipeline import stages as port_stages

from test_torch_pileup import mutate_reads
from test_torch_pipeline import TIMED, _untimed
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


@pytest.fixture
def device_backend(monkeypatch):
    """The port's consensus on its device backend (tpu_orc's stays on its
    default, native)."""
    monkeypatch.setattr(C, "PILEUP_BACKEND", "device")


def test_pileup_counts_multi_equals_native():
    rng = np.random.default_rng(21)
    drafts, groups = [], []
    for L, R in ((45, 3), (200, 1), (700, 130), (120, 17)):
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        drafts.append(base)
        groups.append(mutate_reads(rng, base, R))
    got = C.pileup_counts_multi(drafts, groups, backend="device",
                                device="cpu")
    for d, rs, g in zip(drafts, groups, got):
        want = ref_c.pileup_counts(d, rs, backend="native")
        assert g.shape == want.shape and (g == want).all()


def test_build_consensus_multi_equals_reference(device_backend):
    rng = np.random.default_rng(22)
    groups = [[]]
    for L, R in ((150, 1), (260, 9), (90, 40)):
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        groups.append(mutate_reads(rng, base, R))
    want = [ref_c.build_consensus(g) for g in groups]
    got = C.build_consensus_multi(groups, device="cpu")
    single = [C.build_consensus(g, device="cpu") for g in groups]
    for w, g, s in zip(want, got, single):
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.array_equal(np.asarray(s), np.asarray(w))


def test_run_all_device_backend_equals_reference(tmp_path, device_backend):
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_plate(12, n5=4, n27=2, seed=31)
    recs.append(synthetic.fused_read(2, 1))
    fq = str(tmp_path / "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    # one bin worker: the plain path bits are Python-bound, and threads
    # would only contend for the interpreter (the tree is the same)
    got = port_stages.run_all(fq, str(tmp_path / "port"), "plate", "COI",
                              port_stages.PipelineConfig(adapters,
                                                         device="cpu",
                                                         bin_workers=1))
    want = ref_stages.run_all(fq, str(tmp_path / "ref"), "plate", "COI",
                              ref_stages.PipelineConfig(adapters_dir=adapters))
    assert got["barcodes"] == want["barcodes"]
    assert sum(b["species_groups"] for b in got["barcodes"].values()) >= 6
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"),
                     skip=TIMED)
    for name in TIMED:
        assert (_untimed(str(tmp_path / "port" / name))
                == _untimed(str(tmp_path / "ref" / name))), name
