"""The port's multi-device path without JAX: in a fresh interpreter
where neither ``import jax`` nor ``import tpu_orc`` works
(tests/torch_nojax.py), ``run_all`` on a mesh of the CPU listed twice
gives the demux report and the consensus files of a one-device run of
the same plate (with the native pileup). Tolerance: none (files
compared as strings)."""
import torch

from torch_nojax import run_leg

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

LEG = r"""
rep, native = coi_run("native")
from tpu_orc_torch.dist.sharded import make_mesh
PipelineConfig.mesh = lambda self: make_mesh(devices=["cpu", "cpu"])
mrep, mesh = coi_run("native", use_mesh=True)
result(mesh=[mrep["demux"] == rep["demux"], mesh == native])
"""


def test_port_runs_without_jax_on_a_mesh():
    res = run_leg(LEG)
    assert res["loaded"] == []
    assert res["mesh"] == [True, True]
