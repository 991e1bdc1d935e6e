"""The port's COI ``run_all`` without JAX, with each consensus pileup
backend: in a fresh interpreter where neither ``import jax`` nor ``import
tpu_orc`` works (tests/torch_nojax.py), the native and the device
backend (its plain version on the CPU) give the same consensus files.
Tolerance: none (files compared as strings)."""
import torch

from torch_nojax import run_leg

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

LEG = r"""
rep, native = coi_run("native")
_, device = coi_run("device")
result(bins=rep["demux"]["bins"],
       groups=sum(b["species_groups"] for b in rep["barcodes"].values()),
       same=native == device)
"""


def test_port_runs_without_jax():
    res = run_leg(LEG)
    assert res["loaded"] == []
    assert res["bins"] == 4 and res["groups"] >= 3 and res["same"]
