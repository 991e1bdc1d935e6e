"""The port's rRNA path without JAX: in a fresh interpreter where
neither ``import jax`` nor ``import tpu_orc`` works
(tests/torch_nojax.py), ``run_all -a RNA`` with the Kogge-Stone locate
finds the planted 18S and 28S genes."""
import torch

from torch_nojax import run_leg

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

LEG = r"""
from tpu_orc_torch.align import locate
locate.LOCATE_IMPL = "ks"
rrecs, _ = synthetic.make_rrna_plate(8, n5=1, n27=2, seed=3,
                                     error_rate=0.03)
rfq = os.path.join(tempfile.mkdtemp(), "rrna.fastq")
write_records(rfq, rrecs, fmt="fastq")
with contextlib.redirect_stdout(io.StringIO()):
    rrep = run_all(rfq, tempfile.mkdtemp(), "r", "RNA",
                   PipelineConfig(d, device="cpu"))
result(rrna=[b.get("rrna") for b in rrep["barcodes"].values()])
"""


def test_port_runs_without_jax_rrna():
    res = run_leg(LEG)
    assert res["loaded"] == []
    assert {"18S": 1, "28S": 1} in res["rrna"]
