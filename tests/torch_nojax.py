"""Shared pieces of the tests that run the port in a fresh interpreter
where neither ``import jax`` nor ``import tpu_orc`` works (the GPU host
has no JAX, and the port imports nothing of tpu_orc):
test_torch_nojax_coi.py, test_torch_nojax_mesh.py and
test_torch_nojax_rrna.py. Each of those runs one leg of the main path in
its own subprocess, so that pytest-xdist (``--dist loadfile``) can spread
the legs over its workers.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the start of every leg's script: block jax and tpu_orc, import the
#: whole path, write the synthetic adapter folder and the COI plate
PREAMBLE = r"""
import contextlib, io, json, os, sys, tempfile
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["tpu_orc"] = None      # and so does any import of tpu_orc
import torch
torch.set_num_threads(1)
from tpu_orc_torch import synthetic
from tpu_orc_torch.cluster import consensus
from tpu_orc_torch.io.fastq import write_records
from tpu_orc_torch.pipeline.stages import PipelineConfig, run_all
import tpu_orc_torch.cli  # the whole path
d = synthetic.write_adapter_dir(tempfile.mkdtemp())
recs, _ = synthetic.make_plate(10, n5=2, n27=2, seed=2, insert_len=300)
fq = os.path.join(tempfile.mkdtemp(), "plate.fastq")
write_records(fq, recs, fmt="fastq")


def consensus_files(out):
    sdir = os.path.join(out, "sorted")
    return {b: open(os.path.join(sdir, b, "consensusfile.fasta")).read()
            for b in sorted(os.listdir(sdir))
            if os.path.isdir(os.path.join(sdir, b))}


def coi_run(backend="native", **cfg):
    consensus.PILEUP_BACKEND = backend
    out = tempfile.mkdtemp()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = run_all(fq, out, "x", "COI",
                      PipelineConfig(d, device="cpu", bin_workers=1, **cfg))
    return rep, consensus_files(out)


def result(**res):
    res["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "tpu_orc")
                           and sys.modules[m] is not None)
    print(json.dumps(res))
"""

#: each leg's subprocess limit, in seconds
TIMEOUT = 600


def run_leg(body: str) -> dict:
    """Run PREAMBLE + ``body`` in a fresh interpreter; return the JSON
    object its last line prints (``body`` ends with ``result(...)``)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", PREAMBLE + body], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
