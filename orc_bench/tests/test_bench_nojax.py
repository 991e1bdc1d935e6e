"""The no-JAX check, and runs that must print no result."""
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from orc_bench import nojax


@pytest.mark.parametrize("names,bad", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax.numpy", "jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["tpu_orc", "tpu_orc.align.pallas_locate"],
     ["tpu_orc", "tpu_orc.align.pallas_locate"]),
    (["tpu_orc_torch", "tpu_orc_torch.demux.fused", "jaxtyping",
      "tpu_orcx"], []),
])
def test_forbidden_by_whole_top_level_name(names, bad):
    assert nojax.forbidden_loaded(names) == bad


def test_a_blocked_module_is_not_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", None)
    assert "jax" not in nojax.forbidden_loaded()


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "orc_bench.run", "--workload", "coi.demux",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "orc_bench"),
                    tmp_path / "orc_bench")
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
