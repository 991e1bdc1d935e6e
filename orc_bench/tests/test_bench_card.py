"""Each cell run through its command on the card, for 20 s (skips
without one): exit 0, ``correct``, and the result line the contract
asks for, traced and not."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, load

CELLS = [w["name"] for w in load("..", "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, trace, card):
    p = subprocess.run(
        [sys.executable, "-m", "orc_bench.run", "--workload", workload,
         "--seed", str(2**32 + 17), "--seconds", "20", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=360, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "breakdown" in line
    else:
        assert "setup_s" in line["metrics"]
