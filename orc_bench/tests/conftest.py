"""Shared pieces of the benchmark's tests: tiny versions of the cells'
configurations and mixes, for runs on the CPU, and the fixture that
decides whether a card is there."""
import json
import os

import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


#: the cells of the tests: those of BENCHMARK.json, and the sort cells
#: that the benchmark leaves out for now (PERF.md, Open questions)
CELLS = {"coi.demux": ("coi_plate96", "plate_coi"),
         "coi.sort": ("coi_plate96", "bins_coi_1k"),
         "rrna.sort": ("rrna_plate96", "bins_rrna_1k")}


def tiny(workload: str):
    """(configuration, mix, limits) of a cell cut to a size that the
    port's plain versions run in seconds on the CPU: short reads, few
    reads, small chunks and bins."""
    config, traffic = CELLS[workload]
    cfg = load("configs", f"{config}.json")
    mix = load("traffic", f"{traffic}.json")
    lim = load("limits", f"{workload}.json")
    if mix["stage"] == "demux_stream":
        cfg = dict(cfg, insert_length=60)
        cfg.pop("insert_range", None)
        mix = dict(mix, reads=300, chunk=64, check_reads=300,
                   check_block=256)
        lim = dict(lim, reads_checked_min=16)
    else:
        cfg = dict(cfg, insert_range=[1000, 1100])
        mix = dict(mix, reads_per_bin=60, pool_bins=3, warm_reads=12,
                   check_pairs_per_bin=80)
        lim = dict(lim, pairs_checked_min=6)
    return cfg, mix, lim


@pytest.fixture
def cpu_fused(monkeypatch):
    """The fused demux on CPU banks (the port takes it on CUDA only), so
    that a CPU run drives ``FusedDemux.assign`` as the card's does."""
    import tpu_orc_torch.demux.demux as D
    monkeypatch.setattr(D, "_use_fused", lambda a, b: True)


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
