"""tpu_orc_torch CUDA kernels against their plain PyTorch versions, on the
card.

Every test is marked ``cuda`` and skips where there is no CUDA device
(the kernels have no CPU mode). This file imports no JAX, so it runs on
the GPU host, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) Tolerance: none,
the outputs are integers. Inputs come from fixed seeds.
"""
import os
import random

import numpy as np
import pytest
import torch

from tpu_orc_torch import synthetic
from tpu_orc_torch.align import locate as L
from tpu_orc_torch.align import myers as M
from tpu_orc_torch.demux import fused
from tpu_orc_torch.demux.adapters import AdapterBank

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _seqs(rng, n, lo, hi, p=(.23, .23, .23, .23, .08)):
    return ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(lo, hi)),
                               p=list(p))) for _ in range(n)]


@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_locate_kernel_equals_plain(cuda, mode):
    """All 8 outputs, adapters up to 120 bp (past the Pallas tables),
    empty and N-bearing reads."""
    rng = np.random.default_rng(21)
    refs = _seqs(rng, 7, 3, 121)
    bank = AdapterBank([f"a{k}" for k in range(7)], refs, 0.2)
    tabs = L.BankTables(bank.masks, bank.lens, bank.k_table, bank.n_prefix,
                        mode == "front", 3)
    reads = _seqs(rng, 700, 0, 300)
    for k in range(0, 700, 5):   # plant (partial) adapters
        a = refs[k % 7]
        reads[k] = reads[k][:50] + a[int(rng.integers(0, len(a))):]
    masks, lens = synthetic.read_masks(reads, 320)
    tt = tabs.tensors(cuda)
    rt = torch.from_numpy(np.ascontiguousarray(masks.T)).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    got = L.locate_cuda(tt, rt, ln, mode, tabs.A)
    want = L.locate_plain(tt, rt, ln, mode, tabs.A)
    torch.cuda.synchronize()
    assert int(want[4].sum()) > 50
    assert torch.equal(got, want)


def test_locate_tiles_dispatches_cuda_to_kernel(cuda):
    bank = AdapterBank(["a"], ["ACGTACGTAC"], 0.1)
    tabs = L.BankTables(bank.masks, bank.lens, bank.k_table, bank.n_prefix,
                        True, 3)
    masks, lens = synthetic.read_masks(["TTACGTACGTACTT"] * 3, 16)
    rt = torch.from_numpy(np.ascontiguousarray(masks.T)).to(cuda)
    before = L.LAUNCHES.snapshot()["front"]
    L.locate_tiles(tabs.tensors(cuda), rt, torch.from_numpy(lens).to(cuda),
                   "front", 1)
    assert L.LAUNCHES.snapshot()["front"] == before + 1
    with pytest.raises(ValueError):   # non-contiguous reads
        L.locate_tiles(tabs.tensors(cuda), rt.t().contiguous().t(),
                       torch.from_numpy(lens).to(cuda), "front", 1)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_myers_kernel_equals_plain(cuda, mode):
    """Dense and listed-tile entry points; patterns from 1 to 1,100 bp
    (1 to 35 words)."""
    rng = np.random.default_rng(6)
    base = "".join(rng.choice(list("ACGT"), size=480))
    seqs = [synthetic.mutate(random.Random(k), base, 0.08)
            for k in range(96)] + _seqs(rng, 32, 1, 1100)
    W = -(-max(len(s) for s in seqs) // 32) * 32
    pc, pl = synthetic.codes(seqs, W)
    up = M._upload(pc, pl, pc, pl, 128, 128, cuda)
    kd, kp = M.myers_cuda(*up, mode)
    pd, pp = M.myers_plain(*up, mode)
    ti = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda)
    tj = torch.zeros(3, dtype=torch.int32, device=cuda)
    qd, qp = M.myers_cuda(*up, mode, ti, tj, 32, 128)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(kp, pp)
    for t in (0, 2, 3):
        rows = slice(32 * t, 32 * (t + 1))
        assert torch.equal(qd[rows], pd[rows])
        assert torch.equal(qp[rows], pp[rows])


def test_best_takes_first_adapter_on_ties_on_card(cuda):
    rng = np.random.default_rng(2)
    m = rng.integers(-1, 4, size=(12, 4000)).astype(np.int32)
    m[:, :500] = 3
    q = rng.integers(0, 100, size=(12, 4000)).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(cuda)
    idx = fused._best(t(m), t(q), t(q), 12)[0]
    want = np.argmax(m, axis=0)
    want = np.where(m.max(axis=0) < 0, -1, want)
    np.testing.assert_array_equal(idx.cpu().numpy(), want)


def test_fused_kernel_path_equals_plain_path(cuda, tmp_path):
    """FusedDemux through the locate kernel == through the plain locate
    on the same CUDA tensors: the 8 decision vectors."""
    d = synthetic.write_adapter_dir(str(tmp_path))
    sp5 = AdapterBank.from_fasta(
        os.path.join(d, synthetic.FILES[0]), 0.1, "cuda")
    sp27 = AdapterBank.from_fasta(
        os.path.join(d, synthetic.FILES[1]), 0.1, "cuda")
    recs, _ = synthetic.make_plate(10, seed=4, insert_len=200)
    masks, lens = synthetic.read_masks([r.seq for r in recs], 384)
    got = fused.FusedDemux(sp5, sp27).decide(masks, lens)
    want = fused.FusedDemux(sp5, sp27, locate=L.locate_plain).decide(
        masks, lens)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.idx2 >= 0).sum() > 0.9 * len(recs)
