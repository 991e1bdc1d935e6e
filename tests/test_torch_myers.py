"""tpu_orc_torch Myers (align/myers.py) against tpu_orc on the CPU.

The port's plain version of the Myers kernels must equal, bit for bit,
the Pallas kernels run in interpret mode (dense grid and listed tile
pairs), in NW/SHW/HW with the end position, and the native C++ oracle.
Tolerance: none (integer equality). Inputs come from fixed numpy seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc import native
from tpu_orc.align import pallas_myers as ref_pm
from tpu_orc.io import encode
from tpu_orc_torch.align import myers as M

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


def _pack(seqs, width=None):
    codes = [encode.encode_codes(s) for s in seqs]
    W = width or -(-max(len(c) for c in codes) // 32) * 32
    out = np.full((len(codes), W), 4, np.uint8)
    lens = np.zeros(len(codes), np.int32)
    for i, c in enumerate(codes):
        out[i, :len(c)] = c
        lens[i] = len(c)
    return out, lens


def _seqs(rng, n, lo, hi, alphabet="ACGTN", p=(.24, .24, .24, .24, .04)):
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(lo, hi)),
                               p=list(p))) for _ in range(n)]


def _related(rng, n, length, rate):
    base = "".join(rng.choice(list("ACGT"), size=length))
    out = []
    for _ in range(n):
        s = list(base)
        for _ in range(int(rate * length)):
            k = int(rng.integers(0, len(s)))
            op = int(rng.integers(0, 3))
            if op == 0:
                s[k] = str(rng.choice(list("ACGT")))
            elif op == 1 and len(s) > 1:
                del s[k]
            else:
                s.insert(k, str(rng.choice(list("ACGT"))))
        out.append("".join(s))
    return out


def test_peq_packing_equals_reference():
    rng = np.random.default_rng(1)
    pc, pl = _pack(_seqs(rng, 9, 1, 140))
    W = pc.shape[1] // 32
    np.testing.assert_array_equal(M.build_peq_packed(pc, pl, W),
                                  ref_pm.build_peq_packed(pc, pl, W))


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_dense_equals_pallas(mode):
    """Dense entry point: dist and pos == distances_pallas(interpret)."""
    rng = np.random.default_rng(2)
    pats = _seqs(rng, 12, 1, 100) + _related(rng, 4, 90, 0.1)
    txts = _seqs(rng, 20, 1, 140) + _related(rng, 4, 90, 0.1)
    pc, pl = _pack(pats)
    tc, tl = _pack(txts)
    want_d, want_p = ref_pm.distances_pallas(pc, pl, tc, tl, mode, TI=8,
                                             TJ=128, interpret=True)
    got_d, got_p = M.distances(pc, pl, tc, tl, mode)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_p, want_p)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_pairs_equals_pallas(mode):
    """Listed-tile entry point: every listed block == the Pallas pairs
    kernel's, at the same tile granularity (unlisted blocks are
    unspecified on both sides)."""
    rng = np.random.default_rng(3)
    seqs = _related(rng, 20, 150, 0.08) + _seqs(rng, 20, 60, 170)
    pc, pl = _pack(seqs)
    TI, TJ = 8, 128
    P = -(-len(seqs) // TI) * TI
    tiles = np.array([[0, 0], [2, 0], [4, 0]], np.int32)
    want_d, want_p = ref_pm.distances_pallas_pairs(pc, pl, pc, pl, tiles,
                                                   mode, TI=TI, TJ=TJ,
                                                   interpret=True)
    want_d, want_p = np.asarray(want_d), np.asarray(want_p)
    with pytest.raises(ValueError):   # the CUDA block is 8 x 32
        M.distances_pairs(pc, pl, pc, pl, tiles, mode, TI=4, TJ=TJ)
    got_d, got_p = M.distances_pairs(pc, pl, pc, pl, tiles, mode, TI=TI,
                                     TJ=TJ)
    assert got_d.shape == (P, TJ)
    for ti, tj in tiles:
        rows = slice(ti * TI, (ti + 1) * TI)
        cols = slice(tj * TJ, min((tj + 1) * TJ, len(seqs)))
        np.testing.assert_array_equal(got_d[rows, cols], want_d[rows, cols])
        np.testing.assert_array_equal(got_p[rows, cols], want_p[rows, cols])


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_dense_equals_native(mode):
    """Multi-word patterns (up to 3 x 64-bit words) against the C++
    oracle's edit distance."""
    rng = np.random.default_rng(4)
    pats = _related(rng, 5, 180, 0.1) + _seqs(rng, 3, 1, 70)
    txts = _related(rng, 3, 200, 0.05) + _seqs(rng, 3, 1, 230)
    pc, pl = _pack(pats)
    tc, tl = _pack(txts)
    got, _ = M.distances(pc, pl, tc, tl, mode)
    for i in range(len(pats)):
        for j in range(len(txts)):
            want = native.edit_distance(pc[i, :pl[i]], tc[j, :tl[j]], mode)
            assert got[i, j] == want, (i, j, mode)


def test_gated_block_equals_native_all_vs_all():
    """The scorer's listed-tile gene-stage block == the native
    all-vs-all on every gated pair (the 5% length gate and the upper
    triangle)."""
    from tpu_orc_torch.cluster.scoring import DeviceScorer, pack_codes
    rng = np.random.default_rng(5)
    seqs = sorted(_related(rng, 40, 300, 0.06), key=len)
    codes = [encode.encode_codes(s) for s in seqs]
    n = len(codes)
    packed, lens = pack_codes(codes, count_cap=64)
    lo = np.minimum.outer(lens[:n], lens[:n])
    hi = np.maximum.outer(lens[:n], lens[:n])
    gate = (np.arange(n)[:, None] < np.arange(n)[None, :]) & \
        (lo * 1.05 >= hi)
    D = DeviceScorer()._gated_block(packed, lens, packed[:64], lens[:64],
                                    gate, n, n, 64)
    want = native.all_vs_all(codes, band=1.05)
    gi, gj = np.nonzero(gate)
    np.testing.assert_array_equal(D[gi, gj], want[gi, gj])
