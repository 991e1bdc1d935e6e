"""tpu_orc_torch ``align/oracle.py`` (the copy of the definitional Python
oracle) against tpu_orc's on the CPU.

``locate`` on random (adapter, read) cases for every flag set the
pipeline uses (FRONT, BACK, INFIX, PREFIX, SUFFIX) at min_overlap 0 and
3, with N wildcards in adapters and reads and empty reads among them;
``edit_distance`` in NW/SHW/HW with and without ``use_iupac``, on
strings and on code arrays; ``similarity``. Tolerance: none (integer
tuples and rounded floats compared with ==). Inputs are made with numpy
from fixed seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc.align import oracle as ref_oracle
from tpu_orc_torch.align import oracle
from tpu_orc_torch.align.spec import BACK, FRONT, PREFIX, SUFFIX, Flag
from tpu_orc_torch.io import encode

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

INFIX = Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2
FLAGS = {"front": FRONT, "back": BACK, "infix": INFIX, "prefix": PREFIX,
         "suffix": SUFFIX}
CASES = 240


def _seq(rng, n, alphabet="ACGTN", p=(.24, .24, .24, .24, .04)):
    return "".join(rng.choice(list(alphabet), size=n, p=list(p)))


def _locate_cases(seed):
    """(adapter, read, error rate) cases: adapters of 1-20 bp with N
    wildcards, reads of 0-60 bp (every 12th empty), a third planted with
    the adapter or a piece of it so that hits, partial hits and ties
    occur."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(CASES):
        a = _seq(rng, int(rng.integers(1, 21)))
        r = "" if k % 12 == 0 else _seq(rng, int(rng.integers(1, 61)))
        if k % 3 == 1:
            lo, hi = sorted(rng.integers(0, len(a) + 1, size=2))
            piece = a[lo:hi] if hi > lo else a
            cut = int(rng.integers(0, len(r) + 1))
            r = r[:cut] + piece.replace("N", "A") + r[cut:]
        out.append((a, r, float(rng.choice([0.0, 0.1, 0.2, 0.3]))))
    return out


@pytest.mark.parametrize("min_overlap", [0, 3])
@pytest.mark.parametrize("mode", list(FLAGS))
def test_locate_equals_reference(mode, min_overlap):
    flags = FLAGS[mode]
    cases = _locate_cases(7 + min_overlap)
    found = 0
    for a, r, e in cases:
        want = ref_oracle.locate(a, r, e, flags, min_overlap)
        got = oracle.locate(a, r, e, flags, min_overlap)
        assert (got is None) == (want is None), (a, r, e)
        if want is not None:
            assert got.astuple() == want.astuple(), (a, r, e)
            found += 1
        # pre-encoded masks give the same answer
        masks = oracle.locate(encode.encode_ref_masks(a),
                              encode.encode_read_masks(r), e, flags,
                              min_overlap)
        assert (None if masks is None else masks.astuple()) == \
            (None if got is None else got.astuple())
    assert sum(r == "" for _, r, _ in cases) >= 20
    assert found > 0
    if min_overlap == 3:
        assert found < len(cases)


def _pairs(seed, n=30):
    rng = np.random.default_rng(seed)
    alphabet = "ACGTNRY"
    p = (.2, .2, .2, .2, .08, .06, .06)
    out = []
    for k in range(n):
        a = _seq(rng, int(rng.integers(0 if k == 0 else 1, 50)), alphabet, p)
        b = _seq(rng, int(rng.integers(0 if k == 1 else 1, 80)), alphabet, p)
        if k % 3 == 2:
            b = b[:10] + a + b[10:]
        out.append((a, b))
    return out


@pytest.mark.parametrize("use_iupac", [False, True])
@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_edit_distance_equals_reference(mode, use_iupac):
    for a, b in _pairs(3):
        want = ref_oracle.edit_distance(a, b, mode, use_iupac)
        assert oracle.edit_distance(a, b, mode, use_iupac) == want, (a, b)
        enc = encode.encode_ref_masks if use_iupac else encode.encode_codes
        assert oracle.edit_distance(enc(a), enc(b), mode, use_iupac) == want


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_similarity_equals_reference(mode):
    pairs = [(a, b) for a, b in _pairs(5) if a or b]
    pairs += [("A" * 399 + "C", "A" * 400),       # 1 - 1/400 = 0.9975
              ("ACGT" * 500, "ACGT" * 499 + "ACGA")]
    for a, b in pairs:
        assert oracle.similarity(a, b, mode) == \
            ref_oracle.similarity(a, b, mode), (a, b)
