"""tpu_orc_torch's plain ``batched_locate`` against tpu_orc's XLA
``batched_locate`` on the CPU, for every valid flag set (moved out of
test_torch_batched.py, whose helpers it uses, so that pytest-xdist can
run the two files on two workers).

All nine outputs must be equal, at error rates 0, 0.1 and 0.2,
min_overlap 0 and 3, adapters of 4-255 bp (up to 255 bp, where tpu_orc's
reduction is exact). Tolerance: none (integer outputs). Inputs are made
with numpy from fixed seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc.align.batched import batched_locate as ref_batched_locate
from tpu_orc_torch.align import batched as BL
from tpu_orc_torch.align.tables import make_k_table, make_n_prefix

from test_torch_batched import FLAG_SETS, _bank, _case, _reads, _ref_fields

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_plain_equals_reference_batched(flags):
    """All 9 fields, e in {0, 0.1, 0.2}, min_overlap 0 and 3, adapters of
    4-255 bp."""
    refs, reads = _case(flags, (4, 17, 40, 63, 130, 255), 24, 320)
    rm, rl = _bank(refs)
    qm, ql = _reads(reads, 320)
    hits = 0
    for e in (0.0, 0.1, 0.2):
        kt, npf = make_k_table(e, rm, rl), make_n_prefix(rm)
        for mo in (0, 3):
            want = _ref_fields(ref_batched_locate(rm, rl, kt, npf, qm, ql,
                                                  flags, mo))
            got = BL.batched_locate_plain(rm, rl, kt, npf, qm, ql, flags,
                                          mo).numpy()
            bad = [BL.FIELDS[k] for k in range(9)
                   if not np.array_equal(got[k], want[k])]
            assert not bad, (e, mo, bad)
            hits += int(got[0].sum())
    assert hits > 0
