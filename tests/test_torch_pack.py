"""tpu_orc_torch's batch packing on the batch's device (``align/pack.py``)
against the host packing it replaces, on the CPU.

``pack_reads_T`` (join, upload, ``pack_masks_T``) must give bit for bit
the [L, B] matrix ``tpu_orc``'s route builds on the host:
``read_masks_matrix(ascii_matrix(seqs, L)).T``, or ``iupac_masks_matrix``
for ``--match-read-wildcards``; at L 128, 4,096 and 8,192, on empty
reads, reads of exactly L, and reads holding X (the fused-read re-scan's
mask), N, IUPAC codes and lower case. ``pack_masks_T`` takes reads
anywhere in its byte buffer and refuses what its kernel does not take.
``locate_batch_lazy`` on a CPU pychopper bank packs through
``pack_reads_T`` and returns the LocateResult of the host-packed route
in all eight fields. The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py``. Tolerance: none (integer equality). Inputs
come from fixed seeds.
"""
import os
import random

import numpy as np
import pytest
import torch

from pack_cases import CASES, ENCODERS, TABLES, batch, host_packing
from pack_cases import pychopper_reads
from tpu_orc_torch import synthetic
from tpu_orc_torch.align import locate as LOC
from tpu_orc_torch.align import pack as P
from tpu_orc_torch.align.locate import INFIX
from tpu_orc_torch.demux import demux as D
from tpu_orc_torch.demux.reorient import build_primer_bank
from tpu_orc_torch.io import encode
from tpu_orc_torch.utils.profiling import recording

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("L", [128, 4096, 8192])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_pack_reads_equals_host_packing(table, L, case):
    seqs = batch(case, L)
    reads_T, lens = P.pack_reads_T(seqs, L, TABLES[table][0], "cpu")
    want, want_lens = host_packing(seqs, L, table)
    assert reads_T.dtype == torch.uint8 and reads_T.shape == (L, len(seqs))
    assert reads_T.is_contiguous() and lens.dtype == torch.int32
    np.testing.assert_array_equal(reads_T.numpy(), want)
    np.testing.assert_array_equal(lens.numpy(), want_lens)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_pack_masks_takes_reads_anywhere_in_data(table):
    """Reads laid out in reverse order with junk bytes between them, and
    one read twice: offsets, not order, place a read."""
    seqs = batch("symbols", 300, seed=1) + [""]
    rnd = random.Random(2)
    buf, offs = bytearray(), [0] * len(seqs)
    for k in reversed(range(len(seqs))):
        buf += bytes(rnd.randrange(256) for _ in range(rnd.randrange(9)))
        offs[k] = len(buf)
        buf += seqs[k].encode("ascii")
    offs[3] = offs[0]
    seqs[3] = seqs[0]
    got = P.pack_masks_T(torch.frombuffer(buf, dtype=torch.uint8),
                         torch.tensor(offs, dtype=torch.int64),
                         torch.tensor([len(s) for s in seqs],
                                      dtype=torch.int32),
                         TABLES[table][0], 320)
    np.testing.assert_array_equal(got.numpy(),
                                  host_packing(seqs, 320, table)[0])


def _refusal(kind):
    data = torch.frombuffer(bytearray(b"ACGTACGTAC"), dtype=torch.uint8)
    offs = torch.tensor([0, 4], dtype=torch.int64)
    lens = torch.tensor([4, 6], dtype=torch.int32)
    tab = TABLES["read"][0]
    return {
        "len_past_L": lambda: P.pack_masks_T(data, offs, lens, tab, 5),
        "negative_len": lambda: P.pack_masks_T(
            data, offs, torch.tensor([4, -1], dtype=torch.int32), tab, 8),
        "read_past_data": lambda: P.pack_masks_T(
            data, torch.tensor([0, 5], dtype=torch.int64), lens, tab, 8),
        "int64_lens": lambda: P.pack_masks_T(data, offs, lens.long(), tab,
                                             8),
        "int32_offs": lambda: P.pack_masks_T(data, offs.int(), lens, tab,
                                             8),
        "short_table": lambda: P.pack_masks_T(data, offs, lens, tab[:128],
                                              8),
        "zero_L": lambda: P.pack_masks_T(data, offs[:0], lens[:0], tab, 0),
        "seq_past_L": lambda: P.pack_reads_T(["ACGT", "ACGTACGT"], 6, tab,
                                             "cpu"),
    }[kind]


@pytest.mark.parametrize("kind", ["len_past_L", "negative_len",
                                  "read_past_data", "int64_lens",
                                  "int32_offs", "short_table", "zero_L",
                                  "seq_past_L"])
def test_pack_refuses(kind):
    with pytest.raises(ValueError):
        _refusal(kind)()


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_mask_table_is_the_encoders_table(encoder):
    """``encode.mask_table`` gives the table each standard encoder maps
    every byte through, and None for any other encoder."""
    every = bytes(range(256))
    np.testing.assert_array_equal(encode.mask_table(ENCODERS[encoder]),
                                  ENCODERS[encoder](every))
    assert encode.mask_table(encode.encode_ref_masks) is None
    assert encode.mask_table(lambda seq: ENCODERS[encoder](seq)) is None


@pytest.mark.parametrize("impl", ["ks", "wf"])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_locate_batch_lazy_device_route_equals_host_route(
        tmp_path, monkeypatch, encoder, impl):
    """``locate_batch_lazy`` on a CPU pychopper bank packs once through
    ``pack_reads_T`` (the host packing, as the CPU tensors pick it) and
    ``locate_dispatch_T``, and returns the LocateResult of the
    host-packed route (``ascii_matrix``, the encoder's masks matrix,
    ``locate_dispatch``), all eight fields. It counts no device pack."""
    monkeypatch.setattr(LOC, "LOCATE_IMPL", impl)
    d = synthetic.write_adapter_dir(str(tmp_path))
    bank = build_primer_bank(os.path.join(d, synthetic.FILES[2]), 0.9,
                             "cpu")[0]
    seqs = pychopper_reads(24, seed=7)
    Lc = encode.bucket_len(max(map(len, seqs)))
    calls = []
    real = P.pack_reads_T
    monkeypatch.setattr(D, "pack_reads_T",
                        lambda *a: calls.append(a[1]) or real(*a))
    with recording() as rec:
        got = D.locate_batch_collect(
            D.locate_batch_lazy(bank, seqs, INFIX, 3, ENCODERS[encoder]))
    assert calls == [Lc] and "locate.device_packs" not in rec.counters()
    masks, lens = host_packing(seqs, Lc, encoder)
    want = LOC.locate_collect(*LOC.locate_dispatch(
        LOC.tables_for_bank(bank, "infix", 3), masks.T, lens, "infix",
        "cpu"))
    assert int(want.valid.sum()) > len(seqs) and int(want.nloc.max()) > 1
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
