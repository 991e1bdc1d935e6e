"""tpu_orc_torch fused dual-round demux (demux/fused.py) against tpu_orc.

The port's FusedDemux (plain locate on the CPU) must give the same eight
decision vectors and the same materialized records as tpu_orc's
FusedDemux with its Pallas kernels in interpret mode, on synthetic
12 x 12 banks of 59-mers and the read mix of tests/test_fused.py: clean
dual-adapter reads, mutated adapters, SP5-only reads, garbage, half
reverse-complemented, plus reads whose only hit is the 3-6 bp suffix all
12 SP5 adapters share (a tie across every adapter: the first wins).
Tolerance: none.
"""
import os

import numpy as np
import pytest
import torch

from tpu_orc.demux import adapters as ref_adapters
from tpu_orc.demux import fused as ref_fused
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record
from tpu_orc_torch import synthetic
from tpu_orc_torch.demux import fused as port_fused
from tpu_orc_torch.demux.adapters import AdapterBank

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    d = synthetic.write_adapter_dir(str(tmp_path_factory.mktemp("adapters")))
    f5 = os.path.join(d, "M13_amplicon_indices_forward.fa")
    f27 = os.path.join(d, "M13_amplicon_indices_reverse_rc.fa")
    return ((AdapterBank.from_fasta(f5, 0.1),
             AdapterBank.from_fasta(f27, 0.1)),
            (ref_adapters.AdapterBank.from_fasta(f5, 0.1),
             ref_adapters.AdapterBank.from_fasta(f27, 0.1)))


def make_reads(rng, sp5, sp27, n=64):
    reads = []
    for i in range(n):
        ins = "".join(rng.choice(list("ACGT"),
                                 size=int(rng.integers(40, 200))))
        kind = i % 5
        if kind == 0:      # clean dual-adapter read
            s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        elif kind == 1:    # mutated adapters
            a = list(sp5.seqs[(i + 3) % 12])
            for _ in range(3):
                a[int(rng.integers(0, len(a)))] = str(rng.choice(list("ACGT")))
            s = "".join(a) + ins + sp27.seqs[(i + 1) % 8]
        elif kind == 2:    # SP5 only
            s = sp5.seqs[i % 12] + ins
        elif kind == 3:    # the shared SP5 suffix only: 12-way tie
            s = sp5.seqs[0][-(3 + i % 4):] + ins
        else:              # garbage
            s = ins
        if i % 2:
            s = encode.revcomp(s)
        reads.append(Record(f"r{i}", f"r{i} meta", s, "I" * len(s)))
    return reads


def test_fused_decide_equals_reference(banks):
    (p5, p27), (r5, r27) = banks
    reads = make_reads(np.random.default_rng(0), p5, p27, n=96)
    amat, lens = encode.ascii_matrix([r.seq for r in reads], max_len=384)
    masks = encode.read_masks_matrix(amat, lens)
    want = ref_fused.FusedDemux(r5, r27, interpret=True).decide(masks, lens)
    got = port_fused.FusedDemux(p5, p27).decide(masks, lens)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the suffix-only reads tie across all 12 SP5 adapters
    tie = [i for i in range(len(reads)) if i % 5 == 3]
    assert (got.idx1[tie] == 0).all()


def test_fused_assign_equals_reference(banks):
    (p5, p27), (r5, r27) = banks
    reads = make_reads(np.random.default_rng(1), p5, p27, n=64)
    reads += [Record("e0", "e0", "", ""), Record("e1", "e1", "ACG", "III"),
              Record("e2", "e2", p5.seqs[0], "I" * len(p5.seqs[0]))]
    want = ref_fused.FusedDemux(r5, r27, interpret=True).assign(
        reads, batch_size=32, max_len=128)
    got = port_fused.FusedDemux(p5, p27).assign(reads, batch_size=32,
                                                max_len=128)
    assert got == want


def test_best_takes_first_adapter_on_ties():
    """_best's tie-break is the first index holding the maximum, for any
    tie pattern (numpy argmax is the reference)."""
    rng = np.random.default_rng(2)
    A, B = 12, 500
    m = rng.integers(-1, 4, size=(A, B)).astype(np.int32)
    m[:, :20] = 3                      # all-adapter ties
    m[:, 20:40] = -1                   # no hit
    q, o, c = (rng.integers(0, 100, size=(A, B)).astype(np.int32)
               for _ in range(3))
    t = lambda x: torch.from_numpy(x)
    idx, best, pq, po, pc = port_fused._best(t(m), t(q), t(o), A, t(c))
    want = np.argmax(m, axis=0)
    none = m.max(axis=0) < 0
    np.testing.assert_array_equal(idx.numpy(), np.where(none, -1, want))
    b = np.arange(B)
    np.testing.assert_array_equal(pq.numpy(), q[want, b])
    np.testing.assert_array_equal(pc.numpy(), c[want, b])
