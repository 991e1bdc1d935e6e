"""tpu_orc_torch path-bits pileup (align/pileup.py) against tpu_orc's Pallas
kernels and native pileup.

``path_bits_plain`` (reached through the port's ``path_bits`` and
``path_bits_groups`` on the CPU) against ``tpu_orc.align.pallas_pileup``'s
``path_bits`` / ``path_bits_groups`` with ``interpret=True``, on the
shapes of tests/test_cluster.py: drafts of 40-260 bp, reads that mutate
them (substitutions to any code, N included, insertions, deletions), a
group straddling the Pallas 128-read tile, drafts of different word
counts in one multi-group call, a 1-read group and an empty group. The
planes must agree bit for bit on the region the host traceback reads
(read positions below the read's length, words below the draft's
ceil(len / 32): the kernel's contract) and on the whole array where both
define it (every word, positions below the longest read). The counts of
the port's device backend on the CPU must equal ``tpu_orc``'s native
pileup, and a whole sort of one bin with it ``tpu_orc``'s sort with its
own device backend. Tolerance: none. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc import native as ref_native
from tpu_orc.align import pallas_pileup as ref_pp
from tpu_orc.cluster import consensus as ref_c
from tpu_orc.cluster import engine as ref_engine
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record
from tpu_orc_torch.align import pileup as P
from tpu_orc_torch.cluster import consensus as C
from tpu_orc_torch.cluster import engine as port_engine

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


def mutate_reads(rng, base, n, rate=8):
    """The read model of tests/test_cluster.py::_mutate_reads."""
    reads = []
    for _ in range(n):
        s = list(base)
        for _ in range(int(rng.integers(0, max(2, len(base) // rate)))):
            op = int(rng.integers(0, 3))
            p = int(rng.integers(0, len(s)))
            if op == 0:
                s[p] = int(rng.integers(0, 5))
            elif op == 1 and len(s) > 1:
                del s[p]
            else:
                s.insert(p, int(rng.integers(0, 5)))
        reads.append(np.array(s, np.uint8))
    return reads


def assert_planes_equal(got, want, draft, reads):
    """Bit for bit on the specified region of every read, and on every
    word at positions below the longest read."""
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape
    nw = -(-len(draft) // 32)
    for r, read in enumerate(reads):
        np.testing.assert_array_equal(got[r, :len(read), :, :nw],
                                      want[r, :len(read), :, :nw],
                                      err_msg=f"read {r}")
    top = max((len(r) for r in reads), default=0)
    np.testing.assert_array_equal(got[:, :top], want[:, :top])


@pytest.mark.parametrize("L, R, seed", [(40, 11, 0), (260, 6, 1)])
def test_path_bits_plain_equals_pallas(L, R, seed):
    """One draft (Pallas _kernel, #5); the reads carry N and '-' (code 4,
    which matches N in the draft)."""
    rng = np.random.default_rng(seed)
    draft = encode.encode_codes("".join(
        rng.choice(list("ACGTN-"), size=L, p=[.24, .24, .24, .24, .02, .02])))
    reads = mutate_reads(rng, draft, R)
    want = ref_pp.path_bits(draft, reads, interpret=True)
    got = P.path_bits(draft, reads, "cpu")
    assert_planes_equal(got, want, draft, reads)
    counts = ref_native.pileup_from_bits(got, reads, draft)
    assert np.array_equal(counts, ref_native.pileup_batch(reads, draft))


def test_path_bits_groups_plain_equals_pallas():
    """Many groups in one call (Pallas _kernel_multi, #6): drafts of 2, 7
    and 9 words, a 130-read group across the 128-read tile, a 1-read
    group and an empty group."""
    rng = np.random.default_rng(21)
    drafts, groups = [], []
    for L, R in ((45, 130), (200, 1), (260, 17), (120, 0)):
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        drafts.append(base)
        groups.append(mutate_reads(rng, base, R))
    want = ref_pp.path_bits_groups(drafts, groups, interpret=True)
    got = P.path_bits_groups(drafts, groups, "cpu")
    assert len(got) == len(want) == 4
    for d, rs, g, w in zip(drafts, groups, got, want):
        assert_planes_equal(g, w, d, rs)
    assert got[3].shape[0] == 0


def test_pileup_counts_device_backend_equals_native():
    """The port's device backend on the CPU (plain path bits + native
    traceback) == tpu_orc's native pileup, as tests/test_cluster.py::
    test_device_pileup_backend_parity holds tpu_orc's own."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        L = int(rng.integers(40, 260))
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        reads = mutate_reads(rng, base, int(rng.integers(1, 12)))
        want = ref_c.pileup_counts(base, reads, backend="native")
        got = C.pileup_counts(base, reads, backend="device", device="cpu")
        assert got.shape == want.shape and (got == want).all(), trial


def test_sorter_device_backend_equals_reference(monkeypatch):
    """One 60-read two-species bin (tests/test_cluster.py:333-359): the
    port's sorter with the device backend on the CPU gives the same
    species groups and consensus strings as tpu_orc's sorter on its
    device backend (Pallas in interpret mode)."""
    monkeypatch.setattr(C, "PILEUP_BACKEND", "device")
    monkeypatch.setattr(ref_c, "PILEUP_BACKEND", "device")
    rng = np.random.default_rng(23)
    t1 = "".join("ACGT"[c] for c in rng.integers(0, 4, 320))
    t2 = "".join("ACGT"[c] for c in rng.integers(0, 4, 340))
    recs = []
    for k, t in enumerate((t1, t2)):
        for i in range(30):
            s = list(t)
            for _ in range(int(rng.integers(0, 12))):
                p = int(rng.integers(0, len(s)))
                s[p] = "ACGT"[int(rng.integers(0, 4))]
            recs.append(Record(f"r{k}_{i}", f"r{k}_{i}", "".join(s)))
    results = []
    for sorter in (
            port_engine.AmpliconSorter(
                port_engine.SorterConfig(min_length=1, seed=5),
                device="cpu"),
            ref_engine.AmpliconSorter(
                ref_engine.SorterConfig(min_length=1, seed=5))):
        res = sorter.sort_records(recs)
        results.append([(tuple(sorted(g.members)), g.consensus)
                        for gg in res.species for g in gg])
    assert results[0] == results[1]
    assert len(results[0]) == 2


def test_pileup_bits_dispatch_and_checks():
    """A CPU tensor takes the plain version and counts no launch; inputs
    the kernel does not take raise, and so does a device with no
    kernel."""
    rng = np.random.default_rng(3)
    draft = rng.integers(0, 4, size=70).astype(np.uint8)
    tensors, _ = P._upload([draft], [mutate_reads(rng, draft, 3)], "cpu")
    before = P.LAUNCHES.snapshot()
    planes = P.pileup_bits(*tensors)
    assert planes.shape == (8, 128, 4, 3) and planes.dtype == torch.int32
    assert P.LAUNCHES.snapshot() == before
    peqs, dwords, tile_gid, texts, nl = tensors
    with pytest.raises(ValueError):      # codes must be uint8
        P.pileup_bits(peqs, dwords, tile_gid, texts.to(torch.int32), nl)
    with pytest.raises(ValueError):      # T not a multiple of the tile
        P.pileup_bits(peqs, dwords, tile_gid, texts[:, :5].contiguous(),
                      nl[:5])
    with pytest.raises(ValueError):
        P.pileup_bits(*(t.to("meta") for t in tensors))


def test_pileup_rejects_peq_row_in_two_channels_and_code_8():
    """pileup_bits shares myers' host checks: a draft's Peq row set in two
    channels, or a read code of 8, is rejected (the warp kernel would
    read both differently from the plain version); the path_bits host
    wrapper rejects a read code of 8 while it packs."""
    rng = np.random.default_rng(4)
    draft = rng.integers(0, 4, size=40).astype(np.uint8)
    reads = mutate_reads(rng, draft, 3)
    tensors, _ = P._upload([draft], [reads], "cpu")
    peqs, dwords, tile_gid, texts, nl = tensors
    bad = peqs.clone()
    bad[0, (int(draft[0]) + 1) % 4] |= 1
    with pytest.raises(ValueError, match="channel"):
        P.pileup_bits(bad, dwords, tile_gid, texts, nl)
    bad_t = texts.clone()
    bad_t[2, 0] = 8
    with pytest.raises(ValueError, match="code 8"):
        P.pileup_bits(peqs, dwords, tile_gid, bad_t, nl)
    reads[1] = reads[1].copy()
    reads[1][5] = 8
    with pytest.raises(ValueError, match="code 8"):
        P.path_bits(draft, reads, "cpu")
