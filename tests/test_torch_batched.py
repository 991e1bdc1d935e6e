"""tpu_orc_torch ``align/batched.py`` and the locate routing of
``demux/demux.py`` against tpu_orc on the CPU.

The port's plain ``batched_locate`` must equal tpu_orc's XLA
``batched_locate`` (JAX on the CPU) on all nine outputs for every valid
flag set, error rate and min_overlap, at adapters up to 255 bp (that
sweep is in test_torch_batched_plain.py, which uses this file's
helpers). From 256 bp on, tpu_orc's STOP_WITHIN_SEQ1 reduction packs the
row into 8 bits and goes wrong; there the port equals the Python and C++
oracles on the six location fields and tpu_orc on nloc/nacc, and one
pinned case shows tpu_orc's difference. The demux routes a locate as
tpu_orc does: banks of 63 bp or more and flag sets other than
FRONT/BACK/INFIX take the batched locate. Tolerance: none (integer
outputs, files compared byte for byte). Inputs are made with numpy from
fixed seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc.align import oracle as ref_oracle
from tpu_orc.align.batched import batched_locate as ref_batched_locate
from tpu_orc.align.batched import batched_locate_with_rc as ref_with_rc
from tpu_orc.align.batched import revcomp_masks_device as ref_revcomp
from tpu_orc.demux import adapters as ref_adapters
from tpu_orc.demux import demux as ref_demux
from tpu_orc.io.fastq import write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import native, synthetic
from tpu_orc_torch.align import batched as BL
from tpu_orc_torch.align.spec import BACK, FRONT, PREFIX, SUFFIX
from tpu_orc_torch.align.tables import make_k_table, make_n_prefix
from tpu_orc_torch.demux import demux as port_demux
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.io import encode
from tpu_orc_torch.pipeline import stages as port_stages

from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

FLAG_SETS = [f for f in range(16) if not (f & 1 and f & 4)]
LOCATION = ("refstart", "refstop", "querystart", "querystop", "matches",
            "errors")


def _seq(rng, n, alphabet="ACGT", p=None):
    return "".join(rng.choice(list(alphabet), size=n, p=p))


def _bank(refs):
    A, M = len(refs), max(len(r) for r in refs)
    masks = np.zeros((A, M), np.uint8)
    lens = np.zeros(A, np.int32)
    for i, r in enumerate(refs):
        m = encode.encode_ref_masks(r)
        masks[i, :len(m)] = m
        lens[i] = len(m)
    return masks, lens


def _case(seed, lengths, n_reads, max_len):
    """Adapters of the given lengths (N wildcards included) and reads:
    random, empty, whole adapters, and planted with prefixes (at the
    read's end) and suffixes (at its start) of the adapters, some
    mutated."""
    rng = np.random.default_rng(seed)
    refs = [_seq(rng, n, "ACGTN", [.24, .24, .24, .24, .04])
            for n in lengths]
    reads = [_seq(rng, int(rng.integers(1, max_len // 2)))
             for _ in range(n_reads)]
    for k in range(n_reads):
        a = refs[k % len(refs)]
        cut = int(rng.integers(min(12, len(a)), len(a) + 1))
        if k % 4 == 1:
            reads[k] = (reads[k][:30] + a[:cut])[:max_len]
        elif k % 4 == 2:
            reads[k] = (a[-cut:] + reads[k])[:max_len]
        elif k % 4 == 3:
            reads[k] = a[:max_len]
        if k % 8 in (2, 3):
            s = list(reads[k])
            for p in rng.integers(0, len(s), size=len(s) // 30 + 1):
                s[p] = "ACGT"[int(rng.integers(0, 4))]
            reads[k] = "".join(s)
    for k in (3, 11):
        if k < n_reads:
            reads[k] = ""
    return refs, reads


def _reads(reads, L):
    return synthetic.read_masks(reads, L)


def _ref_fields(res):
    return np.stack([np.asarray(v) for v in res])


def test_batched_locate_returns_result_on_inputs_device():
    refs, reads = _case(1, (10, 30), 20, 64)
    rm, rl = _bank(refs)
    qm, ql = _reads(reads, 64)
    kt, npf = make_k_table(0.1, rm, rl), make_n_prefix(rm)
    res = BL.batched_locate(rm, rl, kt, npf, qm, ql, int(BACK))
    assert res._fields == BL.FIELDS
    assert all(v.dtype == torch.int32 and v.shape == (20, 2) for v in res)
    want = ref_batched_locate(rm, rl, kt, npf, qm, ql, int(BACK), 3)
    for f in BL.FIELDS:
        assert np.array_equal(getattr(res, f).numpy(),
                              np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("flags", [FRONT, BACK, PREFIX, SUFFIX])
def test_long_adapters_equal_the_oracles(flags):
    """Adapters of 256-300 bp: the six location fields equal the Python
    oracle and the port's C++ oracle, nloc/nacc equal tpu_orc's."""
    refs, reads = _case(7 + int(flags), (256, 300), 16, 400)
    rm, rl = _bank(refs)
    qm, ql = _reads(reads, 400)
    kt, npf = make_k_table(0.1, rm, rl), make_n_prefix(rm)
    got = dict(zip(BL.FIELDS, BL.batched_locate_plain(
        rm, rl, kt, npf, qm, ql, int(flags), 3).numpy()))
    ref = ref_batched_locate(rm, rl, kt, npf, qm, ql, int(flags), 3)
    for f in ("nloc", "nacc"):
        assert np.array_equal(got[f], np.asarray(getattr(ref, f))), f
    out, valid = native.locate_batch(
        [encode.encode_ref_masks(r) for r in refs],
        [encode.encode_read_masks(s) for s in reads], 0.1, int(flags), 3,
        nthreads=1)
    assert np.array_equal(got["valid"], valid.astype(np.int32))
    for b, read in enumerate(reads):
        for a, r in enumerate(refs):
            want = ref_oracle.locate(r, read, 0.1, flags, 3)
            assert bool(got["valid"][b, a]) == (want is not None), (b, a)
            if want is None:
                continue
            loc = tuple(int(got[f][b, a]) for f in LOCATION)
            assert loc == want.astuple() == tuple(out[b, a]), (b, a)
    assert got["valid"].sum() >= 2


def test_reference_batched_wrong_from_row_256():
    """Fault 6 of ROADMAP §3, pinned: in BACK, a read of 30 random bp and
    the first 260 bp of a 300 bp adapter. The oracle and the port give
    refstop 260 with no error; tpu_orc's 8-bit row field gives 260 & 255
    and one error."""
    rng = np.random.default_rng(0)
    adapter = _seq(rng, 300)
    reads = [_seq(rng, 30) + adapter[:260], _seq(rng, 30) + adapter[:290]]
    rm, rl = _bank([adapter])
    qm, ql = _reads(reads, 320)
    kt, npf = make_k_table(0.1, rm, rl), make_n_prefix(rm)
    want = ref_oracle.locate(adapter, reads[0], 0.1, BACK, 3).astuple()
    assert want == (0, 260, 30, 290, 260, 0)
    got = BL.batched_locate(rm, rl, kt, npf, qm, ql, int(BACK), 3)
    assert tuple(int(getattr(got, f)[0, 0]) for f in LOCATION) == want
    assert int(got.refstop[1, 0]) == 290 and int(got.errors[1, 0]) == 0
    ref = ref_batched_locate(rm, rl, kt, npf, qm, ql, int(BACK), 3)
    assert tuple(int(np.asarray(getattr(ref, f))[0, 0])
                 for f in LOCATION) == (0, 4, 0, 290, 260, 1)


@pytest.mark.parametrize("flags", [5, 7, 13, 15])
def test_start1_with_stop1_raises(flags):
    refs, reads = _case(2, (10,), 4, 32)
    rm, rl = _bank(refs)
    qm, ql = _reads(reads, 32)
    kt, npf = make_k_table(0.1, rm, rl), make_n_prefix(rm)
    with pytest.raises(NotImplementedError):
        BL.batched_locate(rm, rl, kt, npf, qm, ql, flags)
    with pytest.raises(NotImplementedError):
        ref_batched_locate(rm, rl, kt, npf, qm, ql, flags)


def test_revcomp_and_with_rc_equal_reference():
    refs, reads = _case(5, (20, 70), 18, 96)
    reads[4] = "ACGTNRYacgt"   # IUPAC read code masks and lower case
    rm, rl = _bank(refs)
    qm, ql = _reads(reads, 96)
    assert np.array_equal(BL.revcomp_masks_device(qm, ql).numpy(),
                          np.asarray(ref_revcomp(qm, ql)))
    kt, npf = make_k_table(0.1, rm, rl), make_n_prefix(rm)
    for flags in (FRONT, BACK):
        got = BL.batched_locate_with_rc(rm, rl, kt, npf, qm, ql,
                                        int(flags), 3)
        want = ref_with_rc(rm, rl, kt, npf, qm, ql, int(flags), 3)
        for g, w in zip(got, want):
            assert np.array_equal(torch.stack(tuple(g)).numpy(),
                                  _ref_fields(w)), flags


def _both_banks(seqs, e=0.1):
    names = [f"a{k}" for k in range(len(seqs))]
    return (AdapterBank(names, seqs, e, "cpu"),
            ref_adapters.AdapterBank(names, seqs, e))


def test_locate_batch_routes_70bp_back_like_reference():
    """A 70 bp BACK bank at min_overlap 0 with 20 reads (over the C++
    shortcut's 16), the first empty: all 9 fields as tpu_orc's, which
    routes banks of 63 bp or more to its XLA locate. On the wavefront
    locate's route the empty read's row 0 of column 0 was never a
    candidate."""
    rng = np.random.default_rng(3)
    ads = [_seq(rng, 70), _seq(rng, 70)]
    reads = [""] + [_seq(rng, int(rng.integers(20, 150)))
                    for _ in range(19)]
    reads[3] = reads[3][:10] + ads[0][:40]
    port, ref = _both_banks(ads)
    assert not port_demux._use_tiles(port, BACK)
    got = port_demux.locate_batch(port, reads, BACK, 0)
    want = ref_demux.locate_batch(ref, reads, BACK, 0)
    for f in BL.FIELDS:
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f))), f
    assert list(got.valid[0]) == [1, 1] and list(got.refstop[0]) == [0, 0]


@pytest.mark.parametrize("flags", [PREFIX, SUFFIX])
def test_locate_batch_prefix_suffix_like_reference(flags):
    rng = np.random.default_rng(int(flags))
    ads = [_seq(rng, 25), _seq(rng, 31)]
    reads = [_seq(rng, int(rng.integers(0, 90))) for _ in range(24)]
    for k in range(0, 24, 3):
        a = ads[k % 2]
        reads[k] = a + reads[k] if flags == PREFIX else reads[k] + a
    port, ref = _both_banks(ads)
    got = port_demux.locate_batch(port, reads, flags)
    want = ref_demux.locate_batch(ref, reads, flags)
    for f in BL.FIELDS:
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f))), f
    assert got.valid.sum() >= 8


def test_routing_rule():
    """``_use_tiles``/``_use_pallas``/``_use_fused`` follow tpu_orc's
    rule: FRONT/BACK/INFIX under 63 bp take the locate kernels' route,
    the kernel itself only on CUDA; the fused demux needs both banks
    there."""
    short = AdapterBank(["a"], ["ACGT" * 15 + "AC"], 0.1, "cuda")   # 62
    long_ = AdapterBank(["a"], ["ACGT" * 15 + "ACG"], 0.1, "cuda")  # 63
    cpu = AdapterBank(["a"], ["ACGT" * 5], 0.1, "cpu")
    assert port_demux._use_pallas(short, FRONT)
    assert not port_demux._use_pallas(long_, FRONT)
    assert not port_demux._use_pallas(short, PREFIX)
    assert not port_demux._use_pallas(cpu, BACK)
    assert port_demux._use_tiles(cpu, BACK)
    assert port_demux._use_fused(short, short)
    assert not port_demux._use_fused(short, long_)


def test_stage_demux_with_70bp_banks_equals_reference(tmp_path):
    """stage_demux on a plate whose SP5 and SP27-rc adapters carry an
    11 bp head (70 bp): the batched locate on both rounds, files
    byte-identical to tpu_orc's."""
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"),
                                           head=11)
    recs, _ = synthetic.make_plate(10, n5=3, n27=2, seed=9, insert_len=150,
                                   head=11)
    fq = str(tmp_path / "pass.fastq")
    write_records(fq, recs, fmt="fastq")
    BL.LAUNCHES.reset()
    got = port_stages.stage_demux(fq, str(tmp_path / "port"), "ds",
                                  port_stages.PipelineConfig(adapters,
                                                             device="cpu"))
    want = ref_stages.stage_demux(fq, str(tmp_path / "ref"), "ds",
                                  ref_stages.PipelineConfig(adapters))
    assert got["final_bins"] == want["final_bins"]
    assert len(got["final_bins"]) == 6
    assert sum(got["final_bins"].values()) == 60
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


# ---------------------------------------------------------------------------
# the kernel wrapper's host logic (the kernel itself runs on the card only:
# tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,lens,bands,slots", [
    (4, [0, 31, 63, 64, 255, 12], [1, 1, 1, 2, 4, 1], [-1, -1, -1, 0, 1, -1]),
    (5, [0, 31, 79, 80, 255, 12], [1, 1, 1, 2, 4, 1], [-1, -1, -1, 0, 1, -1]),
    (8, [0, 31, 127, 128, 255, 12], [1, 1, 1, 2, 2, 1],
     [-1, -1, -1, 0, 1, -1]),
    (8, [300, 64, 256, 611], [3, 1, 3, 5], [0, -1, 1, 2]),
    (8, [70], [1], [-1]),
])
def test_band_count_and_handoff_slots(k, lens, bands, slots):
    """Rows 0..m run in bands of 16 k rows; only adapters of more than
    one band take a handoff slot, numbered in bank order."""
    lens = torch.tensor(lens, dtype=torch.int32)
    assert BL.n_bands(lens, k).tolist() == bands
    got = BL.handoff_slots(lens, k)
    assert got.dtype == torch.int32 and got.tolist() == slots


@pytest.mark.parametrize("max_len,k", [
    (0, 4), (1, 4), (59, 4), (63, 4), (64, 5), (70, 5), (79, 5), (80, 8),
    (127, 8), (128, 8), (300, 8), (611, 8)])
def test_choose_k_fits_the_bank_in_one_band_where_it_can(max_len, k):
    """The fewest rows a lane of 4, 5 and 8 that hold the longest adapter
    in one band, else 8: no handoff where one band does."""
    assert BL.choose_k(max_len) == k
    assert all(BL.LANES * j <= max_len for j in BL.ROWS_PER_LANE if j < k)
    one_band = int(BL.n_bands([max_len], k)[0]) == 1
    assert one_band == (max_len < BL.LANES * BL.ROWS_PER_LANE[-1])
    assert BL.handoff_slots([max_len], k).tolist() == \
        [-1 if one_band else 0]


def test_table_bytes_bound_the_adapter_length():
    """8 (M+1) + M bytes of tables must fit 227 KB: M 25,826 is the
    longest adapter bank the kernel takes, and its matches (<= M) fit the
    16 bits the kernel shuffles them in."""
    assert BL.table_bytes(300) == 8 * 301 + 300
    M = (BL.MAX_SHARED - 8) // 9
    assert BL.table_bytes(M) <= BL.MAX_SHARED < BL.table_bytes(M + 1)
    assert M == 25826 < 1 << 16


@pytest.mark.parametrize("n_slots,L,B,want", [
    (0, 3584, 2048, 2048),                    # no handoff: one launch
    (4, 3584, 2048, 1170),                    # 4 x 3,584 x 16 B a read
    (4, 512, 100, 100),
    (1, 1 << 25, 10, 1),                      # one read over the bound
    (2, 1000, 1, 1),
])
def test_chunk_reads_under_the_handoff_bound(n_slots, L, B, want):
    assert BL.chunk_reads(n_slots, L, B) == want


def test_chunk_reads_follows_the_scratch_bound(monkeypatch):
    monkeypatch.setattr(BL, "SCRATCH_BYTES", 7 * 3 * 400 * BL.HAND_BYTES)
    assert BL.chunk_reads(3, 400, 300) == 7
    assert BL.chunk_reads(3, 401, 300) == 6
    assert BL.chunk_reads(0, 400, 300) == 300


def _cuda_args(M=10, B=4, L=32):
    rm = np.ones((2, M), np.uint8)
    rl = np.array([M, M // 2], np.int32)
    qm = np.ones((B, L), np.uint8)
    ql = np.full(B, L // 2, np.int32)
    return rm, rl, make_k_table(0.1, rm, rl), make_n_prefix(rm), qm, ql


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        BL.batched_locate_cuda(*_cuda_args(), int(BACK), 3)
    assert BL.locate_stack(*_cuda_args(), int(BACK), 3).shape == (9, 4, 2)


def test_kernel_wrapper_refuses_tables_over_shared_memory():
    M = (BL.MAX_SHARED - 8) // 9 + 1
    with pytest.raises(ValueError, match="shared memory"):
        BL.batched_locate_cuda(*_cuda_args(M=M, L=4), int(BACK), 3)


@pytest.mark.parametrize("flags", [5, 7, 13, 15])
def test_kernel_wrapper_refuses_start1_with_stop1(flags):
    with pytest.raises(NotImplementedError):
        BL.batched_locate_cuda(*_cuda_args(), flags, 3)
