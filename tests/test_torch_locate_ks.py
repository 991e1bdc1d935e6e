"""tpu_orc_torch's Kogge-Stone locate (``align/locate.py``) against tpu_orc
on the CPU.

``locate_plain_ks`` must equal, bit for bit, tpu_orc's Pallas ``_kernel``
(``locate_tiles(impl="ks")``) in interpret mode on all eight outputs, in
FRONT/BACK/INFIX, at e 0.1 and 0.2 and min_overlap 0, 1 and 3, with N in
the adapters, N and IUPAC codes in the reads, empty reads and reads
shorter than the adapters. At R = 128 rows, where tpu_orc has no kernel,
it must equal the port's wavefront ``locate_plain``. The two Pallas
kernels are also held against each other: they agree everywhere except
BACK with min_overlap 0 on empty reads, where ``_kernel`` counts row 0 of
column 0 as a candidate and ``_kernel_wf`` does not. The "half_warp"
cases are the edges of the CUDA kernel's 16-lane design: adapters of 15,
16, 17, 31, 32 and 33 bp, reads of 0, 1, 15-17 and 31-33 columns, and an
odd count of reads (127). Reads of ``MAX_COLUMNS`` columns or more are
refused by both implementations, as ``tpu_orc`` refuses them. Tolerance:
none (integer equality). Inputs are made with numpy from fixed seeds;
interpret-mode cases stay at 128 reads and L 96.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_orc.align import pallas_locate as ref_pl
from tpu_orc.io import encode
from tpu_orc_torch.align import locate as L
from tpu_orc_torch.align.tables import make_k_table, make_n_prefix

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

FIELDS = ("matches", "errors", "origin", "qstop", "valid", "refstop",
          "nloc", "nacc")
EMPTY = (0, 41, 77)          # reads made empty (others may be drawn so)
MODES = ("front", "back", "infix")
#: the 16-lane design's edges: adapter lengths, and the read lengths
#: given to the last reads
HALF_WARP = ((15, 16, 17, 31, 32, 33), (0, 1, 15, 16, 17, 31, 32, 33))


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


def _case(seed, ref_len, read_len, n_reads=128, L_max=96, exact=None):
    """(adapter strings, read masks [B, L], read lengths [B]): adapters
    with N, reads with N/R/Y codes, planted full and partial adapters,
    three empty reads and some reads shorter than the adapters.
    ``exact`` = (adapter lengths, read lengths): six adapters of those
    lengths instead of ``ref_len``'s, and the last reads of those
    lengths, each an adapter's suffix and random bases."""
    rng = np.random.default_rng(seed)
    pn = [0.23, 0.23, 0.23, 0.23, 0.08]
    if exact is None:
        refs = [_seq(rng, int(rng.integers(*ref_len)), "ACGTN", pn)
                for _ in range(6)]
    else:
        refs = [_seq(rng, n, "ACGTN", pn) for n in exact[0]]
    pr = [0.22, 0.22, 0.22, 0.22, 0.04, 0.04, 0.04]
    reads = [_seq(rng, int(rng.integers(*read_len)), "ACGTNRY", pr)
             for _ in range(n_reads)]
    for k in range(1, n_reads, 3):
        a = refs[k % 6]
        cut = int(rng.integers(0, len(a)))
        reads[k] = reads[k][:20] + (a if k % 2 else a[cut:]) + reads[k][20:40]
    for k in range(2, n_reads, 10):
        reads[k] = reads[k][:int(rng.integers(1, 6))]
    for k in EMPTY:
        if k < n_reads:
            reads[k] = ""
    for k, n in enumerate(() if exact is None else exact[1]):
        reads[-1 - k] = (refs[k % 6][k:] + _seq(rng, n, "ACGT"))[:n]
    masks, lens = encode.pack_batch(reads, max_len=L_max, pad_multiple=1,
                                    encoder=encode.encode_read_masks_iupac,
                                    pad_value=0)
    return refs, masks, lens.astype(np.int32)


def _pallas(tabs, masks, lens, mode, impl):
    """tpu_orc's Pallas kernel ``impl`` in interpret mode -> [8, A, B]."""
    B0, Lr = masks.shape
    B = -(-B0 // ref_pl.TB) * ref_pl.TB
    rt = np.zeros((Lr, B), np.int32)
    rt[:, :B0] = masks.T
    ln = np.zeros((1, B), np.int32)
    ln[0, :B0] = lens
    out = ref_pl.locate_tiles(*tabs.arrays(), jnp.asarray(rt),
                              jnp.asarray(ln), mode, tabs.Ap, Lr, True,
                              impl=impl, As=tabs.A if impl == "wf" else None)
    return np.stack([np.asarray(x)[:tabs.A, :B0] for x in out])


def _plain(fn, tabs, masks, lens, mode):
    rt = torch.from_numpy(np.ascontiguousarray(masks.T, np.uint8))
    return fn(tabs.tensors("cpu"), rt, torch.from_numpy(lens), mode,
              tabs.A).numpy()


def _tables(pkg, refs, e, mode, min_overlap):
    bm, bl = _bank(refs)
    return pkg.BankTables(bm, bl, make_k_table(e, bm, bl), make_n_prefix(bm),
                          mode == "front", min_overlap)


def _assert_equal(got, want):
    assert got.shape == want.shape
    for k, field in enumerate(FIELDS):
        np.testing.assert_array_equal(got[k], want[k], err_msg=field)


KS_CASES = [pytest.param(mode, e, mo, "random", id=f"{mode}-{e}-{mo}")
            for mode in MODES for e in (0.1, 0.2) for mo in (0, 1, 3)]
KS_CASES += [pytest.param(mode, 0.2, mo, "half_warp",
                          id=f"{mode}-half_warp-{mo}")
             for mode in MODES for mo in (0, 3)]


@pytest.mark.parametrize("mode,e,min_overlap,shape", KS_CASES)
def test_locate_plain_ks_equals_pallas_ks(mode, e, min_overlap, shape):
    if shape == "random":
        refs, masks, lens = _case(200 + int(e * 10) + min_overlap, (3, 30),
                                  (0, 60))
    else:
        refs, masks, lens = _case(500 + min_overlap, None, (0, 96),
                                  n_reads=127, exact=HALF_WARP)
        assert sorted(map(len, refs)) == list(HALF_WARP[0])
        assert set(HALF_WARP[1]) <= set(lens.tolist())
    want = _pallas(_tables(ref_pl, refs, e, mode, min_overlap), masks, lens,
                   mode, "ks")
    got = _plain(L.locate_plain_ks, _tables(L, refs, e, mode, min_overlap),
                 masks, lens, mode)
    assert want[4].sum() > 20
    _assert_equal(got, want)


@pytest.mark.parametrize("min_overlap", [0, 1, 3])
@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_pallas_ks_and_wf_differ_only_on_empty_back_reads(mode, min_overlap):
    """The reference's two Pallas kernels: equal on all 8 outputs, except
    BACK with min_overlap 0, where they differ on exactly the empty
    reads (``_kernel`` seeds its final-column snapshot with column 0,
    row 0 included; ``_kernel_wf`` never evaluates cell (0, 0))."""
    refs, masks, lens = _case(300 + min_overlap, (3, 30), (0, 60))
    tabs = _tables(ref_pl, refs, 0.2, mode, min_overlap)
    ks = _pallas(tabs, masks, lens, mode, "ks")
    wf = _pallas(tabs, masks, lens, mode, "wf")
    differ = np.flatnonzero((ks != wf).any(axis=(0, 1)))
    if mode == "back" and min_overlap == 0:
        np.testing.assert_array_equal(differ, np.flatnonzero(lens == 0))
        assert set(EMPTY) <= set(differ)
    else:
        assert differ.size == 0, differ


@pytest.mark.parametrize("min_overlap", [0, 3])
@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_locate_plain_ks_equals_plain_wf_at_128_rows(mode, min_overlap):
    """Adapters of 64-120 bp take R = 128 rows, past the Pallas tables:
    the port's two plain versions agree as the two Pallas kernels do."""
    refs, masks, lens = _case(400 + min_overlap, (64, 121), (0, 220),
                              n_reads=64, L_max=256)
    tabs = _tables(L, refs, 0.2, mode, min_overlap)
    assert tabs.ref.shape[1] == 128
    ks = _plain(L.locate_plain_ks, tabs, masks, lens, mode)
    wf = _plain(L.locate_plain, tabs, masks, lens, mode)
    assert ks[4].sum() > 10
    differ = np.flatnonzero((ks != wf).any(axis=(0, 1)))
    if mode == "back" and min_overlap == 0:
        np.testing.assert_array_equal(differ, np.flatnonzero(lens == 0))
        assert set(EMPTY[:2]) <= set(differ)   # read 77 is past the 64
    else:
        assert differ.size == 0, differ


def test_locate_tiles_picks_the_implementation(monkeypatch):
    """``impl`` and ``LOCATE_IMPL`` route a CPU tensor to the chosen plain
    version (told apart on BACK with min_overlap 0 and an empty read); an
    unknown implementation raises."""
    refs, masks, lens = _case(7, (3, 30), (0, 60))
    tabs = _tables(L, refs, 0.1, "back", 0)
    ks = _plain(L.locate_plain_ks, tabs, masks, lens, "back")
    wf = _plain(L.locate_plain, tabs, masks, lens, "back")
    assert not np.array_equal(ks, wf)
    monkeypatch.setattr(L, "LOCATE_IMPL", "wf")
    tiles = lambda **kw: _plain(lambda *a: L.locate_tiles(*a, **kw), tabs,
                                masks, lens, "back")
    np.testing.assert_array_equal(tiles(), wf)
    np.testing.assert_array_equal(tiles(impl="ks"), ks)
    monkeypatch.setattr(L, "LOCATE_IMPL", "ks")
    np.testing.assert_array_equal(tiles(), ks)
    np.testing.assert_array_equal(tiles(impl="wf"), wf)
    monkeypatch.setattr(L, "LOCATE_IMPL", "kogge")
    with pytest.raises(ValueError, match="kogge"):
        tiles()


@pytest.mark.parametrize("impl", ["wf", "ks"])
def test_locate_tiles_refuses_reads_of_max_columns(monkeypatch, impl):
    """Both implementations refuse reads of ``MAX_COLUMNS`` = 2**20 - 64
    columns (``tpu_orc``'s ``locate_tiles`` limit) before the CPU/CUDA
    split, and take one column fewer (the plain version stubbed: its
    loop would walk a million columns)."""
    assert L.MAX_COLUMNS == 2 ** 20 - 64
    refs, _, _ = _case(7, (3, 30), (0, 60))
    tabs = _tables(L, refs, 0.1, "front", 3).tensors("cpu")
    called = []
    stub = lambda *a: called.append(a[1].shape[0])
    monkeypatch.setitem(L.IMPLS, impl, (stub, stub))
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="columns"):
        L.locate_tiles(tabs, torch.zeros((2 ** 20 - 64, 1), dtype=torch.uint8),
                       lens, "front", 6, impl=impl)
    assert called == []
    L.locate_tiles(tabs, torch.zeros((2 ** 20 - 65, 1), dtype=torch.uint8),
                   lens, "front", 6, impl=impl)
    assert called == [2 ** 20 - 65]


def test_locate_cuda_ks_rejects_unknown_lanes():
    """The KS kernel's designs are 16 and 32 lanes an alignment; any
    other ``lanes`` raises before a launch is tried."""
    refs, masks, lens = _case(7, (3, 30), (0, 60))
    tabs = _tables(L, refs, 0.1, "front", 3).tensors("cpu")
    rt = torch.from_numpy(np.ascontiguousarray(masks.T, np.uint8))
    with pytest.raises(ValueError, match="lanes 8"):
        L.locate_cuda_ks(tabs, rt, torch.from_numpy(lens), "front", 6,
                         lanes=8)
