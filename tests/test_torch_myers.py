"""tpu_orc_torch Myers (align/myers.py) against tpu_orc on the CPU.

The port's plain version of the Myers kernels must equal, bit for bit,
the Pallas kernels run in interpret mode (dense grid and listed tile
pairs), in NW/SHW/HW with the end position, and the native C++ oracle;
``distances_with_pos`` must equal the XLA ``myers_tile`` that stage 05a
calls in tpu_orc, at the rRNA callers' shapes. Tolerance: none (integer
equality). Inputs come from fixed numpy seeds.
"""
import numpy as np
import pytest
import torch

from tpu_orc import native
from tpu_orc.align import myers as ref_myers
from tpu_orc.align import pallas_myers as ref_pm
from tpu_orc.io import encode
from tpu_orc.rrna.anchors import ANCHOR_18S_END, ANCHOR_28S_START
from tpu_orc_torch.align import myers as M

from test_rrna_accuracy import make_rdna_contig

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
    got_d, got_p = M.distances(pc, pl, tc, tl, mode, device="cpu")
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
        M.distances_pairs(pc, pl, pc, pl, tiles, mode, TI=4, TJ=TJ,
                          device="cpu")
    got_d, got_p = M.distances_pairs(pc, pl, pc, pl, tiles, mode, TI=TI,
                                     TJ=TJ, device="cpu")
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
    got, _ = M.distances(pc, pl, tc, tl, mode, device="cpu")
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
    D = DeviceScorer(device="cpu")._gated_block(packed, lens, packed[:64], lens[:64],
                                    gate, n, n, 64)
    want = native.all_vs_all(codes, band=1.05)
    gi, gj = np.nonzero(gate)
    np.testing.assert_array_equal(D[gi, gj], want[gi, gj])


@pytest.mark.parametrize("patterns,mode", [
    ("anchors", "HW"), ("anchors", "SHW"), ("anchors", "NW"),
    ("exemplars", "HW")])
def test_distances_with_pos_equals_xla(patterns, mode):
    """Stage 05a's packing (pattern and text pad code 4): ~20 bp anchors,
    one with an N, or ~1,800 bp exemplars, against ~3.5 kb rDNA texts on
    both strands, a short text and an empty one."""
    rng = np.random.default_rng(3)
    rdna = [make_rdna_contig(rng, 0.05)[0] for _ in range(2)]
    texts = rdna + [encode.revcomp(rdna[0]), rdna[0][:500], ""]
    if patterns == "anchors":
        pats = [ANCHOR_18S_END, ANCHOR_28S_START, "GCATCGATGNAGAACGCAGC"]
    else:
        pats = [rdna[0][:1800], rdna[1][100:1880]]
    pc, pl = _pack(pats)
    tc, tl = _pack(texts, -(-max(len(t) for t in texts) // 128) * 128)
    want = ref_myers.distances_with_pos(pc, pl, tc, tl, mode)
    got = M.distances_with_pos(pc, pl, tc, tl, mode, "cpu")
    assert (want[0][:, 4] == pl).all() and (want[1][:, 4] == 0).all()
    for g, w, what in zip(got, want, ("dist", "pos")):
        np.testing.assert_array_equal(g, w, err_msg=what)


def _pipeline_shapes():
    """(pairs launched, W) of the scorer's Myers launches: the COI gene
    stage's 1000 x 1000 block (dense, and as the 144 listed 32 x 128
    tiles of chip_smoke.py), and an rRNA bin of 24 ~3.4 kb reads: the
    species ladder's 2 consensuses x 24 reads and the gene stage's one
    listed tile; 05a's anchor locate (2 anchors, W 1)."""
    from tpu_orc_torch.cluster.scoring import _bucket, _count_cap
    W_coi = _bucket(490) // 32
    W_rrna = _bucket(3400) // 32
    TI, TJ = M.tile_shape(W_rrna)
    return [
        pytest.param(1000 * 1000, W_coi, "thread", id="coi_block_dense"),
        pytest.param(144 * 32 * 128, W_coi, "thread", id="coi_block_tiles"),
        pytest.param(_count_cap(2) * _count_cap(24), W_rrna, "warp",
                     id="rrna_ladder_dense"),
        pytest.param(TI * TJ, W_rrna, "warp", id="rrna_gene_stage_tile"),
        pytest.param(2 * 8, 1, "warp", id="rrna_anchors"),
    ]


@pytest.mark.parametrize("pairs, W, want", _pipeline_shapes() + [
    pytest.param(1 << 20, W, "thread" if W <= 32 else "warp",
                 id=f"many_pairs_W{W}")
    for W in (1, 2, 31, 32, 33, 64, 65, 128, 129, 256, 257, 512)] + [
    pytest.param(M.THREAD_MIN_PAIRS - 1, W, "warp", id=f"few_pairs_W{W}")
    for W in (1, 16, 32, 33)])
def test_design_choice(pairs, W, want):
    """csrc/myers.cu's design by launch shape: the thread design for many
    pairs at W <= 32 words (the COI block), the warp design for the rest
    (every rRNA launch)."""
    assert M.choose_design(pairs, W) == want


def test_myers_cuda_rejects_unknown_design():
    """The forcing keyword takes the two designs only, and the launch
    counter has one key per entry point and design."""
    rng = np.random.default_rng(9)
    pc, pl = _pack(_seqs(rng, 3, 5, 60))
    up = M._upload(pc, pl, pc, pl, 3, 3, "cpu")
    with pytest.raises(ValueError):
        M.myers_cuda(*up, "NW", design="block")
    assert set(M.LAUNCHES.snapshot()) == {
        "dense_thread", "dense_warp", "pairs_thread", "pairs_warp"}


def _peq_case():
    rng = np.random.default_rng(12)
    pc, pl = _pack(_seqs(rng, 3, 20, 60))
    return pc, pl, M._upload(pc, pl, pc, pl, 3, 3, "cpu")


@pytest.mark.parametrize("bad", ["two_channels", "n_and_base", "channel_5",
                                 "channel_7"])
def test_myers_rejects_peq_row_outside_one_channel(bad):
    """A Peq row set in two of the channels 0..4, or any bit in the
    channels 5..7, which the kernel's designs would read differently, is
    rejected on the host, as numpy and as a CPU tensor."""
    pc, pl, up = _peq_case()
    peq = up[0].clone()
    c0 = int(pc[0, 0])                     # row 0 of pattern 0 sits here
    ch = {"two_channels": (c0 + 1) % 4, "n_and_base": 4 if c0 < 4 else 0,
          "channel_5": 5, "channel_7": 7}[bad]
    peq[0, ch] |= 1
    with pytest.raises(ValueError, match="channel"):
        M.check_peq(peq.numpy())
    with pytest.raises(ValueError, match="channel"):
        M.myers_tiles(peq, *up[1:], "NW")


def test_myers_rejects_text_codes_of_8():
    """A text code of 8 (which the warp design would read as 0) is
    rejected where the texts are packed and by myers_tiles; the pad codes
    5..7 are taken."""
    pc, pl, up = _peq_case()
    texts = pc.copy()
    texts[1, 3] = 8
    with pytest.raises(ValueError, match="code 8"):
        M._upload(pc, pl, texts, pl, 3, 3, "cpu")
    with pytest.raises(ValueError, match="code 8"):
        M.distances(pc, pl, texts, pl, "NW", device="cpu")
    tt = up[2].clone()
    tt[3, 1] = 8
    with pytest.raises(ValueError, match="code 8"):
        M.myers_tiles(up[0], up[1], tt, up[3], "HW")
    for pad in (5, 6, 7):
        tt[3, 1] = pad
        M.myers_tiles(up[0], up[1], tt, up[3], "HW")


def test_pipeline_inputs_pass_the_checks():
    """What the pipeline packs passes both checks: build_peq_packed over
    every byte value as a pattern code (codes >= 5 land in no channel),
    encoded reads with N and IUPAC letters, and the sorter's and 05a's
    packing (pad 4, pattern pad m = 1)."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 256, (5, 200)).astype(np.uint8)
    M.check_peq(M.build_peq_packed(codes, np.array([200, 150, 1, 64, 63]),
                                   7))
    from tpu_orc_torch.cluster.scoring import pack_codes
    from tpu_orc_torch.io import encode as port_encode
    reads = [port_encode.encode_codes(s) for s in
             _seqs(rng, 9, 1, 300, alphabet="ACGTNRYKM",
                   p=(.2, .2, .2, .2, .08, .03, .03, .03, .03))]
    packed, lens = pack_codes(reads)
    d, p = M.distances(packed, lens, packed, lens, "HW", device="cpu")
    assert d.shape == (9, 9) and (np.diag(d) == 0).all()


# ---------------------------------------------------------------------------
# tpu_orc/align/myers.py's public API: n_words, build_peq, myers_tile,
# similarity_matrix (exact: integers, and rounded floats compared by ==)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [0, 1, 31, 32, 33, 64, 65, 500, 3584])
def test_n_words_equals_reference(max_len):
    assert M.n_words(max_len) == ref_myers.n_words(max_len)


def _build_peq_case(rng, P, M_, W, lens):
    codes = rng.integers(0, 5, size=(P, M_)).astype(np.uint8)
    codes[0, :3] = 4                      # N in the pattern
    m_lens = None if lens is None else rng.integers(
        1, lens + 1, size=P).astype(np.int32)
    return codes, m_lens


@pytest.mark.parametrize("P, M_, W, lens", [
    (5, 45, 2, None),        # width not a multiple of 32, no m_lens
    (6, 45, 2, 45),          # m_lens masking
    (4, 70, 3, 70),          # a pattern longer than one word
    (3, 100, 2, 64),         # codes past the words (cut at W * 32)
    (7, 32, 1, 32),          # exactly one word
])
def test_build_peq_equals_reference(P, M_, W, lens):
    rng = np.random.default_rng(P * 100 + M_)
    codes, m_lens = _build_peq_case(rng, P, M_, W, lens)
    want = np.asarray(ref_myers.build_peq(
        codes, W, None if m_lens is None else m_lens)).astype(np.int64)
    got = M.build_peq(torch.from_numpy(codes), W,
                      None if m_lens is None else torch.from_numpy(m_lens))
    assert got.shape == (P, W, 6) and got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[:, :, 5].any() and want[:, :, 4].any()


def _tile_case(seed, P, T, lo, hi):
    """Patterns and texts (with N, pad 4 past each text) as tpu_orc's
    myers_tile takes them."""
    rng = np.random.default_rng(seed)
    pats = _seqs(rng, P, lo, hi)
    texts = _related(rng, T // 2, hi, 0.1) + _seqs(rng, T - T // 2, 1, hi + 20)
    pc, pl = _pack(pats)
    tc, tl = _pack(texts)
    return pc, pl, tc, tl


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("P, T, lo, hi", [
    (9, 13, 1, 30),          # one word, W not a multiple of 32 columns
    (6, 10, 40, 75),         # patterns over one word (W 3)
])
def test_myers_tile_equals_reference(mode, P, T, lo, hi):
    import jax.numpy as jnp
    pc, pl, tc, tl = _tile_case(P * 7 + hi, P, T, lo, hi)
    W = ref_myers.n_words(pc.shape[1])
    ref_peq = ref_myers.build_peq(jnp.asarray(pc), W, jnp.asarray(pl))
    wd, wp = ref_myers.myers_tile(ref_peq, jnp.asarray(pl), jnp.asarray(tc),
                                  jnp.asarray(tl), mode, W)
    peq = M.build_peq(torch.from_numpy(pc), W, torch.from_numpy(pl))
    gd, gp = M.myers_tile(peq, torch.from_numpy(pl), torch.from_numpy(tc),
                          torch.from_numpy(tl), mode, W)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    # int32 bits of the same words give the same answer
    bits = M.myers_tile(peq.to(torch.int32), torch.from_numpy(pl),
                        torch.from_numpy(tc), torch.from_numpy(tl), mode)
    assert torch.equal(bits[0], gd) and torch.equal(bits[1], gp)
    # and so does the packed layout through myers_tiles
    up = M._upload(pc, pl, tc, tl, P, T, "cpu")
    pd, pp = M.myers_tiles(*up, mode)
    assert torch.equal(pd, gd) and torch.equal(pp, gp)


def test_similarity_matrix_equals_reference():
    rng = np.random.default_rng(12)
    m_lens = np.array([400, 2000, 8, 1, 333], np.int32)
    n_lens = np.array([400, 2000, 7, 250, 1000, 1], np.int32)
    dist = rng.integers(0, 9, size=(5, 6)).astype(np.int32)
    dist[0, 0] = 1       # 1 - 1/400 = 0.9975: a half-way tie
    dist[1, 1] = 1       # 1 - 1/2000 = 0.9995: another
    dist[4, 4] = 5       # 1 - 5/1000 = 0.995: exact at 3 digits
    want = ref_myers.similarity_matrix(dist, m_lens, n_lens)
    got = M.similarity_matrix(dist, m_lens, n_lens)
    assert got.dtype == want.dtype == np.float64
    assert (got == want).all()
    assert got[0, 0] == np.round(0.9975, 3) and got[1, 1] == np.round(0.9995, 3)
