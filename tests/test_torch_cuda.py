"""tpu_orc_torch CUDA kernels against their plain PyTorch versions, on the
card.

Every test is marked ``cuda`` and skips where there is no CUDA device
(the kernels have no CPU mode). This file imports no JAX, so it runs on
the GPU host, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) Tolerance: none,
the outputs are integers, and the Viterbi's float32 scores are compared
bit for bit. Inputs come from fixed seeds.
"""
import os
import random

import numpy as np
import pytest
import torch

from tpu_orc_torch import synthetic
from tpu_orc_torch.align import batched as BL
from tpu_orc_torch.align import locate as L
from tpu_orc_torch.align import myers as M
from tpu_orc_torch.align import pileup as P
from tpu_orc_torch.align.spec import BACK
from tpu_orc_torch.demux import fused
from tpu_orc_torch.demux import demux as D
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.io import encode
from tpu_orc_torch.rrna import hmm as H
from tpu_orc_torch.align import pack as PK
from tpu_orc_torch.align.locate import INFIX

from pack_cases import CASES as PACK_CASES, ENCODERS as PACK_ENCODERS
from pack_cases import TABLES as PACK_TABLES
from pack_cases import batch as pack_batch, pychopper_reads

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


def _locate_case(rng, max_ref, min_overlap, mode):
    """Tables of 7 adapters up to ``max_ref`` bp and 700 reads with
    planted (partial) adapters, N codes and empty reads, on the card."""
    refs = _seqs(rng, 7, 3, max_ref)
    bank = AdapterBank([f"a{k}" for k in range(7)], refs, 0.2, "cpu")
    tabs = L.BankTables(bank.masks, bank.lens, bank.k_table, bank.n_prefix,
                        mode == "front", min_overlap)
    reads = _seqs(rng, 700, 0, 300)
    for k in range(0, 700, 5):
        a = refs[k % 7]
        reads[k] = reads[k][:50] + a[int(rng.integers(0, len(a))):]
    for k in range(3, 700, 101):
        reads[k] = ""
    masks, lens = synthetic.read_masks(reads, 320)
    rt = torch.from_numpy(np.ascontiguousarray(masks.T)).cuda()
    return tabs.tensors("cuda"), rt, torch.from_numpy(lens).cuda(), lens


@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_locate_ks_kernel_equals_plain(cuda, mode):
    """The Kogge-Stone kernel: all 8 outputs equal locate_plain_ks, at 64
    rows and at 128 (adapters up to 120 bp), min_overlap 0 and 3; one
    counted launch per call."""
    rng = np.random.default_rng(31)
    for max_ref, mo in ((60, 0), (60, 3), (121, 0), (121, 3)):
        tt, rt, ln, _ = _locate_case(rng, max_ref, mo, mode)
        before = L.LAUNCHES.snapshot()[f"ks_{mode}"]
        got = L.locate_tiles(tt, rt, ln, mode, 7, impl="ks")
        want = L.locate_plain_ks(tt, rt, ln, mode, 7)
        torch.cuda.synchronize()
        assert L.LAUNCHES.snapshot()[f"ks_{mode}"] == before + 1
        assert int(want[4].sum()) > 20
        assert torch.equal(got, want), (max_ref, mo)



@pytest.mark.parametrize("L_cols", [4096, 8192])
def test_locate_ks_infix_pychopper_long_reads(cuda, tmp_path, L_cols):
    """Stage 01's scan: the KS kernel in INFIX mode with the pychopper
    bank (four 59 bp primers with N17, the budget floor((1 - q) len)) at
    L 4,096 and 8,192, reads fused in both orientations, a span masked
    by X, empty reads: all 8 outputs, nloc and nacc included, equal
    locate_plain_ks, at a strict and a lenient q."""
    from tpu_orc_torch.demux.reorient import build_primer_bank
    d = synthetic.write_adapter_dir(str(tmp_path / "ad"))
    b = synthetic.banks(5)
    rnd = random.Random(L_cols)
    unit = lambda k: (b["sp5"][k % 12][1]
                      + "".join(rnd.choice("ACGT")
                                for _ in range(L_cols // 2 - 200))
                      + b["sp27rc"][k % 8][1])
    reads = []
    for k in range(48):
        s = unit(k) + (unit(k + 1) if k % 3 == 0 else
                       encode.revcomp(unit(k + 1)) if k % 3 == 1 else "")
        if k % 5 == 0:
            s = s[:30] + "X" * 59 + s[89:]
        reads.append(s[:L_cols])
    masks, lens = synthetic.read_masks(reads, L_cols)
    lens[::11] = 0
    rt = torch.from_numpy(np.ascontiguousarray(masks.T)).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    for q in (0.9, 0.7):
        bank = build_primer_bank(os.path.join(d, synthetic.FILES[2]), q,
                                 "cuda")[0]
        tt = L.tables_for_bank(bank, "infix", 3).tensors(cuda)
        got = L.locate_tiles(tt, rt, ln, "infix", 4, impl="ks")
        want = L.locate_plain_ks(tt, rt, ln, "infix", 4)
        torch.cuda.synchronize()
        assert int(want[4].sum()) > 48 and int(want[6].max()) > 1
        assert torch.equal(got, want), q

@pytest.mark.parametrize("case", PACK_CASES)
@pytest.mark.parametrize("L_cols", [128, 4096, 8192])
@pytest.mark.parametrize("table", sorted(PACK_TABLES))
def test_pack_kernel_equals_plain(cuda, table, L_cols, case):
    """csrc/pack.cu against pack_masks_plain on the same reads: empty
    reads, reads of exactly L, X, N, IUPAC codes and lower case."""
    seqs = pack_batch(case, L_cols)
    tab = PACK_TABLES[table][0]
    before = PK.LAUNCHES.snapshot()["pack"]
    got, glens = PK.pack_reads_T(seqs, L_cols, tab, cuda)
    want, wlens = PK.pack_reads_T(seqs, L_cols, tab, "cpu")
    torch.cuda.synchronize()
    assert PK.LAUNCHES.snapshot()["pack"] == before + 1
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.cpu(), want) and torch.equal(glens.cpu(), wlens)


@pytest.mark.parametrize("B", [2048, 2047])
@pytest.mark.parametrize("table", sorted(PACK_TABLES))
def test_pack_kernel_scan_batch(cuda, table, B):
    """A stage-01 scan batch at L 8,192: reads of 3.4-3.9 kb, 3% of them
    fused to ~7.5 kb, N in some, a few empty; B even and odd. The
    counters count one device pack and the bytes uploaded."""
    from tpu_orc_torch.utils.profiling import recording
    rng = np.random.default_rng(B)
    lens = rng.integers(3400, 3900, size=B)
    lens[rng.random(B) < 0.03] = 7500
    lens[::331] = 0
    abc = np.frombuffer(b"ACGTN", np.uint8)
    raw = abc[rng.choice(5, size=int(lens.sum()),
                         p=[.245, .245, .245, .245, .02])].tobytes()
    cut = np.concatenate([[0], np.cumsum(lens)])
    seqs = [raw[cut[k]:cut[k + 1]].decode() for k in range(B)]
    tab = PACK_TABLES[table][0]
    with recording() as rec:
        got, _ = PK.pack_reads_T(seqs, 8192, tab, cuda)
    want = PACK_TABLES[table][1](*encode.ascii_matrix(seqs, max_len=8192)).T
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    counters = rec.counters()
    assert counters["locate.device_packs"] == 1
    assert counters["locate.pack_h2d_bytes"] == int(lens.sum()) + 12 * B


@pytest.mark.parametrize("encoder", ["read", "iupac"])
def test_locate_batch_lazy_packs_on_card(cuda, tmp_path, monkeypatch,
                                         encoder):
    """locate_batch_lazy on a CUDA pychopper bank (the device pack) equals
    the host-packed route to the same KS kernel, on all eight
    LocateResult fields, at L 8,192 with fused reads; one device pack a
    batch and the launches keep their shape."""
    from tpu_orc_torch.demux.reorient import build_primer_bank
    from tpu_orc_torch.utils.profiling import recording
    monkeypatch.setattr(L, "LOCATE_IMPL", "ks")
    d = synthetic.write_adapter_dir(str(tmp_path))
    bank = build_primer_bank(os.path.join(d, synthetic.FILES[2]), 0.9,
                             "cuda")[0]
    enc = PACK_ENCODERS[encoder]
    seqs = pychopper_reads(301, seed=3, insert=(3300, 3700))
    Lc = encode.bucket_len(max(map(len, seqs)))
    with recording() as rec:
        got = D.locate_batch_collect(
            D.locate_batch_lazy(bank, seqs, INFIX, 3, enc))
    masks = PACK_TABLES[encoder][1](*encode.ascii_matrix(seqs, max_len=Lc))
    want = L.locate_collect(*L.locate_dispatch(
        L.tables_for_bank(bank, "infix", 3), masks,
        [len(s) for s in seqs], "infix", cuda))
    assert Lc == 8192
    c = rec.counters()
    assert c["locate.device_packs"] == 1
    assert c[f"locate.launches/ks/infix/L{Lc}/A4/R64"] == 1
    assert int(want.valid.sum()) > 301 and int(want.nloc.max()) > 1
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


EMIT_CASES = ("cuts/0", "cuts/1", "cuts/2", "long/3", "long/4", "block")


def _emit_case(case, tmp_path):
    """(seqs, quals, ids, read, s0, s1, neg, seg_no) of one emit case:
    ``reorient_cases.cut_table`` over short reads or over 300 reads of up
    to 8 kb, or the segment plan of ``Reorienter.run`` (CPU) over a block
    of ``reorient_cases``' raw stream."""
    from reorient_cases import cut_table, records, write_primers
    from tpu_orc_torch.demux import reorient as R
    kind, _, seed = case.partition("/")
    if kind == "cuts":
        return cut_table(int(seed))
    if kind == "long":
        return cut_table(int(seed), reads=300, max_len=8192)
    cfg, _, recs = records(35, 90)
    pf = write_primers(str(tmp_path / "primers.fa"))
    p = R.Reorienter(pf, cfg["orientation_config"], R.ReorientConfig(
        q=0.8, min_len=420, device="cpu")).run(recs).plan
    return (p.work, [r.qual for r in p.kept], [r.id for r in p.kept], p.ci,
            p.s0, p.s1, p.neg, p.seg_no)


@pytest.mark.parametrize("case", EMIT_CASES)
def test_emit_kernel_equals_plain(cuda, tmp_path, case):
    """csrc/emit.cu against emit_plain on the same segment cuts: the same
    bytes and offsets; one launch, its copies counted."""
    from tpu_orc_torch.demux import emit as E
    from tpu_orc_torch.utils.profiling import recording
    args = _emit_case(case, tmp_path)
    before = E.LAUNCHES.snapshot()["emit"]
    with recording() as rec:
        got, goffs = E.Emitter(cuda)(*args)
    want, woffs = E.Emitter("cpu")(*args)
    assert E.LAUNCHES.snapshot()["emit"] == before + 1
    np.testing.assert_array_equal(goffs, woffs)
    assert bytes(got) == bytes(want) and len(want) == woffs[-1] > 0
    c = rec.counters()
    assert c["reorient.device_emits"] == 1
    assert c["reorient.emit_records"] == len(args[3])
    assert c["reorient.emit_d2h_bytes"] == len(want)
    assert c["reorient.emit_h2d_bytes"] > len(want) // 2


def test_emit_kernel_runs_and_boundaries(cuda):
    """One run of records cut at every offset around the kernel's 16-byte
    chunks and 8-record runs: 1-40 byte slices from every alignment of
    the buffer, both signs, the last slice at the buffer's end (where
    the aligned loads would leave it)."""
    from tpu_orc_torch.demux import emit as E
    rnd = np.random.default_rng(5)
    seq = "".join(rnd.choice(list("ACGTN"), size=997))
    qual = "".join(chr(33 + int(x)) for x in rnd.integers(0, 40, size=997))
    cuts = [(a, a + n, bool(k % 2), k % 3)
            for k, (a, n) in enumerate((a, n) for n in range(0, 41, 3)
                                       for a in range(0, 33))]
    cuts.append((997 - 40, 997, True, 0))
    cuts.append((997 - 17, 997, False, 1))
    read = np.zeros(len(cuts), np.int64)
    s0, s1, neg, seg = (np.array(x) for x in zip(*cuts))
    args = ([seq], [qual], ["r"], read, s0, s1, neg, seg)
    got, _ = E.Emitter(cuda)(*args)
    want, _ = E.Emitter("cpu")(*args)
    assert bytes(got) == bytes(want)


def test_locate_ks_kernel_equals_wf_kernel(cuda):
    """The two kernels agree in every mode at min_overlap 3; at 0 they
    differ only in BACK, on the empty reads (the two Pallas kernels'
    contracts)."""
    rng = np.random.default_rng(32)
    for mode in ("front", "back", "infix"):
        for max_ref, mo in ((60, 3), (121, 3), (60, 0)):
            tt, rt, ln, lens = _locate_case(rng, max_ref, mo, mode)
            ks = L.locate_cuda_ks(tt, rt, ln, mode, 7)
            wf = L.locate_cuda(tt, rt, ln, mode, 7)
            torch.cuda.synchronize()
            differ = (ks != wf).any(0).any(0).nonzero().flatten().cpu()
            if mode == "back" and mo == 0:
                np.testing.assert_array_equal(differ.numpy(),
                                              np.flatnonzero(lens == 0))
            else:
                assert differ.numel() == 0, (mode, max_ref, mo)


def test_viterbi_kernel_equals_plain(cuda):
    """Score bits, end position and end node, for profiles of 40 to 4,096
    nodes (every node-per-thread instantiation of the block design, the
    warp design up to 512), N and pad codes, an empty and a one-code
    sequence; one counted launch per call, of the chosen design."""
    rng = np.random.default_rng(33)
    seqs = rng.integers(0, 5, (6, 1200)).astype(np.uint8)
    lens = np.array([1200, 1000, 0, 1, 700, 1199], np.int32)
    for K in (40, 300, 600, 1100, 2100, 4096):
        cons = rng.integers(0, 4, K)
        match = rng.normal(-1.0, 0.5, (K, 4))
        match[np.arange(K), cons] = 1.2
        t = rng.normal(-2.0, 0.7, (K, 7))
        t[rng.random(K) < 0.05, 6] = -1e9
        s = seqs.copy()
        s[0, 100:100 + min(K, 1000)] = cons[:1000]
        for b, n in enumerate(lens):
            s[b, n:] = 4
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
        args = (put(match.astype(np.float32)), put(t.astype(np.float32)),
                put(H.dd_prefix(t)), put(s), put(lens))
        key = f"scan_{H.choose_viterbi_design(K)}"
        before = H.LAUNCHES.snapshot()[key]
        got = H.viterbi_tiles(*args)
        want = H.viterbi_plain(*args)
        torch.cuda.synchronize()
        assert H.LAUNCHES.snapshot()[key] == before + 1
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), K
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def viterbi_case(K, kind, device):
    """(match, trans, S, seqs, lens) tensors on ``device``: a profile of K
    nodes and 8 sequences of 0, 1, 31, 33, 64, 97, 500 and 1,000 codes
    with N, a code above 4 and pad. ``kind``: "rand" (a random profile
    with a planted consensus and some impossible D->D), "tie" (constant
    emissions and transitions: every cell ties) or "blocks" (a consensus
    of blocks of 5 nodes and no M->M: the best ties at every position,
    first reached at a node in a later lane)."""
    rng = np.random.default_rng(1000 + K)
    lens = np.array([0, 1, 31, 33, 64, 97, 500, 1000], np.int32)
    seqs = rng.integers(0, 4, (8, 1003)).astype(np.uint8)
    seqs[rng.random(seqs.shape) < 0.03] = 4
    seqs[6, 7] = 200
    if kind == "rand":
        cons = rng.integers(0, 4, K)
        match = rng.normal(-1.0, 0.5, (K, 4))
        match[np.arange(K), cons] = 1.2
        t = rng.normal(-2.0, 0.7, (K, 7))
        t[rng.random(K) < 0.05, 6] = -1e9
        seqs[7, 100:100 + min(K, 800)] = cons[:800]
    elif kind == "tie":
        match, t = np.full((K, 4), 0.5), np.full((K, 7), -1.0)
    else:
        cons = (np.arange(K) // 5) % 4
        match = np.where(cons[:, None] == np.arange(4)[None, :], 1.0, -1.0)
        t = np.full((K, 7), -2.0)
        t[:, 0] = -1e9
        seqs[:, 0] = 3
    for b, n in enumerate(lens):
        seqs[b, n:] = 4
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (put(match.astype(np.float32)), put(t.astype(np.float32)),
            put(H.dd_prefix(t)), put(seqs), put(lens))


@pytest.mark.parametrize("K", [1, 32, 33, 74, 96, 97, 512, 513])
def test_viterbi_designs_at_lane_boundaries(cuda, K):
    """Both designs (the warp design up to 512 nodes) equal viterbi_plain
    and each other, bit for bit in score, end position and end node, at
    node counts on each side of the warp design's nodes-per-lane steps,
    on random, all-tie and block-tie profiles; one counted launch per
    call, under its design."""
    bits = lambda x: x.view(torch.int32)
    for kind in ("rand", "tie", "blocks"):
        args = viterbi_case(K, kind, cuda)
        want = H.viterbi_plain(*args)
        for design in H.DESIGNS:
            if design == "warp" and K > H.MAX_WARP_NODES:
                continue
            before = H.LAUNCHES.snapshot()[f"scan_{design}"]
            got = H.viterbi_cuda(*args, design=design)
            torch.cuda.synchronize()
            assert H.LAUNCHES.snapshot()[f"scan_{design}"] == before + 1
            assert torch.equal(bits(got[0]), bits(want[0])), (kind, design)
            assert torch.equal(got[1], want[1]), (kind, design)
            assert torch.equal(got[2], want[2]), (kind, design)


def locate_boundary_case(kind, mode, min_overlap, device, n_reads=120,
                         lengths=(0, 1, 31, 32, 33, 63, 64, 65, 97, 301, 0)):
    """(tables, reads_T, lens, A) for the locate kernels' lane
    boundaries. ``kind`` names the adapters: "m15" .. "m64" (one adapter
    of that length beside a 10 bp one; rows m / K on each side of a lane
    edge), "r128" (64, 90 and 127 bp: R 128), "repeated" (three equal 30
    bp adapters of a repeated motif and its 20 bp prefix: ties between
    adapters, columns and rows) or "pair" (a 32 bp and a 10 bp adapter,
    and reads 4 and 5, which share a warp of the 16-lane design, of 0 and
    3,584 codes, the adapter at the long one's end). ``n_reads`` reads:
    the last ones of the codes ``lengths`` gives, the others of random
    lengths, N in them, (partial) adapters planted at their ends and
    inside."""
    rng = np.random.default_rng(sum(map(ord, kind + mode)) + min_overlap)
    if kind == "repeated":
        refs = ["ACGTTGCAAC" * 3] * 3 + ["ACGTTGCAAC" * 2]
    elif kind == "r128":
        refs = _seqs(rng, 1, 64, 65) + _seqs(rng, 1, 90, 91) \
            + _seqs(rng, 1, 127, 128)
    else:
        n = 32 if kind == "pair" else int(kind[1:])
        refs = _seqs(rng, 1, n, n + 1) + _seqs(rng, 1, 10, 11)
    bank = AdapterBank([f"a{k}" for k in range(len(refs))], refs, 0.2, "cpu")
    tabs = L.BankTables(bank.masks, bank.lens, bank.k_table, bank.n_prefix,
                        mode == "front", min_overlap)
    reads = _seqs(rng, n_reads, 0, 330)
    for k in range(0, n_reads, 2):
        a = refs[k % len(refs)]
        cut = int(rng.integers(0, len(a)))
        reads[k] = (a[cut:] + reads[k] if k % 4 else reads[k] + a[:len(a)
                                                                   - cut])
    for k in range(1, n_reads, 6):
        a = refs[k % len(refs)]
        reads[k] = reads[k][:40] + a + reads[k][40:80]
    for k, n in enumerate(lengths):
        reads[n_reads - 1 - k] = (reads[k] * 2)[:n].ljust(n, "A")
    L_max = 333
    if kind == "pair":
        L_max = 3584
        reads[4] = ""
        reads[5] = _seqs(rng, 1, L_max - 32, L_max - 31)[0] + refs[0]
    masks, lens = synthetic.read_masks(reads, L_max)
    rt = torch.from_numpy(np.ascontiguousarray(masks.T)).to(device)
    return tabs.tensors(device), rt, torch.from_numpy(lens).to(device), \
        len(refs)


@pytest.mark.parametrize("kind", ["m31", "m32", "m63", "m64", "r128",
                                  "repeated"])
@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_locate_wavefront_at_lane_boundaries(cuda, kind, mode):
    """The wavefront kernel equals locate_plain in all 8 outputs at
    adapter lengths on each side of a lane edge, at R 128, with tied
    adapters, at min_overlap 0 (BACK: the empty reads, whose cell (0, 0)
    the wavefront never evaluates) and 3, and at read lengths around the
    32-column blocks of its byte loads; one counted launch per call."""
    for mo in (0, 3):
        tt, rt, ln, A = locate_boundary_case(kind, mode, mo, cuda)
        before = L.LAUNCHES.snapshot()[mode]
        got = L.locate_tiles(tt, rt, ln, mode, A, impl="wf")
        want = L.locate_plain(tt, rt, ln, mode, A)
        torch.cuda.synchronize()
        assert L.LAUNCHES.snapshot()[mode] == before + 1
        assert int(want[4].sum()) > 10, (kind, mo)
        assert torch.equal(got, want), (kind, mo)


@pytest.mark.parametrize("kind", ["m15", "m16", "m17", "m31", "m32", "m33",
                                  "r128", "repeated", "pair"])
@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_locate_ks_at_half_warp_boundaries(cuda, kind, mode):
    """The KS kernel (``locate_tiles(impl="ks")``) and both of its designs
    (16 and 32 lanes an alignment) equal locate_plain_ks in all 8
    outputs at adapter lengths on each side of the 16-lane design's lane
    edges (K 4 at R 64) and of its half-warp edge, at R 128 (K 8), with
    tied adapters, on 127 reads (the last warp's second half has none),
    at read lengths around its 16-column byte blocks, with a 0-column and
    a 3,584-column read in one warp, and at min_overlap 0 (BACK: the empty
    reads' row 0 counts) and 3; one counted launch per call."""
    lengths = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 97, 301, 0)
    for mo in (0, 3):
        tt, rt, ln, A = locate_boundary_case(kind, mode, mo, cuda, 127,
                                             lengths)
        want = L.locate_plain_ks(tt, rt, ln, mode, A)
        assert int(want[4].sum()) > 10, (kind, mo)
        for lanes in (None, *L.KS_LANES):
            before = L.LAUNCHES.snapshot()[f"ks_{mode}"]
            if lanes is None:
                got = L.locate_tiles(tt, rt, ln, mode, A, impl="ks")
            else:
                got = L.locate_cuda_ks(tt, rt, ln, mode, A, lanes=lanes)
            torch.cuda.synchronize()
            assert L.LAUNCHES.snapshot()[f"ks_{mode}"] == before + 1
            assert torch.equal(got, want), (kind, mo, lanes)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_myers_kernel_equals_plain(cuda, mode):
    """Dense and listed-tile entry points in both designs; patterns from 1
    to 1,100 bp (1 to 35 words)."""
    rng = np.random.default_rng(6)
    base = "".join(rng.choice(list("ACGT"), size=480))
    seqs = [synthetic.mutate(random.Random(k), base, 0.08)
            for k in range(96)] + _seqs(rng, 32, 1, 1100)
    W = -(-max(len(s) for s in seqs) // 32) * 32
    pc, pl = synthetic.codes(seqs, W)
    up = M._upload(pc, pl, pc, pl, 128, 128, cuda)
    pd, pp = M.myers_plain(*up, mode)
    ti = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda)
    tj = torch.zeros(3, dtype=torch.int32, device=cuda)
    for design in M.DESIGNS:
        kd, kp = M.myers_cuda(*up, mode, design=design)
        qd, qp = M.myers_cuda(*up, mode, ti, tj, 32, 128, design=design)
        torch.cuda.synchronize()
        assert torch.equal(kd, pd) and torch.equal(kp, pp), design
        for t in (0, 2, 3):
            rows = slice(32 * t, 32 * (t + 1))
            assert torch.equal(qd[rows], pd[rows]), design
            assert torch.equal(qp[rows], pp[rows]), design


def _myers_width_case(rng, W, ncols, device):
    """13 patterns at width W words (lengths W*32, W*32 - 1, off the word
    edges and short ones, N in them) and 29 texts of up to ``ncols``
    codes (an empty and a 1-code text, N, and pad code 5 inside three
    texts), padded to 16 x 64 as the wrappers pad (patterns m = 1, texts
    code 5 and n = 1)."""
    top = W * 32
    lens = sorted({min(m, top) for m in (top, top - 1, top - 13, top - 39,
                                         top // 2 + 3, 1, 5, 31, 32, 33)
                   if m >= 1})
    lens += [int(rng.integers(1, top + 1)) for _ in range(13 - len(lens))]
    pats = ["".join(rng.choice(list("ACGTN"), size=m, p=[.24] * 4 + [.04]))
            for m in lens]
    tl = [0, 1] + [int(rng.integers(2, ncols + 1)) for _ in range(27)]
    texts = ["".join(rng.choice(list("ACGTN"), size=n, p=[.23] * 4 + [.08]))
             for n in tl]
    pc, pl = synthetic.codes(pats, top)
    tc, tl = synthetic.codes(texts, ncols)
    up = M._upload(pc, pl, tc, tl, 16, 64, device)
    for t in (3, 7, 11):                   # pad code inside a text
        up[2][int(tl[t]) // 2, t] = 5
    return up


@pytest.mark.parametrize("W", [1, 2, 31, 32, 33, 64, 65, 112, 128, 129,
                               512])
def test_myers_designs_at_lane_boundaries(cuda, W):
    """Both designs equal myers_plain and each other in NW, SHW and HW, on
    both entry points, at widths on each side of the warp design's
    words-per-lane steps (32, 64, 128 words) and at 512 (texts of 64
    codes there, to keep the plain version cheap); one counted launch per
    call, under its entry point and design."""
    rng = np.random.default_rng(40 + W)
    up = _myers_width_case(rng, W, 64 if W == 512 else 100, cuda)
    ti = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)
    tj = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    mask = torch.zeros((16, 64), dtype=torch.bool, device=cuda)
    mask[0:8, 0:32] = mask[8:16, 32:64] = mask[8:16, 0:32] = True
    for mode in ("NW", "SHW", "HW"):
        want = M.myers_plain(*up, mode)
        got = {}
        for design in M.DESIGNS:
            before = M.LAUNCHES.snapshot()
            dense = M.myers_cuda(*up, mode, design=design)
            pairs = M.myers_cuda(*up, mode, ti, tj, 8, 32, design=design)
            torch.cuda.synchronize()
            after = M.LAUNCHES.snapshot()
            assert after[f"dense_{design}"] == before[f"dense_{design}"] + 1
            assert after[f"pairs_{design}"] == before[f"pairs_{design}"] + 1
            for g, w, q in zip(dense, want, pairs):
                assert torch.equal(g, w), (mode, design)
                assert torch.equal(q[mask], w[mask]), (mode, design)
            got[design] = dense
        for a, b in zip(got["thread"], got["warp"]):
            assert torch.equal(a, b), mode


def test_myers_tiles_launches_the_chosen_design(cuda):
    """myers_tiles on CUDA tensors launches the design that choose_design
    names for the launch's shape."""
    rng = np.random.default_rng(41)
    up = _myers_width_case(rng, 112, 100, cuda)
    before = M.LAUNCHES.snapshot()
    M.myers_tiles(*up, "NW")
    torch.cuda.synchronize()
    key = f"dense_{M.choose_design(16 * 64, 112)}"
    assert M.LAUNCHES.snapshot()[key] == before[key] + 1


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_myers_tile_on_cuda_equals_the_oracle(cuda, mode):
    """``myers_tile`` (tpu_orc's [P, W, 6] Peq and [T, N] texts) on CUDA
    tensors: the distances of the Python oracle on every pair, and the
    distances and positions of ``myers_tiles`` on the packed layout; one
    dense launch."""
    from tpu_orc_torch.align import oracle
    rng = np.random.default_rng(43)
    pats = _seqs(rng, 5, 20, 80)
    texts = _seqs(rng, 7, 1, 120)
    texts[2] = "AC" + pats[1] + "GT"
    pc, pl = synthetic.codes(pats, 96)
    tc, tl = synthetic.codes(texts, 128)
    W = M.n_words(pc.shape[1])
    peq = M.build_peq(torch.from_numpy(pc).to(cuda), W,
                      torch.from_numpy(pl).to(cuda))
    args = [torch.from_numpy(x).to(cuda) for x in (pl, tc, tl)]
    before = sum(M.LAUNCHES.snapshot().values())
    dist, pos = M.myers_tile(peq, args[0], args[1], args[2], mode, W)
    torch.cuda.synchronize()
    assert sum(M.LAUNCHES.snapshot().values()) == before + 1
    d = dist.cpu().numpy()
    for i, p in enumerate(pats):
        for j, t in enumerate(texts):
            assert d[i, j] == oracle.edit_distance(p, t, mode), (i, j)
    up = M._upload(pc, pl, tc, tl, len(pats), len(texts), cuda)
    pd, pp = M.myers_tiles(*up, mode)
    torch.cuda.synchronize()
    assert torch.equal(pd, dist) and torch.equal(pp, pos)


PILEUP_CASES = {
    "single": [(500, 100)],
    "multi": [(40, 3), (500, 50), (1700, 9), (260, 1), (33, 20), (100, 8)],
    "single_w107": [(3400, 6)],
    "single_1_word": [(20, 9)],
    "multi_1_word_w107": [(20, 5), (3400, 3)],
}


@pytest.mark.parametrize("entry", list(PILEUP_CASES))
def test_pileup_kernel_equals_plain(cuda, entry):
    """Path bits on the region the traceback reads (read positions below
    each read's length, words below its draft's ceil(len / 32)): one
    500 bp draft, six groups with drafts of 33 to 1,700 bp (2 to 54
    words) and a 1-read group, a 3,400 bp draft (W 107, the rRNA bins'
    width), a 1-word draft alone and beside a W 107 group; N in drafts
    and reads; each call is one launch of its contract."""
    rng = np.random.default_rng(8)
    rnd = random.Random(8)
    specs = PILEUP_CASES[entry]
    entry = "single" if len(specs) == 1 else "multi"
    drafts, groups = [], []
    for L, R in specs:
        d = _seqs(rng, 1, L, L + 1)[0]
        drafts.append(encode.encode_codes(d))
        groups.append([encode.encode_codes(synthetic.mutate(rnd, d, 0.05))
                       for _ in range(R)])
    tensors, _ = P._upload(drafts, groups, cuda)
    before = P.LAUNCHES.snapshot()[entry]
    got = P.path_bits_cuda(*tensors)
    want = P.path_bits_plain(*tensors)
    torch.cuda.synchronize()
    assert P.LAUNCHES.snapshot()[entry] == before + 1
    peqs, dwords, tile_gid, texts, nl = tensors
    mask = P.specified(dwords, tile_gid, nl, got.shape[1],
                       got.shape[3]).expand_as(got)
    assert int(mask.sum()) > 0
    assert torch.equal(got[mask], want[mask])


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


BATCHED_FLAGS = [f for f in range(16) if not (f & 1 and f & 4)]


def _batched_case(rng, lo, hi):
    """A bank of 5 adapters of lo..hi bp (N wildcards included) and 300
    reads up to 400 bp: random, empty, and planted with prefixes and
    suffixes of the adapters."""
    refs = _seqs(rng, 5, lo, hi + 1, p=(.24, .24, .24, .24, .04))
    bank = AdapterBank([f"a{k}" for k in range(5)], refs, 0.1)
    reads = _seqs(rng, 300, 0, 120)
    for k in range(0, 300, 3):
        a = refs[k % 5]
        cut = int(rng.integers(1, len(a) + 1))
        reads[k] = (reads[k][:30] + a[:cut] if k % 2
                    else a[-cut:] + reads[k])[:400]
    reads[7] = reads[8] = ""
    masks, lens = synthetic.read_masks(reads, 400)
    return bank, masks, lens


def _batched_args(bank, masks, lens, device):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (bank.masks, bank.lens, bank.k_table, bank.n_prefix,
                      masks, lens)]


@pytest.mark.parametrize("flags", BATCHED_FLAGS)
def test_batched_kernel_equals_plain(cuda, flags, monkeypatch):
    """All 9 outputs at min_overlap 3 and 0, adapters of 3-60 and of
    250-300 bp (rows past 255), empty and N-bearing reads, in one launch
    and, where adapters take more than one band, in launches of 7 reads
    (the scratch bound set to 7 reads' handoff)."""
    rng = np.random.default_rng(40 + flags)
    for lo, hi in ((3, 60), (250, 300)):
        bank, masks, lens = _batched_case(rng, lo, hi)
        args = _batched_args(bank, masks, lens, cuda)
        L = masks.shape[1]
        k = BL.choose_k(int(bank.lens.max()))
        n_slots = int((BL.handoff_slots(bank.lens, k) >= 0).sum())
        for mo in (3, 0):
            want = BL.batched_locate_plain(*args, flags, mo)
            got = BL.batched_locate_cuda(*args, flags, mo)
            monkeypatch.setattr(BL, "SCRATCH_BYTES",
                                7 * n_slots * L * BL.HAND_BYTES)
            mode = BL.MODE_NAMES.get(flags, "other")
            before = BL.LAUNCHES.snapshot()[mode]
            chunked = BL.batched_locate_cuda(*args, flags, mo)
            n = BL.LAUNCHES.snapshot()[mode] - before
            monkeypatch.undo()
            torch.cuda.synchronize()
            assert n == (-(-300 // 7) if n_slots else 1), (lo, n)
            assert torch.equal(got, want), (lo, mo)
            assert torch.equal(chunked, want), (lo, mo)


def _band_bank(rng, lengths):
    refs = ["".join(rng.choice(list("ACGTN"), size=n,
                               p=[.24, .24, .24, .24, .04]))
            for n in lengths]
    return AdapterBank([f"a{k}" for k in range(len(refs))], refs, 0.1), refs


def _band_reads(rng, refs, n_reads, L):
    """n_reads reads (odd, so that a 16-lane warp has an empty half) of
    at most L bp: empty, 1 bp, shorter than the shortest adapter, one of
    exactly L bp, whole adapters with one substitution, random, and
    planted with mutated prefixes (at the read's end) and suffixes (at
    its start) of the adapters."""
    reads = _seqs(rng, n_reads, 0, min(L, 700) + 1, p=(.25, .25, .25, .25,
                                                        0))
    for k in range(n_reads):
        a = refs[k % len(refs)]
        cut = int(rng.integers(1, len(a) + 1))
        if k % 3 == 1:
            reads[k] = (reads[k][:40] + a[:cut])[:L]
        elif k % 3 == 2:
            reads[k] = (a[-cut:] + reads[k])[:L]
        if k % 6 in (1, 2):
            s = list(reads[k])
            for p in rng.integers(0, len(s), size=len(s) // 25 + 1):
                s[p] = "ACGT"[int(rng.integers(0, 4))]
            reads[k] = "".join(s)
    for k, a in enumerate(refs):         # whole adapters, one substitution
        p = int(rng.integers(0, len(a)))
        reads[12 + k] = a[:p] + "ACGT"[int(rng.integers(0, 4))] + a[p + 1:]
    reads[0], reads[3] = "", "G"
    reads[6] = reads[6][:max(1, min(len(r) for r in refs) - 2)]
    tail = refs[0][:200]
    reads[9] = (_seqs(rng, 1, L, L + 1, p=(.25, .25, .25, .25, 0))[0]
                [:L - len(tail)] + tail)
    return synthetic.read_masks(reads, L)


def _assert_kernel_equals_plain(args, flags):
    """The kernel, in one launch, against the plain version on all 9
    fields at min_overlap 3 and 0."""
    mode = BL.MODE_NAMES.get(flags, "other")
    for mo in (3, 0):
        want = BL.batched_locate_plain(*args, flags, mo)
        assert int(want[0].sum()) > 0, mo
        before = BL.LAUNCHES.snapshot()[mode]
        got = BL.batched_locate_cuda(*args, flags, mo)
        torch.cuda.synchronize()
        assert BL.LAUNCHES.snapshot()[mode] == before + 1
        if not torch.equal(got, want):
            bad = [BL.FIELDS[k] for k in range(9)
                   if not torch.equal(got[k], want[k])]
            raise AssertionError(f"min_overlap {mo}: {bad} differ")


#: banks that reach each kept rows a lane K (R = 16 K rows a band): one
#: band at R-2 and R-1 of every K (with the longest adapter the next
#: smaller K cannot hold), and the band edges of K 8, R-2 .. 2R+1
BAND_BANKS = {"k4": ((1, 2, 62, 63), 4, [1, 1, 1, 1]),
              "k5": ((63, 64, 78, 79), 5, [1, 1, 1, 1]),
              "k8": ((80, 126, 127), 8, [1, 1, 1]),
              "k8_edges": ((126, 127, 128, 129, 256, 257), 8,
                           [1, 1, 2, 2, 3, 3])}


@pytest.mark.parametrize("bank_id", sorted(BAND_BANKS))
@pytest.mark.parametrize("flags", BATCHED_FLAGS)
def test_batched_kernel_at_band_edges(cuda, flags, bank_id):
    """Adapter lengths that make the wrapper pick each kept K, one band
    at every K and R-2, R-1, R, R+1, 2R and 2R+1 at K 8: all 9 fields
    equal to plain on 37 reads with empty, 1 bp and short reads, at
    min_overlap 3 and 0."""
    lengths, k, bands = BAND_BANKS[bank_id]
    rng = np.random.default_rng(700 + 10 * flags + k + len(lengths))
    bank, refs = _band_bank(rng, lengths)
    assert BL.choose_k(max(lengths)) == k
    assert BL.n_bands(bank.lens, k).tolist() == bands
    masks, lens = _band_reads(rng, refs, 37, 2 * max(lengths) + 60)
    _assert_kernel_equals_plain(_batched_args(bank, masks, lens, cuda),
                                flags)


@pytest.mark.parametrize("flags", BATCHED_FLAGS)
def test_batched_kernel_long_adapters_and_reads(cuda, flags):
    """Adapters of 255, 256, 300 and 611 bp (two to five bands of 128
    rows) against 25 reads up to L 3,584, one of them 3,584 bp: all 9
    fields equal to plain."""
    rng = np.random.default_rng(900 + flags)
    bank, refs = _band_bank(rng, (255, 256, 300, 611))
    masks, lens = _band_reads(rng, refs, 25, 3584)
    assert int(lens.max()) == 3584 and int(lens.min()) == 0
    _assert_kernel_equals_plain(_batched_args(bank, masks, lens, cuda),
                                flags)


@pytest.mark.parametrize("flags", BATCHED_FLAGS)
def test_batched_kernel_small_banks(cuda, flags):
    """A bank of one 70 bp adapter and one of two adapters that take one
    and three bands, on 37 reads (odd B)."""
    rng = np.random.default_rng(1100 + flags)
    for lengths, k, bands in (((70,), 5, [1]), ((20, 261), 8, [1, 3])):
        bank, refs = _band_bank(rng, lengths)
        masks, lens = _band_reads(rng, refs, 37, 400)
        assert BL.choose_k(max(lengths)) == k
        assert BL.n_bands(bank.lens, k).tolist() == bands
        _assert_kernel_equals_plain(_batched_args(bank, masks, lens, cuda),
                                    flags)


def test_batched_locate_dispatches_cuda_to_kernel(cuda):
    rng = np.random.default_rng(3)
    bank, masks, lens = _batched_case(rng, 64, 80)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (bank.masks, bank.lens, bank.k_table, bank.n_prefix,
                      masks, lens)]
    before = BL.LAUNCHES.snapshot()
    fwd, rc = BL.batched_locate_with_rc(*args, int(BACK), 3)
    after = BL.LAUNCHES.snapshot()
    assert after["back"] == before["back"] + 1
    assert fwd.valid.device.type == "cuda"
    cpu = BL.batched_locate_with_rc(*(a.cpu() for a in args), int(BACK), 3)
    for g, w in zip((fwd, rc), cpu):
        assert all(torch.equal(x.cpu(), y) for x, y in zip(g, w))


def test_demux_routes_long_banks_to_batched_kernel(cuda):
    """A 70 bp bank takes the batched kernel on CUDA, with the CPU bank's
    assignments; the locate kernels stay idle."""
    recs, _ = synthetic.make_plate(6, n5=2, n27=2, seed=4, insert_len=150,
                                   head=11)
    b = synthetic.banks(head=11)
    got = {}
    for dev in ("cuda", "cpu"):
        sp5 = AdapterBank.from_pairs(b["sp5"], 0.1, dev)
        L.LAUNCHES.reset()
        BL.LAUNCHES.reset()
        got[dev] = D.assign_reads(recs, sp5, "front")
        if dev == "cuda":
            assert BL.LAUNCHES.snapshot()["front"] > 0
            assert not any(L.LAUNCHES.snapshot().values())
    assert [(a.adapter, a.rc, a.trimmed.seq, a.err) for a in got["cuda"]] \
        == [(a.adapter, a.rc, a.trimmed.seq, a.err) for a in got["cpu"]]


# ---------------------------------------------------------------------------
# the multi-device path: stripes per card
# ---------------------------------------------------------------------------

def _cards(cuda, at_least=1):
    """Every card, or cuda:0 listed twice on a one-card host (stripes run
    one after another there); skips below ``at_least`` cards."""
    n = torch.cuda.device_count()
    if n < at_least:
        pytest.skip(f"needs {at_least} CUDA devices, the host has {n}")
    return [f"cuda:{k}" for k in range(n)] if n > 1 else ["cuda:0"] * 2


def _launched_on(counter):
    return {d for d, n in counter.by_device().items() if any(n.values())}


def test_decide_multi_stripes_equal_decide(cuda, tmp_path):
    from tpu_orc_torch.dist.sharded import device_of
    d = synthetic.write_adapter_dir(str(tmp_path))
    sp5 = AdapterBank.from_fasta(
        os.path.join(d, synthetic.FILES[0]), 0.1, "cuda")
    sp27 = AdapterBank.from_fasta(
        os.path.join(d, synthetic.FILES[1]), 0.1, "cuda")
    recs, _ = synthetic.make_plate(10, seed=5, insert_len=200)
    masks, lens = synthetic.read_masks([r.seq for r in recs[:901]], 384)
    cards = _cards(cuda)
    fd = fused.FusedDemux(sp5, sp27)
    L.LAUNCHES.reset()
    got = fd.decide_multi(masks, lens, cards)
    assert _launched_on(L.LAUNCHES) == {str(device_of(c)) for c in cards}
    want = fd.decide(masks, lens)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_sharded_dual_demux_step_on_cards_equals_plain(cuda):
    """70 bp banks (the batched kernel's route) striped over the cards:
    the CPU plain version's ten outputs."""
    from tpu_orc_torch.dist import sharded as S
    b = synthetic.banks(head=11)
    sp5 = AdapterBank.from_pairs(b["sp5"], 0.1, "cuda")
    sp27 = AdapterBank.from_pairs(b["sp27rc"], 0.1, "cuda")
    recs, _ = synthetic.make_plate(4, seed=6, insert_len=150, head=11)
    masks, lens = synthetic.read_masks([r.seq for r in recs[:384]], 384)
    cards = _cards(cuda)
    BL.LAUNCHES.reset()
    got = S.sharded_dual_demux_step(S.make_mesh(devices=cards), sp5, sp27,
                                    masks, lens)
    assert _launched_on(BL.LAUNCHES) == {str(S.device_of(c)) for c in cards}
    want = S.sharded_dual_demux_step(S.make_mesh(devices=["cpu"]), sp5,
                                     sp27, masks, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(got[8].sum()) == 384 and (got[3] >= 0).sum() > 300


@pytest.mark.parametrize("gated", [False, True])
def test_device_parallel_pairwise_on_cards(cuda, gated):
    from tpu_orc_torch.dist import sharded as S
    rng = np.random.default_rng(7)
    pat = rng.integers(0, 4, (300, 520)).astype(np.uint8)
    plens = rng.integers(440, 521, 300).astype(np.int32)
    gate = (rng.random((300, 300)) < 0.05) if gated else None
    cards = _cards(cuda)
    M.LAUNCHES.reset()
    got = S.device_parallel_pairwise(cards, pat, plens, pat, plens,
                                     gate=gate)
    assert _launched_on(M.LAUNCHES) == {str(S.device_of(c)) for c in cards}
    want, _ = M.distances(pat, plens, pat, plens, device="cuda:0")
    sel = gate if gated else np.ones(want.shape, bool)
    np.testing.assert_array_equal(got[sel], want[sel])


def test_stripes_reach_cards_past_the_first(cuda):
    """On a host of two or more cards a stripe on cuda:1.. reads and
    writes that card's memory: each card's launches and results."""
    from tpu_orc_torch.dist import sharded as S
    cards = _cards(cuda, at_least=2)
    rng = np.random.default_rng(8)
    n = 16 * len(cards)               # two stripes of 8 rows a card
    pat = rng.integers(0, 4, (n, 200)).astype(np.uint8)
    plens = rng.integers(150, 201, n).astype(np.int32)
    M.LAUNCHES.reset()
    got = S.sharded_pairwise_step(S.make_mesh(devices=cards * 2), pat,
                                  plens, pat, plens)
    per = M.LAUNCHES.by_device()
    assert sorted(per) == sorted(cards)
    assert all(sum(per[c].values()) == 2 for c in cards)
    want, _ = M.distances(pat, plens, pat, plens, device="cpu")
    np.testing.assert_array_equal(got, want)
