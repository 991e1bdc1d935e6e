"""tpu_orc_torch locate (align/locate.py) against tpu_orc on the CPU.

The port's plain version of the locate kernel must equal, bit for bit,
the Pallas wavefront kernel run in interpret mode (all eight outputs, in
FRONT/BACK/INFIX), the Python oracle, the XLA ``batched_locate`` on a
bank of adapters longer than the Pallas tables hold, and the cutadapt
vector files. Tolerance: none (integer equality). Inputs are made with
numpy from fixed seeds; interpret-mode cases stay at <= 256 reads and
L <= 384.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_orc.align import pallas_locate as ref_pl
from tpu_orc.align.batched import batched_locate
from tpu_orc.align.oracle import locate as oracle_locate
from tpu_orc.align.spec import BACK, FRONT
from tpu_orc.demux import adapters as ref_adapters
from tpu_orc.demux import reorient as ref_reorient
from tpu_orc.io import encode
from tpu_orc_torch import synthetic
from tpu_orc_torch.align import locate as L
from tpu_orc_torch.align.tables import make_k_table, make_n_prefix
from tpu_orc_torch.demux import reorient as port_reorient
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.demux.demux import assign_reads
from tpu_orc_torch.demux.primer_clean import PrimerPair, linked_trim
from tpu_orc.io.fastq import Record

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

FLAGS = {"front": FRONT, "back": BACK, "infix": L.INFIX}
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _seq(rng, n, alphabet="ACGT", p=None):
    return "".join(rng.choice(list(alphabet), size=n, p=p))


def _bank_arrays(refs):
    A, M = len(refs), max(len(r) for r in refs)
    masks = np.zeros((A, M), np.uint8)
    lens = np.zeros(A, np.int32)
    for i, r in enumerate(refs):
        m = encode.encode_ref_masks(r)
        masks[i, :len(m)] = m
        lens[i] = len(m)
    return masks, lens


def _reference_wf(tabs, masks, lens, mode):
    """tpu_orc's Pallas wavefront kernel in interpret mode -> [8, A, B]."""
    B0, Lr = masks.shape
    B = -(-B0 // ref_pl.TB) * ref_pl.TB
    rt = np.zeros((Lr, B), np.int32)
    rt[:, :B0] = masks.T
    ln = np.zeros((1, B), np.int32)
    ln[0, :B0] = lens
    out = ref_pl.locate_tiles(*tabs.arrays(), jnp.asarray(rt), jnp.asarray(ln),
                              mode, tabs.Ap, Lr, True, impl="wf", As=tabs.A)
    return np.stack([np.asarray(x)[:, :B0] for x in out])


def _port(tabs_port, masks, lens, mode):
    rt = torch.from_numpy(np.ascontiguousarray(masks.T, np.uint8))
    return L.locate_tiles(tabs_port.tensors("cpu"), rt,
                          torch.from_numpy(lens.astype(np.int32)), mode,
                          tabs_port.A).numpy()


@pytest.mark.parametrize("mode", ["front", "back", "infix"])
@pytest.mark.parametrize("e", [0.0, 0.1, 0.2])
@pytest.mark.parametrize("iupac_reads", [False, True],
                         ids=["literal", "iupac"])
def test_locate_plain_equals_pallas_wf(mode, e, iupac_reads):
    """All 8 outputs of the plain version == the Pallas wf kernel, with
    N wildcards in the adapters and (iupac) wildcard codes in the reads
    (the --match-read-wildcards encoder)."""
    rng = np.random.default_rng(100 + int(e * 10) + 7 * iupac_reads)
    pn = [0.23, 0.23, 0.23, 0.23, 0.08]
    refs = [_seq(rng, int(rng.integers(3, 30)), "ACGTN", pn)
            for _ in range(6)]
    alpha = "ACGTNRY" if iupac_reads else "ACGTN"
    pr = [0.22, 0.22, 0.22, 0.22, 0.04, 0.04, 0.04] if iupac_reads else pn
    reads = [_seq(rng, int(rng.integers(0, 120)), alpha, pr)
             for _ in range(200)]
    # plant adapters so that hits, partial hits and ties occur
    for k in range(0, 200, 3):
        a = refs[k % 6]
        cut = int(rng.integers(0, len(a)))
        reads[k] = (reads[k][:40] + (a if k % 2 else a[cut:])
                    + reads[k][40:80])
    enc = (encode.encode_read_masks_iupac if iupac_reads
           else encode.encode_read_masks)
    masks, lens = encode.pack_batch(reads, max_len=128, pad_multiple=1,
                                    encoder=enc, pad_value=0)
    bm, bl = _bank_arrays(refs)
    kt, npf = make_k_table(e, bm, bl), make_n_prefix(bm)
    ref_tabs = ref_pl.BankTables(bm, bl, kt, npf, mode == "front", 3)
    port_tabs = L.BankTables(bm, bl, kt, npf, mode == "front", 3)
    for name in ("ref", "kbyrs", "kfin", "mrow", "kconst"):
        np.testing.assert_array_equal(getattr(port_tabs, name),
                                      getattr(ref_tabs, name))
    want = _reference_wf(ref_tabs, masks, lens, mode)
    got = _port(port_tabs, masks, lens, mode)
    assert got.shape == want.shape
    for k, field in enumerate(("matches", "errors", "origin", "qstop",
                               "valid", "refstop", "nloc", "nacc")):
        np.testing.assert_array_equal(got[k], want[k], err_msg=field)


@pytest.mark.parametrize("mode", ["front", "back", "infix"])
def test_locate_result_equals_oracle(mode):
    """LocateResult of the port (refstart/refstop/querystart/querystop/
    matches/errors) == tpu_orc.align.oracle.locate per (read, adapter)."""
    rng = np.random.default_rng(7)
    refs = [_seq(rng, int(rng.integers(4, 14)), "ACGTN",
                 [0.24, 0.24, 0.24, 0.24, 0.04]) for _ in range(5)]
    reads = [_seq(rng, int(rng.integers(0, 40))) for _ in range(24)]
    bm, bl = _bank_arrays(refs)
    masks, lens = encode.pack_batch(reads, pad_multiple=16,
                                    encoder=encode.encode_read_masks,
                                    pad_value=0)
    for e in (0.0, 0.1, 0.2):
        res = L.locate_masks(bm, bl, make_k_table(e, bm, bl),
                             make_n_prefix(bm), masks, lens, FLAGS[mode],
                             device="cpu")
        for b, read in enumerate(reads):
            for a, r in enumerate(refs):
                want = oracle_locate(r, read, e, FLAGS[mode], 3)
                assert bool(res.valid[b, a]) == (want is not None), (b, a)
                if want is None:
                    continue
                got = (int(res.refstart[b, a]), int(res.refstop[b, a]),
                       int(res.querystart[b, a]), int(res.querystop[b, a]),
                       int(res.matches[b, a]), int(res.errors[b, a]))
                assert got == want.astuple(), (b, a, e)


@pytest.mark.parametrize("mode", ["front", "back"])
def test_locate_long_bank_equals_batched_locate(mode):
    """A bank of 70-90 bp adapters (beyond the Pallas tables' 62 bp):
    the port's locate == tpu_orc's XLA batched_locate on all 9 fields."""
    rng = np.random.default_rng(11)
    refs = [_seq(rng, int(rng.integers(70, 91))) for _ in range(3)]
    reads = []
    for k in range(40):
        a = list(refs[k % 3])
        for _ in range(int(rng.integers(0, 6))):
            a[int(rng.integers(0, len(a)))] = str(rng.choice(list("ACGT")))
        body = "".join(a)
        if k % 4 == 3:
            body = body[:int(rng.integers(10, 60))]
        reads.append(_seq(rng, int(rng.integers(0, 30))) + body
                     + _seq(rng, int(rng.integers(0, 30))))
    bm, bl = _bank_arrays(refs)
    kt, npf = make_k_table(0.1, bm, bl), make_n_prefix(bm)
    masks, lens = encode.pack_batch(reads, max_len=160, pad_multiple=1,
                                    encoder=encode.encode_read_masks,
                                    pad_value=0)
    want = batched_locate(bm, bl, kt, npf, masks, lens, int(FLAGS[mode]), 3)
    got = L.locate_masks(bm, bl, kt, npf, masks, lens, FLAGS[mode],
                         device="cpu")
    assert int(np.asarray(want.valid).sum()) > 20
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_bank_tables_equal_reference(tmp_path):
    """The port's BankTables of the synthetic SP5 (FRONT) and SP27-rc
    (BACK) banks and of the reorient primer bank with its custom k
    (INFIX) equal tpu_orc's, element for element; tables_from_reference
    carries the reference's tables over unchanged."""
    d = synthetic.write_adapter_dir(str(tmp_path))
    cases = []
    for fa, mode in (("M13_amplicon_indices_forward.fa", "front"),
                     ("M13_amplicon_indices_reverse_rc.fa", "back")):
        cases.append((AdapterBank.from_fasta(os.path.join(d, fa), 0.1, "cpu"),
                      ref_adapters.AdapterBank.from_fasta(
                          os.path.join(d, fa), 0.1), mode))
    pf = os.path.join(d, "M13_seqs_for_pychopper.fa")
    port_rb, _ = port_reorient.build_primer_bank(pf, 0.8, "cpu")
    ref_rb, _ = ref_reorient.build_primer_bank(pf, 0.8)
    np.testing.assert_array_equal(port_rb.k_table, ref_rb.k_table)
    cases.append((port_rb, ref_rb, "infix"))
    for port_bank, ref_bank, mode in cases:
        pt = L.tables_for_bank(port_bank, mode, 3)
        rt = ref_pl.tables_for_bank(ref_bank, mode, 3)
        carried = L.tables_from_reference(rt)
        assert (pt.A, pt.Ap, pt.M) == (rt.A, rt.Ap, rt.M)
        for name in ("ref", "kbyrs", "kfin", "mrow", "kconst"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name), err_msg=name)
            np.testing.assert_array_equal(getattr(carried, name),
                                          getattr(rt, name), err_msg=name)


def test_locate_rejects_unported_flags():
    bm, bl = _bank_arrays(["ACGTACGT"])
    masks, lens = encode.pack_batch(["ACGTACGTAA"], pad_multiple=1,
                                    encoder=encode.encode_read_masks,
                                    pad_value=0)
    with pytest.raises(NotImplementedError):
        L.locate_masks(bm, bl, make_k_table(0.1, bm, bl),
                       make_n_prefix(bm), masks, lens, 2,  # SUFFIX
                       device="cpu")


def _vector_cases(kind):
    out = []
    for fname in ("cutadapt_vectors.json", "cutadapt_grid.json",
                  "cutadapt_doc_vectors.json"):
        with open(os.path.join(FIX, fname)) as fh:
            data = json.load(fh)
        out += [pytest.param(c, id=f"{fname.split('.')[0]}-{c['name']}")
                for c in data.get(kind, [])]
    return out


# one read repeated past NATIVE_SMALL_READS, so the cases run through the
# port's locate and not through the native small-batch shortcut
COPIES = 17


@pytest.mark.parametrize("case", _vector_cases("cases"))
def test_cutadapt_vector_through_port_locate(case):
    bank = AdapterBank([n for n, _ in case["adapters"]],
                       [s for _, s in case["adapters"]], case["e"], "cpu")
    enc = (encode.encode_read_masks_iupac if case.get("read_wildcards")
           else encode.encode_read_masks)
    recs = [Record(f"v{k}", f"v{k}", case["read"], None)
            for k in range(COPIES)]
    got = assign_reads(recs, bank, case["mode"], rc=case["rc"],
                       min_overlap=case["min_overlap"], encoder=enc)
    exp = case["expect"]
    for a in got:
        assert a.adapter == exp["adapter"], case["name"]
        assert a.rc == exp["rc"], case["name"]
        assert a.trimmed.seq == exp["trimmed"], case["name"]


@pytest.mark.parametrize("case", _vector_cases("linked_cases"))
def test_cutadapt_linked_vector_through_port_locate(case):
    pair = PrimerPair("A", case["fwd"], case["rev"])
    recs = [Record(f"v{k}", f"v{k}", case["read"], None)
            for k in range(COPIES)]
    trimmed, untrimmed = linked_trim(recs, [pair], e=case["e"],
                                      device="cpu")
    exp = case["expect"]
    if exp["untrimmed"]:
        assert not trimmed and len(untrimmed) == COPIES, case["name"]
        assert all(u.seq == case["read"] for u in untrimmed)
    else:
        assert len(trimmed) == COPIES and not untrimmed, case["name"]
        assert all(t.seq == exp["trimmed"] for t in trimmed), case["name"]
