"""tpu_orc_torch stage 05a (``rrna/``) against tpu_orc on the CPU.

* ``dd_prefix`` (the D->D prefix sums S) equals XLA's ``jnp.cumsum`` bit
  for bit on every profile used here and on random ones up to 3,399
  nodes, so a JAX whose summation order changes fails here;
* ``viterbi_plain`` equals ``_viterbi_kernel`` (XLA on the CPU) bit for
  bit in score, end position and end node, on the default block profiles
  and their reverses, the three models of ``fixtures/euk_rrna.hmm`` and
  the three p7 filters of ``fixtures/euk_rrna.cm``, with N and pad codes
  and an empty sequence; ``viterbi_host`` is the reference's
  (``distances_with_pos``, the other device call of 05a, is held against
  the XLA Myers in ``test_torch_myers.py``);
* the finders give equal hits field by field, and stage 05a
  (``stage_rrna``) and the ``rrna`` subcommand write byte-identical
  directories in default, exemplar, HMMER3 and .cm modes;
* stage 05a's spans (``rrna.extract`` and under it ``rrna.model``,
  ``.pack``, ``.viterbi``, ``.hits``, ``.write``) and counters
  (``rrna.contigs``, ``rrna.hits``, ``viterbi.cells_launched``,
  ``viterbi.launches/<design>/K<K>``) inside ``recording()``, nothing
  outside it, and the same files either way.

Tolerance: none, except where the float64 host Viterbi is compared with a
float32 scan (2e-2, the reference's own). Inputs are made with numpy from
fixed seeds.
"""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_orc.cli import main as ref_cli
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record, write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc.rrna import anchors as ref_anchors
from tpu_orc.rrna import cm as ref_cm
from tpu_orc.rrna import extract as ref_extract
from tpu_orc.rrna import hmm as ref_hmm
from tpu_orc.rrna import profiles as ref_profiles
from tpu_orc_torch import cli as port_cli
from tpu_orc_torch import synthetic
from tpu_orc_torch.io.fastq import Record as PortRecord
from tpu_orc_torch.pipeline import stages as port_stages
from tpu_orc_torch.rrna import anchors, extract, hmm, profiles

from test_rrna_accuracy import make_rdna_contig
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
HMM = os.path.join(FIX, "euk_rrna.hmm")
CM = os.path.join(FIX, "euk_rrna.cm")
with open(os.path.join(FIX, "euk_rrna_consensus.json")) as _fh:
    CONS = json.load(_fh)

MODEL_NAMES = ["euk_18S_core", "euk_28S_core", "euk_18S_core_rev",
               "euk_28S_core_rev", "hmm:18S_rRNA", "hmm:5_8S_rRNA",
               "hmm:28S_rRNA", "cm:SSU_rRNA_eukarya", "cm:5_8S_rRNA",
               "cm:LSU_rRNA_eukarya"]


@functools.lru_cache(maxsize=None)
def ref_profile(name):
    """A tpu_orc ProfileHMM by name: the default block profiles and their
    reverses, the HMMER3 fixture's models ('hmm:'), the .cm fixture's p7
    filters ('cm:'), or 'random<K>' (random tables, DD partly -1e9)."""
    if name.startswith("random"):
        K = int(name[6:])
        rng = np.random.default_rng(K)
        t = rng.normal(-2.0, 1.0, (K, 7))
        t[rng.random(K) < 0.1, 6] = -1e9
        return ref_hmm.ProfileHMM(name, rng.normal(0.0, 1.0, (K, 4)), t)
    if name.startswith("hmm:"):
        return {m.name: m for m in ref_hmm.parse_hmmer3(HMM)}[name[4:]]
    if name.startswith("cm:"):
        return {m.name: m for m in ref_cm.parse_cm(CM)}[name[3:]]
    prof = {p.name: p for p in ref_profiles.default_euk_profiles().values()}
    if name.endswith("_rev"):
        return ref_profiles._reverse_profile(prof[name[:-4]])
    return prof[name]


def fields(hits):
    """{gene: [hit as a tuple]} of either package's RRNAHit lists."""
    return {g: [(h.gene, h.contig_id, h.start, h.end, h.strand, h.score,
                 h.seq) for h in v] for g, v in hits.items()}


def port_records(recs):
    return [PortRecord(r.id, r.desc, r.seq, r.qual) for r in recs]


def rdna_records(seed, n=4):
    """Noisy full-length rDNA contigs (every other one reverse-
    complemented), a 28S-only contig and a random one."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        c, _, _ = make_rdna_contig(rng, 0.05)
        recs.append(Record(f"c{i}", f"c{i}",
                           encode.revcomp(c) if i % 2 else c))
    c, e18, _ = make_rdna_contig(rng, 0.05)
    recs.append(Record("lsu", "lsu", c[e18 + 400:]))
    recs.append(Record("junk", "junk",
                       "".join(rng.choice(list("ACGT"), size=1500))))
    return recs


def fixture_records(seed):
    """Contigs carrying the HMM fixture's 18S and 28S consensus with a few
    substitutions, on both strands, and a random contig."""
    rng = np.random.default_rng(seed)
    pad = lambda n: "".join(rng.choice(list("ACGT"), size=n))

    def noisy(s, k):
        s = list(s)
        for p in rng.choice(len(s), k, replace=False):
            s[int(p)] = "ACGT"[int(rng.integers(4))]
        return "".join(s)

    plus = (pad(60) + noisy(CONS["18S_rRNA"], 4) + pad(90)
            + noisy(CONS["28S_rRNA"], 4) + pad(70))
    return [Record("p", "p", plus), Record("m", "m", encode.revcomp(plus)),
            Record("x", "x", pad(len(plus)))]


# ---------------------------------------------------------------------------
# the Viterbi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODEL_NAMES + ["random39", "random300",
                                                "random1799", "random3399"])
def test_dd_prefix_equals_jax_cumsum(name):
    p = ref_profile(name)
    dd = jnp.maximum(jnp.asarray(p.t)[:, 6], ref_hmm.DD_FLOOR)
    want = np.asarray(jnp.concatenate([jnp.zeros(1), jnp.cumsum(dd[:-1])]))
    got = hmm.dd_prefix(p.t)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _scan_inputs(p, seed):
    """6 sequences x 640 codes: the model's consensus (mutated) planted
    in random flanks, N codes, pad 4 past each length, one empty."""
    rng = np.random.default_rng(seed)
    cons = np.argmax(p.match_scores, axis=1).astype(np.uint8)
    seqs = rng.integers(0, 4, (6, 640)).astype(np.uint8)
    lens = np.array([640, 600, 0, 17, 512, 333], np.int32)
    for b in (0, 1, 4, 5):
        c = cons.copy()
        sub = rng.random(len(c)) < 0.05
        c[sub] = rng.integers(0, 4, int(sub.sum()))
        c = c[:lens[b] - 40]
        seqs[b, 30:30 + len(c)] = c
    seqs[rng.random(seqs.shape) < 0.02] = 4      # N
    for b, n in enumerate(lens):
        seqs[b, n:] = 4                          # pad
    return seqs, lens


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_viterbi_plain_equals_xla(name):
    p = ref_profile(name)
    seqs, lens = _scan_inputs(p, 5)
    want = ref_hmm.viterbi_scan(p, seqs, lens)
    got = hmm.viterbi_scan(hmm.profile_from_reference(p), seqs, lens,
                           device="cpu")
    assert want[0][0] > 30 and want[0][2] == ref_hmm.NEG
    for g, w, what in zip(got, want, ("score", "pos", "node")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=what)


@pytest.mark.parametrize("K, want", [
    (1, "warp"), (32, "warp"), (33, "warp"), (74, "warp"), (75, "warp"),
    (96, "warp"), (97, "warp"), (512, "warp"), (513, "block"),
    (1800, "block"), (hmm.MAX_NODES, "block")])
def test_viterbi_design_choice(K, want):
    """csrc/viterbi.cu's design by profile length: one warp per sequence up
    to 512 nodes (16 on each lane; the default profiles have 74 and 75),
    one block per sequence above (HMMER3 profiles up to MAX_NODES)."""
    assert hmm.choose_viterbi_design(K) == want


def test_viterbi_cuda_rejects_unknown_design():
    """The forcing keyword takes the two designs only, the warp design
    stops at 512 nodes, and the launch counter has one key per design."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(x) for x in (
        rng.normal(size=(600, 4)).astype(np.float32),
        rng.normal(size=(600, 7)).astype(np.float32),
        np.zeros(600, np.float32), np.zeros((2, 5), np.uint8),
        np.array([5, 3], np.int32))]
    with pytest.raises(ValueError):
        hmm.viterbi_cuda(*args, design="thread")
    with pytest.raises(ValueError):
        hmm.viterbi_cuda(*args, design="warp")
    assert set(hmm.LAUNCHES.snapshot()) == {"scan_warp", "scan_block"}


def test_viterbi_host_parity():
    """The reference's position-dependent-DD model with deletion runs
    (test_rrna.py): the port's scan equals XLA's bit for bit and
    tpu_orc's float64 host Viterbi within 2e-2 (its own tolerance), end
    position and node exactly; the port's viterbi_host is the
    reference's."""
    rng = np.random.default_rng(0)
    K = 48
    motif = rng.integers(0, 4, size=K)
    match = np.full((K, 4), np.log(0.05 / 3 / 0.25))
    match[np.arange(K), motif] = np.log(0.95 / 0.25)
    t = np.zeros((K, 7))
    for i, (lo, hi) in enumerate(((0.90, 0.98), (0.005, 0.03), (0.005, 0.06),
                                  (0.5, 0.8), (0.2, 0.5), (0.6, 0.95),
                                  (0.05, 0.7))):
        t[:, i] = np.log(rng.uniform(lo, hi, K))
    t[-1, 2] = t[-1, 6] = -1e9
    ref = ref_hmm.ProfileHMM("dd_test", match, t)
    port = hmm.profile_from_reference(ref)
    seqs = np.full((6, 96), 4, np.uint8)
    lens = np.zeros(6, np.int32)
    for b in range(6):
        s = list(motif)
        if b % 2:
            d0 = int(rng.integers(5, K - 12))
            del s[d0:d0 + 5]
        full = (list(rng.integers(0, 4, int(rng.integers(0, 12)))) + s
                + list(rng.integers(0, 4, int(rng.integers(0, 12)))))[:96]
        seqs[b, :len(full)] = full
        lens[b] = len(full)
    score, pos, node = hmm.viterbi_scan(port, seqs, lens, device="cpu")
    want = ref_hmm.viterbi_scan(ref, seqs, lens)
    np.testing.assert_array_equal(score.view(np.int32),
                                  want[0].view(np.int32))
    for b in range(6):
        hs, hp, hn = hmm.viterbi_host(port, seqs[b, :lens[b]])
        assert (hs, hp, hn) == ref_hmm.viterbi_host(ref, seqs[b, :lens[b]])
        assert abs(score[b] - hs) < 2e-2, (b, score[b], hs)
        assert (pos[b], node[b]) == (hp, hn)


def test_profile_from_seqs_equals_reference():
    rng = np.random.default_rng(11)
    gene = rng.integers(0, 4, 400).astype(np.uint8)
    examples = []
    for _ in range(6):
        g = gene.copy()
        sub = rng.random(400) < 0.03
        g[sub] = rng.integers(0, 4, int(sub.sum()))
        examples.append(g)
    want = ref_hmm.profile_from_seqs(examples, "18S")
    got = hmm.profile_from_seqs(examples, "18S", device="cpu")
    np.testing.assert_array_equal(got.match_scores, want.match_scores)
    np.testing.assert_array_equal(got.t, want.t)


# ---------------------------------------------------------------------------
# the finders and stage 05a
# ---------------------------------------------------------------------------

def test_default_and_anchor_finders_equal_reference():
    recs = rdna_records(21)
    want = ref_profiles.find_rrna_default(recs)
    got = profiles.find_rrna_default(port_records(recs), device="cpu")
    assert len(want["18S"]) >= 4 and len(want["28S"]) >= 5
    assert fields(got) == fields(want)
    want = ref_anchors.find_rrna_by_anchors(recs)
    got = anchors.find_rrna_by_anchors(port_records(recs), device="cpu")
    assert len(want["18S"]) >= 3
    assert fields(got) == fields(want)


def test_profile_and_exemplar_finders_equal_reference():
    recs = fixture_records(4)
    models = {m.name: m for m in ref_hmm.parse_hmmer3(HMM)}
    for gene in ("18S", "28S"):
        m = models[f"{gene}_rRNA"]
        want = ref_extract.find_gene_profile(recs, m, gene, 40.0)
        got = extract.find_gene_profile(port_records(recs),
                                        hmm.profile_from_reference(m), gene,
                                        40.0, device="cpu")
        assert len(want) == 2
        assert fields({gene: got}) == fields({gene: want})
        ex = [CONS[f"{gene}_rRNA"]]
        want = ref_extract.find_gene_exemplar(recs, ex, gene, 0.7)
        got = extract.find_gene_exemplar(port_records(recs), ex, gene, 0.7,
                                         device="cpu")
        assert len(want) == 2
        assert fields({gene: got}) == fields({gene: want})


@pytest.mark.parametrize("mode", ["default", "exemplar", "hmm", "cm"])
def test_stage_rrna_tree_equals_reference(tmp_path, mode):
    """stage_rrna of both packages on one cleaned FASTA: the rRNA_genes/
    directories (the 18S/28S FASTAs and barrnap_outs/ GFF3 + combined
    FASTA) are byte-identical."""
    recs = rdna_records(8, n=2) + fixture_records(9)
    fa = str(tmp_path / "cleaned.fasta")
    write_records(fa, recs, fmt="fasta")
    kw = {}
    if mode == "exemplar":
        for gene in ("18S", "28S"):
            ex = str(tmp_path / f"ex{gene}.fa")
            write_records(ex, [Record(gene, gene, CONS[f"{gene}_rRNA"])],
                          fmt="fasta")
            kw[f"rrna_exemplars_{gene.lower()}"] = ex
    elif mode in ("hmm", "cm"):
        kw[f"rrna_{mode}"] = HMM if mode == "hmm" else CM
    want = ref_stages.stage_rrna(fa, str(tmp_path / "ref"), "BC01",
                                 ref_stages.PipelineConfig(**kw))
    got = port_stages.stage_rrna(fa, str(tmp_path / "port"), "BC01",
                                 port_stages.PipelineConfig(
                                     str(tmp_path), device="cpu", **kw))
    assert want["18S"] and want["28S"]
    assert fields(got) == fields(want)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_cli_rrna_equals_reference(tmp_path, capsys):
    fa = str(tmp_path / "in.fasta")
    write_records(fa, fixture_records(12), fmt="fasta")
    ref_cli(["rrna", fa, "-o", str(tmp_path / "ref"), "-b", "B1", "--cm", CM])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_cli.main(["rrna", fa, "-o", str(tmp_path / "port"), "-b",
                          "B1", "--cm", CM, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want == {"18S": 2, "28S": 2}
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_make_rrna_plate_is_seeded_rdna():
    """The smoke plate's reads: seeded, 3.2-3.6 kb rDNA templates between
    the RNA primers, two templates in the enlarged bin."""
    a, planted = synthetic.make_rrna_plate(3, n5=2, n27=2, seed=4,
                                           enlarged=(1, 0), enlarged_reads=4)
    b, _ = synthetic.make_rrna_plate(3, n5=2, n27=2, seed=4,
                                     enlarged=(1, 0), enlarged_reads=4)
    assert [(r.id, r.seq) for r in a] == [(r.id, r.seq) for r in b]
    assert len(a) == 3 * 3 + 4
    assert [len(v) for v in planted.values()] == [1, 1, 2, 1]
    for ins in planted.values():
        for t in ins:
            assert 3150 <= len(t) <= 3700
            assert ref_anchors.ANCHOR_18S_END in t


# ---------------------------------------------------------------------------
# stage 05a's spans and counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["hmm", "cm"])
def test_stage_rrna_spans_and_counters(tmp_path, mode):
    """stage_rrna in profile mode inside ``recording()``: every 05a span
    nests under ``rrna.extract`` (one a call); ``rrna.contigs`` counts
    the contigs read, ``rrna.hits`` the hits, ``viterbi.cells_launched``
    B x padded L x K over the forward and reversed scan of each gene, and
    ``viterbi.launches/plain/K<K>`` those scans; a recorded and an
    unrecorded run write byte-identical directories."""
    from tpu_orc_torch.utils.profiling import recording
    recs = rdna_records(8, n=2) + fixture_records(9)
    fa = str(tmp_path / "cleaned.fasta")
    write_records(fa, recs, fmt="fasta")
    cfg = port_stages.PipelineConfig(str(tmp_path), device="cpu",
                                     **{f"rrna_{mode}": HMM if mode == "hmm"
                                        else CM})
    plain = port_stages.stage_rrna(fa, str(tmp_path / "plain"), "BC01", cfg)
    with recording() as rec:
        got = port_stages.stage_rrna(fa, str(tmp_path / "rec"), "BC01", cfg)
    assert fields(got) == fields(plain) and got["18S"] and got["28S"]
    assert_same_tree(str(tmp_path / "rec"), str(tmp_path / "plain"))
    spans = rec.spans()
    assert spans["rrna.extract"]["n"] == 1
    assert spans["rrna.extract"]["parent"] is None
    for name, n in (("rrna.model", 1), ("rrna.pack", 4), ("rrna.viterbi", 4),
                    ("rrna.hits", 2), ("rrna.write", 3)):
        assert spans[name]["parent"] == "rrna.extract", name
        assert spans[name]["n"] == n, name
    inner = sum(spans[n]["total_s"] for n in spans if n != "rrna.extract")
    assert inner <= spans["rrna.extract"]["total_s"]
    c = rec.counters()
    if mode == "hmm":
        models = {m.name: m for m in hmm.parse_hmmer3(HMM)}
        Ks = [models[f"{g}_rRNA"].K for g in ("18S", "28S")]
    else:
        from tpu_orc_torch.rrna.cm import parse_cm, profiles_by_gene
        bygene = profiles_by_gene(parse_cm(CM))
        Ks = [bygene[g].K for g in ("18S", "28S")]
    L = -(-max(len(r.seq) for r in recs) // 128) * 128
    assert c["rrna.contigs"] == len(recs)
    assert c["rrna.hits"] == len(got["18S"]) + len(got["28S"])
    assert c["viterbi.cells_launched"] == sum(2 * 2 * len(recs) * L * K
                                              for K in Ks)
    for K in set(Ks):
        assert c[f"viterbi.launches/plain/K{K}"] == 2 * Ks.count(K)
    assert not any(k.startswith("viterbi.launches/") and "/plain/" not in k
                   for k in c)


def test_stage_rrna_records_nothing_outside_recording(tmp_path):
    """Outside ``recording()`` the 05a spans are the shared null context
    and its counters are dropped: a recorder opened afterwards starts
    empty."""
    from tpu_orc_torch.utils import profiling
    from tpu_orc_torch.utils.profiling import recording
    fa = str(tmp_path / "in.fasta")
    write_records(fa, fixture_records(12), fmt="fasta")
    cfg = port_stages.PipelineConfig(str(tmp_path), device="cpu",
                                     rrna_hmm=HMM)
    assert profiling.span("rrna.extract") is profiling._NULL
    port_stages.stage_rrna(fa, str(tmp_path / "a"), "B1", cfg)
    with recording() as rec:
        pass
    assert rec.spans() == {} and rec.counters() == {}
