"""tpu_orc_torch stages 06-09 (``pipeline/extractors.py``,
``pipeline/downstream.py``, ``analysis/{lca,phylo,anchors,reports,
figures}.py``) against tpu_orc's, function by function.

Each function of the copied modules runs on both sides on the inputs of
``tests/test_analysis.py``, ``tests/test_figures.py`` and
``tests/test_pipeline.py``; the returned values must be equal (records
and dataclasses field by field, paths relative to each side's output
folder) and every text file written (TSV, CSV, FASTA, Newick) byte for
byte. The figures are compared by the names of the files written (a
rendered image is not held to bytes). Tolerance: none.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import tpu_orc.analysis.anchors as ref_anchors
import tpu_orc.analysis.figures as ref_figures
import tpu_orc.analysis.lca as ref_lca
import tpu_orc.analysis.phylo as ref_phylo
import tpu_orc.analysis.reports as ref_reports
import tpu_orc.io.fastq as ref_fastq
import tpu_orc.pipeline.downstream as ref_down
import tpu_orc.pipeline.extractors as ref_ext
import tpu_orc_torch.analysis.anchors as port_anchors
import tpu_orc_torch.analysis.figures as port_figures
import tpu_orc_torch.analysis.lca as port_lca
import tpu_orc_torch.analysis.phylo as port_phylo
import tpu_orc_torch.analysis.reports as port_reports
import tpu_orc_torch.io.fastq as port_fastq
import tpu_orc_torch.pipeline.downstream as port_down
import tpu_orc_torch.pipeline.extractors as port_ext

from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

SIDES = {"port": (port_ext, port_down, port_lca, port_phylo, port_anchors,
                  port_reports, port_figures, port_fastq),
         "ref": (ref_ext, ref_down, ref_lca, ref_phylo, ref_anchors,
                 ref_reports, ref_figures, ref_fastq)}


def norm(x, root=None):
    """``x`` with records and dataclasses as field tuples, numpy values
    as Python values and ``root`` in paths as '<out>'."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dc", type(x).__name__,
                norm([getattr(x, f.name) for f in dataclasses.fields(x)],
                     root))
    if isinstance(x, dict):
        return {k: norm(v, root) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v, root) for v in x]
    if isinstance(x, np.ndarray):
        return norm(x.tolist(), root)
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, str) and root:
        return x.replace(str(root), "<out>")
    return x


def both(tmp_path, fn):
    """fn(side modules, out folder) on each side; the two results,
    normalised, must be equal and the two folders hold the same files.
    Returns the port's result."""
    got = {}
    for side, mods in SIDES.items():
        out = tmp_path / side
        out.mkdir(exist_ok=True)
        got[side] = (fn(*mods, out), out)
    (p, p_out), (r, r_out) = got["port"], got["ref"]
    assert norm(p, p_out) == norm(r, r_out)
    assert_same_tree(str(p_out), str(r_out))
    return p


def _fasta(path, pairs):
    with open(path, "w") as fh:
        fh.write("".join(f">{h}\n{s}\n" for h, s in pairs))
    return str(path)


# -- pipeline/extractors.py -------------------------------------------------

def test_get_readcount_and_categorize_by_length(tmp_path):
    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        recs = [fq.Record(n, n, "A" * k) for n, k in
                (("m", 700), ("s", 200), ("d", 400), ("e", 600),
                 ("f", 350), ("g", 349))]
        return ([ext.get_readcount(h) for h in
                 ("BC_group1_readcount_42", "no_count_here",
                  "x_readcount_7_readcount_9")],
                ext.categorize_by_length(recs),
                ext.categorize_by_length(recs, 500, 300),
                ext.find_max_readcount_entry(
                    [fq.Record(h, h, "A") for h in
                     ("a_readcount_3", "b_readcount_8", "c_readcount_8",
                      "d")]),
                ext.find_max_readcount_entry([]))
    both(tmp_path, fn)


def test_extract_ribo_and_coi_max(tmp_path):
    inp = tmp_path / "in"
    for bc in ("BC01", "BC02"):
        (inp / bc).mkdir(parents=True)
    _fasta(inp / "BC01" / "BC01_18S.fa", [("x_readcount_5", "ACGT"),
                                          ("y_readcount_9", "ACGT")])
    _fasta(inp / "BC01" / "BC01_28S.fasta", [("z_readcount_2", "AC")])
    _fasta(inp / "BC02" / "BC02_18S.fa", [])
    _fasta(inp / "BC02" / "BC02_COI.fasta",
           [("m_readcount_3", "A" * 650), ("m2_readcount_8", "A" * 700),
            ("s_readcount_2", "A" * 300), ("d_readcount_4", "A" * 400)])

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        return (ext.extract_ribo_max(str(inp), str(out / "ribo")),
                ext.extract_coi_max(str(inp), str(out / "coi")))
    got = both(tmp_path, fn)
    assert got[1]["moorea"][0].id == "m2_readcount_8"


# -- pipeline/downstream.py -------------------------------------------------

def test_concat_blast_top5_and_gene_fetch(tmp_path):
    ds = tmp_path / "ds"
    for sub in ("b1", "b2"):
        (ds / "COI" / sub).mkdir(parents=True)
    _fasta(ds / "COI" / "b1" / "b1_COI.fa", [("c1", "ACGT"), ("c2", "GG")])
    _fasta(ds / "COI" / "b2" / "b2_COI.fasta", [("c3", "TTT")])
    rows = [f"{q}\t100\ts{i}\t{10 ** -i}\t50\t98\t123"
            for q in ("q2", "q1") for i in range(8)]
    tsv = tmp_path / "in.tsv"
    tsv.write_text("\n".join(rows) + "\n\n")

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        return (down.concat_gene_fastas(str(ds), "COI", str(out / "c.fa")),
                down.concat_gene_fastas(str(ds), "18S", str(out / "n.fa")),
                down.blast_top5_filter(str(tsv), str(out / "top5.tsv")),
                down.blast_top5_filter(str(tsv), str(out / "top2.tsv"), 2),
                down.run_blastn(str(out / "c.fa"), str(out / "b.tsv"),
                                "no-such-db"),
                down.gene_fetch_stub("COI", "6447", str(out / "gf")))
    assert both(tmp_path, fn)[:3] == (3, 0, 10)


def test_reorganise_barcodes_and_prep_anchors(tmp_path):
    csv = tmp_path / "curated.csv"
    csv.write_text(
        "sample,fasta_header,barcode,expected_taxon,name\n"
        "SP27_001_SP5_003_lakes,BC1_group1_readcount_9,COI,Mollusca,snailA\n"
        "SP27_002_SP5_004_lakes,BC2_group1_readcount_5,18S,Annelida,wormB\n"
        "short,row\n")
    coi = _fasta(tmp_path / "coi.fa",
                 [("consensus_BC1_group1_readcount_9", "ACGTACGT"),
                  ("consensus_BC9_group1_readcount_1", "ACGT")])
    r18 = _fasta(tmp_path / "r18.fa",
                 [("18S_rRNA::BC2_group1_readcount_5:1-900", "GGCC")])
    aligned = _fasta(tmp_path / "aligned.fa",
                     [("s1|x", "ACGT"), ("anch 1", "ACGT"), ("s:2", "AC")])
    samples = _fasta(tmp_path / "samples.fa", [("s1|x", "ACGT"),
                                               ("s:2", "AC")])

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        return ([down.sanitize_header(h) for h in ("a b|c:d", "x.y_z")],
                [down._strip_header(h) for h in
                 ("18S_rRNA::BC2_g:1-900", "consensus_BC1", "plain")],
                down.reorganise_barcodes(
                    str(csv), {"COI": coi, "18S": r18,
                               "28S": str(tmp_path / "absent.fa")},
                    str(out)),
                down.prep_anchor_selection(aligned, samples, "COI",
                                           str(out / "anchors")))
    got = both(tmp_path, fn)
    assert got[2] == {"Mollusca/COI": 1, "Annelida/18S": 1}


# -- analysis/lca.py ----------------------------------------------------------

def test_lca(tmp_path):
    tsv = tmp_path / "b.tsv"
    tsv.write_text(
        "SP27_001_SP5_002_group1_readcount_5\t620\ts1\t1e-50\t200\t99.0\t1\n"
        "SP27_001_SP5_002_group1_readcount_5\t620\ts2\t1e-40\t180\t97.0\t2;3\n"
        "SP27_003_SP5_001_28S_readcount_2\t3000\ts3\t1e-9\t80\t90.0\t9\n"
        "short\tline\n")
    tax = tmp_path / "tax.tsv"
    tax.write_text(
        "taxid\tdomain\tphylum\tclass\torder\tfamily\tgenus\tspecies\n"
        "1\tEuk\tAnnelida\tClitellata\tHirudinida\tHirudinidae\tHirudo\t"
        "H. medicinalis\n"
        "2\tEuk\tAnnelida\tClitellata\tHirudinida\tHirudinidae\tHirudo\t"
        "H. verbana\n")
    lin = [{"domain": "Euk", "phylum": "Mollusca", "class": "Gastropoda",
            "order": None, "family": None, "genus": None, "species": None},
           {"domain": "Euk", "phylum": "Mollusca", "class": "Bivalvia",
            "order": None, "family": None, "genus": None, "species": None}]

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        taxonomy = lca.read_taxonomy_table(str(tax))
        return ([lca.derive_metadata(q, n) for q, n in
                 (("SP27_001_SP5_003_group1_readcount_7", 450),
                  ("x_18S_rRNA", 1800), ("x_28S_y", 3000),
                  ("c_readcount_2", 700), ("x_28S_y", 2400))],
                lca.compute_lca(lin), lca.compute_lca(lin[:1]),
                lca.read_blast_tsv(str(tsv)),
                [h.first_taxid for h in lca.read_blast_tsv(str(tsv))],
                taxonomy,
                lca.lca_table(str(tsv), taxonomy, str(out / "lca.csv")))
    got = both(tmp_path, fn)
    assert got[-1][0]["lca"] == "Hirudo"


# -- analysis/phylo.py --------------------------------------------------------

def test_phylo(tmp_path):
    aligned = _fasta(tmp_path / "aln.fa",
                     [("a", "AAAAAAAAAA"), ("b", "AAAAAAAAAG"),
                      ("c", "AAAA--AAAC"), ("d", "GAAAATAAAC")])
    D = np.array([[0.0, 0.02, 0.5, 0.5], [0.02, 0.0, 0.5, 0.5],
                  [0.5, 0.5, 0.0, 0.02], [0.5, 0.5, 0.02, 0.0]])
    nwk = "((a1:0.01,a2:0.01)0.99:0.24,(b1:0.01,b2:0.01)0.95:0.24):0.0;"

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        recs = list(fq.read_fasta(aligned))
        M, labels = phylo.aln_matrix(recs)
        t = phylo.nj_tree(D, ["a1", "a2", "b1", "b2"])
        p = phylo.parse_newick(nwk)
        r = phylo.midpoint_root(phylo.parse_newick(
            "(a:5.0,(b:2.0,c:0.5)y:1.0)x;"))
        phylo.write_newick(t, str(out / "nj.nwk"))
        phylo.write_newick(r, str(out / "mid.nwk"))
        built = phylo.build_tree(aligned, str(out / "built"),
                                 fasttree_bin=None)
        return (M, labels, phylo.dist_matrix(M, "raw"),
                phylo.dist_matrix(M, "K80"),
                phylo.overlap_matrix(M, [0, 1], [2, 3]), t,
                [phylo.faith_pd(t, s) for s in
                 (["a1", "a2"], ["a1", "b1"], t.labels)],
                p, phylo.faith_pd(p, ["a1", "b1"]), r, built)
    both(tmp_path, fn)


# -- analysis/anchors.py ------------------------------------------------------

def test_anchor_filter(tmp_path):
    rng = np.random.default_rng(0)
    base = "".join(rng.choice(list("ACGT"), size=300))

    def mut(s, k):
        s = list(s)
        for pos in rng.choice(len(s), k, replace=False):
            s[int(pos)] = str(rng.choice(list("ACGT")))
        return "".join(s)

    pairs, meta = [], ["label,type"]
    for i in range(3):
        pairs.append((f"s{i}", mut(base, 3)))
        meta.append(f"s{i},sample")
    for i in range(4):
        pairs.append((f"anch_c{i}", mut(base, 8 + i)))
    pairs.append(("anch_dup1", mut(base, 12)))
    pairs.append(("anch_dup2", pairs[-1][1]))
    pairs.append(("anch_far", "".join(rng.choice(list("ACGT"), size=300))))
    meta += [f"{n},anchor" for n, _ in pairs[3:]]
    aligned = _fasta(tmp_path / "aln.fa", pairs)
    mcsv = tmp_path / "meta.csv"
    mcsv.write_text("\n".join(meta) + "\n")

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        return [anch.run_anchor_filter(
            aligned, str(mcsv), str(out / name),
            anch.AnchorFilterConfig(threshold=0.2, dedup=0.005, subset=10,
                                    **kw))
            for name, kw in (("raw", {}), ("k80", {"distance_model": "K80",
                                                   "min_overlap": 250}))]
    got = both(tmp_path, fn)
    assert "anch_far" in got[0].final_anchors


# -- analysis/reports.py ------------------------------------------------------

def test_reports(tmp_path):
    blast = [dict(plate="day1", SP27="1", SP5="3", barcode="CO1",
                  max_readcount_group="2", max_readcount="40",
                  hit1_expect="Y", hit1_primer_set="Moorea",
                  hit2_group="", hit2_readcount="", hit2_expect="",
                  final_expect="Y"),
             dict(plate="day1", SP27="2", SP5="4", barcode="CO1",
                  max_readcount_group="1", max_readcount="9",
                  hit1_expect="N", hit1_primer_set="",
                  hit2_group="3", hit2_readcount="7", hit2_expect="Y",
                  final_expect="Y")]
    names = [dict(plate="day1", sample="SP27_001_SP5_003", barcode="CO1",
                  new_code="snail A", expected_taxon="Mollusca"),
             dict(plate="day1", sample="SP27_002_SP5_004", barcode="CO1",
                  new_code="cf. worm", expected_taxon="Annelida")]

    def fn(ext, down, lca, phylo, anch, rep, figs, fq, out):
        return (rep.wrangle_metadata(blast, names, str(out / "names.csv")),
                rep.success_metrics(blast),
                rep.stage_read_flow({"raw": {"b1": 100, "b2": 7},
                                     "demux": {"b1": 80}},
                                    str(out / "flow.tsv")),
                rep.stage_read_flow({"raw": {"b1": 1}}))
    got = both(tmp_path, fn)
    assert got[1]["MRC_match"] == 1 and got[1]["AC_match"] == 1


# -- analysis/figures.py -------------------------------------------------------

def test_figures_write_the_same_files(tmp_path):
    pytest.importorskip("matplotlib")
    blast_rows = [
        {"max_readcount_group": "1", "hit1_expect": "Y", "hit2_expect": "n",
         "hit1_primer_set": "Moorea", "max_readcount": 120},
        {"max_readcount_group": "2", "hit1_expect": "n", "hit2_expect": "Y",
         "hit1_primer_set": "Sauron", "max_readcount": 30},
        {"max_readcount_group": "", "hit1_expect": "n", "hit2_expect": "n",
         "hit1_primer_set": "", "max_readcount": ""},
        {"max_readcount_group": "3", "hit1_expect": "n", "hit2_expect": "n",
         "hit1_primer_set": "Moorea", "max_readcount": 55}]
    lca_rows = [
        {"lca": "Lumbricidae", "lca_rank": "family", "dataset": "L1"},
        {"lca": "Lumbricidae", "lca_rank": "family", "dataset": "L1"},
        {"lca": "Eisenia", "lca_rank": "genus", "dataset": "L1"},
        {"lca": "Annelida", "lca_rank": "phylum", "dataset": "G1"},
        {"lca": "Eisenia fetida", "lca_rank": "species", "dataset": "G1"}]
    written = {}
    for side, (ext, down, lca, phylo, anch, rep, figs, fq) in SIDES.items():
        out = tmp_path / side
        flow = rep.stage_read_flow({
            "raw": {"bc1": 1000, "bc2": 800},
            "pychopped": {"bc1": 900, "bc2": 700},
            "sorted": {"bc1": 700, "bc2": 500}})
        paths = [
            figs.plot_success_metrics(
                {"Lakes_1": rep.success_metrics(blast_rows),
                 "Gardens_1": rep.success_metrics(blast_rows[:2])},
                str(out / "success.png")),
            figs.plot_read_flow(flow, str(out / "flow.svg")),
            figs.plot_lca_lollipop(lca_rows, str(out / "lolli.png")),
            figs.plot_lca_bubble(lca_rows, str(out / "bubble.png")),
            figs.plot_readcount_means(blast_rows, str(out / "rc.png")),
            figs.plot_length_histogram([100, 200, 250, 300],
                                       str(out / "len.png")),
            figs.plot_length_vs_quality([100, 200], [10.0, 12.5],
                                        str(out / "lq.png")),
            figs.plot_read_length_histogram(
                [300, 350, 420, 500, 800], str(out / "h.pdf"),
                min_length=320, max_length=600, n50=420)]
        assert all(os.path.getsize(p) > 2000 for p in paths)
        written[side] = sorted(os.path.relpath(os.path.join(d, f), out)
                               for d, _, fs in os.walk(out) for f in fs)
    assert written["port"] == written["ref"]
    assert len(written["port"]) == 8
