"""tpu_orc_torch's CLI against tpu_orc's, subcommand by subcommand.

Each new subcommand of the port (qc, extract-max, summary, blast-top5,
reorganise, prep-anchors, figures), each flag of ``sort``, its folder
input and ``--ho``, and ``run-all --trace`` run through both packages'
``main(argv)`` in this process, on the CPU (the port with ``--device
cpu``), on the same inputs. The printed JSON line must be the same, each
side's output folder written as '<out>', and so must every file written,
byte for byte (gzip files decompressed; images, whose PDF and SVG
headers carry a time, by name only). tpu_orc's ``run-all`` takes no
adapter folder, so its PipelineConfig gets the synthetic one here.
"""
import functools
import gzip
import json
import os
import random

import pytest
import torch

from tpu_orc import cli as ref_cli
from tpu_orc.io.fastq import Record, write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import cli as port_cli
from tpu_orc_torch import synthetic

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

IMAGES = (".png", ".pdf", ".svg")
TIMED = ("metrics.json", "run_report.json")


def _tree(root, skip=()):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if rel in skip or "trace" in rel.split(os.sep)[0]:
                continue
            if f.endswith(IMAGES):
                out[rel] = None
                continue
            with (gzip.open if f.endswith(".gz") else open)(p, "rb") as fh:
                out[rel] = fh.read()
    return out


def _json(capsys, main, argv):
    assert main(argv) in (0, None)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def both(tmp_path, capsys, argv, port_extra=(), skip=()):
    """Run ``argv`` (with '{out}' standing for each side's folder) through
    both CLIs; the JSON lines and the folders must be equal. Returns the
    port's JSON line."""
    got = {}
    for side, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        out = str(tmp_path / side)
        os.makedirs(out, exist_ok=True)
        args = [a.replace("{out}", out) for a in argv]
        if side == "port":
            args += list(port_extra)
        line = json.dumps(_json(capsys, main, args))
        got[side] = json.loads(line.replace(out, "<out>"))
    assert got["port"] == got["ref"]
    a, b = _tree(tmp_path / "port", skip), _tree(tmp_path / "ref", skip)
    assert sorted(a) == sorted(b)
    for rel in a:
        assert a[rel] == b[rel], rel
    return got["port"]


def _fasta(path, pairs):
    with open(path, "w") as fh:
        fh.write("".join(f">{h}\n{s}\n" for h, s in pairs))
    return str(path)


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """Two sort bins (FASTQ, one gzipped): reads of one and of two
    ~480 bp templates at 3% noise, as a demuxed bin holds them."""
    d = tmp_path_factory.mktemp("bins")
    rnd = random.Random(12)
    tmpls = ["".join(rnd.choice("ACGT") for _ in range(n))
             for n in (480, 470)]
    for name, k, n in (("BC1.fastq", 1, 24), ("BC2.fastq.gz", 2, 30)):
        recs = []
        for r in range(n):
            s = synthetic.mutate(rnd, tmpls[r % k], 0.03)
            recs.append(Record(f"r{r}", f"r{r}", s, "I" * len(s)))
        write_records(str(d / name), recs, fmt="fastq")
    return d


def test_qc(tmp_path, capsys):
    recs, _ = synthetic.make_plate(2, n5=2, n27=2, seed=3)
    fq = str(tmp_path / "raw.fastq")
    write_records(fq, recs, fmt="fastq")
    got = both(tmp_path, capsys, ["qc", fq, "-o", "{out}", "-n", "x"])
    assert got["number_of_reads"] == 8


SORT_FLAGS = [[], ["--amb"], ["--sg", "0.7"], ["--ssg", "0.9"],
              ["--ss", "0.9"], ["--sc", "0.9"], ["--ldc", "4"],
              ["--np", "3"], ["--sequential", "--maxr", "20"], ["--sfq"],
              ["--gz", "--sfq"], ["--all"], ["--aln"], ["--mac"],
              ["--min", "400", "--max", "600", "--seed", "7"]]


@pytest.mark.parametrize("flags", SORT_FLAGS, ids=lambda f: " ".join(f)
                         or "defaults")
def test_sort_flags(tmp_path, capsys, bins, flags):
    got = both(tmp_path, capsys,
               ["sort", str(bins / "BC2.fastq.gz"), "-o", "{out}", "-b",
                "BC2", *flags], port_extra=["--device", "cpu"])
    assert got["reads"] == (20 if "--maxr" in flags else 30)


def test_sort_folder_input(tmp_path, capsys, bins):
    got = both(tmp_path, capsys, ["sort", str(bins), "-o", "{out}"],
               port_extra=["--device", "cpu"])
    assert [s["reads"] for s in got["sorted"]] == [24, 30]


def test_sort_histogram_only(tmp_path, capsys, bins):
    pytest.importorskip("matplotlib")
    got = both(tmp_path, capsys,
               ["sort", str(bins / "BC1.fastq"), "-o", "{out}", "--ho",
                "--min", "450"], port_extra=["--device", "cpu"])
    assert got == {"histogram": "<out>/BC1_total_outputfig.pdf",
                   "reads": 24}


def test_sort_needs_a_barcode_for_one_file(bins):
    with pytest.raises(SystemExit):
        port_cli.main(["sort", str(bins / "BC1.fastq"), "-o", "x",
                       "--device", "cpu"])


def test_extract_max_and_summary(tmp_path, capsys):
    inp = tmp_path / "in"
    (inp / "BC01").mkdir(parents=True)
    _fasta(inp / "BC01" / "BC01_18S.fa", [("x_readcount_5", "ACGT"),
                                          ("y_readcount_9", "ACGT")])
    _fasta(inp / "BC01" / "BC01_COI.fasta",
           [("m_readcount_3", "A" * 650), ("s_readcount_2", "A" * 300)])
    _fasta(inp / "SP27_001_SP5_003_consensus_coi.fasta",
           [("SP27_001_SP5_003_group1_readcount_12", "ACGT")])
    for mode in ("ribo", "coi"):
        got = both(tmp_path, capsys, ["extract-max", mode, str(inp), "-o",
                                      "{out}/" + mode])
        assert sum(got.values()) >= 1
    got = both(tmp_path, capsys, ["summary", str(inp), "-o",
                                  "{out}/sum.tsv"])
    assert got == {"rows": 96, "found": 1}


def test_blast_top5_reorganise_prep_anchors(tmp_path, capsys):
    tsv = tmp_path / "in.tsv"
    tsv.write_text("".join(f"{q}\t100\ts{i}\t{10 ** -i}\t50\t98\t123\n"
                           for q in ("q1", "q2") for i in range(8)))
    assert both(tmp_path, capsys, ["blast-top5", str(tsv), "-o",
                                   "{out}/top5.tsv"]) == {"kept": 10}
    csv = tmp_path / "curated.csv"
    csv.write_text(
        "sample,fasta_header,barcode,expected_taxon,name\n"
        "SP27_001_SP5_003_lakes,BC1_group1_readcount_9,COI,Mollusca,snailA\n")
    coi = _fasta(tmp_path / "coi.fa",
                 [("consensus_BC1_group1_readcount_9", "ACGTACGT")])
    got = both(tmp_path, capsys, ["reorganise", str(csv), "--coi", coi,
                                  "--r18s", coi + ".none", "--r28s",
                                  coi + ".none", "-o", "{out}"])
    assert got == {"Mollusca/COI": 1}
    aligned = _fasta(tmp_path / "aligned.fa", [("s1|x", "ACGT"),
                                               ("anch 1", "ACGT")])
    samples = _fasta(tmp_path / "samples.fa", [("s1|x", "ACGT")])
    got = both(tmp_path, capsys, ["prep-anchors", aligned, samples, "-g",
                                  "COI", "-o", "{out}/anchors"])
    assert got["metadata"] == "<out>/anchors/COI_metadata.csv"


def test_figures(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    blast = tmp_path / "blast.csv"
    blast.write_text(
        "plate,max_readcount_group,hit1_expect,hit2_expect,"
        "hit1_primer_set,max_readcount\n"
        "L1,1,Y,n,Moorea,120\nL1,2,n,Y,Sauron,30\nG1,,n,n,,\n")
    lca = tmp_path / "lca.csv"
    lca.write_text("lca,lca_rank,dataset\nLumbricidae,family,L1\n"
                   "Eisenia,genus,L1\nAnnelida,phylum,G1\n")
    flow = tmp_path / "flow.tsv"
    flow.write_text("stage\tsample\treads\nraw\tbc1\t100\n"
                    "demux\tbc1\t80\n")
    got = both(tmp_path, capsys, ["figures", "-o", "{out}", "--blast-csv",
                                  str(blast), "--lca-csv", str(lca),
                                  "--flow-tsv", str(flow)])
    assert len(got["figures"]) == 5


def test_run_all_trace(tmp_path, capsys, monkeypatch):
    """``run-all --trace`` through both CLIs on the plate of
    test_torch_stages (36 reads): the same report (timings aside) and
    files, and a trace in each trace folder."""
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_plate(3, n5=4, n27=3, seed=21, insert_len=300)
    fq = str(tmp_path / "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    monkeypatch.setattr(ref_stages, "PipelineConfig", functools.partial(
        ref_stages.PipelineConfig, adapters_dir=adapters))
    reports = {}
    for side, main, extra in (
            ("port", port_cli.main, ["--adapters-dir", adapters,
                                     "--device", "cpu"]),
            ("ref", ref_cli.main, [])):
        out = str(tmp_path / side)
        rep = _json(capsys, main, ["run-all", fq, "-o", out, "-n", "plate",
                                   "-a", "COI", "--trace",
                                   str(tmp_path / f"trace_{side}"),
                                   "--bin-workers", "1", *extra])
        rep.pop("metrics")
        reports[side] = rep
        traced = [f for _, _, fs in os.walk(tmp_path / f"trace_{side}")
                  for f in fs]
        assert traced, side
    assert reports["port"] == reports["ref"]
    assert reports["port"]["demux"]["bins"] == 12
    a = _tree(tmp_path / "port", TIMED)
    b = _tree(tmp_path / "ref", TIMED)
    assert sorted(a) == sorted(b)
    for rel in a:
        assert a[rel] == b[rel], rel
    for d, _, fs in os.walk(tmp_path / "trace_port"):
        for f in fs:
            os.unlink(os.path.join(d, f))   # a CPU trace of every op
