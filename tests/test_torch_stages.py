"""tpu_orc_torch stages 01, 02 and 04 against tpu_orc's, file for file.

The port's ``reorient_file``, ``dual_round_demux_stream`` and
``clean_primers`` (locate on the CPU: the plain version) and tpu_orc's
(its CPU paths) run on the same synthetic inputs; every file they write
must be byte-identical: pychopper pass/rescued/unclass/short and stats,
demux bins (compared decompressed: a gzip header carries a timestamp)
and the cutadapt-schema JSON reports, and the cleaned/untrimmed/round-2
contigs. The input holds a fused read, which must come out as
``fused_reads: 1, rescued_segments: 2``. ``Reorienter.FORCE_SCHEDULE``
is left as it is on both sides.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from tpu_orc.demux import adapters as ref_adapters
from tpu_orc.demux import demux as ref_demux
from tpu_orc.demux import primer_clean as ref_clean
from tpu_orc.demux import reorient as ref_reorient
from tpu_orc.io.fastq import Record, write_records
from tpu_orc_torch import synthetic
from tpu_orc_torch.demux import demux as port_demux
from tpu_orc_torch.demux import primer_clean as port_clean
from tpu_orc_torch.demux import reorient as port_reorient
from tpu_orc_torch.demux.adapters import AdapterBank

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


def read_tree(root, skip=()):
    """{relative path: bytes} of every file under root; .gz files are
    decompressed (their headers carry a write time)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if rel in skip:
                continue
            opener = gzip.open if f.endswith(".gz") else open
            with opener(p, "rb") as fh:
                out[rel] = fh.read()
    return out


def assert_same_tree(got_root, want_root, skip=()):
    got, want = read_tree(got_root, skip), read_tree(want_root, skip)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    return synthetic.write_adapter_dir(
        str(tmp_path_factory.mktemp("adapters")))


@pytest.fixture(scope="module")
def raw_reads():
    recs, _ = synthetic.make_plate(3, n5=4, n27=3, seed=21, insert_len=300)
    rng = np.random.default_rng(8)
    junk = "".join(rng.choice(list("ACGT"), size=400))
    recs += [synthetic.fused_read(1, 2),
             Record("junk", "junk", junk, "I" * len(junk)),
             Record("lowq", "lowq", recs[0].seq, "#" * len(recs[0].seq))]
    return recs


def test_reorient_file_equals_reference(tmp_path, adapters, raw_reads):
    fq = str(tmp_path / "raw.fastq")
    write_records(fq, raw_reads, fmt="fastq")
    pf = os.path.join(adapters, "M13_seqs_for_pychopper.fa")
    pc = os.path.join(adapters, "M13_config_for_pychopper.txt")
    got = port_reorient.reorient_file(fq, pf, pc, str(tmp_path / "port"),
                                      "x")
    want = ref_reorient.reorient_file(fq, pf, pc, str(tmp_path / "ref"),
                                      "x")
    assert got.stats == want.stats
    assert got.stats["fused_reads"] == 1
    assert got.stats["rescued_segments"] == 2
    assert got.stats["pass"] == len(raw_reads) - 3
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_dual_round_demux_stream_equals_reference(tmp_path, adapters,
                                                  raw_reads):
    recs = raw_reads[:-3]
    # reoriented reads carry the SP5 adapter first: demux both strands
    f5 = os.path.join(adapters, "M13_amplicon_indices_forward.fa")
    f27 = os.path.join(adapters, "M13_amplicon_indices_reverse_rc.fa")
    got = port_demux.dual_round_demux_stream(
        iter(recs), AdapterBank.from_fasta(f5, 0.1),
        AdapterBank.from_fasta(f27, 0.1), "ds", str(tmp_path / "port"),
        chunk_size=16)
    want = ref_demux.dual_round_demux_stream(
        iter(recs), ref_adapters.AdapterBank.from_fasta(f5, 0.1),
        ref_adapters.AdapterBank.from_fasta(f27, 0.1), "ds",
        str(tmp_path / "ref"), chunk_size=16)
    assert got == want
    assert len(got["final_bins"]) == 12
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_clean_primers_equals_reference(tmp_path, adapters):
    """Linked trim, failsafe drop and round 2 on synthetic contigs: both
    primers (trimmed), forward only (round 2), none (untrimmed), and a
    residual primer copy near an end (failsafe)."""
    import random
    b = synthetic.banks()
    rnd = random.Random(4)
    f = synthetic.concretize(rnd, b["coi"][0][1])
    r = synthetic.concretize(rnd, b["coi"][2][1])
    body = lambda n: "".join(rnd.choice("ACGT") for _ in range(n))
    contigs = []
    for k in range(24):
        kind = k % 4
        if kind == 0:
            s = body(5) + f + body(400) + r + body(4)
        elif kind == 1:
            s = f + body(420)
        elif kind == 2:
            s = body(430)
        else:
            s = f + body(30) + f + body(300) + r
        contigs.append(Record(f"c{k}", f"c{k}", s, None))
    coi = os.path.join(adapters, "COI_primers.fa")
    rna = os.path.join(adapters, "RNA_primers.fa")
    got, grep = port_clean.clean_primers(contigs, coi, rna,
                                         outdir=str(tmp_path / "port"),
                                         name="bc")
    want, wrep = ref_clean.clean_primers(contigs, coi, rna,
                                         outdir=str(tmp_path / "ref"),
                                         name="bc")
    assert got == want
    assert vars(grep) == vars(wrep)
    assert wrep.trimmed > 0 and wrep.failsafe_dropped > 0
    assert wrep.round2_trimmed > 0
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))
