"""tpu_orc_torch.bench (the port of bench.py) on the CPU.

The input generators are held to ``bench.py``'s own lines, run here on
the same banks: the same reads, tile and bins at ``bench.py``'s sizes.
Every section then runs once at a small size on the CPU (the kernels'
plain versions), through ``Bench.run``; its checks must pass, and its
outputs must equal tpu_orc's on the same inputs: ``FusedDemux.assign``
(Pallas in interpret mode), ``myers.distances`` (XLA), ``AmpliconSorter``
with its native scorer, and ``run_all``'s report (bins, reads and species
groups a bin). A corrupted demux decision or tile entry must turn
``correct`` false and the exit code nonzero, and ``main`` without a CUDA
device must return 2 and print nothing. Tolerance: none.
"""
import os
import random
import textwrap

import numpy as np
import pytest
import torch

from tpu_orc.align import myers as ref_myers
from tpu_orc.cluster import engine as ref_engine
from tpu_orc.cluster import scoring as ref_scoring
from tpu_orc.demux import adapters as ref_adapters
from tpu_orc.demux import fused as ref_fused
from tpu_orc.io import encode as ref_encode
from tpu_orc.io.fastq import Record as RefRecord
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import bench, synthetic

from test_torch_stages import fields_of

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

BENCH_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
FULL = bench.Sizes()
TINY = bench.Sizes(demux_reads=64, chunk=16, demux_cpu_reads=8, tile=32,
                   pipe=2, tile_cpu=16, sort_per_template=20,
                   long_per_template=10, long_read=(900, 116, 51),
                   long_warm=4, reorient_reads=64, reorient_cpu_reads=8,
                   plate=(12, 2, 2), plate_warm=(6, 1, 2))
#: the keys of bench.py's line that the bench must fill with numbers
NUMBER_KEYS = (
    "cluster_device_cells_per_s", "cluster_device_pairs_per_s",
    "cluster_single_dispatch_min_s", "cluster_single_dispatch_cells_per_s",
    "cluster_median_s", "cluster_reps",
    "sort_1000reads_e2e_s", "sort_median_s", "sort_reps",
    "sort_species_found", "sort_longread_e2e_s",
    "sort_longread_median_s", "sort_longread_reps",
    "sort_longread_species_found", "reorient_reads_per_s",
    "reorient_median_s", "reorient_reps", "reorient_cpu_reads_per_s_1core",
    "reorient_vs_ref_24core", "pipeline_plate_wall_s",
    "pipeline_plate_median_s", "pipeline_plate_reps",
    "pipeline_plate_reads_per_s", "pipeline_plate_bins",
    "pipeline_plate_species_groups", "cpu_demux_reads_per_s_1core",
    "cluster_cpu_cells_per_s_1core", "vs_ref_24core", "cluster_vs_ref_12core",
    "demux_median_s", "demux_reps")


def bench_py(*spans, **names):
    """Run lines ``spans`` ((first, last), 1-based) of bench.py's main in
    a namespace holding ``names`` and tpu_orc's helpers; returns it."""
    with open(BENCH_PY) as fh:
        lines = fh.read().splitlines()
    code = "\n".join(textwrap.dedent("\n".join(lines[a - 1:b]))
                     for a, b in spans)
    ns = dict(np=np, encode=ref_encode, Record=RefRecord, **names)
    exec(compile(code, "bench.py", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    return synthetic.write_adapter_dir(
        str(tmp_path_factory.mktemp("adapters")), seed=bench.BANK_SEED)


def port_inputs(adapters):
    """The bench's inputs, made as ``Bench.run`` makes them."""
    rng = np.random.default_rng(0)
    f = lambda k: os.path.join(adapters, synthetic.FILES[k])
    sp5 = ref_adapters.AdapterBank.from_fasta(f(0), 0.1)
    sp27 = ref_adapters.AdapterBank.from_fasta(f(1), 0.1)
    recs = bench.demux_reads(sp5.seqs, sp27.seqs, rng, FULL.demux_reads)
    fam, pat, lens = bench.tile_codes(rng, FULL.tile)
    primers = {r.id: r.seq.upper() for r in bench.read_fasta(f(2))}
    rrecs = bench.reorient_reads(primers, rng, FULL.reorient_reads)
    return sp5, sp27, recs, fam, pat, lens, rrecs


def test_generators_are_bench_py_s_at_its_sizes(adapters):
    sp5, sp27, recs, fam, pat, lens, rrecs = port_inputs(adapters)
    ns = bench_py((344, 357), (416, 428), (552, 569), sp5=sp5, sp27=sp27,
                  REF=adapters)
    # B 16,384 reads of 59 + 260 + 59 bp, odd reads reverse-complemented
    assert len(recs) == 16384
    assert [r.seq for r in recs] == ns["reads"]
    for i in (0, 1, 16383):
        s = recs[i].seq if i % 2 == 0 else ref_encode.revcomp(recs[i].seq)
        assert len(s) == 378
        assert s.startswith(sp5.seqs[i % 12])
        assert s.endswith(sp27.seqs[i % 8])
    # N 1,024 codes of 480 bp in a [1024, 512] tile
    assert len(fam) == 1024 and {len(c) for c in fam} == {480}
    assert pat.shape == (1024, 512) and (lens == 480).all()
    np.testing.assert_array_equal(pat, ns["pat"])
    # RB 8,192 reads, every 17th only its 380 bp insert
    assert [r.seq for r in rrecs] == [r.seq for r in ns["rrecs"]]
    assert len(rrecs) == 8192
    assert all(len(rrecs[i].seq) == 380 for i in range(0, 8192, 17))
    assert len(rrecs[1].seq) > 380


def test_sort_generators_are_bench_py_s():
    state = random.getstate()
    try:
        ns = bench_py((489, 512), (528, 535))
    finally:
        random.setstate(state)
    srecs = bench.sort_reads(FULL.sort_per_template)
    lrecs = bench.long_reads(FULL.long_per_template, *FULL.long_read)
    for got, want in ((srecs, ns["srecs"]), (lrecs, ns["lrecs"])):
        assert len(got) == 1000      # 2 templates x 500 reads
        assert [(r.id, r.seq) for r in got] == [(r.id, r.seq) for r in want]
    assert sorted({r.id[:2] for r in srecs}) == ["r0", "r1"]
    assert 3000 < np.mean([len(r.seq) for r in lrecs]) < 4000
    assert ([r.seq for r in bench.sort_reads(FULL.sort_per_template)]
            == [r.seq for r in srecs])


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """Every section at TINY sizes on the CPU, one timed rep each."""
    b = bench.Bench("cpu", reps=1, cpu_window_s=0.01,
                    work=str(tmp_path_factory.mktemp("bench")))
    b.run(TINY)
    return b


def test_sections_run_and_check_on_cpu(ran):
    out, rc = ran.result()
    d = out["details"]
    assert rc == 0 and d["correct"] is True, d["checks"]
    assert out["metric"] == "demux_reads_per_s_per_chip"
    assert out["unit"] == "reads/s"
    for k in NUMBER_KEYS + ("value", "vs_baseline"):
        v = out[k] if k in out else d[k]
        assert isinstance(v, (int, float)) and not isinstance(v, bool), k
    assert d["backend"] == "cpu" and d["demux_len"] == 384
    assert d["checks"]["demux_reads"] == 64
    assert d["checks"]["plate_bins"] == d["checks"]["plate_bins_built"] == 4
    assert set(d["multidev_single_chip"]) >= {
        "demux_single_s", "demux_multi1_s", "demux_overhead_pct",
        "pairwise_single_s", "pairwise_multi1_s", "pairwise_overhead_pct"}
    assert all(isinstance(v, float) for k, v in
               d["pipeline_plate_stage_s"].items())
    # one timed rep a section; no kernel launches on the CPU
    assert set(ran.times) == set(bench.REPS)
    assert all(len(t) == 1 for t in ran.times.values())
    assert ran.launches == {k: {} for k in bench.REPS}


def test_demux_and_tile_equal_reference(ran, adapters):
    f = lambda k: os.path.join(adapters, synthetic.FILES[k])
    r5 = ref_adapters.AdapterBank.from_fasta(f(0), 0.1)
    r27 = ref_adapters.AdapterBank.from_fasta(f(1), 0.1)
    rng = np.random.default_rng(0)
    recs = bench.demux_reads(r5.seqs, r27.seqs, rng, TINY.demux_reads)
    fam, pat, lens = bench.tile_codes(rng, TINY.tile)
    want = ref_fused.FusedDemux(r5, r27).assign(
        [RefRecord(r.id, r.desc, r.seq, r.qual) for r in recs],
        batch_size=TINY.chunk)
    assert ran.out["demux"] == [(o[0], o[1], o[3]) for o in want]
    from tpu_orc_torch.demux.adapters import AdapterBank
    from tpu_orc_torch.demux.fused import FusedDemux
    got = FusedDemux(AdapterBank.from_fasta(f(0), 0.1, "cpu"),
                     AdapterBank.from_fasta(f(1), 0.1, "cpu")).assign(
        recs, batch_size=TINY.chunk)
    assert fields_of(got) == fields_of(want)
    np.testing.assert_array_equal(
        ran.out["tile"], np.asarray(ref_myers.distances(pat, lens, pat,
                                                        lens)))
    assert ran.out["tile_codes"][5].tolist() == fam[5].tolist()


def test_sorts_equal_reference_native(ran):
    for key, recs in (
            ("sort", bench.sort_reads(TINY.sort_per_template)),
            ("longsort", bench.long_reads(TINY.long_per_template,
                                          *TINY.long_read))):
        want = ref_engine.AmpliconSorter(
            ref_engine.SorterConfig(min_length=300, seed=7),
            scorer=ref_scoring.DeviceScorer(backend="native")
        ).sort_records(recs)
        got = ran.out[key]
        assert bench.species(got) == bench.species(want) == 2, key
        assert ([[fields_of(g) for g in s] for s in got.species]
                == [[fields_of(g) for g in s] for s in want.species]), key
        assert got.gene_groups == want.gene_groups


def test_plate_report_equals_reference(ran, adapters, tmp_path):
    rep, bins = ran.out["plate"]
    fq = os.path.join(ran.work, "plate", "plate.fastq")
    want = ref_stages.run_all(
        fq, str(tmp_path / "ref"), "plate", "COI",
        ref_stages.PipelineConfig(adapters_dir=os.path.join(ran.work,
                                                            "adapters")))
    assert rep["demux"] == want["demux"]
    assert rep["barcodes"] == want["barcodes"]
    assert len(rep["barcodes"]) == bins == 4
    assert bench.plate_groups(rep) == 4


@pytest.mark.parametrize("corrupt", ["demux_bin", "tile_entry"])
def test_a_wrong_result_fails_the_run(ran, corrupt):
    saved = {k: ran.out[k] for k in ("demux", "tile")}
    try:
        if corrupt == "demux_bin":
            dec = list(ran.out["demux"])
            i, n5, n27 = dec[7]
            dec[7] = (i, ran.out["demux_names"][0][(i + 1) % 12], n27)
            ran.out["demux"] = dec
        else:
            tile = ran.out["tile"].copy()
            i, j = bench.tile_sample(len(ran.out["tile_codes"]))[3]
            tile[i, j] += 1
            ran.out["tile"] = tile
        out, rc = ran.result()
    finally:
        ran.out.update(saved)
    assert rc != 0 and out["details"]["correct"] is False
    checks = out["details"]["checks"]
    assert (checks["demux_reads_in_wrong_bin"] == 1) == (corrupt
                                                         == "demux_bin")
    assert (checks["tile_entries_wrong"] >= 1) == (corrupt == "tile_entry")
    assert ran.result()[1] == 0


def test_main_without_cuda_returns_2_and_prints_nothing(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert bench.main(["--reps", "1"]) == 2
    got = capsys.readouterr()
    assert got.out == ""
    assert "bench: no CUDA device" in got.err
