"""tpu_orc_torch ``run_all -a RNA`` with the Kogge-Stone locate against
tpu_orc's ``run_all`` on the CPU.

A synthetic rRNA plate (2 x 2 bins of 8 reads of 3.2-3.6 kb rDNA between
the RNA primers, ``synthetic.make_rrna_plate``) goes through both
packages' whole rRNA path: 00 qc, 01 reorient, 02 demux, 03 sort, 04
clean with ``RNA_primers.fa`` and 05a. The port runs with
``LOCATE_IMPL = "ks"`` (every locate through ``locate_plain_ks``),
tpu_orc with its default. The output trees must be byte-identical,
except the timings (and the completion order of the concurrent bins) in
metrics.json and run_report.json. On one worker this file takes about a
minute and a half: every locate walks ~3,600 columns in torch ops.
"""
import torch

from tpu_orc.io.fastq import write_records
from tpu_orc.pipeline import stages as ref_stages
from tpu_orc_torch import synthetic
from tpu_orc_torch.align import locate as L
from tpu_orc_torch.pipeline import stages as port_stages

from test_torch_pipeline import TIMED, _untimed
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


def test_run_all_rna_ks_equals_reference(tmp_path, monkeypatch):
    adapters = synthetic.write_adapter_dir(str(tmp_path / "adapters"))
    recs, _ = synthetic.make_rrna_plate(8, n5=2, n27=2, seed=3,
                                        error_rate=0.03)
    fq = str(tmp_path / "plate.fastq")
    write_records(fq, recs, fmt="fastq")
    calls = []

    def counted(*a):
        calls.append(a[3])
        return L.locate_plain_ks(*a)

    monkeypatch.setattr(L, "LOCATE_IMPL", "ks")
    monkeypatch.setitem(L.IMPLS, "ks", (counted, L.locate_cuda_ks))
    got = port_stages.run_all(fq, str(tmp_path / "port"), "plate", "RNA",
                              port_stages.PipelineConfig(adapters,
                                                         device="cpu"))
    want = ref_stages.run_all(fq, str(tmp_path / "ref"), "plate", "RNA",
                              ref_stages.PipelineConfig(adapters_dir=adapters))
    assert set(calls) == {"front", "back", "infix"}
    assert got["demux"] == want["demux"] == {"bins": 4, "binned_reads": 32}
    assert got["barcodes"] == want["barcodes"]
    hits = [b["rrna"] for b in got["barcodes"].values() if "rrna" in b]
    assert len(hits) >= 2 and all(h == {"18S": 1, "28S": 1} for h in hits)
    assert "coi_gene" not in got
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"),
                     skip=TIMED)
    for name in TIMED:
        assert (_untimed(str(tmp_path / "port" / name))
                == _untimed(str(tmp_path / "ref" / name))), name
