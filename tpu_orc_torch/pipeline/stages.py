"""Stage graph of the COI main path, on one torch device.

Copy of ``tpu_orc/pipeline/stages.py``; the device seam:
``PipelineConfig.device`` names the torch device of every locate and
Myers call ("cuda": the kernels of ``csrc/``; "cpu": their plain
versions), and ``run_all`` (:244) differs in four places:

* it raises ``NotImplementedError`` up front for a non-COI amplicon:
  stage 05a (rRNA) is not ported yet;
* it raises for ``use_mesh``: the multi-device path is not ported;
* it raises unless the consensus pileup backend (``ORC_PILEUP_BACKEND``)
  is ``native``: the device pileup of ``tpu_orc.cluster.consensus``
  imports JAX;
* it never opens ``utils.profiling.device_trace`` (a jax.profiler trace).

  00 qc         raw.fastq            -> <name>_nanoplot/
  01 reorient   raw.fastq            -> pychopped/<name>_pass.fastq (+aux)
  02 demux      pass.fastq           -> demuxed/SP5/, demuxed/SP27/
  03 sort       demuxed bin          -> sorted/<barcode>/ + consensus file
  04 clean      consensus fasta      -> primerless/<barcode>/
  05b reorganise cleaned COI contigs -> COI_gene/<barcode>/
  LX summary    sorted/              -> amplicon_summary.tsv

Every stage's output directory is a durable checkpoint; any stage can be
re-run from its predecessor's directory (reference behavior, SURVEY.md §5
checkpoint/resume).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict

from tpu_orc.cluster import consensus as _consensus_mod
from tpu_orc.io.fastq import read_records
from tpu_orc.pipeline.qc import write_stats
from tpu_orc.pipeline.summary import summarize_barcode_dir

from ..cluster.engine import AmpliconSorter, SorterConfig
from ..cluster.output import write_barcode_consensus, write_sort_outputs
from ..demux.adapters import AdapterBank
from ..demux.primer_clean import clean_primers
from ..demux.reorient import ReorientConfig, reorient_file


@dataclass
class PipelineConfig:
    adapters_dir: str                        # the six adapter/primer files
    device: str = "cuda"                     # torch device of the kernels
    e_rate: float = 0.1                      # 02_cutadapt_loop.sh:22
    qmin: float = 10.0                       # 01_pychopper.sh:16
    sorter: SorterConfig = field(default_factory=SorterConfig)
    clean_e_rate: float = 0.1
    # cutadapt --match-read-wildcards for stage 04: enable with -amb
    # consensus so IUPAC ambiguity codes still match primers
    match_read_wildcards: bool = False
    # multi-device sharding is not ported: run_all raises when set
    use_mesh: bool = False
    # Concurrent barcode bins (the reference's --array=1-96 fan-out,
    # 03_amplicon_sorter.sh:7). Bins are independent; overlapping them
    # hides one bin's host consensus work behind another bin's device
    # scoring. Outputs are byte-identical to sequential.
    bin_workers: int = 4

    @property
    def sp5_fasta(self):
        return os.path.join(self.adapters_dir,
                            "M13_amplicon_indices_forward.fa")

    @property
    def sp27rc_fasta(self):
        return os.path.join(self.adapters_dir,
                            "M13_amplicon_indices_reverse_rc.fa")

    @property
    def pychopper_fasta(self):
        return os.path.join(self.adapters_dir, "M13_seqs_for_pychopper.fa")

    @property
    def pychopper_config(self):
        return os.path.join(self.adapters_dir,
                            "M13_config_for_pychopper.txt")

    @property
    def coi_primers(self):
        return os.path.join(self.adapters_dir, "COI_primers.fa")

    @property
    def rna_primers(self):
        return os.path.join(self.adapters_dir, "RNA_primers.fa")


def stage_qc(in_fastq: str, outdir: str, name: str):
    return write_stats(read_records(in_fastq), outdir, name)


def stage_reorient(in_fastq: str, outdir: str, name: str,
                   cfg: PipelineConfig):
    return reorient_file(in_fastq, cfg.pychopper_fasta,
                         cfg.pychopper_config,
                         os.path.join(outdir, "pychopped"), name,
                         ReorientConfig(qmin=cfg.qmin, device=cfg.device))


def stage_demux(in_fastq: str, outdir: str, dataset: str,
                cfg: PipelineConfig):
    from ..demux.demux import dual_round_demux_stream
    sp5 = AdapterBank.from_fasta(cfg.sp5_fasta, cfg.e_rate, cfg.device)
    sp27 = AdapterBank.from_fasta(cfg.sp27rc_fasta, cfg.e_rate, cfg.device)
    # stream straight off the file: host memory is O(chunk), not O(file)
    return dual_round_demux_stream(
        read_records(in_fastq), sp5, sp27, dataset,
        os.path.join(outdir, "demuxed"))


# Bins at or below this many total nucleotides sort with the native C++
# scorer instead of device launches, with BIT-IDENTICAL results
# (parity-tested backend, cluster/scoring.py): ~125 COI reads or ~17
# rRNA reads. The threshold was set against TPU dispatch latency and
# has not been re-measured on a GPU yet.
NATIVE_SMALL_BIN_NT = int(os.environ.get("TPU_ORC_NATIVE_SMALL_BIN_NT",
                                         "60000"))


def stage_sort(bin_fastq: str, outdir: str, barcode: str, prefix: str,
               cfg: PipelineConfig, save_fastq: bool = False,
               compressed: bool = False, alignment: bool = False):
    from ..cluster.scoring import DeviceScorer
    records = list(read_records(bin_fastq))
    scorer = DeviceScorer(tile=cfg.sorter.tile, backend="kernel",
                          device=cfg.device)
    if sum(len(r.seq) for r in records) <= NATIVE_SMALL_BIN_NT:
        try:
            from tpu_orc import native
            native.lib()  # no compiler / read-only dir -> device path
            scorer = DeviceScorer(tile=cfg.sorter.tile, backend="native")
        except Exception:
            pass
    sorter = AmpliconSorter(cfg.sorter, scorer=scorer)
    result = sorter.sort_records(records)
    sorted_dir = os.path.join(outdir, "sorted", barcode)
    # results.txt parameter echo (the reference's save_arguments writes
    # every setting into the audit trail, amplicon_sorter.py:193-223)
    from dataclasses import asdict
    params = {k: v for k, v in asdict(cfg.sorter).items()}
    write_sort_outputs(result, records, sorted_dir, barcode,
                       params=params,
                       save_fastq=save_fastq, compressed=compressed,
                       alignment=alignment)
    consensus_path = write_barcode_consensus(
        result, os.path.join(outdir, "sorted"), barcode, prefix)
    return result, consensus_path


def stage_clean(consensus_fasta: str, outdir: str, barcode: str,
                amplicon: str, cfg: PipelineConfig):
    primers = cfg.coi_primers if amplicon.upper() == "COI" \
        else cfg.rna_primers
    records = list(read_records(consensus_fasta))
    return clean_primers(records, primers,
                         outdir=os.path.join(outdir, "primerless", barcode),
                         name=barcode, e=cfg.clean_e_rate,
                         match_read_wildcards=cfg.match_read_wildcards,
                         device=cfg.device)


def stage_reorganise_cois(outdir: str) -> Dict[str, str]:
    """05b (05b_reorganise_COIs.sh:20-51): copy every
    primerless/<sample>/[COIs/]cleaned*.fasta to
    COI_gene/<sample>/<sample>_COI.fasta. Returns {sample: dest_path}."""
    import glob
    import shutil as _sh
    workdir = os.path.join(outdir, "primerless")
    dest_base = os.path.join(outdir, "COI_gene")
    copied: Dict[str, str] = {}
    # reference layout (<sample>/COIs/cleaned*.fasta) and our flat layout
    patterns = [os.path.join(workdir, "*", "COIs", "cleaned*.fasta"),
                os.path.join(workdir, "*", "cleaned*.fasta")]
    for pat in patterns:
        for src in sorted(glob.glob(pat)):
            sample_path = os.path.dirname(src)
            if os.path.basename(sample_path) == "COIs":
                sample_path = os.path.dirname(sample_path)
            sample = os.path.basename(sample_path)
            if sample in copied:
                continue
            dest_dir = os.path.join(dest_base, sample)
            os.makedirs(dest_dir, exist_ok=True)
            dest = os.path.join(dest_dir, f"{sample}_COI.fasta")
            _sh.copyfile(src, dest)
            copied[sample] = dest
    return copied


def run_all(in_fastq: str, outdir: str, dataset: str, amplicon: str,
            cfg: PipelineConfig, prefix: str = "amplicons") -> Dict:
    """00 -> 05b on one COI dataset FASTQ. Returns a run report dict and
    writes run_report.json + metrics.json (per-stage wall time and
    throughput)."""
    from tpu_orc.utils.profiling import Metrics

    if amplicon.upper() != "COI":
        raise NotImplementedError(
            "stage 05a (rRNA extraction) is not ported; run_all takes the "
            "COI amplicon only")
    if cfg.use_mesh:
        raise NotImplementedError("the multi-device path is not ported")
    if _consensus_mod.PILEUP_BACKEND != "native":
        raise NotImplementedError(
            f"ORC_PILEUP_BACKEND={_consensus_mod.PILEUP_BACKEND!r}: only "
            f"the native consensus pileup is ported")
    os.makedirs(outdir, exist_ok=True)
    report: Dict = {"dataset": dataset, "amplicon": amplicon}
    met = Metrics(run=dataset)

    with met.stage("00_qc") as st:
        stats = stage_qc(in_fastq, outdir, dataset)
        st.count(n_reads=stats.number_of_reads)
    report["qc"] = {"reads": stats.number_of_reads, "n50": stats.n50}

    with met.stage("01_reorient") as st:
        reor = stage_reorient(in_fastq, outdir, dataset, cfg)
        st.count(n_reads=stats.number_of_reads)
    report["reorient"] = reor.stats
    pass_path = os.path.join(outdir, "pychopped",
                             f"{dataset}_pass.fastq")

    with met.stage("02_demux") as st:
        demux_rep = stage_demux(pass_path, outdir, dataset, cfg)
        st.count(n_reads=demux_rep["total_reads"])
    report["demux"] = {
        "bins": len(demux_rep["final_bins"]),
        "binned_reads": sum(demux_rep["final_bins"].values())}

    report["barcodes"] = {}

    def process_bin(comb: str):
        """Stages 03-04 for one barcode bin — the reference's SLURM
        array-task unit (03_amplicon_sorter.sh:7). Bins are fully
        independent (own dirs, own seeded sorter), so
        cfg.bin_workers > 1 overlaps one bin's host-side consensus
        with another bin's device scoring."""
        bin_path = os.path.join(outdir, "demuxed", "SP27",
                                f"{comb}_{dataset}.fastq.gz")
        with met.stage(f"03_sort/{comb}") as st:
            result, consensus_path = stage_sort(bin_path, outdir, comb,
                                                prefix, cfg)
            st.count(n_reads=result.n_reads)
        rep_bc = {"reads": result.n_reads, "skipped": result.skipped,
                  "species_groups": sum(len(s)
                                        for s in result.species)}
        if not result.skipped and rep_bc["species_groups"]:
            with met.stage(f"04_clean/{comb}") as st:
                clean, crep = stage_clean(consensus_path, outdir, comb,
                                          amplicon, cfg)
                st.count(n_contigs=crep.total)
            rep_bc["cleaned"] = len(clean)
        return comb, rep_bc

    combs = sorted(demux_rep["final_bins"])
    if cfg.bin_workers > 1 and len(combs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(cfg.bin_workers) as pool:
            for comb, rep_bc in pool.map(process_bin, combs):
                report["barcodes"][comb] = rep_bc
    else:
        for comb in combs:
            comb, rep_bc = process_bin(comb)
            report["barcodes"][comb] = rep_bc

    with met.stage("05b_reorganise_cois") as st:
        copied = stage_reorganise_cois(outdir)
        st.count(n_contigs=len(copied))
    report["coi_gene"] = {"samples": len(copied)}

    summarize_barcode_dir(os.path.join(outdir, "sorted"),
                          os.path.join(outdir, "amplicon_summary.tsv"))

    met.write(os.path.join(outdir, "metrics.json"))
    report["metrics"] = met.as_dict()
    with open(os.path.join(outdir, "run_report.json"), "w") as fh:
        json.dump(report, fh, indent=2, default=str)
    return report
