"""Stage graph of the COI and rRNA paths, on one torch device.

Copy of ``tpu_orc/pipeline/stages.py``; the device seam:
``PipelineConfig.device`` names the torch device of every locate, Myers,
path-bits pileup and Viterbi call ("cuda": the kernels of ``csrc/``;
"cpu": their plain versions). ``stage_sort`` hands it to the sorter for
the consensus pileup (the ``device`` backend of ``ORC_PILEUP_BACKEND``),
whichever backend scores the bin; ``stage_rrna`` to stage 05a's finders.
With ``use_mesh`` (:59, :73-77), ``run_all`` builds one mesh of the
cards (``dist/sharded.py::make_mesh``) for stages 02 and 03, as
``tpu_orc``'s does: the demux stripes its chunks over the mesh, and
every bin scores on the mesh (no native scorer for small bins,
:148-150); the work that is not striped (reorient, the consensus
pileup, primer clean, 05a) stays on ``cfg.device``. Its ``trace_dir``
opens ``utils.profiling.device_trace``, a ``torch.profiler`` trace.

  00 qc         raw.fastq            -> <name>_nanoplot/
  01 reorient   raw.fastq            -> pychopped/<name>_pass.fastq (+aux)
  02 demux      pass.fastq           -> demuxed/SP5/, demuxed/SP27/
  03 sort       demuxed bin          -> sorted/<barcode>/ + consensus file
  04 clean      consensus fasta      -> primerless/<barcode>/
  05a rrna      cleaned contigs      -> rRNA_genes/<barcode>_{18S,28S}.fa
                                        (amplicons other than COI)
  05b reorganise cleaned COI contigs -> COI_gene/<barcode>/ (COI)
  LX summary    sorted/              -> amplicon_summary.tsv

Every stage's output directory is a durable checkpoint; any stage can be
re-run from its predecessor's directory (reference behavior, SURVEY.md §5
checkpoint/resume).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..io.fastq import read_records
from ..utils.profiling import count, span
from .qc import write_stats
from .summary import summarize_barcode_dir

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
    rrna_exemplars_18s: Optional[str] = None  # FASTA paths
    rrna_exemplars_28s: Optional[str] = None
    rrna_hmm: Optional[str] = None            # HMMER3 file (barrnap euk.hmm)
    rrna_cm: Optional[str] = None             # Infernal .cm (Rfam; rrna/cm.py)
    # multi-device: stripe demux reads and clustering patterns over a
    # ('data','pair') mesh of the cards (dist/sharded.py). False = one
    # device; True = every visible card (SLURM-array fan-out replaced by
    # mesh data parallelism, SURVEY.md §2.4).
    use_mesh: bool = False
    # Concurrent barcode bins (the reference's --array=1-96 fan-out,
    # 03_amplicon_sorter.sh:7). Bins are independent; overlapping them
    # hides one bin's host consensus work behind another bin's device
    # scoring. Outputs are byte-identical to sequential.
    bin_workers: int = 4

    def mesh(self):
        """The mesh of ``use_mesh``: every visible card for a CUDA
        ``device``, the one device otherwise; None without ``use_mesh``."""
        if not self.use_mesh:
            return None
        from ..dist.sharded import make_mesh
        if torch.device(self.device).type == "cuda":
            return make_mesh()
        return make_mesh(devices=[self.device])

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
                cfg: PipelineConfig, mesh=None):
    from ..demux.demux import dual_round_demux_stream
    sp5 = AdapterBank.from_fasta(cfg.sp5_fasta, cfg.e_rate, cfg.device)
    sp27 = AdapterBank.from_fasta(cfg.sp27rc_fasta, cfg.e_rate, cfg.device)
    # stream straight off the file: host memory is O(chunk), not O(file)
    return dual_round_demux_stream(
        read_records(in_fastq), sp5, sp27, dataset,
        os.path.join(outdir, "demuxed"),
        mesh=mesh if mesh is not None else cfg.mesh())


# Bins at or below this many total nucleotides sort with the native C++
# scorer instead of device launches, with BIT-IDENTICAL results
# (parity-tested backend, cluster/scoring.py): ~125 COI reads or ~17
# rRNA reads. The threshold was set against TPU dispatch latency and
# has not been re-measured on a GPU yet.
NATIVE_SMALL_BIN_NT = int(os.environ.get("TPU_ORC_NATIVE_SMALL_BIN_NT",
                                         "60000"))


def stage_sort(bin_fastq: str, outdir: str, barcode: str, prefix: str,
               cfg: PipelineConfig, mesh=None, save_fastq: bool = False,
               compressed: bool = False, alignment: bool = False):
    from ..cluster.scoring import DeviceScorer
    records = list(read_records(bin_fastq))
    mesh = mesh if mesh is not None else cfg.mesh()
    scorer = DeviceScorer(tile=cfg.sorter.tile, backend="kernel",
                          device=cfg.device, mesh=mesh)
    if mesh is None and sum(len(r.seq) for r in records) \
            <= NATIVE_SMALL_BIN_NT:
        try:
            from .. import native
            native.lib()  # no compiler / read-only dir -> device path
            scorer = DeviceScorer(tile=cfg.sorter.tile, backend="native")
        except Exception:
            pass
    sorter = AmpliconSorter(cfg.sorter, scorer=scorer, device=cfg.device)
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


def stage_rrna(cleaned_fasta: str, outdir: str, barcode: str,
               cfg: PipelineConfig):
    """05a: HMMER3 model file > exemplar FASTAs > conserved-core block
    profiles with single-anchor fallback (zero-config default;
    rrna/profiles.py), on ``cfg.device``. Span ``rrna.extract`` (the
    call; ``rrna.model`` reading the model files, and under it the
    finders' ``rrna.pack``/``.viterbi``/``.hits`` and ``rrna.write``),
    counters ``rrna.contigs`` and ``rrna.hits``."""
    from ..io.fastq import read_fasta
    from ..rrna.extract import extract_rrna
    with span("rrna.extract"):
        with span("rrna.model"):
            ex18 = ([r.seq for r in read_fasta(cfg.rrna_exemplars_18s)]
                    if cfg.rrna_exemplars_18s else None)
            ex28 = ([r.seq for r in read_fasta(cfg.rrna_exemplars_28s)]
                    if cfg.rrna_exemplars_28s else None)
            p18 = p28 = None
            if cfg.rrna_cm:
                # pybarrnap/infernal variant (README.md:50-51): Rfam-layout
                # .cm models, scored via each CM's embedded p7 filter
                # (rrna/cm.py)
                from ..rrna.cm import parse_cm, profiles_by_gene
                bygene = profiles_by_gene(parse_cm(cfg.rrna_cm))
                p18 = bygene.get("18S")
                p28 = bygene.get("28S")
            elif cfg.rrna_hmm:
                from ..rrna.hmm import parse_hmmer3
                models = {m.name: m for m in parse_hmmer3(cfg.rrna_hmm)}
                p18 = models.get("18S_rRNA")
                p28 = models.get("28S_rRNA")
        records = list(read_records(cleaned_fasta))
        count("rrna.contigs", len(records))
        hits = extract_rrna(records, os.path.join(outdir, "rRNA_genes"),
                            barcode, exemplars_18s=ex18, exemplars_28s=ex28,
                            profile_18s=p18, profile_28s=p28,
                            device=cfg.device)
        count("rrna.hits", sum(len(h) for h in hits.values()))
        return hits


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
            cfg: PipelineConfig, prefix: str = "amplicons",
            trace_dir: Optional[str] = None) -> Dict:
    """00 -> 05 on one dataset FASTQ. Returns a run report dict and
    writes run_report.json + metrics.json (per-stage wall time and
    throughput; ``trace_dir`` or TPU_ORC_TRACE additionally captures a
    torch.profiler trace of the whole run)."""
    from ..utils.profiling import Metrics, device_trace

    os.makedirs(outdir, exist_ok=True)
    report: Dict = {"dataset": dataset, "amplicon": amplicon}
    met = Metrics(run=dataset)
    mesh = cfg.mesh()  # one mesh for every striped stage (None = 1 device)

    with device_trace(trace_dir):
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
            demux_rep = stage_demux(pass_path, outdir, dataset, cfg,
                                    mesh=mesh)
            st.count(n_reads=demux_rep["total_reads"])
        report["demux"] = {
            "bins": len(demux_rep["final_bins"]),
            "binned_reads": sum(demux_rep["final_bins"].values())}

        report["barcodes"] = {}

        def process_bin(comb: str):
            """Stages 03-05 for one barcode bin — the reference's SLURM
            array-task unit (03_amplicon_sorter.sh:7). Bins are fully
            independent (own dirs, own seeded sorter), so
            cfg.bin_workers > 1 overlaps one bin's host-side consensus
            with another bin's device scoring."""
            bin_path = os.path.join(outdir, "demuxed", "SP27",
                                    f"{comb}_{dataset}.fastq.gz")
            with met.stage(f"03_sort/{comb}") as st:
                result, consensus_path = stage_sort(bin_path, outdir, comb,
                                                    prefix, cfg, mesh=mesh)
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
                cleaned_path = os.path.join(outdir, "primerless", comb,
                                            f"cleaned_{comb}.fasta")
                if amplicon.upper() != "COI":
                    # runs by default: anchor mode needs no model files
                    with met.stage(f"05_rrna/{comb}") as st:
                        hits = stage_rrna(cleaned_path, outdir, comb, cfg)
                        st.count(n_contigs=len(clean))
                    rep_bc["rrna"] = {g: len(h) for g, h in hits.items()}
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

        if amplicon.upper() == "COI":
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
