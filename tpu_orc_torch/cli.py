"""tpu_orc_torch command line: the COI and rRNA paths on one torch device.

    python -m tpu_orc_torch.cli run-all  <fastq> -o OUT -n DATASET
                                         -a {COI,RNA} --adapters-dir DIR
                                         [--rrna-hmm F | --rrna-cm F]
                                         [--exemplars-18s F]
                                         [--exemplars-28s F] [--device cuda]
    python -m tpu_orc_torch.cli reorient <fastq> -o OUT -n NAME --adapters-dir DIR
    python -m tpu_orc_torch.cli demux    <fastq> -o OUT -n DATASET --adapters-dir DIR
    python -m tpu_orc_torch.cli sort     <bin.fastq> -o OUT -b BARCODE
    python -m tpu_orc_torch.cli clean    <consensus.fasta> -o OUT -b BARCODE
                                         -a {COI,RNA} --adapters-dir DIR
    python -m tpu_orc_torch.cli rrna     <cleaned.fasta> -o OUT -b BARCODE
                                         [--hmm F | --cm F]
                                         [--exemplars-18s F]
                                         [--exemplars-28s F]

Port of the path's subcommands of ``tpu_orc/cli.py``. ``--device``
(default ``cuda``) names the torch device of the kernels; a CUDA device
that is not there is an error, never a CPU fallback. ``--device cpu``
runs the kernels' plain versions. ``TPU_ORC_LOCATE_IMPL=ks`` runs every
locate through the Kogge-Stone kernel (``align/locate.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

__version__ = "0.1.0"


def _device(name: str) -> str:
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"tpu_orc_torch: --device {name}: no CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"tpu_orc_torch: --device {name}: not cuda or cpu")
    return name


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu_orc_torch", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("-v", "--version", action="version",
                   version=f"tpu_orc_torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, adapters=True):
        sp = sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("-o", "--outdir", required=True)
        sp.add_argument("--device", default="cuda",
                        help="torch device of the kernels (default cuda)")
        if adapters:
            sp.add_argument("--adapters-dir", required=True,
                            help="folder of the six adapter/primer files")
        return sp

    sp = add("reorient")
    sp.add_argument("-n", "--name", required=True)
    sp.add_argument("-Q", "--qmin", type=float, default=10.0)

    sp = add("demux")
    sp.add_argument("-n", "--dataset", required=True)
    sp.add_argument("-e", "--error-rate", type=float, default=0.1)

    sp = add("sort", adapters=False)
    sp.add_argument("-b", "--barcode", required=True)
    sp.add_argument("-p", "--prefix", default="amplicons")
    sp.add_argument("--min", type=int, default=300)
    sp.add_argument("--max", type=int, default=None)
    sp.add_argument("--maxr", type=int, default=10000)
    sp.add_argument("--seed", type=int, default=42)

    sp = add("clean")
    sp.add_argument("-b", "--barcode", required=True)
    sp.add_argument("-a", "--amplicon", choices=["COI", "RNA"],
                    required=True)
    sp.add_argument("-e", "--error-rate", type=float, default=0.1)
    sp.add_argument("--match-read-wildcards", action="store_true",
                    help="IUPAC codes in contigs match their base set "
                         "(use with -amb consensus)")

    sp = add("rrna", adapters=False)
    sp.add_argument("-b", "--barcode", required=True)
    sp.add_argument("--exemplars-18s")
    sp.add_argument("--exemplars-28s")
    sp.add_argument("--hmm", help="HMMER3 .hmm with 18S/28S models")
    sp.add_argument("--cm", help="Infernal .cm (Rfam SSU/LSU models; "
                                 "pybarrnap variant)")

    sp = add("run-all")
    sp.add_argument("-n", "--dataset", required=True)
    sp.add_argument("-a", "--amplicon", choices=["COI", "RNA"],
                    required=True)
    sp.add_argument("--rrna-hmm", default=None,
                    help="HMMER3 .hmm (e.g. barrnap euk.hmm) for stage 05; "
                         "default = universal junction anchors")
    sp.add_argument("--rrna-cm", default=None,
                    help="Infernal .cm (e.g. Rfam 14.10 SSU/LSU) for "
                         "stage 05, scored via the CM's embedded p7 "
                         "filter (rrna/cm.py)")
    sp.add_argument("--exemplars-18s", default=None)
    sp.add_argument("--exemplars-28s", default=None)
    sp.add_argument("--bin-workers", type=int, default=4,
                    help="concurrent barcode bins in stages 03-05")

    args = p.parse_args(argv)
    from .pipeline.stages import PipelineConfig
    device = _device(args.device)
    adapters = getattr(args, "adapters_dir", "")

    if args.cmd == "reorient":
        from .pipeline.stages import stage_reorient
        cfg = PipelineConfig(adapters, device=device, qmin=args.qmin)
        res = stage_reorient(args.input, args.outdir, args.name, cfg)
        print(json.dumps(res.stats))
    elif args.cmd == "demux":
        from .pipeline.stages import stage_demux
        cfg = PipelineConfig(adapters, device=device, e_rate=args.error_rate)
        rep = stage_demux(args.input, args.outdir, args.dataset, cfg)
        print(json.dumps({"final_bins": rep["final_bins"]}))
    elif args.cmd == "sort":
        from .cluster.engine import SorterConfig
        from .pipeline.stages import stage_sort
        cfg = PipelineConfig(adapters, device=device, sorter=SorterConfig(
            min_length=args.min, max_length=args.max, max_reads=args.maxr,
            seed=args.seed))
        result, path = stage_sort(args.input, args.outdir, args.barcode,
                                  args.prefix, cfg)
        print(json.dumps({"skipped": result.skipped,
                          "reads": result.n_reads,
                          "species_groups": sum(len(s)
                                                for s in result.species),
                          "consensus": path}))
    elif args.cmd == "clean":
        from .pipeline.stages import stage_clean
        cfg = PipelineConfig(adapters, device=device,
                             clean_e_rate=args.error_rate,
                             match_read_wildcards=args.match_read_wildcards)
        clean, rep = stage_clean(args.input, args.outdir, args.barcode,
                                 args.amplicon, cfg)
        print(json.dumps({"total": rep.total, "trimmed": rep.trimmed,
                          "failsafe_dropped": rep.failsafe_dropped}))
    elif args.cmd == "rrna":
        from .io.fastq import read_fasta, read_records
        from .rrna.extract import extract_rrna
        from .rrna.hmm import parse_hmmer3
        kw = {}
        if args.exemplars_18s:
            kw["exemplars_18s"] = [r.seq for r in
                                   read_fasta(args.exemplars_18s)]
        if args.exemplars_28s:
            kw["exemplars_28s"] = [r.seq for r in
                                   read_fasta(args.exemplars_28s)]
        if args.cm:
            from .rrna.cm import parse_cm, profiles_by_gene
            bygene = profiles_by_gene(parse_cm(args.cm))
            if "18S" in bygene:
                kw["profile_18s"] = bygene["18S"]
            if "28S" in bygene:
                kw["profile_28s"] = bygene["28S"]
        elif args.hmm:
            models = {m.name: m for m in parse_hmmer3(args.hmm)}
            for name, m in models.items():
                if "18" in name:
                    kw["profile_18s"] = m
                if "28" in name:
                    kw["profile_28s"] = m
        hits = extract_rrna(list(read_records(args.input)), args.outdir,
                            args.barcode, device=device, **kw)
        print(json.dumps({g: len(h) for g, h in hits.items()}))
    elif args.cmd == "run-all":
        from .pipeline.stages import run_all
        cfg = PipelineConfig(adapters, device=device,
                             rrna_hmm=args.rrna_hmm,
                             rrna_cm=args.rrna_cm,
                             rrna_exemplars_18s=args.exemplars_18s,
                             rrna_exemplars_28s=args.exemplars_28s,
                             bin_workers=args.bin_workers)
        rep = run_all(args.input, args.outdir, args.dataset, args.amplicon,
                      cfg=cfg)
        print(json.dumps(rep, default=str))
    return 0


def _entry():
    try:
        return main()
    except FileNotFoundError as e:
        print(f"tpu_orc_torch: error: file not found: {e.filename or e}",
              file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"tpu_orc_torch: error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(_entry())
