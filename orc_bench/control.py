"""The controls and the planted faults of the cells' correctness checks,
run on the card at a cell's own size (never by the benchmark's own runs):

    python3 -m orc_bench.control --workload NAME --seeds A,B,C --control
    python3 -m orc_bench.control --workload NAME --seeds A,B,C \
        --fault FAULT --seconds S

``--control`` puts the reference, with one guarantee of the
configuration broken, in the program's place and compares it as the
check compares the program: for the demux cells the decisions of the
sampled reads under the mix's ``control_e_rate`` (half of ``-e 0.1``:
the error budget that a locate banded to fewer diagonals would keep)
instead of the configuration's; for the sort cells the similarities of sampled
gene-stage pairs rounded to the mix's ``control_decimals`` (2: whole
percent, as an int8 store of them would keep) instead of
amplicon_sorter's 3. ``--fault`` runs
the cell with a fault of ``orc_bench/faults.py`` planted under its timed
path. One JSON line per seed: the numbers compared, as the check prints
them.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np

from . import faults, gen
from .reference import cutadapt, nw
from .run import HERE, ROOT, Ctx, cache_env, read_json, run_cell


def demux_control(seed: int, cfg, mix, device) -> dict:
    """The sampled reads as a run draws them, decided by the control and
    by the reference."""
    pool = gen.demux_pool(seed, cfg, mix)
    rng = gen.rng_for(seed, 7)
    idx = np.sort(rng.choice(len(pool.seqs), int(mix["check_reads"]),
                             replace=False))
    b = gen.banks(cfg["bank_seed"])
    reads = [(f"x_{i}", pool.seqs[i], pool.quals[i]) for i in idx]
    args = dict(min_overlap=cfg["min_overlap"], device=device,
                block=int(mix.get("check_block", 4096)))
    sp5 = [s for _, s in b["sp5"]]
    sp27 = [s for _, s in b["sp27rc"]]
    ref = cutadapt.decide_blocks(reads, sp5, sp27, e=cfg["e_rate"], **args)
    ctl = cutadapt.decide_blocks(reads, sp5, sp27,
                                 e=float(mix["control_e_rate"]), **args)
    return {"decisions_wrong": sum(a != c for a, c in zip(ref, ctl)),
            "reads": len(reads)}


def sort_control(seed: int, cfg, mix, device, bins: int) -> dict:
    """Sampled gene-stage pairs of the first ``bins`` bins (as many as a
    run sorts), scored exactly and by the banded control."""
    from .stages.sort_bins import _gate, gene_reads
    rng = gen.rng_for(seed, 11)
    pa, pb = [], []
    for b in gen.sort_bins(seed, cfg, mix, bins):
        order = gene_reads(b, cfg["sorter"])
        lens = np.array([len(b.seqs[r]) for r in order])
        gi, gj = np.nonzero(_gate(lens, 1.05))
        for t in rng.choice(len(gi), int(mix["check_pairs_per_bin"]),
                            replace=False):
            pa.append(b.seqs[order[gi[t]]])
            pb.append(b.seqs[order[gj[t]]])
    d = nw.distances(pa, pb, device=device)
    longer = np.maximum([len(x) for x in pa], [len(y) for y in pb])
    ref = np.round(1.0 - d / longer, 3)
    ctl = np.round(1.0 - d / longer, int(mix["control_decimals"]))
    sg = float(cfg["sorter"]["similar_genes"])
    # the program's answer is the similarity where it is kept, else none
    ans = lambda s: np.where(s >= sg, s, -1.0)
    return {"sims_wrong": int((ans(ref) != ans(ctl)).sum()),
            "pairs": len(pa)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m orc_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--bins", type=int, default=9,
                    help="sort cells: bins to sample, as many as a run sorts")
    args = ap.parse_args(argv)
    bench = read_json(ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = read_json(HERE, "configs", f"{cell['config']}.json")
    mix = read_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = read_json(HERE, "limits", f"{args.workload}.json")
    cache_env()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed}
        if args.control:
            line["control"] = (
                demux_control(seed, cfg, mix, "cuda")
                if mix["stage"] == "demux_stream" else
                sort_control(seed, cfg, mix, "cuda", args.bins))
        else:
            work = tempfile.mkdtemp(prefix="orc_bench_")
            try:
                ctx = Ctx(args.workload, seed, args.seconds, False, cfg, mix,
                          limits, work)
                with faults.FAULTS[mix["stage"]][args.fault]():
                    out = run_cell(ctx)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            line.update(fault=args.fault, correct=out.correct,
                        checks={k: c["value"] for k, c in out.checks.items()})
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
