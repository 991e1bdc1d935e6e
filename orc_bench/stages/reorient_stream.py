"""Stage 01 as a stream: ``reorient_stream`` over a pool of raw reads, with
its defaults (as ``pipeline/stages.py::stage_reorient`` runs it through
``reorient_file``: 65,536-read blocks, 2,048-read INFIX scan batches, q
autotuned on the first block, four uncompressed FASTQ files and the
stats), on the configuration's locate kernel.

Set-up writes the configuration's primers (``gen_raw.pychopper_primers``)
and makes the read pool (the mix's, from the seed), then streams the
pool's first ``warm_reads`` reads through the stage to load the kernels
and warm every scan shape. The window feeds the pool, read ids made
unique on each pass, block after block; once ``--seconds`` have passed
no new block starts, so the stream ends at a block boundary, and the
window ends when the stage has written its files and stats.
``demux_reads_per_s`` is every raw read the stage consumed over the
whole window: pychopper is the front end of the dual-index demux. A
traced run records the program's spans and counters over the window
into ``layer["program"]``.

The check, against :mod:`orc_bench.reference.pychopper`: a sample of
the pool drawn from the seed, every time the window consumed it, read
back from the files the window wrote (its route, the files it landed in,
and every record it came out as, exactly); the window's tuned q against
the reference's own autotune on the same first 500 kept reads; and the
window's stats and files against the reads it consumed (every read in
some file once, each file's record count and the low-quality count as
the stats say).

The check's control (the reference with one scan in the program's
place) and planted faults run through the cell's own window and check,
on the card, from this module's own command (``orc_bench/control.py``
and ``faults.py`` look stages up in tables of their own):

    python3 -m orc_bench.stages.reorient_stream --workload rrna.reorient \\
        --seeds A,B,C --control --seconds 1
    python3 -m orc_bench.stages.reorient_stream --workload rrna.reorient \\
        --seeds A,B,C --fault FAULT --seconds S
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from .. import gen, gen_raw, peaks
from ..faults import patched
from ..reference import files
from ..reference import pychopper as ref
from ..run import (HERE, ROOT, Ctx, Outcome, cache_env, measure, memory_peak,
                   note, read_json, run_cell, sync, tree_bytes)

NAME = "bench"
#: the program's spans that the device's idle gaps are put down to
INNER = ("reorient.input", "reorient.qfilter", "reorient.autotune",
         "reorient.scan", "reorient.fetch", "reorient.classify",
         "reorient.enumerate", "reorient.schedule", "reorient.segment",
         "reorient.write", "reorient.finish")


class Capture:
    """Wraps the stage's locate dispatch (``locate_batch_lazy``): in a
    traced window, counts the INFIX work the contract needs for each scan
    (first pass, autotune and enumeration alike): every read's own length
    by every primer's length, 16 operations a cell; each read byte in
    once and the 8 int32 outputs of every (read, primer) out once."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx

    def installed(self, D):
        orig = D.locate_batch_lazy
        cap = self

        def lazy(bank, seqs, *a, **kw):
            cap.take(bank, seqs)
            return orig(bank, seqs, *a, **kw)

        return patched(D, "locate_batch_lazy", lazy)

    def take(self, bank, seqs) -> None:
        sp = self.ctx.spans
        if not (sp.active and self.ctx.trace):
            return
        bases = sum(len(s) for s in seqs)
        sp.count("locate_ops", bases * int(np.sum(bank.lens))
                 * peaks.OPS_PER_LOCATE_CELL)
        sp.count("locate_bytes", bases + 8 * 4 * len(bank.lens) * len(seqs))


def write_primers(path: str, bank_seed: int) -> List[tuple]:
    primers = gen_raw.pychopper_primers(bank_seed)
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in primers))
    return primers


def run(ctx: Ctx) -> Outcome:
    # a program without the stream entry fails here, before any work
    from tpu_orc_torch.demux.reorient import ReorientConfig, reorient_stream
    os.environ["TPU_ORC_LOCATE_IMPL"] = ctx.cfg["locate_impl"]
    from tpu_orc_torch.align import locate as LOC
    from tpu_orc_torch.demux import demux as D
    from tpu_orc_torch.io.fastq import Record
    from tpu_orc_torch.utils.profiling import recording
    LOC.LOCATE_IMPL = ctx.cfg["locate_impl"]

    cfg, mix = ctx.cfg, ctx.mix
    pfa = os.path.join(ctx.workdir, "M13_seqs_for_pychopper.fa")
    primers = write_primers(pfa, cfg["bank_seed"])
    rcfg = ReorientConfig(qmin=cfg["qmin"], device=ctx.device)
    # the program's own block; a mix may name a smaller one (the tests'
    # tiny runs on the CPU)
    block = int(mix.get("block", inspect.signature(
        reorient_stream).parameters["stream_block"].default))
    pool = gen_raw.raw_pool(ctx.seed, cfg, mix)
    P = len(pool.seqs)
    note(ctx, f"pool of {P} raw reads made")
    cap = Capture(ctx)
    out_dir = os.path.join(ctx.workdir, "pychopped")
    consumed = [0]
    starts: List[float] = []
    program: Dict = {}

    def stream(t0):
        k = 0
        while True:
            if k % block == 0:
                starts.append(time.perf_counter() - t0)
                if starts[-1] >= ctx.seconds:
                    return
            i = k % P
            rid = f"s{k // P}_{i}"
            yield Record(rid, rid, pool.seqs[i], pool.quals[i])
            k += 1
            consumed[0] = k

    def window(t0):
        with ctx.spans.span("stream"):
            if not ctx.trace:
                reorient_stream(stream(t0), pfa, cfg["orientation_config"],
                                out_dir, NAME, rcfg, block)
                return
            with recording() as rec:
                reorient_stream(stream(t0), pfa, cfg["orientation_config"],
                                out_dir, NAME, rcfg, block)
            program.update(rec.as_dict())

    with cap.installed(D):
        warm = os.path.join(ctx.workdir, "warm")
        n_warm = min(int(mix["warm_reads"]), P)
        reorient_stream((Record(f"w_{i}", f"w_{i}", pool.seqs[i],
                                pool.quals[i]) for i in range(n_warm)),
                        pfa, cfg["orientation_config"], warm, NAME, rcfg,
                        block)
        sync(ctx)
        shutil.rmtree(warm)
        note(ctx, f"warm-up of {n_warm} reads done")
        _, secs, setup_s, layer = measure(ctx, window, INNER, ["stream"])
    peak = memory_peak(ctx)
    if ctx.trace:
        layer["program"] = program
        note(ctx, "program counters " + json.dumps(program["counters"],
                                                   sort_keys=True))
        note(ctx, "program spans " + json.dumps(
            {k: [v["n"], round(v["total_s"], 4), round(v["self_s"], 4),
                 v["parent"]] for k, v in program["spans"].items()},
            sort_keys=True))
    n = consumed[0]
    note(ctx, "blocks started at " + " ".join(f"{t:.2f}" for t in starts))
    note(ctx, f"files written: {tree_bytes(out_dir)} bytes")
    checks, failed = check(ctx, pool, primers, n, out_dir, block)
    return Outcome({"demux_reads_per_s": n / secs, "setup_s": setup_s},
                   n, failed, checks, peak, layer)


def sample(ctx: Ctx, P: int) -> np.ndarray:
    """The pool indices the check follows, sorted."""
    rng = gen.rng_for(ctx.seed, 7)
    return np.sort(rng.choice(P, min(int(ctx.mix["check_reads"]), P),
                              replace=False))


def chopper(ctx: Ctx, primers) -> ref.Pychopper:
    """The reference at the configuration's settings."""
    cfg = ctx.cfg
    return ref.Pychopper(primers, cfg["orientation_config"],
                         qmin=cfg["qmin"], min_len=cfg["min_len"],
                         max_segments=cfg["max_segments"],
                         autotune_sample=cfg["autotune_sample"],
                         device=ctx.device, block=int(ctx.mix["check_block"]))


def reference(ctx: Ctx, primers, pool, idx: np.ndarray, block: int):
    """(q the reference tunes on the window's first block, the records
    each pool read ``idx[k]`` comes out as, the pool's low-quality
    flags); records are named by the read's pool index."""
    cfg = ctx.cfg
    ch = chopper(ctx, primers)
    low = ref.mean_q(pool.quals) < cfg["qmin"]
    first = [pool.seqs[i].upper()
             for i in range(min(block, len(pool.seqs))) if not low[i]]
    q = ch.autotune(first) if cfg["q"] is None else cfg["q"]
    reads = [(str(i), pool.seqs[i], pool.quals[i]) for i in idx.tolist()]
    return q, ch.run(reads, q), low


def check(ctx: Ctx, pool, primers, n: int, out_dir: str, block: int):
    """Every sampled read the window consumed, each time it did, against
    the reference; the tuned q; the stats and files against the reads
    consumed."""
    P = len(pool.seqs)
    idx = sample(ctx, P)
    q, want, low = reference(ctx, primers, pool, idx, block)
    note(ctx, f"reference done: q {q}")
    want_of = dict(zip(idx.tolist(), want))
    got: Dict[str, List[tuple]] = {}
    ids = set()
    per_file = {}
    for f in ref.FILES:
        c = 0
        for h, s, qu in files.fastq(os.path.join(out_dir,
                                                 f"{NAME}_{f}.fastq")):
            c += 1
            rid = h.split("|", 1)[0]
            ids.add(rid)
            if int(rid.rsplit("_", 1)[1]) in want_of:
                got.setdefault(rid, []).append((f, h, s, qu))
        per_file[f] = c
    stats = {}
    with open(os.path.join(out_dir, f"{NAME}_stats.out")) as fh:
        for ln in fh:
            k, v = ln.split("\t")
            stats[k] = int(v)
    wrong_route = wrong_rec = checked = 0
    bad = set()
    for k in range(n):     # every consumption of a sampled read
        i = k % P
        w = want_of.get(i)
        if w is None:
            continue
        rid = f"s{k // P}_{i}"
        exp = sorted((f, f"s{k // P}_" + h, s, qu) for f, h, s, qu in w)
        g = sorted(got.get(rid, []))
        checked += 1
        if ref.route(g) != ref.route(exp):
            wrong_route += 1
        if g != exp:
            if wrong_rec < 3:
                note(ctx, f"read {rid}: program {_short(g)} reference "
                     f"{_short(exp)}")
            wrong_rec += 1
            bad.add(rid)
    keys = {"pass": "pass", "rescued": "rescued_segments",
            "unclass": "unclass", "short": "short"}
    low_consumed = (n // P) * int(low.sum()) + int(low[:n % P].sum())
    unaccounted = (abs(stats.get("total", 0) - n) + abs(len(ids) - n)
                   + sum(abs(per_file[f] - stats.get(keys[f], 0))
                         for f in ref.FILES)
                   + abs(stats.get("low_q", 0) - low_consumed))
    # q tuned by the window (its stats' line) against the reference's
    tuned = stats.get("autotuned_q_x100")
    q_ok = tuned == (int(round(q * 100)) if ctx.cfg["q"] is None else None)
    lim = ctx.limits
    checks = {
        "routes_wrong": {"value": wrong_route, "limit": lim["routes_wrong"]},
        "records_wrong": {"value": wrong_rec, "limit": lim["records_wrong"]},
        "q_wrong": {"value": int(not q_ok), "limit": lim["q_wrong"]},
        "reads_unaccounted": {"value": unaccounted,
                              "limit": lim["reads_unaccounted"]},
        "sample_short": {"value": max(int(lim["reads_checked_min"])
                                      - checked, 0), "limit": 0}}
    note(ctx, f"checked {checked} consumptions of {len(idx)} sampled reads;"
         f" stats {stats}; files {per_file}")
    return checks, len(bad)


def _short(recs) -> str:
    """Records cut to their names, files and lengths, for a log line."""
    return str([(f, h, len(s)) for f, h, s, _ in recs])


# -- the control and the planted faults -----------------------------------

def control(ctx: Ctx):
    """The reference with rule 8 broken in the program's place: each
    block ``Reorienter.run`` takes is decided by the reference with one
    scan and no masked re-scan (``control_max_segments`` 1), so a fused
    read's interior primers stay shadowed; q tuned by the reference's own
    autotune. The window writes its files and stats as ever, and the
    cell's check compares them."""
    from tpu_orc_torch.demux import reorient as R
    from tpu_orc_torch.io.fastq import Record
    cfg = ctx.cfg
    ch = chopper(ctx, gen_raw.pychopper_primers(cfg["bank_seed"]))
    rounds = int(ctx.mix["control_max_segments"])

    def run_(self, records):
        records = list(records)
        out = R.ReorientResult()
        st = out.stats
        low = ref.mean_q([r.qual for r in records]) < cfg["qmin"]
        if self.q is None:
            self.q = ch.autotune([r.seq.upper() for r, lo in
                                  zip(records, low) if not lo])
            st["autotuned_q_x100"] = int(round(self.q * 100))
        recs = ch.run([(r.id, r.seq, r.qual) for r in records], self.q,
                      rounds)
        lists = {"pass": out.passed, "rescued": out.rescued,
                 "unclass": out.unclass, "short": out.short}
        for r in recs:
            for f, h, sq, qu in r:
                lists[f].append(Record(h, h, sq, qu))
        st.update({"total": len(records), "pass": len(out.passed),
                   "rescued_segments": len(out.rescued),
                   "fused_reads": sum(len(r) > 1 for r in recs),
                   "unclass": len(out.unclass), "short": len(out.short),
                   "low_q": int(low.sum())})
        return out
    return patched(R.Reorienter, "run", run_)


def half_block():
    """``Reorienter.run`` decides the first half of each block only."""
    from tpu_orc_torch.demux import reorient as R
    orig = R.Reorienter.run

    def run_(self, records, *a, **kw):
        records = list(records)
        return orig(self, records[: (len(records) + 1) // 2], *a, **kw)
    return patched(R.Reorienter, "run", run_)


def multiplicity_dropped():
    """The locate's multiplicity outputs (``nloc``, ``nacc``) read as 0
    where they are fetched, so every read looks complete and no fused
    read is enumerated."""
    from tpu_orc_torch.demux import demux as D
    orig = D.locate_batch_collect

    def collect(handle):
        res = orig(handle)
        return res._replace(nloc=np.zeros_like(res.nloc),
                            nacc=np.zeros_like(res.nacc))
    return patched(D, "locate_batch_collect", collect)


def answer_altered():
    """Every 31st read's best SP5 location starts one base later where it
    is fetched."""
    from tpu_orc_torch.demux import demux as D
    orig = D.locate_batch_collect

    def collect(handle):
        res = orig(handle)
        qs = np.array(res.querystart, copy=True)
        qs[::31, 0] += 1
        return res._replace(querystart=qs)
    return patched(D, "locate_batch_collect", collect)


FAULTS = {"half_block": half_block,
          "multiplicity_dropped": multiplicity_dropped,
          "answer_altered": answer_altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m "
                                 "orc_bench.stages.reorient_stream")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = read_json(ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = read_json(HERE, "configs", f"{cell['config']}.json")
    mix = read_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = read_json(HERE, "limits", f"{args.workload}.json")
    cache_env()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed}
        work = tempfile.mkdtemp(prefix="orc_bench_")
        try:
            ctx = Ctx(args.workload, seed, args.seconds, False, cfg, mix,
                      limits, work, device=args.device)
            with control(ctx) if args.control else FAULTS[args.fault]():
                out = run_cell(ctx)
            line.update(fault="control" if args.control else args.fault,
                        correct=out.correct,
                        checks={k: c["value"]
                                for k, c in out.checks.items()})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
