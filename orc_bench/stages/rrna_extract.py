"""Stage 05a, one sample at a time: ``stage_rrna`` on each sample's cleaned
contigs with the configuration's HMMER3 file (``PipelineConfig.rrna_hmm``,
barrnap ``-k euk --incseq``), on the card, as ``run_all`` calls it once
a bin and as the reference pipeline runs one SLURM task a sample.

Set-up draws the models from the seed and writes them as one HMMER3/f
file (``gen_euk.write_hmmer3``), makes the pool of samples
(``gen_euk.contig_pool``), and runs one sample through the stage to load
the kernel and its two instances. The window feeds the pool's samples
in turn, on one thread, closed loop: each sample's contigs written as
its cleaned FASTA (sample and contig names new on each pass), then one
``stage_rrna`` call, which reads the model file, scans both genes and
writes ``rRNA_genes/<sample>_{18S,28S}.fa`` and ``barrnap_outs/``. Once
``--seconds`` have passed no new sample starts, so the window ends at a
sample's end. ``demux_reads_per_s`` is every contig the stage consumed
over the window. A traced run records the program's spans and counters
over the window into ``layer["program"]``, and counts the Viterbi cells
the window's contigs need (``viterbi_cells``: each contig's length by
the scanned profiles' nodes, both strands, forward and reversed scans).

The check, against :mod:`orc_bench.reference.barrnap` in float64 on the
card after the window: every consumption of the checked pool samples,
read back from the files the window wrote, and the scores the stage
returned. ``records_wrong``: gene FASTA records whose header (strand,
interval) or sequence differs; ``gff_wrong``: GFF3 rows and combined
FASTA records that differ (the score column, one decimal on both
sides, within the tolerance and 0.1 for the two roundings);
``scores_off``: hits whose score is further from the reference's best
on that strand than the tolerance; ``sample_short``: consumptions
checked short of ``samples_checked_min``. The tolerance is
``score_rel_tol`` times the score (at least 1): float32 rounds each of
the scan's adds to its last bit, so its gap to float64 grows with the
score's size. One difference is allowed, and only it: float32 against
float64 may move a hit's end (or its start, the reversed scan's end) to
another position whose reference score lies within the tolerance of
the best, since the first of two near-equal positions can swap under
rounding; the record must then be the contig's slice at the program's
interval.

The check's control (a sound float32 variant: the D->D prefix summed
in a running order instead of the program's blocked one) and the
planted faults run through the cell's own window and check, on the
card, from this module's own command:

    python3 -m orc_bench.stages.rrna_extract --workload rrna.extract \\
        --seeds A,B,C --control --seconds 10
    python3 -m orc_bench.stages.rrna_extract --workload rrna.extract \\
        --seeds A,B,C --fault FAULT --seconds 10
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np

from .. import gen, gen_euk
from ..faults import patched
from ..reference import barrnap as ref
from ..reference import files
from ..run import (HERE, ROOT, Ctx, Outcome, cache_env, measure, memory_peak,
                   note, read_json, run_cell, sync, tree_bytes)

#: the program's spans that the device's idle gaps are put down to
INNER = ("rrna.model", "rrna.pack", "rrna.viterbi", "rrna.hits",
         "rrna.write")
OUTER = ("rrna.extract",)
GENES = ("18S", "28S")


def scanned_nodes(cfg: Dict) -> int:
    """The nodes of the profiles ``stage_rrna`` scans (18S and 28S)."""
    K = {m["name"]: int(m["leng"]) for m in cfg["models"]}
    return sum(K[cfg["genes"][g]] for g in GENES)


def write_sample(path: str, names: List[str], contigs: List[str]) -> None:
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in zip(names, contigs)))


def run(ctx: Ctx) -> Outcome:
    from tpu_orc_torch.pipeline.stages import PipelineConfig, stage_rrna
    from tpu_orc_torch.utils.profiling import recording

    cfg, mix = ctx.cfg, ctx.mix
    hmm_path = os.path.join(ctx.workdir, "euk.hmm")
    models = gen_euk.euk_models(ctx.seed, cfg)
    gen_euk.write_hmmer3(hmm_path, models)
    pool = gen_euk.contig_pool(ctx.seed, cfg, mix, models)
    P = len(pool.samples)
    note(ctx, f"models {[(m.name, m.K) for m in models]} and a pool of {P} "
         f"samples, {sum(map(len, pool.samples))} contigs made")
    pcfg = PipelineConfig(ctx.workdir, device=ctx.device, rrna_hmm=hmm_path)
    nodes = scanned_nodes(cfg)
    # both strands, the forward and the reversed scan, each gene's nodes
    cells = [4 * nodes * sum(len(c) for c in s) for s in pool.samples]
    in_dir = os.path.join(ctx.workdir, "cleaned")
    out_dir = os.path.join(ctx.workdir, "out")
    os.makedirs(in_dir)
    got: Dict[int, Dict[str, List[tuple]]] = {}
    consumed = [0, 0]                      # samples, contigs
    program: Dict = {}

    def one(k: int, outdir: str, tag: str = "s") -> None:
        i = k % P
        bc = f"{tag}{k // P}_{i:02d}"
        path = os.path.join(in_dir, f"{bc}.fasta")
        with ctx.spans.span("feed"):
            write_sample(path, [f"{bc}_c{j}" for j in
                                range(len(pool.samples[i]))],
                         pool.samples[i])
        ctx.spans.count("viterbi_cells", cells[i])
        hits = stage_rrna(path, outdir, bc, pcfg)
        got[k] = {g: [(h.contig_id, h.strand, float(h.score))
                      for h in hits.get(g, [])] for g in GENES}

    def loop(t0):
        k = 0
        while True:
            one(k, out_dir)
            consumed[0] = k + 1
            consumed[1] += len(pool.samples[k % P])
            k += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                return

    def window(t0):
        if not ctx.trace:
            loop(t0)
            return
        with recording() as rec:
            loop(t0)
        program.update(rec.as_dict())

    warm = os.path.join(ctx.workdir, "warm")
    for k in range(int(mix["warm_samples"])):
        one(k, warm, "w")
    got.clear()
    sync(ctx)
    shutil.rmtree(warm)
    note(ctx, f"warm-up of {mix['warm_samples']} sample(s) done")
    _, secs, setup_s, layer = measure(ctx, window, INNER, OUTER)
    peak = memory_peak(ctx)
    if ctx.trace:
        layer["program"] = program
        note(ctx, "program counters " + json.dumps(
            program.get("counters", {}), sort_keys=True))
        note(ctx, "program spans " + json.dumps(
            {k: [v["n"], round(v["total_s"], 4), round(v["self_s"], 4),
                 v["parent"]] for k, v in program.get("spans", {}).items()},
            sort_keys=True))
    n, n_contigs = consumed
    note(ctx, f"{n} samples, {n_contigs} contigs consumed; files written: "
         f"{tree_bytes(out_dir)} bytes")
    checks, failed = check(ctx, pool, hmm_path, n, out_dir, got)
    return Outcome({"demux_reads_per_s": n_contigs / secs,
                    "setup_s": setup_s}, n_contigs, failed, checks, peak,
                   layer)


def checked_samples(ctx: Ctx, P: int) -> np.ndarray:
    """The pool samples the check follows, sorted."""
    rng = gen.rng_for(ctx.seed, 33)
    return np.sort(rng.choice(P, min(int(ctx.mix["check_samples"]), P),
                              replace=False))


def _parse_header(h: str) -> Tuple[str, int, int, str]:
    """(contig, start, end, strand) of a record's header,
    ``<gene>_rRNA::<contig>:<s>-<e>(<strand>)``."""
    body = h.split("::", 1)[1]
    contig, iv = body.rsplit(":", 1)
    se, strand = iv[:-3], iv[-2]
    s, e = se.split("-")
    return contig, int(s), int(e), strand


def _accepted(gene, name, contig, g: ref.GeneScans, c: int, want, rec,
              rel: float):
    """The hit the program's record ``rec`` (its header) is held to: the
    reference's ``want``, or ``want`` at the program's interval where
    float32 may have moved its end or start (module docstring).
    Returns (hit, moved)."""
    if want is None or rec is None:
        return want, False
    _, s, e, strand = _parse_header(rec)
    if strand != want.strand or (s, e) == (want.start, want.end):
        return want, False
    n = len(contig)
    qs, qe = (s, e) if strand == "+" else (n - e, n - s)
    k = 2 * c + (strand == "-")
    near = lambda sc, j: (1 <= j <= n and sc.row[k, j - 1]
                          >= sc.best[k] - rel * max(1.0, abs(sc.best[k])))
    if qs < qe and near(g.fwd, qe) and near(g.rev, n - qs):
        return ref.place(gene, name, contig, strand, qs, qe, want.score), True
    return want, False


def check(ctx: Ctx, pool, hmm_path: str, n: int, out_dir: str,
          got: Dict[int, Dict[str, List[tuple]]]):
    """Every consumption of the checked samples against the reference."""
    cfg, lim = ctx.cfg, ctx.limits
    rel = float(lim["score_rel_tol"])
    tol = lambda x: rel * max(1.0, abs(x))
    min_score = float(cfg["min_score"])
    P = len(pool.samples)
    idx = checked_samples(ctx, P)
    contigs, first = [], {}
    for i in idx.tolist():
        first[i] = len(contigs)
        contigs += pool.samples[i]
    profiles = ref.read_hmmer3(hmm_path)
    t0 = time.perf_counter()
    scans = {g: ref.scan_gene(profiles[cfg["genes"][g]], contigs, ctx.device)
             for g in GENES}
    note(ctx, f"reference done: {len(contigs)} contigs of {len(idx)} "
         f"samples, {time.perf_counter() - t0:.3f} s")
    genes_dir = os.path.join(out_dir, "rRNA_genes")
    rec_wrong = gff_wrong = off = moved = checked = 0
    gaps: List[float] = []
    bad = set()
    for k in range(n):
        i = k % P
        if i not in first:
            continue
        checked += 1
        bc = f"s{k // P}_{i:02d}"
        names = [f"{bc}_c{j}" for j in range(len(pool.samples[i]))]
        hits_all = []
        for g in GENES:
            sc = scans[g]
            fa = files.fasta(os.path.join(genes_dir, f"{bc}_{g}.fa"))
            by_contig: Dict[str, List[str]] = {}
            for h in fa:
                by_contig.setdefault(_parse_header(h)[0], []).append(h)
            exp = []
            w0 = rec_wrong
            for j, (name, seq) in enumerate(zip(names, pool.samples[i])):
                c = first[i] + j
                want = ref.hit_of(g, name, seq, sc, c, min_score)
                mine = by_contig.pop(name, [])
                acc, mv = _accepted(g, name, seq, sc, c, want,
                                    mine[0] if len(mine) == 1 else None, rel)
                moved += mv
                exp_rec = [] if acc is None else [ref.header(acc)]
                if mine != exp_rec or any(fa[h] != acc.seq for h in mine):
                    rec_wrong += max(len(mine), len(exp_rec))
                    bad.add((k, j))
                if acc is not None:
                    exp.append(acc)
            for hs in by_contig.values():         # contigs it never had
                rec_wrong += len(hs)
                bad.add((k, -1))
            if rec_wrong == w0 and list(fa) != [ref.header(h) for h in exp]:
                rec_wrong += 1                     # the order alone
                bad.add((k, -1))
            hits_all += exp
            for contig, strand, score in got.get(k, {}).get(g, []):
                j = names.index(contig) if contig in names else None
                if j is None:
                    off += 1
                    continue
                kk = 2 * (first[i] + j) + (strand == "-")
                want = float(sc.fwd.best[kk])
                d = abs(score - want)
                gaps.append(d / max(1.0, abs(want)))
                if d > tol(want):
                    off += 1
                    bad.add((k, j))
        rows, comb = ref.sidecars(hits_all)
        bdir = os.path.join(genes_dir, "barrnap_outs")
        with open(os.path.join(bdir, f"{bc}_euk.gff3")) as fh:
            lines = fh.read().splitlines()
        w = int(not lines or lines[0] != "##gff-version 3")
        mine = [ln.split("\t") for ln in lines[1:]]
        w += abs(len(mine) - len(rows))
        for a, b in zip(mine, rows):
            if (len(a) != len(b) or a[:5] + a[6:] != b[:5] + b[6:]
                    or abs(float(a[5]) - float(b[5]))
                    > tol(float(b[5])) + 0.1):
                w += 1
        cfa = list(files.fasta(os.path.join(bdir, f"{bc}_euk.fa")).items())
        w += abs(len(cfa) - len(comb)) + sum(a != b for a, b in zip(cfa, comb))
        gff_wrong += w
        if w:
            bad.add((k, -2))
    if bad:
        note(ctx, f"first wrong consumptions: {sorted(bad)[:5]}")
    med = float(np.median(gaps)) if gaps else 0.0
    note(ctx, f"checked {checked} consumptions of {len(idx)} samples; "
         f"|score - reference| / score: largest {max(gaps, default=0):.6g}, "
         f"median {med:.6g}; ends moved within the tolerance {moved}")
    checks = {
        "records_wrong": {"value": rec_wrong, "limit": lim["records_wrong"]},
        "gff_wrong": {"value": gff_wrong, "limit": lim["gff_wrong"]},
        "scores_off": {"value": off, "limit": lim["scores_off"]},
        "sample_short": {"value": max(int(lim["samples_checked_min"])
                                      - checked, 0), "limit": 0}}
    return checks, len(bad)


# -- the control and the planted faults -----------------------------------

def control():
    """A sound float32 variant in the program's place: the D->D prefix S
    as a running float32 sum, not the program's blocked order. The check
    must pass it."""
    from tpu_orc_torch.rrna import hmm

    def dd_prefix(trans):
        dd = np.maximum(np.asarray(trans, np.float32)[:, 6],
                        np.float32(hmm.DD_FLOOR))
        return np.concatenate([np.zeros(1, np.float32),
                               np.cumsum(dd[:-1], dtype=np.float32)])
    return patched(hmm, "dd_prefix", dd_prefix)


def _rounded(dtype):
    """The Viterbi's tables and scores rounded to ``dtype`` (the -1e9 of
    an impossible transition kept)."""
    import torch
    from tpu_orc_torch.rrna import hmm
    orig = hmm.viterbi_tiles

    def r(x):
        return torch.where(x.abs() < 6e4, x.to(dtype).to(torch.float32), x)

    def tiles(match_s, trans, S, seqs, lens):
        best, pos, node = orig(r(match_s), r(trans), r(S), seqs, lens)
        return r(best), pos, node
    return patched(hmm, "viterbi_tiles", tiles)


def half_scores():
    """The scan in half precision: its tables and scores as float16."""
    import torch
    return _rounded(torch.float16)


def bf16_scores():
    """The scan's tables and scores as bfloat16."""
    import torch
    return _rounded(torch.bfloat16)


def reference_fp16():
    """The reference's own scan computed in float16, the precision below
    the program's float32, in the program's place."""
    import torch
    from tpu_orc_torch.rrna import hmm

    def tiles(match_s, trans, S, seqs, lens):
        p = ref.Profile("p", match_s.double().cpu().numpy(),
                        trans.double().cpu().numpy())
        n = lens.cpu().numpy()
        sq = [r[:k] for r, k in zip(seqs.cpu().numpy(), n)]
        sc = ref.viterbi(p, sq, seqs.device, torch.float16)
        put = lambda x, dt: torch.as_tensor(x, dtype=dt, device=seqs.device)
        return (put(sc.best, torch.float32), put(sc.end, torch.int32),
                torch.zeros_like(lens))
    return patched(hmm, "viterbi_tiles", tiles)


def no_reversed_scan():
    """The reversed scan left out: its ends read as the sequences'
    lengths, so every start is 0."""
    from tpu_orc_torch.rrna import extract
    orig = extract.viterbi_scan
    calls = [0]

    def scan(profile, seqs, lens, device="cuda"):
        calls[0] += 1
        out = orig(profile, seqs, lens, device)
        if calls[0] % 2 == 0:                  # each gene's second scan
            return out[0], np.asarray(lens, np.int32).copy(), out[2]
        return out
    return patched(extract, "viterbi_scan", scan)


def models_swapped():
    """The 18S and 28S models' names exchanged where the file is read."""
    from tpu_orc_torch.rrna import hmm
    orig = hmm.parse_hmmer3
    swap = {"18S_rRNA": "28S_rRNA", "28S_rRNA": "18S_rRNA"}

    def parse(path):
        ms = orig(path)
        for m in ms:
            m.name = swap.get(m.name, m.name)
        return ms
    return patched(hmm, "parse_hmmer3", parse)


def last_contig_dropped():
    """Each sample's last contig left out where its FASTA is read."""
    from tpu_orc_torch.pipeline import stages
    orig = stages.read_records
    return patched(stages, "read_records",
                   lambda path: list(orig(path))[:-1])


FAULTS = {"half_scores": half_scores, "bf16_scores": bf16_scores,
          "reference_fp16": reference_fp16,
          "no_reversed_scan": no_reversed_scan,
          "models_swapped": models_swapped,
          "last_contig_dropped": last_contig_dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m "
                                 "orc_bench.stages.rrna_extract")
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
            with control() if args.control else FAULTS[args.fault]():
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
