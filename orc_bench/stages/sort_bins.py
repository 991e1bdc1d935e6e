"""Stage 03, one bin a task: ``pipeline/stages.py::stage_sort`` on
demultiplexed bins, one after another, with the default
``SorterConfig`` (amplicon_sorter's CLI defaults), as one task of the
reference's SLURM array runs one bin.

Set-up makes a pool of bins from the seed (two species a bin) and writes
each as a gzipped FASTQ under the run's work directory, then sorts a
small bin of the cell's read length to load the kernels and the native
library. The window starts a bin while ``--seconds`` have not passed;
it ends when the last bin started has written its files.
``sort_reads_per_s`` is the reads of every bin the window ran over the
whole window.

The check, on every bin the window ran: a sample of the gene stage's
read pairs, drawn from the seed, half among the pairs the program kept
and half among all that its length gate let through, scored by
:func:`orc_bench.reference.nw.similarities` (the program must keep
exactly those at or above ``similar_genes``, with the same similarity);
the species groups written, against the species each read was made
from; and each group's consensus, against the amplicon of its species.
The groups and consensuses are judged by the planted species, not by a
second run of amplicon_sorter's ladder: only the similarities are
recomputed by the reference.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import os
import sys
import time
from typing import Dict, List

import numpy as np

from .. import gen, peaks
from ..reference import files, nw
from ..faults import patched
from ..run import (Ctx, Outcome, measure, memory_peak, note, sync,
                   tree_bytes)

PREFIX = "bench"


def _gate(lens: np.ndarray, band: float) -> np.ndarray:
    """The gene stage's pairs: upper triangle, lengths within ``band``."""
    n = len(lens)
    lo = np.minimum.outer(lens, lens)
    hi = np.maximum.outer(lens, lens)
    return (np.arange(n)[:, None] < np.arange(n)[None, :]) & \
        (lo * band >= hi)


class Capture:
    """Wraps the public calls into ``DeviceScorer``: times them, keeps
    the gene stage's answers per bin, and (traced) counts the Myers work
    they were given."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.bin = None
        self.gene: Dict[int, list] = {}

    def installed(self, S):
        """Patch the scorer's public calls while the block runs."""
        cap = self
        orig_all = S.DeviceScorer.allvsall_effective_sims
        orig_rvc = S.DeviceScorer.reads_vs_consensus_sims

        def allvsall(sc, codes_list, band=1.05, keep_threshold=0.80):
            with cap.ctx.spans.span("scorer"):
                hits = orig_all(sc, codes_list, band, keep_threshold)
            if cap.ctx.spans.active:
                lens = np.array([len(c) for c in codes_list])
                cap.gene.setdefault(cap.bin, []).append(
                    (lens, hits.i.copy(), hits.j.copy(), hits.sim.copy()))
                if cap.ctx.trace:
                    g = _gate(lens, band)
                    cap.myers(lens[:, None], lens[None, :], g)
            return hits

        def rvc(sc, read_codes, cons_codes, band=1.05):
            with cap.ctx.spans.span("scorer"):
                out = orig_rvc(sc, read_codes, cons_codes, band)
            if cap.ctx.trace and cap.ctx.spans.active:
                rl = np.array([len(c) for c in read_codes])[:, None]
                cl = np.array([len(c) for c in cons_codes])[None, :]
                g = np.minimum(rl, cl) * band >= np.maximum(rl, cl)
                cap.myers(cl + 0 * rl, rl + 0 * cl, g)
            return out

        stack = contextlib.ExitStack()
        stack.enter_context(patched(S.DeviceScorer,
                                    "allvsall_effective_sims", allvsall))
        stack.enter_context(patched(S.DeviceScorer,
                                    "reads_vs_consensus_sims", rvc))
        return stack

    def myers(self, plen: np.ndarray, tlen: np.ndarray, gate: np.ndarray):
        """Count the Myers work of the gated (pattern, text) pairs: text
        length x pattern words, 20 int32 operations a word step; bytes:
        both sequences in once (a byte a base) and a distance out."""
        pl, tl = np.broadcast_arrays(plen, tlen)
        w = -(-pl[gate] // peaks.WORD_BITS)
        steps = float((tl[gate] * w).sum())
        sp = self.ctx.spans
        sp.count("myers_ops", steps * peaks.OPS_PER_MYERS_WORD_STEP)
        sp.count("myers_bytes", float((pl[gate] + tl[gate]).sum()
                                      + 4 * gate.sum()))


def _write_bin(path: str, b: gen.SortBin) -> None:
    with gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write("".join(f"@{i}\n{s}\n+\n{q}\n"
                         for i, s, q in zip(b.ids, b.seqs, b.quals)))


def run(ctx: Ctx) -> Outcome:
    from tpu_orc_torch.cluster import scoring as S
    from tpu_orc_torch.cluster.engine import SorterConfig
    from tpu_orc_torch.pipeline.stages import PipelineConfig, stage_sort

    cfg, mix = ctx.cfg, ctx.mix
    n_pool = int(mix["pool_bins"])
    bins = gen.sort_bins(ctx.seed, cfg, mix, n_pool)
    bin_dir = os.path.join(ctx.workdir, "bins")
    os.makedirs(bin_dir)
    paths = []
    for k, b in enumerate(bins):
        paths.append(os.path.join(bin_dir, f"bin{k:03d}_{PREFIX}.fastq.gz"))
        _write_bin(paths[-1], b)
    note(ctx, f"{n_pool} bins made and written")
    pcfg = PipelineConfig(adapters_dir=ctx.workdir, device=ctx.device,
                          sorter=SorterConfig(**cfg["sorter"]))
    cap = Capture(ctx)
    with cap.installed(S):

        # warm-up: a small bin of the cell's read length
        wmix = dict(mix, reads_per_bin=int(mix["warm_reads"]))
        warm = gen.sort_bins(ctx.seed, cfg, wmix, 1, first=n_pool)[0]
        wpath = os.path.join(bin_dir, f"warm_{PREFIX}.fastq.gz")
        _write_bin(wpath, warm)
        stage_sort(wpath, os.path.join(ctx.workdir, "warm"), "warm", PREFIX,
                   pcfg)
        sync(ctx)
        note(ctx, "warm-up bin sorted")

        out_dir = os.path.join(ctx.workdir, "out")
        ran: List[int] = []
        starts: List[float] = []

        def window(t0):
            for k in range(n_pool):
                starts.append(time.perf_counter() - t0)
                if starts[-1] >= ctx.seconds:
                    break
                cap.bin = k
                with ctx.spans.span("bin"):
                    stage_sort(paths[k], out_dir, f"bin{k:03d}", PREFIX, pcfg)
                ran.append(k)

        _, secs, setup_s, layer = measure(ctx, window, ["scorer"], ["bin"])
        if len(ran) == n_pool:
            print(f"orc_bench: the window used all {n_pool} bins of the pool",
                  flush=True, file=sys.stderr)
    peak = memory_peak(ctx)
    note(ctx, "bins started at " + " ".join(f"{t:.2f}" for t in starts))
    note(ctx, f"files written: {tree_bytes(ctx.workdir)} bytes")
    reads = sum(len(bins[k].ids) for k in ran)
    checks, failed = check(ctx, bins, ran, cap.gene, out_dir)
    return Outcome({"sort_reads_per_s": reads / secs, "setup_s": setup_s},
                   len(ran), failed, checks, peak, layer)


def gene_reads(b: gen.SortBin, sorter: Dict) -> List[int]:
    """The bin's reads in the order of the sorter's gene-stage block:
    those of at least ``min_length`` bases, by length (stable). One block
    while the bin holds no more than ``sub_block`` reads."""
    keep = [k for k, s in enumerate(b.seqs) if len(s) >= sorter["min_length"]]
    if len(keep) > sorter["sub_block"]:
        raise ValueError("a bin of more than one gene-stage block")
    return sorted(keep, key=lambda k: len(b.seqs[k]))


def check(ctx: Ctx, bins: List[gen.SortBin], ran: List[int],
          gene: Dict[int, list], out_dir: str):
    sorter = ctx.cfg["sorter"]
    sg = float(sorter["similar_genes"])
    rng = gen.rng_for(ctx.seed, 11)
    per_bin = int(ctx.mix["check_pairs_per_bin"])
    pa: List[str] = []
    pb: List[str] = []
    prog: List[float] = []   # the program's similarity, or -1: not kept
    owner: List[int] = []
    bad_bins = set()
    for k in ran:
        b = bins[k]
        order = gene_reads(b, sorter)
        calls = gene.get(k, [])
        lens = np.array([len(b.seqs[r]) for r in order])
        if len(calls) != 1 or not np.array_equal(calls[0][0], lens):
            # the program scored another block than the bin's reads
            bad_bins.add(k)
            continue
        _, hi, hj, hs = calls[0]
        kept = {(int(i), int(j)): float(s) for i, j, s in zip(hi, hj, hs)}
        gi, gj = np.nonzero(_gate(lens, 1.05))
        half = per_bin // 2
        pick = list(rng.choice(len(hi), min(half, len(hi)), replace=False)) \
            if len(hi) else []
        pairs = [(int(hi[t]), int(hj[t])) for t in pick]
        pairs += [(int(gi[t]), int(gj[t])) for t in
                  rng.choice(len(gi), min(per_bin - len(pairs), len(gi)),
                             replace=False)]
        for i, j in pairs:
            pa.append(b.seqs[order[i]])
            pb.append(b.seqs[order[j]])
            prog.append(kept.get((i, j), -1.0))
            owner.append(k)
    ref = nw.similarities(pa, pb, device=ctx.device)
    sim_wrong = 0
    for k, p, r in zip(owner, prog, ref):
        want = float(r) if r >= sg else -1.0
        if p != want:
            sim_wrong += 1
            bad_bins.add(k)
    # species groups and their consensuses, as written
    misgrouped = missed = 0
    ca: List[str] = []
    cb: List[str] = []
    cown: List[int] = []
    for k in ran:
        b = bins[k]
        species = dict(zip(b.ids, b.species.tolist()))
        found = set()
        for path in glob.glob(os.path.join(out_dir, "sorted",
                                           f"bin{k:03d}",
                                           f"bin{k:03d}_*_*.fasta")):
            recs = files.fasta(path)
            cons = recs.pop("consensus", "")
            sp = [species.get(h.split(" ", 1)[0], -1) for h in recs]
            if not sp:
                continue
            top = max(set(sp), key=sp.count)
            wrong = sum(s != top for s in sp)
            misgrouped += wrong
            if wrong:
                bad_bins.add(k)
            found.add(top)
            ca.append(cons)
            cb.append(b.planted[top])
            cown.append(k)
        n_missed = len(b.planted) - len(found)
        missed += n_missed
        if n_missed:
            bad_bins.add(k)
    edits = nw.distances(ca, cb, device=ctx.device) if ca else np.zeros(0)
    worst = int(edits.max()) if len(edits) else 0
    lim = ctx.limits
    for k, e in zip(cown, edits):
        if e > lim["consensus_edits"]:
            bad_bins.add(k)
    short = max(int(lim["pairs_checked_min"]) - len(prog), 0)
    checks = {"sims_wrong": {"value": sim_wrong,
                             "limit": lim["sims_wrong"]},
              "reads_misgrouped": {"value": misgrouped,
                                   "limit": lim["reads_misgrouped"]},
              "species_missed": {"value": missed,
                                 "limit": lim["species_missed"]},
              "consensus_edits": {"value": worst,
                                  "limit": lim["consensus_edits"]},
              "sample_short": {"value": short, "limit": 0}}
    return checks, len(bad_bins)
