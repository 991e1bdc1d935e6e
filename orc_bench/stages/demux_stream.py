"""Stage 02 as a stream: ``dual_round_demux_stream`` over a pool of raw
reads, with its defaults (as ``pipeline/stages.py::stage_demux`` calls
it: 16,384-read chunks, the fused dual-round demux in 2,048-read
``assign`` calls, gzipped FASTQ bins).

Set-up makes the banks (the configuration's) and the read pool (the
traffic mix's, from the seed) and runs one chunk through the stream to
load the kernels. The window feeds the pool, read ids made unique on
each pass, chunk after chunk; once ``--seconds`` have passed no new
chunk starts, and the window ends when the stream has written its last
bin and report. ``demux_reads_per_s`` is every read the stream consumed
over the whole window.

The check: a sample of the pool drawn from the seed, every time the
window consumed it. Each such read's round-1 and round-2 decisions, as
``FusedDemux.assign`` returned them, and its records in the round-1 and
final bin files, against :func:`orc_bench.reference.cutadapt.decide`.
"""
from __future__ import annotations

import glob
import os
import shutil
import time
from typing import Dict, List

import numpy as np

from .. import gen, peaks
from ..reference import cutadapt, files
from ..faults import patched
from ..run import (Ctx, Outcome, measure, memory_peak, note, sync,
                   tree_bytes)

DATASET = "bench"
INVALID = ("SP27_009", "SP27_010", "SP27_011", "SP27_012")


class Capture:
    """Wraps ``FusedDemux.assign``: times it, keeps the decisions of the
    sampled reads, and (traced) counts the locate work it was given."""

    def __init__(self, ctx: Ctx, pool_size: int, sampled: np.ndarray,
                 banks: Dict):
        self.ctx = ctx
        self.P = pool_size
        self.sampled = sampled            # [P] bool
        self.offset = 0
        self.got: Dict[int, list] = {}    # pool index -> decisions
        # adapters and their bases, SP5 then SP27-rc
        self.n_ad = (len(banks["sp5"]), len(banks["sp27rc"]))
        self.bases = (sum(len(s) for _, s in banks["sp5"]),
                      sum(len(s) for _, s in banks["sp27rc"]))

    def installed(self, F):
        """Patch ``FusedDemux.assign`` while the block runs."""
        orig = F.FusedDemux.assign
        cap = self

        def assign(fd, records, *a, **kw):
            with cap.ctx.spans.span("assign"):
                out = orig(fd, records, *a, **kw)
            cap.take(records, out)
            return out

        return patched(F.FusedDemux, "assign", assign)

    def take(self, records, out) -> None:
        n = len(records)
        if not self.ctx.spans.active:
            return
        pos = self.offset + np.arange(n)
        idx = pos % self.P
        for r in np.flatnonzero(self.sampled[idx]).tolist():
            if r >= len(out):      # no decision came back for the read
                self.got.setdefault(int(idx[r]), []).append(
                    (records[r].id,) + (None,) * 6)
                continue
            _, s5, t1, s27, fin, rc1, _, rc2, _ = out[r]
            self.got.setdefault(int(idx[r]), []).append(
                (records[r].id, s5, bool(rc1), s27, bool(rc2),
                 (t1.desc, t1.seq, t1.qual), (fin.desc, fin.seq, fin.qual)))
        self.offset += n
        if self.ctx.trace:
            # the locate's work as the contract needs it: round 1 every
            # read and its complement against every SP5 adapter, round 2
            # every read round 1 kept, trimmed, against every SP27 one
            kept = [len(t[2].seq) for t in out if t[1] is not None]
            l1, l2 = sum(len(r.seq) for r in records), sum(kept)
            cells = 2 * (l1 * self.bases[0] + l2 * self.bases[1])
            sp = self.ctx.spans
            sp.count("locate_ops", cells * peaks.OPS_PER_LOCATE_CELL)
            # each read byte in once, fwd and rc, and the 5 int32 outputs
            # of every alignment out once
            nb = 2 * (l1 + l2) + 2 * 5 * 4 * (n * self.n_ad[0]
                                              + len(kept) * self.n_ad[1])
            sp.count("locate_bytes", nb)


def _records(pool: gen.Pool, Record, start: int, n: int, tag: str):
    P = len(pool.seqs)
    return [Record(f"{tag}_{k % P}", f"{tag}_{k % P}", pool.seqs[k % P],
                   pool.quals[k % P]) for k in range(start, start + n)]


def run(ctx: Ctx) -> Outcome:
    os.environ["TPU_ORC_LOCATE_IMPL"] = ctx.cfg["locate_impl"]
    from tpu_orc_torch.align import locate as LOC
    from tpu_orc_torch.demux import fused as F
    from tpu_orc_torch.demux.adapters import AdapterBank
    from tpu_orc_torch.demux.demux import dual_round_demux_stream
    from tpu_orc_torch.io.fastq import Record
    LOC.LOCATE_IMPL = ctx.cfg["locate_impl"]

    cfg, mix = ctx.cfg, ctx.mix
    b = gen.banks(cfg["bank_seed"])
    sp5 = AdapterBank.from_pairs(b["sp5"], cfg["e_rate"], ctx.device)
    sp27 = AdapterBank.from_pairs(b["sp27rc"], cfg["e_rate"], ctx.device)
    pool = gen.demux_pool(ctx.seed, cfg, mix)
    P = len(pool.seqs)
    note(ctx, f"pool of {P} reads made")
    chunk = int(mix["chunk"])
    rng = gen.rng_for(ctx.seed, 7)
    sampled = np.zeros(P, bool)
    sampled[rng.choice(P, min(int(mix["check_reads"]), P),
                       replace=False)] = True
    cap = Capture(ctx, P, sampled, b)
    out_dir = os.path.join(ctx.workdir, "demuxed")
    consumed = [0]
    starts: List[float] = []

    def stream(t0):
        k = 0
        while True:
            if k % chunk == 0:
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
            return dual_round_demux_stream(stream(t0), sp5, sp27, DATASET,
                                           out_dir, chunk_size=chunk)

    with cap.installed(F):
        # warm-up: one chunk of the cell's own reads through the stream
        warm = os.path.join(ctx.workdir, "warm")
        dual_round_demux_stream(_records(pool, Record, 0, chunk, "w"), sp5,
                                sp27, DATASET, warm, chunk_size=chunk)
        sync(ctx)
        shutil.rmtree(warm)
        note(ctx, "warm-up chunk done")
        _, secs, setup_s, layer = measure(ctx, window, ["assign"],
                                            ["stream"])
    peak = memory_peak(ctx)
    n = consumed[0]
    note(ctx, "chunks started at " + " ".join(f"{t:.2f}" for t in starts))
    note(ctx, f"files written: {tree_bytes(ctx.workdir)} bytes")
    checks, failed = check(ctx, pool, b, cap.got, out_dir)
    return Outcome({"demux_reads_per_s": n / secs, "setup_s": setup_s},
                   n, failed, checks, peak, layer)


def check(ctx: Ctx, pool: gen.Pool, b: Dict, got: Dict[int, list],
          out_dir: str):
    """Every sampled read the window consumed, each time it did, against
    the reference: its decisions, and its records in the bins."""
    dev = ctx.device
    idx = sorted(got)
    reads = [(f"x_{i}", pool.seqs[i], pool.quals[i]) for i in idx]
    sp5 = [s for _, s in b["sp5"]]
    sp27 = [s for _, s in b["sp27rc"]]
    ref = cutadapt.decide_blocks(reads, sp5, sp27, e=ctx.cfg["e_rate"],
                                 min_overlap=ctx.cfg["min_overlap"],
                                 device=dev,
                                 block=int(ctx.mix.get("check_block", 4096)))
    n5 = [n for n, _ in b["sp5"]]
    n27 = [n for n, _ in b["sp27rc"]]
    want: Dict[str, tuple] = {}
    wrong_dec = 0
    bad_ids = set()
    for i, d in zip(idx, ref):
        for rid, s5, rc1, s27, rc2, t1, fin in got[i]:
            if t1 is None:         # no decision came back for the read
                wrong_dec += 1
                bad_ids.add(rid)
                want[rid] = expect(rid, d, n5, n27)
                continue
            # a flag is an answer only where its round found an adapter
            prog = (s5, rc1 and s5 is not None, s27,
                    rc2 and s27 is not None, t1, fin)
            exp = expect(rid, d, n5, n27)
            if prog != exp:
                if wrong_dec < 3:
                    note(ctx, f"read {i} {rid}: program {_short(prog)}"
                         f" reference {_short(exp)}")
                wrong_dec += 1
                bad_ids.add(rid)
            want[rid] = exp
    # what the bins hold for the sampled ids
    seen: Dict[str, List[tuple]] = {}
    keep = want.__contains__
    for path in glob.glob(os.path.join(out_dir, "SP5", "*.fastq.gz")) + \
            glob.glob(os.path.join(out_dir, "SP27", "*.fastq.gz")):
        for rec in files.fastq(path, keep):
            seen.setdefault(rec[0].split(" ", 1)[0], []).append(
                (os.path.basename(path),) + rec)
    wrong_rec = 0
    for rid, (e5, _, e27, _, et1, efin) in want.items():
        exp = []
        if e5:
            exp.append((f"{e5}_{DATASET}.fastq.gz",) + et1)
            if e27 and e27 not in INVALID:
                exp.append((f"{e27}_{e5}_{DATASET}.fastq.gz",) + efin)
        if sorted(seen.get(rid, [])) != sorted(exp):
            wrong_rec += 1
            bad_ids.add(rid)
    short = max(int(ctx.limits["reads_checked_min"]) - len(want), 0)
    lim = ctx.limits
    checks = {"decisions_wrong": {"value": wrong_dec,
                                  "limit": lim["decisions_wrong"]},
              "records_wrong": {"value": wrong_rec,
                                "limit": lim["records_wrong"]},
              "sample_short": {"value": short, "limit": 0}}
    return checks, len(bad_ids)


def _short(dec) -> str:
    """A decision with its records cut to their ends, for a log line."""
    cut = lambda r: (r[0], len(r[1]), r[1][:12], r[1][-12:])
    return str(tuple(dec[:4]) + (cut(dec[4]), cut(dec[5])))


def expect(rid: str, d: cutadapt.Decision, n5, n27) -> tuple:
    """The read's decision as ``FusedDemux.assign`` reports it: (SP5
    name, rc, SP27 name, rc, round-1 record, final record), a record as
    (header, sequence, quality)."""
    if d.sp5 is None:
        t1 = (rid,) + d.trimmed1[1:]
        return (None, False, None, False, t1, t1)
    h1 = rid + (" rc" if d.rc1 else "")
    t1 = (h1,) + d.trimmed1[1:]
    if d.sp27 is None:
        return (n5[d.sp5], d.rc1, None, False, t1, t1)
    fin = (h1 + (" rc" if d.rc2 else ""),) + d.final[1:]
    return (n5[d.sp5], d.rc1, n27[d.sp27], d.rc2, t1, fin)
