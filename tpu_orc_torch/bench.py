"""The port's bench: ``bench.py``'s measurements of the system, made by
``tpu_orc_torch`` on one CUDA card.

    python3 -m tpu_orc_torch.bench            # every section, its own reps
    python3 -m tpu_orc_torch.bench --reps 1   # at most 1 timed rep a section

It keeps ``bench.py``'s sections, input generators, sizes and JSON keys
(``bench.py`` lines below). The banks come from :mod:`.synthetic`
(seeded and clearly synthetic: the real adapter files are not in the
repo), written to ``build/bench/`` under the checkout, which also holds
the plate's work files. Sections, in order:

 0. banks: SP5 and SP27-rc at e 0.1 on the card (:336-339);
 1. demux: 16,384 reads SP5[i % 12] + 260 random bp + SP27[i % 8], odd
    reads reverse-complemented, through ``FusedDemux.assign`` in chunks
    of 2,048 (:341-391): the wavefront locate kernel, FRONT and BACK;
 2. its baseline: the C++ oracle on one core, FRONT then BACK, on 128 of
    those reads and their reverse complements, over >= 2 s (:393-411);
 3. cluster tile: 1,024 x 1,024 Myers NW at L 512 (one 480 bp base, 30
    substitutions a copy), one call, then 6 calls all launched before
    any is fetched, every result fetched before the clock stops
    (:413-472): the dense Myers kernel;
 4. its baseline: ``native.all_vs_all`` on 192 of them, one core, over
    >= 2 s (:474-485);
 5. sort: a 1,000-read two-species COI bin through ``AmpliconSorter``
    (its default scorer, the Myers kernels), warmed once, 3 timed reps
    (:487-525, :591-598);
 6. multi-device overhead on one card: ``decide`` against
    ``decide_multi`` on ``["cuda:0"]`` over the first 2,048 demux reads,
    and the tile against ``device_parallel_pairwise`` (:600-636);
 7. reorient: 8,192 reads of the pychopper primers (N filled) around a
    380 bp insert, every 3rd reverse-complemented, every 17th its insert
    only, through ``Reorienter`` at q 0.75 (the locate kernel, INFIX),
    and its one-core INFIX baseline on 128 reads (:547-578, :638-677);
 8. long-read sort: 1,000 reads of ~3.5 kb, two templates, warmed on 256
    of them, 2 timed reps (:527-545, :693-706);
 9. plate: 96 bins (12 x 8) x 80 reads through ``run_all`` (COI), after
    a 3 x 2 x 20-read warm-up plate, min of 2 runs (:256-318, :708-758).

Timing: every rep ends in a fetch to the host or in
``torch.cuda.synchronize()``, so the host clock is the right clock, and
every section is timed after a warm-up call of the same shapes. The
kernels' build is set-up, timed on its own (``build_s``). A headline is
the min over the timed reps, with the median and the rep count beside
it. The product sections use the host's cores (``ORC_THREADS`` as the
caller set it); only the baselines pass ``nthreads=1``.

The last line of standard output is ``bench.py``'s JSON line
(``bench.py:865-937``), with ``details.backend`` ``"cuda"``,
``details.device`` (the card's name and power limit as ``nvidia-smi``
gives them, the card count, the CPU count), ``details.launches`` (each
section's kernel launches over its timed reps, from the wrappers'
counters, by counter and device) and ``details.correct``, from checks
that trust none of the code under test: every demux read in the bin it
was built for; 64 sampled tile entries equal to ``native.edit_distance``
(NW); both sorts find 2 species; the plate finds every bin and one
species group a bin. A failed check exits 1 (the line is printed). With
no CUDA device the bench exits 2 and prints no line. No section is
skipped, set to null or run on another backend: a section that raises
fails the run. ``--reps`` cuts rep counts, never sizes.

Not ported (relay and compile workarounds for the TPU, or comparisons
with a TPU's numbers):

- the relay-resilience layer: adaptive reps (``bench.py:141``),
  ``guarded_warmup`` children and ``--warmup-only`` (:209-250,
  :329-335), sweep passes 2 and 3 (:679-691, :828-840), the late rescue
  (:760-826), the XLA and native fallbacks with ``compile_fallbacks``
  (:383-388, :458-464, :590-593) and ``.jax_cache`` (:40-43); with them
  go the keys only they fill (``compile_fallbacks``,
  ``*_bestpass_dispersion``), and each section takes ``bench.py``'s
  least rep count;
- the regression gate against ``BENCH_r*.json`` (:939-999): those are a
  TPU's numbers and are never compared with the card's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, native, synthetic
from .align import batched, locate, myers, pileup
from .align.spec import BACK, FRONT, Flag
from .io import encode
from .io.fastq import Record, read_fasta, write_records
from .rrna import hmm

WORK = os.path.join(os.path.dirname(_build._PKG), "build", "bench")
BANK_SEED = 5          # the adapter directory's and the plate's banks
CPU_WINDOW_S = 2.0     # each one-core baseline repeats for >= this long
#: timed reps of each section: bench.py's least count (its adaptive reps
#: and sweep passes are not ported)
REPS = {"demux": 5, "cluster1": 6, "cluster": 4, "sort": 3,
        "md_demux_1": 4, "md_demux_m": 4, "md_pw_1": 4, "md_pw_m": 4,
        "reorient": 4, "longsort": 2, "plate": 2}
#: the wrappers' launch counters, by kernel
COUNTERS = {"locate": locate.LAUNCHES, "myers": myers.LAUNCHES,
            "pileup": pileup.LAUNCHES, "batched": batched.LAUNCHES,
            "viterbi": hmm.LAUNCHES}
TILE_SAMPLE = 64       # tile entries held against native.edit_distance
INFIX = int(Flag.START_WITHIN_SEQ2 | Flag.STOP_WITHIN_SEQ2)
ACGT = list("ACGT")


def note(msg: str) -> None:
    """Progress on stderr: stdout carries only the JSON line."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Inputs (bench.py's generators; one numpy Generator, seed 0, feeds the
# demux reads, the tile and the reorient reads in that order)
# ---------------------------------------------------------------------------

def demux_reads(sp5_seqs: Sequence[str], sp27_seqs: Sequence[str], rng,
                n: int) -> List[Record]:
    """bench.py:344-357: SP5[i % 12] + 260 random bp + SP27[i % 8], odd
    reads reverse-complemented."""
    recs = []
    for i in range(n):
        s = (sp5_seqs[i % 12] + "".join(rng.choice(ACGT, size=260))
             + sp27_seqs[i % 8])
        if i % 2:
            s = encode.revcomp(s)
        recs.append(Record(f"r{i}", f"r{i}", s, "I" * len(s)))
    return recs


def tile_codes(rng, n: int):
    """bench.py:416-428: ``n`` copies of one random 480 bp base, each with
    30 random substitutions. Returns (codes list, [n, 512] uint8 codes
    padded with 4, [n] int32 lengths)."""
    base = "".join(rng.choice(ACGT, size=480))
    fam = []
    for _ in range(n):
        s = list(base)
        for _ in range(30):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(ACGT))
        fam.append(encode.encode_codes("".join(s)))
    pat = np.full((n, 512), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i, c in enumerate(fam):
        pat[i, :len(c)] = c
        lens[i] = len(c)
    return fam, pat, lens


def reorient_reads(primers: Dict[str, str], rng, n: int) -> List[Record]:
    """bench.py:556-569: the pychopper primers SP5 and SP27 (each N drawn
    anew) around a 380 bp insert, every 3rd read (i % 3 == 1)
    reverse-complemented, every 17th only its insert."""
    fill = lambda p: "".join(c if c != "N" else str(rng.choice(ACGT))
                             for c in p)
    recs = []
    for i in range(n):
        ins = "".join(rng.choice(ACGT, size=380))
        p5 = fill(primers["SP5"])
        p27 = fill(primers["SP27"])
        s = p5 + ins + encode.revcomp(p27)
        if i % 3 == 1:
            s = encode.revcomp(s)
        if i % 17 == 0:
            s = ins
        recs.append(Record(f"q{i}", f"q{i}", s, "I" * len(s)))
    return recs


def _mutate(rnd: random.Random, s: str, k: int) -> str:
    """bench.py:493-504: ``k`` random substitutions, deletions or
    insertions."""
    s = list(s)
    for _ in range(k):
        op = rnd.randrange(3)
        p = rnd.randrange(len(s))
        if op == 0:
            s[p] = rnd.choice("ACGT")
        elif op == 1 and len(s) > 1:
            del s[p]
        else:
            s.insert(p, rnd.choice("ACGT"))
    return "".join(s)


def sort_reads(per_template: int, seed: int = 2, length: int = 450,
               template_edits: int = 60, read_edits: int = 27,
               prefix: str = "r") -> List[Record]:
    """bench.py:491-512 (the COI bin, these defaults) and :528-535 (the
    long-read bin, :func:`long_reads`): two templates ``template_edits``
    apart, ``per_template`` reads of each with ``read_edits`` edits,
    shuffled."""
    rnd = random.Random(seed)
    t1 = "".join(rnd.choice("ACGT") for _ in range(length))
    t2 = _mutate(rnd, t1, template_edits)
    recs = [Record(f"{prefix}{k}_{i}", "", _mutate(rnd, t, read_edits), None)
            for k, t in enumerate((t1, t2)) for i in range(per_template)]
    rnd.shuffle(recs)
    return recs


def long_reads(per_template: int, length: int, template_edits: int,
               read_edits: int) -> List[Record]:
    """The long-read bin of bench.py:528-535 (seed 5; bench.py's sizes:
    3,500 bp, 450 and 200 edits)."""
    return sort_reads(per_template, 5, length, template_edits, read_edits,
                      "L")


@dataclass(frozen=True)
class Sizes:
    """The sizes of a run: bench.py's by default (``main`` never changes
    them; the CPU tests pass small ones)."""
    demux_reads: int = 16384
    chunk: int = 2048
    demux_cpu_reads: int = 128
    tile: int = 1024
    pipe: int = 6
    tile_cpu: int = 192
    sort_per_template: int = 500
    long_per_template: int = 500
    long_read: Tuple[int, int, int] = (3500, 450, 200)  # length, edits
    long_warm: int = 256
    reorient_reads: int = 8192
    reorient_cpu_reads: int = 128
    plate: Tuple[int, int, int] = (80, 12, 8)   # reads a bin, n5, n27
    plate_warm: Tuple[int, int, int] = (20, 3, 2)


# ---------------------------------------------------------------------------
# Checks (independent of the code under test)
# ---------------------------------------------------------------------------

def demux_wrong(decisions, names5: Sequence[str],
                names27: Sequence[str]) -> int:
    """Reads of (index, SP5 name, SP27 name) not in (SP5[i % 12],
    SP27[i % 8]), the bin :func:`demux_reads` built them for."""
    return sum((n5, n27) != (names5[i % 12], names27[i % 8])
               for i, n5, n27 in decisions)


def tile_sample(n: int, k: int = TILE_SAMPLE, seed: int = 1) -> np.ndarray:
    """[k, 2] (pattern, text) indices of the tile entries checked."""
    return np.random.default_rng(seed).integers(0, n, size=(k, 2))


def tile_wrong(dist: np.ndarray, fam) -> int:
    """Sampled tile entries that differ from the C++ oracle's NW
    distance."""
    return sum(int(dist[i, j]) != native.edit_distance(fam[i], fam[j], "NW")
               for i, j in tile_sample(len(fam)))


# ---------------------------------------------------------------------------
# Timing and counting
# ---------------------------------------------------------------------------

def summary(ts: Sequence[float]):
    """(min, median, dispersion (max - min) / median) of rep times."""
    med = float(np.median(ts))
    return float(min(ts)), med, (max(ts) - min(ts)) / med if med > 0 else 0.0


def cpu_window(fn: Callable, min_s: float):
    """Repeat ``fn`` until >= ``min_s`` of wall clock; (seconds, calls)."""
    t0 = time.perf_counter()
    n = 0
    while True:
        fn()
        n += 1
        el = time.perf_counter() - t0
        if el >= min_s:
            return el, n


def launch_counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """{kernel: {device: {key: launches}}} since the last reset, non-zero
    counts only."""
    out = {}
    for name, c in COUNTERS.items():
        per = {d: {k: n for k, n in keys.items() if n}
               for d, keys in c.by_device().items()}
        per = {d: keys for d, keys in per.items() if keys}
        if per:
            out[name] = per
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info(device: str) -> Dict:
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 0,
                "cpu_count": os.cpu_count()}
    name, limit = (f.strip() for f in card_line().rsplit(",", 1))
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi_name": name,
            "power_limit": limit, "count": torch.cuda.device_count(),
            "cpu_count": os.cpu_count()}


class Bench:
    """One run of the sections on ``device``. Each section method takes
    its inputs and sizes as arguments (``run`` passes bench.py's), fills
    ``details`` with its numbers and ``out`` with what the checks read.
    ``reps`` caps every section's timed reps; ``cpu_window_s`` is each
    baseline's least window."""

    def __init__(self, device: str = "cuda", reps: Optional[int] = None,
                 cpu_window_s: float = CPU_WINDOW_S, work: str = WORK):
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.max_reps = reps
        self.cpu_window_s = cpu_window_s
        self.work = work
        self.details: Dict = {}
        self.launches: Dict = {}
        self.times: Dict[str, List[float]] = {}
        self.out: Dict = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def timed(self, name: str, fn: Callable) -> List[float]:
        """Wall seconds of each timed rep of ``fn`` (warmed up by the
        caller), the device synchronised around each; the launches of
        the reps go to ``launches[name]``."""
        for c in COUNTERS.values():
            c.reset()
        reps = REPS[name] if self.max_reps is None else min(REPS[name],
                                                            self.max_reps)
        ts = []
        for r in range(reps):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            ts.append(time.perf_counter() - t0)
            note(f"  {name} rep {r + 1}/{reps}: {ts[-1]:.3f} s")
        self.launches[name] = launch_counts()
        self.times[name] = ts
        return ts

    def put(self, key: str, ts: Sequence[float]) -> float:
        """``{key}_median_s``, ``{key}_reps`` and ``{key}_dispersion`` of
        rep times ``ts`` into ``details``; returns their min."""
        mn, med, disp = summary(ts)
        self.details.update({f"{key}_median_s": med, f"{key}_reps": len(ts),
                             f"{key}_dispersion": disp})
        return mn

    # -- sections -----------------------------------------------------------
    def banks(self):
        """Section 0: the adapter directory and the SP5 / SP27-rc banks."""
        from .demux.adapters import AdapterBank
        d = synthetic.write_adapter_dir(os.path.join(self.work, "adapters"),
                                        seed=BANK_SEED)
        f = lambda k: os.path.join(d, synthetic.FILES[k])
        return (d, AdapterBank.from_fasta(f(0), 0.1, self.device),
                AdapterBank.from_fasta(f(1), 0.1, self.device))

    def demux(self, sp5, sp27, recs: Sequence[Record], chunk: int):
        """Section 1: ``FusedDemux.assign`` over ``recs`` in chunks of
        ``chunk``. Returns the FusedDemux (section 6 reuses it)."""
        from .demux.fused import FusedDemux, _pick_len
        fd = FusedDemux(sp5, sp27)
        self.out["demux_names"] = (sp5.names, sp27.names)

        def once():
            self.out["demux"] = [(o[0], o[1], o[3]) for o in
                                 fd.assign(recs, batch_size=chunk)]

        note(f"demux: warm-up, {len(recs)} reads")
        once()
        t = self.put("demux", self.timed("demux", once))
        self.details.update(
            demux_batch=len(recs), demux_chunk=chunk, demux_min_s=t,
            demux_reads_per_s=len(recs) / t,
            demux_len=_pick_len(max(len(r.seq) for r in recs[:chunk]), 256))
        return fd

    def demux_cpu(self, sp5, sp27, recs: Sequence[Record], n: int):
        """Section 2: the C++ oracle on one core, FRONT (SP5) then BACK
        (SP27-rc), on ``n`` reads and their reverse complements."""
        ref5 = [encode.encode_ref_masks(s) for s in sp5.seqs]
        ref27 = [encode.encode_ref_masks(s) for s in sp27.seqs]
        seqs = [r.seq for r in recs[:n]]
        qm = [encode.encode_read_masks(s)
              for s in seqs + [encode.revcomp(s) for s in seqs]]

        def once():
            native.locate_batch(ref5, qm, 0.1, int(FRONT), nthreads=1)
            native.locate_batch(ref27, qm, 0.1, int(BACK), nthreads=1)

        note("demux: one-core baseline window")
        t, calls = cpu_window(once, self.cpu_window_s)
        rps = calls * n / t   # n reads a call, each scanned both ways
        dev = self.details["demux_reads_per_s"]
        self.details.update(
            cpu_demux_reads_per_s_1core=rps, cpu_demux_windows=[rps],
            cpu_demux_window_s=t, vs_ref_24core=dev / (rps * 24))

    def cluster(self, fam, pat, lens, pipe: int):
        """Section 3: the all-vs-all Myers NW tile, one call (fetched), then
        ``pipe`` calls launched before any is fetched."""
        run = lambda lazy: myers.distances(pat, lens, pat, lens, "NW",
                                           device=self.device,
                                           fetch_pos=False, lazy=lazy)[0]

        def one():
            self.out["tile"] = run(False)

        def sustained():
            for d in [run(True) for _ in range(pipe)]:
                d.cpu()

        self.out["tile_codes"] = fam
        note(f"cluster: warm-up, {len(fam)} x {len(fam)} tile")
        one()
        t1 = self.put("cluster_single_dispatch", self.timed("cluster1", one))
        ts = self.put("cluster", self.timed("cluster", sustained))
        n = len(fam)
        cells = float(n) * n * float(np.mean(lens)) ** 2
        self.details.update(
            timing=("min over the timed reps after a warm-up; cluster "
                    f"headline = sustained window of {pipe} pipelined "
                    "launches, every result fetched"),
            cluster_n=n, cluster_pipe=pipe,
            cluster_device_cells_per_s=cells * pipe / ts,
            cluster_device_pairs_per_s=float(n) * n * pipe / ts,
            cluster_sustained_min_s=ts, cluster_single_dispatch_min_s=t1,
            cluster_single_dispatch_cells_per_s=cells / t1)
        return one

    def cluster_cpu(self, fam, lens, k: int):
        """Section 4: ``native.all_vs_all`` on ``k`` codes, one core."""
        dist = []

        def once():
            dist[:] = [native.all_vs_all(fam[:k], band=0.0, nthreads=1)]

        note("cluster: one-core baseline window")
        t, calls = cpu_window(once, self.cpu_window_s)
        pairs = int((dist[0] >= 0).sum()) * calls
        cells = float(pairs) * float(np.mean(lens)) ** 2 / t
        dev = self.details["cluster_device_cells_per_s"]
        self.details.update(
            cluster_cpu_cells_per_s_1core=cells, cluster_cpu_windows=[cells],
            cluster_cpu_window_s=t, cluster_vs_cpu=dev / cells,
            cluster_vs_ref_12core=dev / (cells * 12))

    def sorter(self):
        from .cluster.engine import AmpliconSorter, SorterConfig
        return AmpliconSorter(SorterConfig(min_length=300, seed=7),
                              device=self.device)

    def sort(self, recs: Sequence[Record]):
        """Section 5: the sorter (its default scorer) on one bin."""
        def once():
            self.out["sort"] = self.sorter().sort_records(recs)

        note(f"sort: warm-up, {len(recs)} reads")
        once()
        t = self.put("sort", self.timed("sort", once))
        self.details.update(sort_1000reads_e2e_s=t,
                            sort_reads=len(recs),
                            sort_species_found=species(self.out["sort"]))

    def multidev(self, fd, recs: Sequence[Record], tile_one, pat, lens,
                 chunk: int):
        """Section 6: the multi-device paths on a mesh of this one device
        against the single-device calls."""
        from .demux.fused import _pick_len
        from .dist.sharded import device_parallel_pairwise
        seqs = [r.seq for r in recs[:chunk]]
        amat, mlens = encode.ascii_matrix(
            seqs, max_len=_pick_len(max(len(s) for s in seqs), 256))
        masks = encode.read_masks_matrix(amat, mlens)
        dev0 = "cuda:0" if self.cuda else self.device
        calls = {
            "md_demux_1": lambda: fd.decide(masks, mlens),
            "md_demux_m": lambda: fd.decide_multi(masks, mlens, [dev0]),
            "md_pw_1": tile_one,
            "md_pw_m": lambda: device_parallel_pairwise(
                [dev0], pat, lens, pat, lens, "NW")}
        note("multidev: decide / decide_multi, tile / "
             "device_parallel_pairwise on one device")
        for fn in calls.values():   # warm-up
            fn()
        t = {k: min(self.timed(k, fn)) for k, fn in calls.items()}
        md = {}
        for nm, a, b in (("demux", "md_demux_1", "md_demux_m"),
                         ("pairwise", "md_pw_1", "md_pw_m")):
            md[f"{nm}_single_s"] = t[a]
            md[f"{nm}_multi1_s"] = t[b]
            md[f"{nm}_overhead_pct"] = 100.0 * (t[b] / t[a] - 1.0)
            md[f"{nm}_reps"] = len(self.times[a])
        md["device"] = dev0
        self.details["multidev_single_chip"] = md

    def reorient(self, adapters: str, recs: Sequence[Record],
                 n_cpu: int):
        """Section 7: ``Reorienter.run`` at q 0.75, and the one-core INFIX
        scan of the same primer bank over ``n_cpu`` reads."""
        from .demux.reorient import ReorientConfig, Reorienter
        with open(os.path.join(adapters, synthetic.FILES[3])) as fh:
            text = fh.read()
        reo = Reorienter(os.path.join(adapters, synthetic.FILES[2]), text,
                         ReorientConfig(q=0.75, device=self.device))

        def once():
            self.out["reorient"] = reo.run(recs)

        note(f"reorient: warm-up, {len(recs)} reads")
        once()
        t = self.put("reorient", self.timed("reorient", once))
        refs = [encode.encode_ref_masks(s) for s in reo.bank.seqs]
        qm = [encode.encode_read_masks(r.seq.upper()) for r in recs[:n_cpu]]
        note("reorient: one-core baseline window")
        tc, calls = cpu_window(
            lambda: native.locate_batch(refs, qm, 0.25, INFIX, nthreads=1),
            self.cpu_window_s)
        cpu = calls * n_cpu / tc
        rps = len(recs) / t
        self.details.update(
            reorient_reads=len(recs), reorient_min_s=t,
            reorient_reads_per_s=rps,
            reorient_cpu_reads_per_s_1core=cpu,
            reorient_cpu_window_s=tc,
            reorient_vs_ref_24core=rps / (cpu * 24),
            reorient_cpu_baseline_note="1-core = raw DP scan only; "
                                       "upper-bounds pychopper",
            reorient_pass_reads=self.out["reorient"].stats["pass"])

    def longsort(self, recs: Sequence[Record], warm: int, length: int):
        """Section 8: the sorter on the long-read bin, warmed on its first
        ``warm`` reads."""
        def once():
            self.out["longsort"] = self.sorter().sort_records(recs)

        note(f"longread sort: warm-up on {warm} reads")
        self.sorter().sort_records(recs[:warm])
        t = self.put("sort_longread", self.timed("longsort", once))
        self.details.update(
            sort_longread_e2e_s=t, sort_longread_reads=len(recs),
            sort_longread_len=length,
            sort_longread_species_found=species(self.out["longsort"]))

    def run_plate(self, adapters: str, recs: Sequence[Record], name: str):
        """``run_all`` (COI) on ``recs`` in ``work/name``; its narration
        goes to stderr."""
        from .pipeline.stages import PipelineConfig, run_all
        outdir = os.path.join(self.work, name)
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        fq = os.path.join(outdir, "plate.fastq")
        write_records(fq, recs, fmt="fastq")
        with contextlib.redirect_stdout(sys.stderr):
            return run_all(fq, os.path.join(outdir, "out"), "plate", "COI",
                           PipelineConfig(adapters_dir=adapters,
                                          device=self.device))

    def plate(self, adapters: str, n_per_bin: int, n5: int, n27: int,
              warm: Tuple[int, int, int]):
        """Section 9: ``run_all`` on an ``n5`` x ``n27``-bin plate of
        ``n_per_bin`` reads a bin, after a ``warm`` = (reads a bin, n5,
        n27) warm-up plate."""
        w, w5, w27 = warm
        note(f"plate: warm-up plate {w5} x {w27} x {w}")
        self.run_plate(adapters, synthetic.make_plate(
            w, n5=w5, n27=w27, bank_seed=BANK_SEED)[0], "plate_warm")
        recs, _ = synthetic.make_plate(n_per_bin, n5=n5, n27=n27,
                                       bank_seed=BANK_SEED)
        reports = []

        def once():
            reports.append(self.run_plate(adapters, recs, "plate"))

        ts = self.timed("plate", once)
        t = self.put("pipeline_plate", ts)
        rep = reports[int(np.argmin(ts))]
        stage_s: Dict[str, float] = {}
        for st in rep["metrics"]["stages"]:
            key = str(st["stage"]).split("/")[0]
            stage_s[key] = stage_s.get(key, 0.0) + float(st["wall_s"])
        self.out["plate"] = (rep, n5 * n27)
        self.details.update(
            pipeline_plate_wall_s=t,
            pipeline_plate_reads_per_s=len(recs) / t,
            pipeline_plate_reads=len(recs),
            pipeline_plate_bins=len(rep["barcodes"]),
            pipeline_plate_species_groups=plate_groups(rep),
            pipeline_plate_stage_s=stage_s)

    # -- the whole run ------------------------------------------------------
    def run(self, sizes: Sizes = Sizes()) -> None:
        """Every section, in bench.py's order."""
        z = sizes
        t0 = time.perf_counter()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
            self.details["build_s"] = _build.build_all()["build_s"]
            note(f"set-up: kernels built in {self.details['build_s']:.1f} s")
        adapters, sp5, sp27 = self.banks()
        t1 = time.perf_counter()
        rng = np.random.default_rng(0)
        recs = demux_reads(sp5.seqs, sp27.seqs, rng, z.demux_reads)
        fam, pat, lens = tile_codes(rng, z.tile)
        primers = {r.id: r.seq.upper() for r in read_fasta(
            os.path.join(adapters, synthetic.FILES[2]))}
        rrecs = reorient_reads(primers, rng, z.reorient_reads)
        srecs = sort_reads(z.sort_per_template)
        lrecs = long_reads(z.long_per_template, *z.long_read)
        self.details["inputs_s"] = time.perf_counter() - t1
        note(f"set-up: inputs made in {self.details['inputs_s']:.1f} s")
        fd = self.demux(sp5, sp27, recs, z.chunk)
        self.demux_cpu(sp5, sp27, recs, z.demux_cpu_reads)
        tile_one = self.cluster(fam, pat, lens, z.pipe)
        self.cluster_cpu(fam, lens, z.tile_cpu)
        self.sort(srecs)
        self.multidev(fd, recs, tile_one, pat, lens, z.chunk)
        self.reorient(adapters, rrecs, z.reorient_cpu_reads)
        self.longsort(lrecs, z.long_warm, z.long_read[0])
        self.plate(adapters, *z.plate, warm=z.plate_warm)
        self.details["wall_s"] = time.perf_counter() - t0

    def result(self):
        """(bench.py's JSON line, exit code: 0, or 1 when a check fails)."""
        fam = self.out["tile_codes"]
        rep, bins = self.out["plate"]
        checks = {
            "demux_reads": len(self.out["demux"]),
            "demux_reads_in_wrong_bin": demux_wrong(
                self.out["demux"], *self.out["demux_names"]),
            "tile_entries_checked": TILE_SAMPLE,
            "tile_entries_wrong": tile_wrong(self.out["tile"], fam),
            "sort_species": species(self.out["sort"]),
            "longread_species": species(self.out["longsort"]),
            "plate_bins": len(rep["barcodes"]),
            "plate_species_groups": plate_groups(rep),
            "plate_bins_built": bins}
        correct = (checks["demux_reads_in_wrong_bin"] == 0
                   and checks["demux_reads"] == self.details["demux_batch"]
                   and checks["tile_entries_wrong"] == 0
                   and checks["sort_species"] == 2
                   and checks["longread_species"] == 2
                   and checks["plate_bins"] == bins
                   and checks["plate_species_groups"] == bins)
        d = dict(self.details)
        d.update(backend=torch.device(self.device).type,
                 device=device_info(self.device), correct=correct,
                 checks=checks, launches=self.launches)
        if self.cuda:
            d["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        value = d["demux_reads_per_s"]
        out = {"metric": "demux_reads_per_s_per_chip", "value": value,
               "unit": "reads/s",
               "vs_baseline": value / d["cpu_demux_reads_per_s_1core"],
               "details": d}
        return out, 0 if correct else 1


def species(res) -> int:
    """Species groups a sort found."""
    return sum(len(g) for g in res.species)


def plate_groups(rep: Dict) -> int:
    """Species groups over the bins of a ``run_all`` report."""
    return sum(bc.get("species_groups", 0) for bc in rep["barcodes"].values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m tpu_orc_torch.bench",
        description="bench.py's measurements, made by tpu_orc_torch on the "
                    "CUDA card (see the module docstring)")
    ap.add_argument("--reps", type=int, default=None,
                    help="at most this many timed reps a section (default: "
                         "each section's own count); sizes never change")
    args = ap.parse_args(argv)
    if args.reps is not None and args.reps < 1:
        ap.error("--reps must be at least 1")
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    b = Bench("cuda", reps=args.reps)
    with contextlib.redirect_stdout(sys.stderr):
        b.run()
        out, rc = b.result()
    print(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
