"""GPU smoke run of tpu_orc_torch: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, then drive the COI main
path (run_all) on a synthetic 96-bin plate, the rRNA path with the
Kogge-Stone locate on a synthetic 96-bin rRNA plate, the batched locate
through the demux on lengthened banks, a traced run_all, stages 06-09
and prewarm through the CLI, and the multi-device path over every
visible card, check what comes out, hold every locate and Myers
kernel against both oracles of the port (C++ and Python), and run the
port's bench at bench.py's sizes.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 6,14   # setup and these phases only
    python3 chip_smoke.py --phases 15     # the oracles' phase alone

Needs one CUDA device and the CUDA toolkit (nvcc); imports no JAX. With
more cards, phase 14 stripes over all of them. ``--phases`` makes a
check call: it prints no kernel line and no result line.
Phases:
  1. setup: card name and power limit, versions, kernel build time;
  2. wavefront locate kernel (one warp per read and adapter) vs plain:
     FRONT (SP5 bank), BACK (SP27-rc bank), INFIX (reorient primer bank,
     custom k) at min_overlap 3, and BACK at min_overlap 0, on 16,384
     reads at L = 512, half reverse-complemented, and on 2,048 rRNA reads
     at L = 3,584 with some empty reads; all 8 outputs must be equal;
  3. Myers kernel vs plain, in both designs of csrc/myers.cu (thread and
     warp) and in the design the wrapper picks, each equal to the plain
     version and the two designs equal to each other, each timed: dense
     1000 x 1000 NW at ~500 bp (W 17), the listed-tile entry point over
     the gated upper triangle of the same block, smaller SHW and HW with
     end positions; the two designs over launch sizes at W 17 (where the
     wrapper's crossover comes from); and the rRNA bins' launches at W
     112, the species ladder's dense 8 x 32 reads and the gene stage's
     one 32 x 128 tile over a 24-read bin, and 05a's HW anchor locate at
     W 1 (the plain version runs once there, timed over that call); and
     the enlarged rRNA bin's gene stage (37 listed tiles over 400 reads,
     ~150,000 pairs at W 112), the two designs against each other only;
  4. fused demux, kernel path vs plain path on the card, same reads: the
     8 decision vectors equal;
  5. path-bits pileup kernel vs plain at the consensus's shapes: one
     490 bp draft x 100 reads (16 words, 512 columns), 24 groups x 50
     reads in one launch, one 1,700 bp draft (54 words, 2048 columns) x
     50 reads, and one 3,400 bp draft (107 words, the rRNA bins' width,
     4096 columns) x 24 reads; equal on the region the traceback reads, and
     the native traceback of the planes gives the native pileup's
     counts; the planes' copy to the host and the two native pileups
     are timed too;
  6. run_all (COI, device cuda) on a plate of 12 SP5 x 8 SP27 bins x 80
     reads, one bin enlarged to 1000 reads of two species so it sorts
     through both Myers entry points: 96 bins, 1 species group per bin
     (2 in the big one), every consensus >= 0.97 identical to its planted
     insert, and every locate, Myers and pack kernel launched during the
     run (in every run_all, one pack launch for each batch that
     locate_batch_lazy sends to the locate kernels, none for a batch the
     C++ short-cut takes);
  7. run_all again with the consensus pileup's device backend
     (ORC_PILEUP_BACKEND=device): both path-bits contracts launched, and
     every consensusfile.fasta and primerless/ file byte-identical to
     phase 6's;
  8. Kogge-Stone locate kernel (the KS instances of csrc/locate.cu) vs
     its plain version, FRONT/BACK/INFIX, at phase 2's reads (16,384 x L
     512) and at 2,048 rRNA reads x L 3,584 with some empty reads: all 8
     outputs equal, in the design orc_locate_ks keeps and in both designs
     (16 and 32 lanes an alignment), each timed, and equal to the
     wavefront kernel's at the pipeline's min_overlap 3; in BACK at
     min_overlap 0 equal to plain, and different from the wavefront
     kernel on exactly the empty reads;
  9. Viterbi kernel vs plain: 8 sequences x 3,584 positions against the
     default 18S profile and the reversed default 28S profile in both
     designs (one warp or one block per sequence), a random 1,800-node
     profile in the block design and a random 512-node one (the warp
     design's limit) in both; score bits, end position and end node equal
     to the plain version and between the designs;
 10. run_all -a RNA with TPU_ORC_LOCATE_IMPL=ks on a plate of 12 SP5 x 8
     SP27 bins x 24 reads of 3.2-3.6 kb rDNA, one bin enlarged to 400
     reads of two templates: only the KS locate kernels launched, the
     Viterbi and Myers kernels launched, every Myers and every Viterbi
     launch on the warp design, an 18S and a 28S hit in every bin; then
     stages 01-02 again with the wavefront locate (its launches counted
     and the stages timed), their files byte-identical to the KS run's;
 11. batched locate kernel (csrc/batched.cu) vs plain: every valid flag
     set at min_overlap 3 and 0 on 2,048 reads x L 512 (a quarter
     reverse-complemented, some empty, some planted with long-bank
     adapters) against the SP5 59-mers and a bank of 64-300 bp adapters;
     all 9 outputs equal, and in BACK refstop >= 256 on the reads planted
     with the first 260 or 290 bp of the 256 and 300 bp adapters; FRONT
     and BACK timed, and compared and timed on a 4-adapter 70 bp bank at
     the same reads and on the long bank at 2,048 rRNA reads x L 3,584
     (bands with long reads, the global handoff), each with the rows a
     lane the wrapper picks; the new times are printed beside the
     earlier thread design's. Then stage_demux
     on 1,000 reads of a plate whose SP5 and SP27-rc adapters carry a
     shared 11 bp head (70 bp), with device cuda and cpu: demuxed/ trees
     byte-identical, the batched kernel launched, the locate kernels and
     the fused demux not;
 12. cli run-all --trace on phase 6's plate: the files byte-identical to
     phase 6's, the trace's CUDA kernel events equal to the run's launch
     counts per kernel family; prints the trace's size, the device's busy
     share (the union of kernel intervals over the traced window) and the
     device time per kernel;
 13. stages 06-09 and prewarm through the CLI: extract-max coi on phase
     6's tree and ribo on phase 10's, summary on both, blast-top5,
     reorganise and prep-anchors on small inputs written here; figures
     only where matplotlib is installed; prewarm (a fused demux per
     read-length bucket and a dense Myers per length bucket on every
     card);
 14. the multi-device path over a mesh of every visible card (cuda:0
     listed twice on a one-card host, where the stripes run in order on
     one stream): (a) decide_multi on 65,536 COI reads at L 640 equal to
     decide and to the plain path on 4,096 of them, with reads/s over
     one card (one and two stripes) and over every card; (b)
     sharded_dual_demux_step and sharded_demux_step on
     70 bp banks at 16,384 reads equal to the steps on cuda:0 alone,
     histograms consistent; (c) device_parallel_pairwise dense and gated
     on a 1,000-read COI bin (W 17) and a 400-read rRNA bin (W 112)
     equal to the Myers entry points on cuda:0, sharded_pairwise_step
     on the COI bin, each stripe's time on its card; (d) run_all with
     use_mesh and cli run-all --mesh on phase 6's plate: every file
     byte-identical to phase 6's but the timing files and results.txt's
     pairs_ lines, launches per kernel and device; (e) two processes on
     localhost (gloo on one card, nccl with a card a rank on more): the
     all-reduced histogram, host_file_shard's partition and the merged
     consensusfile.fasta against one process.
15. every locate and Myers kernel against both oracles of the port, the
     C++ one (native) and the definitional Python one (align/oracle.py),
     at the card's shapes: locate #1 and #2 through the demux's batch path
     (FRONT, BACK at min_overlap 3 and 0, INFIX on a plain bank at e 0.2;
     phase 2's and phase 8's reads), the batched locate on phase 11's
     banks (FRONT, BACK) and ROADMAP 3.6's 300 bp case, Myers dense and
     pairs through distances, distances_pairs and myers_tile in NW, SHW
     and HW at W 17 and W 112, in both designs, and similarity_matrix;
     every read (a sample of pairs for Myers) against the C++ oracle, a
     sample against the Python oracle (run in spawned processes meanwhile);
     no disagreement but ROADMAP 3.4's (the wavefront locate in BACK at
     min_overlap 0 on the empty reads), asserted as that exact set; the
     cells compared, the disagreements and the time of each case printed;
16. the port's bench (tpu_orc_torch/bench.py, bench.py's measurements)
     in this process with --reps 1: every section at bench.py's sizes
     (16,384 demux reads, the 1,024 x 1,024 tile, the 1,000-read COI and
     3.5 kb bins, 8,192 reorient reads, the 96-bin x 80-read plate), one
     timed rep each, the one-core baselines' windows kept; its JSON line
     printed; every key of BENCH_KEYS a number, ``correct`` true (its
     checks: each demux read in its bin, 64 tile entries equal to the
     C++ oracle, 2 species in each sort, 96 bins and 96 species groups on
     the plate), the device this card, and each section's kernels
     launched;
17. the KS locate kernel in INFIX mode with the pychopper primer bank
     (SP5, -SP5, SP27, -SP27, 59 bp, N17 each, the custom budget
     floor((1 - q) len)) at stage 01's long-read shapes: 2,048 rRNA reads
     at L 4,096 and 2,048 reads at L 8,192, half of them two rRNA reads
     fused (the second reverse-complemented in every other), every 64th
     with a primer's
     span masked by X as the fused-read re-scan masks it, some empty; at
     q 0.90 and 0.70; all 8 outputs, nloc and nacc included, equal to
     locate_plain_ks; kernel and plain version timed.
18. the pack kernel (csrc/pack.cu) against its plain version and the
     host packing on phase 17's reads at L 4,096 and 8,192 with both
     tables, timed against its byte bound (device time: 20 launches
     queued behind a spin of the card); a 2,048-read scan batch of
     stage 01's mix (~3% fused, L 8,192) packed on the host and on the
     card, each timed on the host clock; locate_batch_lazy with the
     pychopper bank through the device pack equal to the host-packed
     route.
19. the emit kernel (csrc/emit.cu) against its plain version and against
     format_records over _make_segment's Records: on phase 17's reads
     (one or two segments a read, both signs, some under 50 bases, some
     reads without a quality) and on the segment plan of
     Reorienter.run (q 0.90) over a 65,536-read block of rrna.reorient's
     mix (orc_bench/gen_raw.py), whose four files must equal the old
     segment and format path's; the kernel timed against its byte bound
     (device time: 20 launches behind a spin), the block's emit on the
     host clock (joins, uploads, kernel, download) against the old
     path (a Record a segment, format_records).
Phase 1 prints each kernel source's ptxas report (registers, stack
frame). Prints a JSON line of per-kernel numbers, the card line, and last
the result line. Exits non-zero, printing no result, when any phase fails or
there is no CUDA device. Times are medians of 5 timed runs (3 for the
plain versions of phases 8 and 9) after a warm-up, from CUDA events; the
tolerance of every comparison is zero (integer outputs, and float32
scores compared bit for bit). A kernel's ``launches`` are counted over
the run_all of its path (phase 6 for the wavefront locate and Myers,
phase 7 for the pileup, phase 10 for the KS locate, the Viterbi and the
rRNA Myers entries), both designs of a kernel together, and over phase
11's stage_demux for the batched locate (its FRONT and BACK launches,
given to the entries of both banks); a Myers or Viterbi entry's ``ms``
is the design the wrapper picks. The batched locate's plain version runs
once per comparison, timed over that call.

``bound_ms`` is the least time the card could take for the kernel's work
at these inputs: the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and its integer
operations over the int32 issue rate, 132 SMs x 64 lanes x 1.98 GHz =
1.67e13/s (the float32 peak of 67 TFLOP/s is 132 x 128 lanes x 2 x 1.98
GHz; an SM has half as many int32 lanes). Operations are counted from
this run's data: per DP cell of locate 16 (compares, adds and selects of
csrc/locate.cu's inner loop; the same count for the KS kernel, which
computes the same contract, and for the batched locate, counted over
the cells the contract needs: rows 1..m of each adapter by columns
1..len of each read, not the rows its bands pad past m), per 32-bit word
step of Myers and of the pileup 20 (the bit-vector recurrence). The
Viterbi's are float32: 15 per (position, node) (9 adds and 6 max of
_viterbi_kernel's step), over the float32 issue rate, 132 x 128 lanes
x 1.98 GHz = 3.35e13/s. No single PyTorch call computes these dynamic
programs, so ``library_ms`` is null.
"""
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "smoke")
BYTES_PER_S = 3.35e12              # H100 SXM HBM3
INT_OPS_PER_S = 132 * 64 * 1.98e9  # int32 issue rate
FP32_OPS_PER_S = 132 * 128 * 1.98e9  # float32 issue rate (no FMA)
OPS_PER_CELL = {"locate": 16, "myers": 20, "pileup": 20, "viterbi": 15}
#: the batched locate's times in its earlier design, one thread per
#: (read, adapter), at phase 11's shapes (an NVIDIA H100 80GB HBM3 at
#: 700.00 W), printed beside this run's
THREAD_DESIGN_MS = {"batched_locate_front": 4.128,
                    "batched_locate_back": 5.578,
                    "batched_locate_front_long": 31.371,
                    "batched_locate_back_long": 36.225}

#: phase 16: the keys of the bench's line (``tpu_orc_torch/bench.py``)
#: that must hold numbers
BENCH_KEYS = (
    "value", "vs_baseline", "demux_median_s", "demux_reps",
    "cpu_demux_reads_per_s_1core", "vs_ref_24core",
    "cluster_device_cells_per_s", "cluster_device_pairs_per_s",
    "cluster_median_s", "cluster_reps", "cluster_single_dispatch_min_s",
    "cluster_single_dispatch_cells_per_s",
    "cluster_single_dispatch_median_s", "cluster_single_dispatch_reps",
    "cluster_cpu_cells_per_s_1core", "cluster_vs_cpu",
    "cluster_vs_ref_12core", "sort_1000reads_e2e_s", "sort_median_s",
    "sort_reps", "sort_species_found", "sort_longread_e2e_s",
    "sort_longread_median_s", "sort_longread_reps",
    "sort_longread_species_found", "reorient_reads_per_s",
    "reorient_median_s", "reorient_reps", "reorient_cpu_reads_per_s_1core",
    "reorient_vs_ref_24core", "reorient_pass_reads",
    "multidev_single_chip.demux_single_s",
    "multidev_single_chip.demux_multi1_s",
    "multidev_single_chip.demux_overhead_pct",
    "multidev_single_chip.pairwise_single_s",
    "multidev_single_chip.pairwise_multi1_s",
    "multidev_single_chip.pairwise_overhead_pct", "pipeline_plate_wall_s",
    "pipeline_plate_median_s", "pipeline_plate_reps",
    "pipeline_plate_reads_per_s", "pipeline_plate_bins",
    "pipeline_plate_species_groups", "build_s", "wall_s",
    "max_memory_allocated_bytes")

#: phase 15's samples for the Python oracle, which walks each DP cell in
#: the interpreter (~1 us a cell): reads per locate case (COI, rRNA; the
#: rRNA sample holds its 22 empty reads, and each sample every read
#: shorter than the longest adapter), reads per batched case (L 512,
#: L 3,584), and pairs per Myers case and entry; jobs of PY_CHUNK reads
#: or pairs. Cut so that the phase keeps to 90 s on the GPU host's 8
#: cores beside the C++ oracle (PERF.md, §6)
PY_READS = (32, 26, 8, 2)
PY_PAIRS = 16
PY_CHUNK = 4

def cuda_ms(fn, reps=5):
    """Median ms of ``reps`` timed calls after one warm-up, from CUDA
    events around each call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_ms(fn, n=20, reps=5):
    """Median device ms a call of ``reps`` runs of ``n`` calls, enqueued
    behind a spin of the card (``torch.cuda._sleep``, ~30 ms) so that
    the host's launch cost stays off the events' interval: for kernels
    shorter than their launch."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


def read_tree(root):
    """{relative path: bytes} of every file under root; .gz files are
    decompressed (their headers carry a write time)."""
    import gzip
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with (gzip.open if f.endswith(".gz") else open)(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def myers_launches(counts):
    """Myers launches of one run_all by entry point, both designs
    together, under the kernel JSON's names."""
    return {f"myers_{e}": counts[f"myers_{e}_thread"]
            + counts[f"myers_{e}_warp"] for e in ("dense", "pairs")}


def max_abs_err(x, y) -> int:
    return int((x.long() - y.long()).abs().max()) if x.numel() else 0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, ops_per_s: float = INT_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their issue rate (int32 unless given)."""
    tb, to = n_bytes / BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ptxas_summary(log: str):
    """[(entry function, registers, stack frame, spill bytes)] from an
    ``nvcc -Xptxas -v`` log."""
    out, fn, frame = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and fn:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append((fn, regs, frame))
            fn = None
    return out


def demangle(name: str) -> str:
    """A kernel's C++ name from its mangled one (``c++filt``, where the
    host has it), without the argument list: a template's instances
    differ in their template arguments."""
    import shutil
    if not shutil.which("c++filt"):
        return name
    out = subprocess.run(["c++filt", name], capture_output=True, text=True,
                         timeout=60).stdout.strip() or name
    return out.split("(")[0]


def host_ms(fn, reps=5):
    """Median ms of ``reps`` calls after one warm-up, host clock, the
    device synchronised before and after each call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


class Smoke:
    def __init__(self):
        import torch
        self.torch = torch
        self.kernels = {}        # name -> dict of the kernel JSON entry
        self.failed = []

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            print(f"== {name}: FAILED", flush=True)
            self.failed.append(name)

    def record(self, name, source, replaces, err, ms, plain_ms, n_bytes,
               n_ops, ops_per_s=INT_OPS_PER_S):
        bound_ms, bound_by = bound(n_bytes, n_ops, ops_per_s)
        # launches come from a main path's counters (:meth:`launches`),
        # whichever phase ran first; None where no main path counts them
        launches = self.kernels.get(name, {}).get("launches")
        self.kernels[name] = {"name": name, "route": "cuda",
                              "source": source, "replaces": replaces,
                              "launches": launches, "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": None}
        print(f"   {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes:.4g} B, "
              f"{n_ops:.4g} ops), max_abs_err {err}", flush=True)

    def launches(self, counts):
        """Set each kernel's ``launches`` from one run_all's counters."""
        for name, n in counts.items():
            self.kernels.setdefault(name, {"name": name})["launches"] = n

    # -- phase 1 ---------------------------------------------------------
    def setup(self):
        torch = self.torch
        from tpu_orc_torch import _build, synthetic
        from tpu_orc_torch.bench import card_line
        print(card_line())
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)}")
        t = _build.build_all()
        print(f"kernel build (one nvcc per source, in parallel): "
              f"{t['build_s']:.1f} s")
        for name, log in _build.PTXAS_LOG.items():
            for fn, regs, frame in ptxas_summary(log):
                print(f"   {name} ptxas {demangle(fn)}: {regs}; {frame}")
        self.adapters = synthetic.write_adapter_dir(
            os.path.join(WORK, "adapters"))

    # -- reads for phases 2 and 4 -------------------------------------------
    def reads(self):
        if not hasattr(self, "_reads"):
            from tpu_orc_torch import synthetic
            recs, _ = synthetic.make_plate(171, seed=7, insert_len=330)
            recs = recs[:16384]            # the demux stream chunk size
            self._reads = synthetic.read_masks([r.seq for r in recs], 512)
        return self._reads

    def banks(self):
        """The locate banks of the main path by mode: SP5 (FRONT), SP27-rc
        (BACK) and the reorient primer bank with its custom k (INFIX)."""
        from tpu_orc_torch.demux.adapters import AdapterBank
        from tpu_orc_torch.demux.reorient import build_primer_bank
        a = self.adapters
        return {
            "front": AdapterBank.from_fasta(
                os.path.join(a, "M13_amplicon_indices_forward.fa"), 0.1,
                "cuda"),
            "back": AdapterBank.from_fasta(
                os.path.join(a, "M13_amplicon_indices_reverse_rc.fa"), 0.1,
                "cuda"),
            "infix": build_primer_bank(
                os.path.join(a, "M13_seqs_for_pychopper.fa"), 0.8,
                "cuda")[0],
        }

    def rrna_reads(self):
        """2,048 reads of the rRNA plate at L 3,584, every 97th empty: the
        locate shape of an rRNA plate's stages 01-02."""
        if not hasattr(self, "_rreads"):
            from tpu_orc_torch import synthetic
            _, recs, _ = self.rrna_plate()
            rmasks, rlens = synthetic.read_masks(
                [r.seq[:3584] for r in recs[:2048]], 3584)
            rlens[::97] = 0                  # some empty reads
            self._rreads = rmasks, rlens
        return self._rreads

    # -- phase 2 ---------------------------------------------------------
    def locate(self):
        """The wavefront kernel against locate_plain in the three modes at
        min_overlap 3 and in BACK at 0 (the empty reads' cell (0, 0)), at
        the COI and the rRNA reads' shapes; timed at min_overlap 3. The
        plain version runs once at the rRNA shape (host clock over that
        call)."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.align import locate as L
        shapes = (("16,384 reads x L 512", "", *self.reads()),
                  ("2,048 rRNA reads x L 3,584", "_rrna", *self.rrna_reads()))
        for label, suffix, masks, lens in shapes:
            rt = torch.from_numpy(np.ascontiguousarray(masks.T)).cuda()
            ln = torch.from_numpy(lens).cuda()
            cases = [(m, b, 3) for m, b in self.banks().items()]
            cases.append(("back", cases[1][1], 0))
            for mode, bank, mo in cases:
                tabs = L.tables_for_bank(bank, mode, mo).tensors("cuda")
                A = len(bank)
                got = L.locate_cuda(tabs, rt, ln, mode, A)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = L.locate_plain(tabs, rt, ln, mode, A)
                torch.cuda.synchronize()
                pms = (time.perf_counter() - t0) * 1e3
                if not torch.equal(got, want):
                    bad = [k for k in range(8) if not torch.equal(got[k],
                                                                  want[k])]
                    raise AssertionError(f"locate {mode} at min_overlap {mo}"
                                         f", {label}: outputs {bad} differ")
                hits = int(got[4].sum())
                ms = cuda_ms(lambda: L.locate_cuda(tabs, rt, ln, mode, A))
                if not suffix:
                    pms = cuda_ms(lambda: L.locate_plain(tabs, rt, ln, mode,
                                                         A))
                print(f"   locate {mode}, min_overlap {mo}: {A} adapters x "
                      f"{label}, {int((ln == 0).sum())} empty, {hits} valid "
                      f"hits, equal to plain; kernel {ms:.3f} ms, plain "
                      f"{pms:.3f} ms", flush=True)
                cells = float(ln.sum()) * float(tabs[4][:A].sum())
                if mo == 3:
                    self.record(f"locate_{mode}{suffix}", "tpu_orc_torch/csrc/locate.cu",
                                "tpu_orc/align/pallas_locate.py:205",
                                max_abs_err(got, want), ms, pms,
                                nbytes(*tabs, rt, ln, got),
                                OPS_PER_CELL["locate"] * cells)

    # -- phase 3 ---------------------------------------------------------
    def myers_case(self, label, u, mode="NW", tiles=None, plain_reps=5):
        """One launch of csrc/myers.cu in each design and in the wrapper's
        choice, each held against the plain version (on the listed tiles
        for the pairs entry) and the two designs against each other, then
        timed. ``plain_reps`` 1 times the plain version over the one call
        that the comparison makes (its Python loop walks every column).
        Returns (max_abs_err, {design: ms}, plain ms, pairs launched, W)."""
        torch = self.torch
        from tpu_orc_torch.align import myers as M
        extra = () if tiles is None else tiles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = M.myers_plain(*u, mode, *extra)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        mask = torch.zeros(want[0].shape, dtype=torch.bool,
                           device=want[0].device)
        if tiles is None:
            mask[:] = True
            pairs = mask.numel()
        else:
            ti, tj, TI, TJ = tiles
            for a, b in zip(ti.tolist(), tj.tolist()):
                mask[a * TI:(a + 1) * TI, b * TJ:(b + 1) * TJ] = True
            pairs = ti.numel() * TI * TJ
        got = {d: M.myers_cuda(*u, mode, *extra, design=d)
               for d in M.DESIGNS}
        got["chosen"] = M.myers_cuda(*u, mode, *extra)
        torch.cuda.synchronize()
        for d, g in got.items():
            for x, w in zip(g, want):
                assert torch.equal(x[mask], w[mask]), \
                    f"myers {label}: {d} design differs from plain"
        for x, y in zip(got["thread"], got["warp"]):
            assert torch.equal(x[mask], y[mask]), \
                f"myers {label}: the designs differ"
        err = max(max_abs_err(x[mask], w[mask])
                  for g in got.values() for x, w in zip(g, want))
        ms = {d: cuda_ms(lambda d=d: M.myers_cuda(*u, mode, *extra,
                                                  design=d))
              for d in M.DESIGNS}
        ms["chosen"] = cuda_ms(lambda: M.myers_cuda(*u, mode, *extra))
        if plain_reps > 1:
            pms = cuda_ms(lambda: M.myers_plain(*u, mode, *extra),
                          reps=plain_reps)
        W = u[0].shape[1] // M.NCHAN
        print(f"   myers {label}, W {W}: both designs equal to plain and to "
              f"each other; thread {ms['thread']:.3f} ms, warp "
              f"{ms['warp']:.3f} ms, the wrapper's choice "
              f"({M.choose_design(pairs, W)}) {ms['chosen']:.3f} ms, plain "
              f"{pms:.3f} ms", flush=True)
        return err, ms, pms, pairs, W

    def myers_record(self, name, replaces, label, u, tiles=None,
                     plain_reps=5):
        """:meth:`myers_case`, then the kernel entry at the wrapper's
        choice, its bound counted from the word steps of this launch:
        each pattern's words up to row m, each text column."""
        err, ms, pms, _, _ = self.myers_case(label, u, "NW", tiles,
                                             plain_reps)
        nwp = (u[1].double() + 31).div(32).floor()
        ncol = u[3].double().clamp(max=u[2].shape[0])
        if tiles is None:
            steps = float(nwp.sum() * ncol.sum())
            n_bytes = nbytes(*u) + 2 * 4 * nwp.numel() * ncol.numel()
        else:
            ti, tj, TI, TJ = tiles
            steps = float((nwp.view(-1, TI).sum(1)[ti.long()]
                           * ncol.view(-1, TJ).sum(1)[tj.long()]).sum())
            n_bytes = nbytes(*u, ti, tj) + 2 * 4 * ti.numel() * TI * TJ
        self.record(name, "tpu_orc_torch/csrc/myers.cu",
                    f"tpu_orc/align/pallas_myers.py:{replaces}", err,
                    ms["chosen"], pms, n_bytes, OPS_PER_CELL["myers"] * steps)

    def myers(self):
        import random
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import myers as M
        rnd = random.Random(3)
        tmpls = ["".join(rnd.choice("ACGT") for _ in range(500))
                 for _ in range(4)]
        seqs = sorted((synthetic.mutate(rnd, tmpls[k % 4], 0.03)
                       for k in range(1000)), key=len)
        W = -(-max(len(x) for x in seqs) // 32) * 32
        pc, pl = synthetic.codes(seqs, W)
        up = M._upload(pc, pl, pc, pl, 1000, 1000, "cuda")
        self.myers_record("myers_dense", 56, "dense NW 1000 x 1000 at ~500 bp",
                          up)
        # listed tiles: the gene stage's upper triangle + 5% length gate
        TI, TJ = M.tile_shape(W // 32)
        P, T = -(-1000 // TI) * TI, -(-1000 // TJ) * TJ
        lo, hi = np.minimum.outer(pl, pl), np.maximum.outer(pl, pl)
        gate = (np.arange(1000)[:, None] < np.arange(1000)[None, :]) & \
            (lo * 1.05 >= hi)
        gfull = np.zeros((P, T), bool)
        gfull[:1000, :1000] = gate
        need = gfull.reshape(P // TI, TI, T // TJ, TJ).any(axis=(1, 3))
        tiles = torch.from_numpy(np.argwhere(need).astype(np.int32)).cuda()
        ti, tj = tiles[:, 0].contiguous(), tiles[:, 1].contiguous()
        upp = M._upload(pc, pl, pc, pl, P, T, "cuda")
        self.myers_record("myers_pairs", 242,
                          f"pairs NW, {ti.numel()} of {need.size} tiles "
                          f"listed ({TI} x {TJ})", upp, (ti, tj, TI, TJ))
        # SHW and HW with end positions: reads within longer texts
        for mode in ("SHW", "HW"):
            pats = pc[:200, :480]
            texts, tl = synthetic.codes(
                ["".join(rnd.choice("ACGT") for _ in range(k % 40))
                 + seqs[(k * 7) % 1000][:400] for k in range(300)], W)
            u = M._upload(pats, np.minimum(pl[:200], 480), texts, tl, 200,
                          300, "cuda")
            self.myers_case(f"{mode} 200 x 300 with end positions", u, mode)
        # where the thread design overtakes the warp design, at these
        # ~500 bp reads' width
        rows = []
        for P, T in ((8, 32), (8, 128), (8, 512), (8, 1024), (12, 1024),
                     (16, 1024), (24, 1024), (32, 1024), (128, 1024)):
            k = np.arange(T) % 1000
            u = M._upload(pc[:P], pl[:P], pc[k], pl[k], P, T, "cuda")
            t = {d: cuda_ms(lambda d=d: M.myers_cuda(*u, "NW", design=d))
                 for d in M.DESIGNS}
            rows.append(f"{P} x {T}: thread {t['thread']:.4f}, warp "
                        f"{t['warp']:.4f}")
        print(f"   myers crossover, dense NW at W {up[0].shape[1] // M.NCHAN}, "
              f"ms: {'; '.join(rows)}")
        self.myers_rrna()

    def myers_rrna(self):
        """The rRNA bins' Myers launches at W 112: the species ladder's
        dense 8 consensuses x 32 reads, and the gene stage's one listed
        32 x 128 tile over a 24-read bin, gated as _gated_block gates it;
        and 05a's anchor locate, HW at W 1. The plain version walks
        ~3,600 columns in Python, so it runs once, timed over that call."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.align import myers as M
        from tpu_orc_torch.cluster.scoring import pack_codes
        from tpu_orc_torch.io import encode
        from tpu_orc_torch.rrna.anchors import (ANCHOR_18S_END,
                                                ANCHOR_28S_START)
        _, recs, _ = self.rrna_plate()
        codes = [encode.encode_codes(r.seq[:3584]) for r in recs[:64]]
        pc, pl = pack_codes(codes[:8])
        tc, tl = pack_codes(codes[8:40])
        assert pc.shape[1] == 3584, pc.shape
        up = M._upload(pc, pl, tc, tl, 8, 32, "cuda")
        self.myers_record("myers_dense_rrna", 56, "dense NW 8 x 32 rRNA reads",
                          up, plain_reps=1)
        n = 24
        bin_codes = sorted(codes[40:40 + n], key=len)
        packed, lens = pack_codes(bin_codes, count_cap=32)
        lo = np.minimum.outer(lens[:n], lens[:n])
        hi = np.maximum.outer(lens[:n], lens[:n])
        gate = (np.arange(n)[:, None] < np.arange(n)[None, :]) & \
            (lo * 1.05 >= hi)
        TI, TJ = M.tile_shape(packed.shape[1] // 32)
        upp = M._upload(packed, lens, packed, lens, TI, TJ, "cuda")
        tiles = torch.zeros((2, 1), dtype=torch.int32, device=upp[0].device)
        self.myers_record("myers_pairs_rrna", 242,
                          f"pairs NW, one {TI} x {TJ} tile over {n} rRNA "
                          f"reads ({int(gate.sum())} gated pairs)", upp,
                          (tiles[0], tiles[1], TI, TJ), plain_reps=1)
        # the enlarged bin's gene stage: 400 reads, tens of listed tiles;
        # the designs against each other (the plain version would take
        # minutes here)
        n = 400
        big = sorted((encode.encode_codes(r.seq[:3584])
                      for r in recs[:n]), key=len)
        packed, lens = pack_codes(big, count_cap=512)
        lo = np.minimum.outer(lens[:n], lens[:n])
        hi = np.maximum.outer(lens[:n], lens[:n])
        gfull = np.zeros((512, 512), bool)
        gfull[:n, :n] = (np.arange(n)[:, None] < np.arange(n)[None, :]) & \
            (lo * 1.05 >= hi)
        need = gfull.reshape(512 // TI, TI, 512 // TJ, TJ).any(axis=(1, 3))
        tg = torch.from_numpy(np.argwhere(need).astype(np.int32)).cuda()
        tiles = (tg[:, 0].contiguous(), tg[:, 1].contiguous(), TI, TJ)
        ub = M._upload(packed, lens, packed, lens, 512, 512, "cuda")
        got = [M.myers_cuda(*ub, "NW", *tiles, design=d) for d in M.DESIGNS]
        torch.cuda.synchronize()
        mask = torch.from_numpy(np.kron(need, np.ones((TI, TJ), bool))).cuda()
        for x, y in zip(*got):
            assert torch.equal(x[mask], y[mask]), "the designs differ"
        ms = {d: cuda_ms(lambda d=d: M.myers_cuda(*ub, "NW", *tiles,
                                                  design=d), reps=3)
              for d in M.DESIGNS}
        pairs = tg.shape[0] * TI * TJ
        print(f"   myers pairs NW, {tg.shape[0]} listed {TI} x {TJ} tiles over "
              f"{n} rRNA reads ({pairs} pairs), W 112: the designs equal; "
              f"thread {ms['thread']:.3f} ms, warp {ms['warp']:.3f} ms, the "
              f"wrapper's choice {M.choose_design(pairs, 112)}")
        anchors = [encode.encode_codes(a)
                   for a in (ANCHOR_18S_END, ANCHOR_28S_START)]
        ac, al = pack_codes(anchors, cap=32)
        al = np.array([len(a) for a in anchors], np.int32)
        ua = M._upload(ac, al, tc[:8], tl[:8], 2, 8, "cuda")
        self.myers_case("HW, 2 anchors x 8 rRNA reads", ua, "HW",
                        plain_reps=1)

    # -- phase 4 ---------------------------------------------------------
    def fused(self):
        from tpu_orc_torch.align.locate import locate_plain
        from tpu_orc_torch.demux.adapters import AdapterBank
        from tpu_orc_torch.demux.fused import FusedDemux
        a = self.adapters
        sp5 = AdapterBank.from_fasta(
            os.path.join(a, "M13_amplicon_indices_forward.fa"), 0.1, "cuda")
        sp27 = AdapterBank.from_fasta(
            os.path.join(a, "M13_amplicon_indices_reverse_rc.fa"), 0.1,
            "cuda")
        masks, lens = self.reads()
        got = FusedDemux(sp5, sp27).decide(masks, lens)
        want = FusedDemux(sp5, sp27, locate=locate_plain).decide(masks,
                                                                  lens)
        import numpy as np
        for name, g, w in zip(want._fields, got, want):
            assert np.array_equal(g, w), f"fused decision {name} differs"
        n1 = int((got.idx1 >= 0).sum())
        n2 = int((got.idx2 >= 0).sum())
        print(f"   fused demux {len(lens)} reads: 8 decision vectors equal; "
              f"round 1 assigned {n1}, round 2 {n2}")
        assert n2 > 0.9 * len(lens), "too few reads demuxed"

    # -- phase 5 ---------------------------------------------------------
    def pileup(self):
        import random
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import native, synthetic
        from tpu_orc_torch.align import pileup as P
        from tpu_orc_torch.io import encode
        rnd = random.Random(5)

        def group(L, R):
            d = "".join(rnd.choice("ACGT") for _ in range(L))
            return encode.encode_codes(d), [
                encode.encode_codes(synthetic.mutate(rnd, d, 0.05))
                for _ in range(R)]

        cases = (("pileup_single", "pileup.py:38", [group(490, 100)]),
                 ("pileup_multi", "pileup.py:132",
                  [group(rnd.randint(470, 500), 50) for _ in range(24)]),
                 ("pileup_single, long draft", "pileup.py:38",
                  [group(1700, 50)]),
                 ("pileup_single, rRNA draft", "pileup.py:38",
                  [group(3400, 24)]))
        for name, line, groups in cases:
            drafts = [d for d, _ in groups]
            reads = [rs for _, rs in groups]
            tensors, starts = P._upload(drafts, reads, "cuda")
            peqs, dwords, tile_gid, texts, nl = tensors
            got = P.path_bits_cuda(*tensors)
            want = P.path_bits_plain(*tensors)
            torch.cuda.synchronize()
            T, N, _, W = got.shape
            mask = P.specified(dwords, tile_gid, nl, N, W).expand_as(got)
            assert torch.equal(got[mask], want[mask]), f"{name} differs"
            err = max_abs_err(got[mask], want[mask])
            ms = cuda_ms(lambda: P.path_bits_cuda(*tensors))
            pms = cuda_ms(lambda: P.path_bits_plain(*tensors))
            # the host's share: planes to the host, then the traceback;
            # the native pileup computes the same counts from scratch
            copy_ms = host_ms(lambda: got.cpu())
            planes = got.cpu().numpy().view(np.uint32)
            per = [planes[st:st + len(rs)] for st, rs in zip(starts, reads)]
            fb = [native.pileup_from_bits(pl, rs, d)
                  for pl, rs, d in zip(per, reads, drafts)]
            nb = [native.pileup_batch(rs, d) for rs, d in zip(reads, drafts)]
            assert all(np.array_equal(a, b) for a, b in zip(fb, nb)), \
                f"{name}: traceback counts differ from the native pileup"
            fb_ms = host_ms(lambda: [native.pileup_from_bits(pl, rs, d)
                                     for pl, rs, d in zip(per, reads,
                                                          drafts)])
            nb_ms = host_ms(lambda: [native.pileup_batch(rs, d)
                                     for rs, d in zip(reads, drafts)])
            steps = float((nl.double() * dwords.double()[
                tile_gid.long().repeat_interleave(P.TR)]).sum())
            print(f"   {name}: {len(groups)} group(s) x {len(reads[0])} "
                  f"reads, W {W}, ncols {N}, planes {planes.nbytes / 1e6:.1f}"
                  f" MB: equal on {int(mask.sum())} specified words; "
                  f"copy to host {copy_ms:.3f} ms, pileup_from_bits "
                  f"{fb_ms:.3f} ms, native pileup_batch {nb_ms:.3f} ms")
            self.record(name, "tpu_orc_torch/csrc/pileup.cu",
                        f"tpu_orc/align/pallas_{line}", err, ms, pms,
                        nbytes(*tensors) + 16 * steps,
                        OPS_PER_CELL["pileup"] * steps)
        # the JSON line keeps the main path's two contracts
        self.kernels.pop("pileup_single, long draft")
        self.kernels.pop("pileup_single, rRNA draft")

    # -- phases 6 and 7 ------------------------------------------------------
    def plate(self):
        """The synthetic plate FASTQ and its planted inserts."""
        from tpu_orc_torch import synthetic
        self.big = (3, 5)
        recs, self.planted = synthetic.make_plate(80, seed=11,
                                                  big_bin=self.big)
        fq = os.path.join(WORK, "plate.fastq")
        with open(fq, "w") as fh:
            fh.write("".join(f"@{r.desc}\n{r.seq}\n+\n{r.qual}\n"
                             for r in recs))
        return fq, len(recs)

    def run_all(self, out, fq, n_reads, amplicon, big, backend="native",
                trace=None, extra=()):
        """``cli run-all --device cuda`` in this process with the given
        consensus pileup backend (and ``--trace trace`` when given, and
        the arguments ``extra``), every launch counter set to 0 just
        before; returns (report, launch counts), and keeps the launches
        per device in ``self.by_device``. The batched locate must not
        launch: every bank of the smoke plates is of 59-mers, under the 63
        bp of its route. Every batch that ``locate_batch_lazy`` sends to
        the locate kernels must launch the pack kernel once, and no batch
        that the C++ short-cut takes (NATIVE_SMALL_READS) may."""
        import collections
        import contextlib
        import io
        import shutil
        import threading
        from tpu_orc_torch import cli
        from tpu_orc_torch.align import batched as BL
        from tpu_orc_torch.align import locate as L, myers as M, pileup as P
        from tpu_orc_torch.align import pack as PK
        from tpu_orc_torch.cluster import consensus
        from tpu_orc_torch.demux import demux as D
        from tpu_orc_torch.rrna import hmm as H
        shutil.rmtree(out, ignore_errors=True)
        argv = ["run-all", fq, "-o", out, "-n", "plate", "-a", amplicon,
                "--adapters-dir", self.adapters, "--device", "cuda"]
        if trace:
            argv += ["--trace", trace]
        argv += list(extra)
        log = io.StringIO()      # the CLI narrates stages, then the report
        counters = {"locate": L.LAUNCHES, "myers": M.LAUNCHES,
                    "pileup": P.LAUNCHES, "viterbi": H.LAUNCHES,
                    "batched": BL.LAUNCHES, "pack": PK.LAUNCHES}
        routes, lock = collections.Counter(), threading.Lock()
        real_lazy = D.locate_batch_lazy

        def lazy(bank, seqs, flags, *args, **kwargs):
            """locate_batch_lazy, each call on a CUDA bank's locate
            kernels' route counted by what it did: a non-empty batch
            dispatched to the kernels, an empty one, or the short-cut."""
            handle = real_lazy(bank, seqs, flags, *args, **kwargs)
            if D._use_pallas(bank, flags):
                kind = ("native" if handle[0] == "done"
                        else "kernels" if handle[3] else "empty")
                with lock:
                    routes[kind] += 1
            return handle

        saved = consensus.PILEUP_BACKEND
        consensus.PILEUP_BACKEND = backend
        D.locate_batch_lazy = lazy    # looked up at call time
        try:
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            counts = {f"{k}_{e}": n for k, c in counters.items()
                      for e, n in c.snapshot().items()}
            self.by_device = per_device(counters)
        finally:
            consensus.PILEUP_BACKEND = saved
            D.locate_batch_lazy = real_lazy
        assert rc == 0, rc
        rep = json.loads(log.getvalue().strip().splitlines()[-1])
        print(f"   tpu_orc_torch.cli {' '.join(argv[:1] + list(extra))} -a "
              f"{amplicon} --device cuda (in process), locate "
              f"{L.LOCATE_IMPL}, pileup backend {backend}: {n_reads} reads, "
              f"{wall:.1f} s wall")
        print(f"   launch counts during run_all: {counts}")
        print(f"   locate_batch_lazy on the locate kernels' route: "
              f"{routes['kernels']} batches to the kernels, "
              f"{routes['empty']} empty, {routes['native']} by the C++ "
              f"short-cut; pack launches {counts['pack_pack']}")
        assert counts["pack_pack"] == routes["kernels"], \
            (f"pack launches {counts['pack_pack']} against "
             f"{routes['kernels']} batches to the locate kernels")
        on = {k: n for k, n in counts.items() if k.startswith("batched_")
              and n}
        assert not on, f"batched locate launched on 59-mer banks: {on}"
        stages = rep["metrics"]["stages"]
        per_bin = ("03_sort/", "04_clean/", "05_rrna/")
        for st in stages:
            if not st["stage"].startswith(per_bin):
                print(f"   stage {st['stage']}: {st['wall_s']} s")
        big_comb = f"SP27_{big[1] + 1:03d}_SP5_{big[0] + 1:03d}"
        for kind in per_bin:
            walls = {st["stage"].split("/")[1]: st["wall_s"]
                     for st in stages if st["stage"].startswith(kind)}
            if walls:
                print(f"   stage {kind[:-1]}: {len(walls)} bins, sum "
                      f"{sum(walls.values()):.2f} s, enlarged bin "
                      f"{walls.get(big_comb, 0.0):.2f} s, other bins max "
                      f"{max(v for k, v in walls.items() if k != big_comb):.2f}"
                      f" s (4 bin workers)")
        return rep, counts

    def coi_run(self, out, backend, trace=None, extra=()):
        if not hasattr(self, "fq"):
            self.fq, self.n_reads = self.plate()
        return self.run_all(out, self.fq, self.n_reads, "COI", self.big,
                            backend, trace, extra)

    def main_path(self):
        from tpu_orc_torch import synthetic
        out = os.path.join(WORK, "plate", "native")
        rep, counts = self.coi_run(out, "native")
        names = [f"locate_{m}" for m in ("front", "back", "infix")]
        self.launches({k: counts[k] for k in names})
        self.launches(myers_launches(counts))
        self.launches({"pack_masks_T": counts["pack_pack"]})
        names += list(myers_launches(counts)) + ["pack_masks_T"]
        bins = rep["barcodes"]
        assert rep["demux"]["bins"] == 96, rep["demux"]
        worst = 1.0
        for (s5, s27), inserts in self.planted.items():
            comb = f"{s27}_{s5}"
            assert comb in bins, f"bin {comb} missing"
            assert bins[comb]["species_groups"] == len(inserts), \
                (comb, bins[comb])
            with open(os.path.join(out, "sorted", comb,
                                   "consensusfile.fasta")) as fh:
                cons = [ln.strip() for ln in fh if not ln.startswith(">")]
            assert len(cons) == len(inserts), (comb, len(cons))
            for c in cons:
                worst = min(worst, max(synthetic.identity(c, p)
                                       for p in inserts))
        print(f"   96 bins, species groups as planted (2 in the enlarged "
              f"bin), lowest consensus identity {worst:.4f}")
        assert worst >= 0.97, worst
        zero = [k for k in names if self.kernels[k]["launches"] == 0]
        assert not zero, f"kernels not launched during run_all: {zero}"
        self.native_out = out
        self.phase6_counts = counts
        self.phase6_wall = rep["metrics"]["total_wall_s"]

    def device_path(self):
        out = os.path.join(WORK, "plate", "device")
        rep, counts = self.coi_run(out, "device")
        self.launches({k: n for k, n in counts.items()
                       if k.startswith("pileup_")})
        assert rep["demux"]["bins"] == 96, rep["demux"]
        zero = [k for k in ("pileup_single", "pileup_multi")
                if counts[k] == 0]
        assert not zero, f"kernels not launched during run_all: {zero}"
        # every consensus and every primerless file as the native run's
        nat = self.native_out
        files = []
        for root, _, names in os.walk(os.path.join(nat, "primerless")):
            files += [os.path.relpath(os.path.join(root, n), nat)
                      for n in names]
        files += [os.path.join("sorted", b, "consensusfile.fasta")
                  for b in sorted(os.listdir(os.path.join(nat, "sorted")))
                  if os.path.isdir(os.path.join(nat, "sorted", b))]
        dev_files = []
        for root, _, names in os.walk(os.path.join(out, "primerless")):
            dev_files += [os.path.relpath(os.path.join(root, n), out)
                          for n in names]
        assert sorted(f for f in files if f.startswith("primerless")) == \
            sorted(dev_files), "primerless/ trees differ"
        for rel in files:
            with open(os.path.join(nat, rel), "rb") as a, \
                    open(os.path.join(out, rel), "rb") as b:
                assert a.read() == b.read(), f"{rel} differs"
        print(f"   {len(files)} files (every consensusfile.fasta and "
              f"primerless/ file) byte-identical to the native run's")

    # -- phases 8 and 10: the rRNA plate ----------------------------------------
    def rrna_plate(self):
        """The synthetic rRNA plate: (FASTQ path, records, planted)."""
        if not hasattr(self, "rfq"):
            from tpu_orc_torch import synthetic
            self.rbig = (3, 5)
            recs, planted = synthetic.make_rrna_plate(24, seed=13,
                                                      enlarged=self.rbig)
            self.rfq = os.path.join(WORK, "rrna_plate.fastq")
            with open(self.rfq, "w") as fh:
                fh.write("".join(f"@{r.desc}\n{r.seq}\n+\n{r.qual}\n"
                                 for r in recs))
            self.rrecs, self.rplanted = recs, planted
        return self.rfq, self.rrecs, self.rplanted

    # -- phase 8 ---------------------------------------------------------
    def locate_ks(self):
        """The KS kernel (``orc_locate_ks``) and both of its designs (16
        and 32 lanes an alignment) against locate_plain_ks, and against
        the wavefront kernel, in the three modes at min_overlap 3, at phase
        2's and the rRNA reads' shapes; then BACK at min_overlap 0, where
        the two contracts differ on exactly the empty reads. Each timed
        beside the wavefront kernel and the plain version."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.align import locate as L
        shapes = (("16,384 reads x L 512", *self.reads()),
                  ("2,048 rRNA reads x L 3,584", *self.rrna_reads()))
        for label, masks, lens in shapes:
            rt = torch.from_numpy(np.ascontiguousarray(masks.T)).cuda()
            ln = torch.from_numpy(lens).cuda()
            for mode, bank in self.banks().items():
                tabs = L.tables_for_bank(bank, mode, 3).tensors("cuda")
                A = len(bank)
                got = L.locate_cuda_ks(tabs, rt, ln, mode, A)
                want = L.locate_plain_ks(tabs, rt, ln, mode, A)
                wf = L.locate_cuda(tabs, rt, ln, mode, A)
                torch.cuda.synchronize()
                others = [(want, "its plain version"),
                          (wf, "the wavefront kernel")]
                others += [(L.locate_cuda_ks(tabs, rt, ln, mode, A, lanes=g),
                            f"the {g}-lane design") for g in L.KS_LANES]
                torch.cuda.synchronize()
                for other, what in others:
                    if not torch.equal(got, other):
                        bad = [k for k in range(8)
                               if not torch.equal(got[k], other[k])]
                        raise AssertionError(f"KS locate {mode}, {label}: "
                                             f"outputs {bad} differ from "
                                             f"{what}")
                ms = cuda_ms(lambda: L.locate_cuda_ks(tabs, rt, ln, mode, A))
                gms = {g: cuda_ms(lambda g=g: L.locate_cuda_ks(
                    tabs, rt, ln, mode, A, lanes=g)) for g in L.KS_LANES}
                wms = cuda_ms(lambda: L.locate_cuda(tabs, rt, ln, mode, A))
                pms = cuda_ms(lambda: L.locate_plain_ks(tabs, rt, ln, mode,
                                                        A), reps=3)
                print(f"   KS locate {mode}, {label}, {A} adapters: "
                      f"{int(got[4].sum())} valid hits, equal to plain, to "
                      f"the wavefront kernel and in both designs; KS kernel "
                      f"{ms:.3f} ms ("
                      + ", ".join(f"{g} lanes {t:.3f} ms"
                                  for g, t in gms.items())
                      + f"), wavefront kernel {wms:.3f} ms, plain {pms:.3f} "
                      f"ms", flush=True)
                if rt.shape[0] == 3584:      # the rRNA path's reads
                    cells = float(ln.sum()) * float(tabs[4][:A].sum())
                    self.record(f"locate_ks_{mode}",
                                "tpu_orc_torch/csrc/locate.cu",
                                "tpu_orc/align/pallas_locate.py:55",
                                max_abs_err(got, want), ms, pms,
                                nbytes(*tabs, rt, ln, got),
                                OPS_PER_CELL["locate"] * cells)
            # BACK at min_overlap 0: equal to plain in both designs, and
            # different from the wavefront kernel on the empty reads only
            tabs = L.tables_for_bank(self.banks()["back"], "back",
                                     0).tensors("cuda")
            A = len(self.banks()["back"])
            want = L.locate_plain_ks(tabs, rt, ln, "back", A)
            wf = L.locate_cuda(tabs, rt, ln, "back", A)
            for g in (None, *L.KS_LANES):
                got = L.locate_cuda_ks(tabs, rt, ln, "back", A, lanes=g)
                torch.cuda.synchronize()
                assert torch.equal(got, want), \
                    f"KS locate back at min_overlap 0, {label}, lanes {g}"
            differ = (got != wf).any(0).any(0).nonzero().flatten().cpu()
            empty = np.flatnonzero(lens == 0)
            assert np.array_equal(differ.numpy(), empty), (differ, empty)
            print(f"   KS locate back, min_overlap 0, {label}: equal to plain"
                  f" in both designs; differs from the wavefront kernel on "
                  f"exactly the {len(empty)} empty reads")

    # -- phase 17 --------------------------------------------------------
    def long_reads(self):
        """{L: (masks, lens)} of stage 01's long-read scan batches: at L
        4,096 the rRNA plate's reads; at L 8,192 half of them two rRNA
        reads fused, the second reverse-complemented in every other one
        (a fused read of one orientation holds each primer twice, so its
        nloc is 2); every 64th read
        with a 59-base span masked by X, every 97th empty."""
        from tpu_orc_torch import synthetic
        out = {}
        for L, batch in self.long_seqs().items():
            masks, lens = synthetic.read_masks(batch, L)
            lens[::97] = 0
            out[L] = masks, lens
        return out

    def long_seqs(self, every: int = 2):
        """{L: reads} of :meth:`long_reads` before packing: at L 8,192
        one read in ``every`` fused (2: half, phase 17; 33: ~3%, the
        share of stage 01's raw stream)."""
        from tpu_orc_torch.io import encode
        _, recs, _ = self.rrna_plate()
        seqs = [r.seq for r in recs[:2048]]
        other = lambda k: seqs[(k + 7) % 2048]
        fused = [s + (other(k) if k % (2 * every) == 0
                      else encode.revcomp(other(k))) if k % every == 0
                 else s for k, s in enumerate(seqs)]
        return {L: [s[:1000] + "X" * 59 + s[1059:] if k % 64 == 0 else s
                    for k, s in enumerate(batch)]
                for L, batch in ((4096, seqs), (8192, fused))}

    def locate_ks_long(self):
        """The KS kernel in INFIX mode with the pychopper bank at L 4,096
        and 8,192 against locate_plain_ks, all 8 outputs, at q 0.90 and
        0.70; each timed."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.demux.reorient import build_primer_bank
        for Lc, (masks, lens) in self.long_reads().items():
            rt = torch.from_numpy(np.ascontiguousarray(masks.T)).cuda()
            ln = torch.from_numpy(lens).cuda()
            for q in (0.9, 0.7):
                bank = build_primer_bank(os.path.join(
                    self.adapters, "M13_seqs_for_pychopper.fa"), q,
                    "cuda")[0]
                tabs = L.tables_for_bank(bank, "infix", 3).tensors("cuda")
                A = len(bank)
                got = L.locate_cuda_ks(tabs, rt, ln, "infix", A)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = L.locate_plain_ks(tabs, rt, ln, "infix", A)
                torch.cuda.synchronize()
                pms = (time.perf_counter() - t0) * 1e3
                if not torch.equal(got, want):
                    bad = [k for k in range(8)
                           if not torch.equal(got[k], want[k])]
                    raise AssertionError(f"KS INFIX at L {Lc}, q {q}: "
                                         f"outputs {bad} differ")
                ms = cuda_ms(lambda: L.locate_cuda_ks(tabs, rt, ln, "infix",
                                                      A))
                multi = int((got[6] > 1).any(0).sum())
                print(f"   KS locate infix, pychopper bank (A {A}, k "
                      f"{int(bank.k_table[0, 0])}), 2,048 reads x L {Lc}, "
                      f"{int((ln == 0).sum())} empty: {int(got[4].sum())} "
                      f"valid hits, {multi} reads with nloc > 1, max nacc "
                      f"{int(got[7].max())}; equal to plain in all 8 "
                      f"outputs; kernel {ms:.3f} ms, plain {pms:.3f} ms "
                      f"(one call)", flush=True)
                if q == 0.9:
                    cells = float(ln.sum()) * float(tabs[4][:A].sum())
                    self.record(f"locate_ks_infix_pychopper_L{Lc}",
                                "tpu_orc_torch/csrc/locate.cu",
                                "tpu_orc/align/pallas_locate.py:55",
                                max_abs_err(got, want), ms, pms,
                                nbytes(*tabs, rt, ln, got),
                                OPS_PER_CELL["locate"] * cells)

    # -- phase 18 --------------------------------------------------------
    def pack(self):
        """csrc/pack.cu against pack_masks_plain on phase 17's reads (every
        97th empty) at L 4,096 and 8,192, both tables, the kernel timed
        against its byte bound; then a scan batch of stage 01's mix (~3%
        fused, L 8,192) dispatched both ways, host clock to the end of
        the device's work: the host packing (ascii_matrix,
        read_masks_matrix, transpose, upload) against the device pack
        (join, upload, kernel); and locate_batch_lazy with the pychopper
        bank on it equal to the host-packed route, all 8 outputs."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.align import pack as PK
        from tpu_orc_torch.align.locate import INFIX
        from tpu_orc_torch.demux import demux as D
        from tpu_orc_torch.demux.reorient import build_primer_bank
        from tpu_orc_torch.io import encode
        tables = (("read", encode.mask_table(encode.encode_read_masks),
                   encode.read_masks_matrix),
                  ("iupac", encode.mask_table(encode.encode_read_masks_iupac),
                   encode.iupac_masks_matrix))
        for Lc, seqs in self.long_seqs().items():
            seqs = ["" if k % 97 == 0 else q for k, q in enumerate(seqs)]
            for name, tab, host in tables:
                got, lens = PK.pack_reads_T(seqs, Lc, tab, "cuda")
                t0 = time.perf_counter()
                want, _ = PK.pack_reads_T(seqs, Lc, tab, "cpu")
                pms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"pack {name} at L {Lc}: differs "
                                         f"from the plain version")
                amat, hl = encode.ascii_matrix(seqs, max_len=Lc)
                if not np.array_equal(want.numpy(), host(amat, hl).T):
                    raise AssertionError(f"pack {name} at L {Lc}: plain "
                                         f"differs from the host packing")
                n = sum(map(len, seqs))
                data = torch.frombuffer(bytearray("".join(seqs), "ascii"),
                                        dtype=torch.uint8).cuda()
                offs = torch.from_numpy(np.concatenate(
                    [[0], np.cumsum(lens.cpu().numpy()[:-1])])).cuda()
                launch = lambda: PK.pack_masks_cuda(data, offs, lens, tab,
                                                    Lc)
                ms, with_launch = device_ms(launch), cuda_ms(launch)
                print(f"   pack {name}, 2,048 reads x L {Lc}, {n:,} bytes "
                      f"in, {int((lens == 0).sum())} empty: equal to plain "
                      f"and to the host packing; kernel {ms:.4f} ms "
                      f"({with_launch:.4f} ms with its launch), plain "
                      f"{pms:.3f} ms (one call)", flush=True)
                if name == "read":     # phase 6 counts its launches
                    self.record("pack_masks_T" if Lc == 8192
                                else f"pack_masks_T_L{Lc}",
                                "tpu_orc_torch/csrc/pack.cu",
                                "none (tpu_orc packs on the host: "
                                "io/encode.py ascii_matrix, "
                                "read_masks_matrix)", 0, ms, pms,
                                nbytes(data, offs, lens, got) + 256, 0)
        seqs = self.long_seqs(every=33)[8192]
        tab = encode.mask_table(encode.encode_read_masks)

        def host_route():
            amat, hl = encode.ascii_matrix(seqs, max_len=8192)
            masks = encode.read_masks_matrix(amat, hl)
            torch.from_numpy(np.ascontiguousarray(masks.T)).cuda()
            torch.from_numpy(hl).cuda()

        old = host_ms(host_route)
        new = host_ms(lambda: PK.pack_reads_T(seqs, 8192, tab, "cuda"))
        join = host_ms(lambda: bytearray("".join(seqs), "ascii"))
        buf = torch.frombuffer(bytearray("".join(seqs), "ascii"),
                               dtype=torch.uint8)
        up = host_ms(lambda: buf.cuda())
        n = sum(map(len, seqs))
        print(f"   scan batch of stage 01's mix (2,048 reads, "
              f"{sum(len(q) > 4096 for q in seqs)} fused, {n:,} bytes, L "
              f"8,192) to the card's [L, B] masks: host packing {old:.3f} "
              f"ms ({old / 2.048:.2f} us a read), device pack {new:.3f} ms "
              f"({new / 2.048:.2f} us a read; the join and encode "
              f"{join:.3f} ms, the bytes' pageable upload {up:.3f} ms)",
              flush=True)
        bank = build_primer_bank(os.path.join(
            self.adapters, "M13_seqs_for_pychopper.fa"), 0.9, "cuda")[0]
        tabs = L.tables_for_bank(bank, "infix", 3)
        L.LOCATE_IMPL = "ks"
        try:
            before = PK.LAUNCHES.snapshot()["pack"]
            got = D.locate_batch_collect(D.locate_batch_lazy(
                bank, seqs, INFIX, 3))
            amat, hl = encode.ascii_matrix(seqs, max_len=8192)
            want = L.locate_collect(*L.locate_dispatch(
                tabs, encode.read_masks_matrix(amat, hl), hl, "infix",
                "cuda"))
        finally:
            L.LOCATE_IMPL = "wf"
        assert PK.LAUNCHES.snapshot()["pack"] == before + 1
        bad = [f for f in want._fields
               if not np.array_equal(getattr(got, f), getattr(want, f))]
        if bad:
            raise AssertionError(f"locate_batch_lazy, device pack: {bad} "
                                 f"differ from the host-packed route")
        print(f"   locate_batch_lazy (KS INFIX, pychopper bank) on the "
              f"device pack: equal to the host-packed route in all 8 "
              f"outputs, {int(got.valid.sum())} valid hits", flush=True)

    # -- phase 19 --------------------------------------------------------
    def emit_cuts(self):
        """{L: segment cuts} over phase 17's reads: a quality a read (none
        on every 29th), one segment a read 0-60 bases inside each end,
        a fused read cut in two at its middle, every 13th segment cut
        under 50 bases; the sign alternating."""
        import numpy as np
        rnd = np.random.default_rng(19)
        out = {}
        for Lc, seqs in self.long_seqs().items():
            quals = [None if k % 29 == 0 else
                     "".join(chr(33 + int(x))
                             for x in rnd.integers(0, 40, len(s)))
                     for k, s in enumerate(seqs)]
            cuts = []
            for k, s in enumerate(seqs):
                n = len(s)
                mids = [0, n // 2, n] if n > 4096 else [0, n]
                for g in range(len(mids) - 1):
                    a = min(mids[g] + int(rnd.integers(0, 61)), mids[g + 1])
                    b = max(mids[g + 1] - int(rnd.integers(0, 61)), a)
                    if (k + g) % 13 == 0:
                        b = min(b, a + int(rnd.integers(0, 50)))
                    cuts.append((k, a, b, (k + g) % 2 == 1,
                                 g if len(mids) > 2 else 0))
            read, s0, s1, neg, seg = (np.array(x) for x in zip(*cuts))
            out[Lc] = (seqs, quals, [f"p17_{k}" for k in range(len(seqs))],
                       read, s0, s1, neg, seg)
        return out

    def emit(self):
        """csrc/emit.cu against emit_plain and against format_records over
        the Records of _make_segment, on phase 17's reads and on the
        segment plan of a 65,536-read block of rrna.reorient's mix; the
        kernel timed against its byte bound (device time: 20 launches
        behind a spin); the block's emit on the host clock against the
        old segment and format path."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import _build
        from tpu_orc_torch.demux import emit as E
        from tpu_orc_torch.demux import reorient as R
        from tpu_orc_torch.io import encode
        from tpu_orc_torch.io.fastq import Record, format_records
        for fn, regs, frame in ptxas_summary(_build.PTXAS_LOG.get("emit",
                                                                  "")):
            print(f"   emit ptxas {demangle(fn)}: {regs}; {frame}")

        def check(args, label):
            """(got, offs) of the cuts on the card, equal to the plain
            version and to format_records; the kernel's device time and
            byte bound recorded under ``label``."""
            seqs, quals, ids, read, s0, s1, neg, seg = args
            got, offs = E.Emitter("cuda")(*args)
            got = bytes(got)
            t0 = time.perf_counter()
            want, woffs = E.Emitter("cpu")(*args)
            pms = (time.perf_counter() - t0) * 1e3
            if got != bytes(want) or not np.array_equal(offs, woffs):
                raise AssertionError(f"emit {label}: differs from plain")
            kept = [Record(i, i, s, q) for i, s, q in zip(ids, seqs, quals)]
            text = format_records(
                [R._make_segment(kept[c], seqs[c], quals[c], n, a, b, g)
                 for c, a, b, n, g in zip(read.tolist(), s0.tolist(),
                                          s1.tolist(), neg.tolist(),
                                          seg.tolist())], "fastq")
            if got != text.encode("utf-8"):
                raise AssertionError(f"emit {label}: differs from "
                                     f"format_records")
            chunks, recs = E.pack_segments(*args)
            data = torch.frombuffer(bytearray(b"".join(chunks)),
                                    dtype=torch.uint8).cuda()
            rt, ot = (torch.from_numpy(x).cuda() for x in (recs, offs))
            total = int(offs[-1])
            launch = lambda: E.emit_cuda(data, rt, ot, encode._COMP_TAB,
                                         total)
            ms, with_launch = device_ms(launch), cuda_ms(launch)
            n_in = int(recs[:, [E.SEQ_LEN, E.QUAL_LEN]].sum()
                       + recs[:, E.NAME_LEN].sum())
            print(f"   emit {label}: {len(recs):,} records, {n_in:,} bytes "
                  f"of slices in, {total:,} bytes out, {int(neg.sum()):,} "
                  f"reversed, {int((s1 - s0 < 50).sum()):,} under 50 "
                  f"bases: equal to plain and to format_records; kernel "
                  f"{ms:.4f} ms ({with_launch:.4f} ms with its launch), "
                  f"plain {pms:.3f} ms (one call)", flush=True)
            self.record(label, "tpu_orc_torch/csrc/emit.cu",
                        "none (tpu_orc builds a Record a segment: "
                        "demux/reorient.py _make_segment, format)", 0, ms,
                        pms, n_in + nbytes(rt, ot) + 256 + total, 0)
            return ms

        for Lc, args in self.emit_cuts().items():
            check(args, f"emit_fastq_L{Lc}")
        # a block of the cell's mix, its plan made by Reorienter.run
        sys.path.insert(0, HERE)
        from orc_bench import gen_raw
        with open(os.path.join(HERE, "orc_bench", "configs",
                               "rrna_pychopper96.json")) as fh:
            cfg = json.load(fh)
        with open(os.path.join(HERE, "orc_bench", "traffic",
                               "raw_rrna_stream.json")) as fh:
            mix = json.load(fh)
        t0 = time.perf_counter()
        pool = gen_raw.raw_pool(2222000019, cfg, mix)
        recs = [Record(f"b{i}", f"b{i}", s, q)
                for i, (s, q) in enumerate(zip(pool.seqs, pool.quals))]
        print(f"   block of {len(recs):,} raw reads made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        pf = os.path.join(WORK, "pychopper_bench.fa")
        with open(pf, "w") as fh:
            fh.write("".join(f">{n}\n{q}\n" for n, q in
                             gen_raw.pychopper_primers(cfg["bank_seed"])))
        reo = R.Reorienter(pf, cfg["orientation_config"], R.ReorientConfig(
            qmin=cfg["qmin"], q=0.9, device="cuda"))
        t0 = time.perf_counter()
        res = reo.run(recs)
        p = res.plan
        print(f"   Reorienter.run on the block: {time.perf_counter() - t0:.2f}"
              f" s, {len(p):,} segments ({res.stats})", flush=True)
        args = (p.work, [r.qual for r in p.kept], [r.id for r in p.kept],
                p.ci, p.s0, p.s1, p.neg, p.seg_no)
        check(args, "emit_fastq")
        files = res.file_bytes()
        old = [format_records(x, "fastq").encode() for x in (
            p.records(R.PASS), p.records(R.RESCUED), res.unclass,
            p.records(R.SHORT))]
        if [bytes(f) for f in files] != old:
            raise AssertionError("the block's four files differ from the "
                                 "old segment and format path")

        def old_path():
            for dest in (R.PASS, R.RESCUED, R.SHORT):
                format_records(p.records(dest), "fastq").encode()

        emitter = E.Emitter("cuda")
        new = host_ms(lambda: emitter(*args), reps=3)
        was = host_ms(old_path, reps=3)
        n = len(recs)
        print(f"   the block's segment records to bytes: emit on the card "
              f"{new:.1f} ms ({new * 1e3 / n:.2f} us a read: joins, "
              f"uploads, kernel, download), old segment and format path "
              f"{was:.1f} ms ({was * 1e3 / n:.2f} us a read)", flush=True)

    # -- phase 9 ---------------------------------------------------------
    def viterbi(self):
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.rrna import hmm as H
        from tpu_orc_torch.rrna.profiles import (_reverse_profile,
                                                 default_euk_profiles)
        rng = np.random.default_rng(9)
        _, recs, _ = self.rrna_plate()
        from tpu_orc_torch.io import encode
        seqs = np.full((8, 3584), 4, np.uint8)
        lens = np.zeros(8, np.int32)
        for i, r in enumerate(recs[:8]):
            c = encode.encode_codes(r.seq[:3584])
            seqs[i, :len(c)] = c
            lens[i] = len(c)
        lens[5] = 0                          # an empty sequence
        profs = default_euk_profiles()
        rand = [H.ProfileHMM(f"random_{K}", rng.normal(0.0, 1.0, (K, 4)),
                             rng.normal(-2.0, 1.0, (K, 7)))
                for K in (1800, H.MAX_WARP_NODES)]
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
        bits = lambda x: x.view(torch.int32)
        for p in (profs["18S"], _reverse_profile(profs["28S"]), *rand):
            args = (put(np.asarray(p.match_scores, np.float32)),
                    put(np.asarray(p.t, np.float32)), put(H.dd_prefix(p.t)),
                    put(seqs), put(lens))
            designs = [d for d in H.DESIGNS
                       if d == "block" or p.K <= H.MAX_WARP_NODES]
            got = {d: H.viterbi_cuda(*args, design=d) for d in designs}
            want = H.viterbi_plain(*args)
            torch.cuda.synchronize()
            for d, g in got.items():
                for name, x, w, y in zip(("score", "pos", "node"), g, want,
                                         got["block"]):
                    if not torch.equal(bits(x), bits(w)):
                        raise AssertionError(f"viterbi {p.name}, {d} design:"
                                             f" {name} differs from plain")
                    if not torch.equal(bits(x), bits(y)):
                        raise AssertionError(f"viterbi {p.name}: {name} "
                                             f"differs between the designs")
            chosen = H.choose_viterbi_design(p.K)
            g = got[chosen]
            err = max(float((g[0] - want[0]).abs().max()),
                      max_abs_err(g[1], want[1]), max_abs_err(g[2], want[2]))
            ms = {d: cuda_ms(lambda d=d: H.viterbi_cuda(*args, design=d))
                  for d in designs}
            pms = cuda_ms(lambda: H.viterbi_plain(*args), reps=3)
            print(f"   viterbi {p.name} (K {p.K}), 8 x 3,584: score bits, "
                  f"position and node equal to plain"
                  f"{' and between the designs' if len(designs) > 1 else ''}"
                  f"; best scores {[round(float(x), 2) for x in g[0][:3]]}; "
                  + ", ".join(f"{d} design {t:.3f} ms" for d, t in ms.items())
                  + f" (the wrapper's choice: {chosen}), plain {pms:.3f} ms")
            if p is profs["18S"]:            # the default path's profile
                n_ops = OPS_PER_CELL["viterbi"] * float(lens.sum()) * p.K
                self.record("viterbi", "tpu_orc_torch/csrc/viterbi.cu",
                            "tpu_orc/rrna/hmm.py:170", err, ms[chosen], pms,
                            nbytes(*args, *g), n_ops, FP32_OPS_PER_S)

    # -- phase 10 --------------------------------------------------------
    def rrna_path(self):
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.pipeline.stages import (PipelineConfig,
                                                   stage_demux,
                                                   stage_reorient)
        fq, recs, planted = self.rrna_plate()
        out = os.path.join(WORK, "rrna", "ks")
        self.rrna_out = out
        L.LOCATE_IMPL = "ks"
        try:
            rep, counts = self.run_all(out, fq, len(recs), "RNA", self.rbig)
        finally:
            L.LOCATE_IMPL = "wf"
        self.launches({f"locate_ks_{m}": counts[f"locate_ks_{m}"]
                       for m in ("front", "back", "infix")})
        self.launches({"viterbi": counts["viterbi_scan_warp"]
                       + counts["viterbi_scan_block"]})
        self.launches({f"{k}_rrna": n
                       for k, n in myers_launches(counts).items()})
        self.launches({"pack_masks_T_rrna": counts["pack_pack"]})
        assert rep["demux"]["bins"] == 96, rep["demux"]
        zero = [k for k in ("locate_ks_front", "locate_ks_back",
                            "locate_ks_infix", "viterbi_scan_warp",
                            "myers_dense_warp", "myers_pairs_warp",
                            "pack_pack")
                if counts[k] == 0]
        assert not zero, f"kernels not launched during run_all: {zero}"
        off = [k for k in ("myers_dense_thread", "myers_pairs_thread",
                           "viterbi_scan_block") if counts[k]]
        assert not off, f"Myers or Viterbi launches off the warp design: {off}"
        wf = [k for k in ("locate_front", "locate_back", "locate_infix")
              if counts[k]]
        assert not wf, f"wavefront locate launched under ks: {wf}"
        genes = os.path.join(out, "rRNA_genes")
        for s5, s27 in planted:
            for gene in ("18S", "28S"):
                path = os.path.join(genes, f"{s27}_{s5}_{gene}.fa")
                with open(path) as fh:
                    n = fh.read().count(">")
                assert n >= 1, f"no {gene} hit in bin {s27}_{s5}"
        print(f"   96 bins, an 18S and a 28S hit in every bin: "
              f"{rep['barcodes'][f'SP27_{self.rbig[1] + 1:03d}_SP5_{self.rbig[0] + 1:03d}']}"
              f" in the enlarged bin")
        # stages 01-02 with the wavefront locate: the same files
        wout = os.path.join(WORK, "rrna", "wf")
        import shutil
        shutil.rmtree(wout, ignore_errors=True)
        cfg = PipelineConfig(self.adapters, device="cuda")
        L.LAUNCHES.reset()
        t0 = time.perf_counter()
        stage_reorient(fq, wout, "plate", cfg)
        t1 = time.perf_counter()
        stage_demux(os.path.join(wout, "pychopped", "plate_pass.fastq"),
                    wout, "plate", cfg)
        t2 = time.perf_counter()
        wfc = L.LAUNCHES.snapshot()
        print(f"   stages 01-02 with the wavefront locate: 01 {t1 - t0:.2f} "
              f"s, 02 {t2 - t1:.2f} s; launches {wfc}")
        self.launches({f"locate_{m}_rrna": wfc[m]
                       for m in ("front", "back", "infix")})
        zero = [m for m in ("front", "back", "infix") if wfc[m] == 0]
        assert not zero, f"wavefront locate not launched: {zero}"
        assert not any(wfc[f"ks_{m}"] for m in ("front", "back", "infix")), wfc
        n = 0
        for sub in ("pychopped", "demuxed"):
            a, b = read_tree(os.path.join(out, sub)), \
                read_tree(os.path.join(wout, sub))
            assert sorted(a) == sorted(b), f"{sub}/ trees differ"
            for rel in a:
                assert a[rel] == b[rel], f"{sub}/{rel} differs"
            n += len(a)
        print(f"   stages 01-02 with the wavefront locate: {n} files "
              f"byte-identical to the KS run's")

    # -- phase 11 --------------------------------------------------------
    def batched_reads(self):
        """2,048 reads x L 512 for the batched locate: COI plate reads,
        every 8th replaced by 30 random bp and the first 260 or 290 bp of
        a long-bank adapter (the read ends there: fault 6's case), every
        8th by the last 260 or 290 bp of one followed by the read, every
        97th of the rest empty, then every 4th reverse-complemented.
        Returns (masks, lens, planted) with planted[k] = (adapter, bp) of
        the prefix-planted reads."""
        import random
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.io import encode
        rnd = random.Random(17)
        rand = lambda n: "".join(rnd.choice("ACGT") for _ in range(n))
        self.longs = [rand(n) for n in (64, 127, 200, 255, 256, 300)]
        recs, _ = synthetic.make_plate(30, seed=23, insert_len=330)
        seqs, planted = [], {}
        for k in range(2048):
            s = recs[k].seq[:512]
            j, cut = k // 8 % 6, (260, 290)[k // 48 % 2]
            a = self.longs[j]
            if k % 8 == 0:
                s = rand(30) + a[:cut]
                planted[k] = (j, min(cut, len(a)))
            elif k % 8 == 4:
                s = (a[-cut:] + s)[:512]
            elif k % 97 == 5:
                s = ""
            if k % 4 == 3:
                s = encode.revcomp(s)
            seqs.append(s)
        masks, lens = synthetic.read_masks(seqs, 512)
        return masks, lens, planted

    def batched_long_reads(self):
        """2,048 rRNA plate reads x L 3,584 for the batched locate with
        the long bank: every 8th carries the first 260 or 290 bp of a
        long-bank adapter at its end (cut to 3,000 bp before it), every
        8th the last 260 or 290 bp of one at its start, every 97th of the
        rest is empty, every 4th is reverse-complemented, then all are
        shuffled (seeded)."""
        import random
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.io import encode
        rnd = random.Random(29)
        _, recs, _ = self.rrna_plate()
        seqs = []
        for k in range(2048):
            s = recs[k].seq[:3584]
            a = self.longs[k // 8 % 6]
            cut = (260, 290)[k // 48 % 2]
            if k % 8 == 0:
                s = s[:3000] + a[:cut]
            elif k % 8 == 4:
                s = (a[-cut:] + s)[:3584]
            elif k % 97 == 5:
                s = ""
            if k % 4 == 3:
                s = encode.revcomp(s)
            seqs.append(s)
        rnd.shuffle(seqs)
        return synthetic.read_masks(seqs, 3584)

    def batched_row(self, label, bank, tabs, reads, flags, mo, timed):
        """One comparison of the batched kernel with its plain version,
        all 9 fields; timed ones record a kernel entry."""
        torch = self.torch
        from tpu_orc_torch.align import batched as BL
        from tpu_orc_torch.align.spec import FRONT
        got = BL.batched_locate_cuda(*tabs, *reads, flags, mo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = BL.batched_locate_plain(*tabs, *reads, flags, mo)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            bad = [BL.FIELDS[k] for k in range(9)
                   if not torch.equal(got[k], want[k])]
            raise AssertionError(f"batched locate{label} flags {flags} "
                                 f"min_overlap {mo}: {bad} differ")
        if not timed:
            return got
        mode = "front" if flags == int(FRONT) else "back"
        name = f"batched_locate_{mode}{label}"
        ms = cuda_ms(lambda: BL.batched_locate_cuda(*tabs, *reads, flags,
                                                    mo))
        cells = float(reads[1].sum()) * float(bank.lens.sum())
        self.record(name, "tpu_orc_torch/csrc/batched.cu",
                    "tpu_orc/align/batched.py:121", max_abs_err(got, want),
                    ms, pms, nbytes(*tabs, *reads, got),
                    OPS_PER_CELL["locate"] * cells)
        k = BL.choose_k(int(bank.lens.max()))
        print(f"   {name}: 16 lanes x {k} rows a lane, "
              f"{BL.n_bands(bank.lens, k).tolist()} bands, {ms:.3f} ms "
              f"({ms / self.kernels[name]['bound_ms']:.2f}x bound)",
              flush=True)
        return got

    def batched(self):
        """The batched locate kernel against its plain version on the
        card (every valid flag set at min_overlap 3 and 0, on the SP5
        59-mers and on a long bank of 64-300 bp adapters; FRONT and BACK
        on a 4-adapter 70 bp bank and on the long bank at L 3,584), then
        stage_demux on lengthened banks on the card and on the CPU."""
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align.spec import BACK, FRONT
        from tpu_orc_torch.demux.adapters import AdapterBank
        masks, lens, planted = self.batched_reads()
        sp5 = AdapterBank.from_fasta(
            os.path.join(self.adapters, "M13_amplicon_indices_forward.fa"),
            0.1, "cuda")
        longb = AdapterBank([f"L{len(a)}" for a in self.longs], self.longs,
                            0.1, "cuda")
        b70 = AdapterBank.from_pairs(synthetic.banks(head=11)["sp5"][:4],
                                     0.1, "cuda")
        reads = [torch.from_numpy(x).cuda() for x in (masks, lens)]
        rreads = [torch.from_numpy(x).cuda()
                  for x in self.batched_long_reads()]
        flag_sets = [f for f in range(16) if not (f & 1 and f & 4)]
        timed = (int(FRONT), int(BACK))

        def tables(bank):
            return [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                    for x in (bank.masks, bank.lens, bank.k_table,
                              bank.n_prefix)]

        for label, bank in (("", sp5), ("_long", longb)):
            tabs = tables(bank)
            for flags in flag_sets:
                for mo in (3, 0):
                    got = self.batched_row(label, bank, tabs, reads, flags,
                                           mo, mo == 3 and flags in timed)
                    if flags == int(BACK) and label:
                        stop = got[4].cpu().numpy()
                        for k, (j, bp) in planted.items():
                            if len(self.longs[j]) >= 256:
                                assert got[0, k, j] and stop[k, j] >= 256, \
                                    (k, j, bp, int(stop[k, j]))
                        print(f"   BACK, long bank: every read planted with "
                              f"the first 260 or 290 bp of the 256 and 300 "
                              f"bp adapters gives refstop >= 256")
            print(f"   batched locate{label or ' (SP5 59-mers)'}: "
                  f"{len(bank)} adapters of {int(bank.lens.min())}-"
                  f"{int(bank.lens.max())} bp x 2,048 reads x L 512 "
                  f"({int((reads[1] == 0).sum())} empty): all 9 fields "
                  f"equal to plain for {len(flag_sets)} flag sets at "
                  f"min_overlap 3 and 0", flush=True)
        for label, bank, rd, shape in (
                ("_b70", b70, reads, "2,048 reads x L 512"),
                ("_long3584", longb, rreads, "2,048 rRNA reads x L 3,584")):
            tabs = tables(bank)
            for flags in timed:
                self.batched_row(label, bank, tabs, rd, flags, 3, True)
            print(f"   batched locate{label}: {len(bank)} adapters of "
                  f"{int(bank.lens.min())}-{int(bank.lens.max())} bp x "
                  f"{shape} ({int((rd[1] == 0).sum())} empty): FRONT and "
                  f"BACK equal to plain at min_overlap 3", flush=True)
        print("   the earlier thread design (NVIDIA H100 80GB HBM3, "
              "700.00 W) against this run: " + ", ".join(
                  f"{n} {ms:.3f} -> {self.kernels[n]['ms']:.3f} ms"
                  for n, ms in THREAD_DESIGN_MS.items()), flush=True)
        self.demux_long()

    def demux_long(self):
        """stage_demux on 1,000 reads of a plate whose SP5 and SP27-rc
        adapters carry a shared 11 bp head (70 bp: the batched locate's
        route), on the card and on the CPU: the same files, the batched
        kernel launched, the wavefront locate and the fused demux not."""
        import shutil
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import batched as BL
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.demux import demux as D
        from tpu_orc_torch.demux.adapters import AdapterBank
        from tpu_orc_torch.pipeline.stages import PipelineConfig, stage_demux
        adir = synthetic.write_adapter_dir(
            os.path.join(WORK, "adapters_long"), head=11)
        recs, _ = synthetic.make_plate(50, n5=5, n27=4, seed=19,
                                       insert_len=180, head=11)
        fq = os.path.join(WORK, "plate_long.fastq")
        with open(fq, "w") as fh:
            fh.write("".join(f"@{r.desc}\n{r.seq}\n+\n{r.qual}\n"
                             for r in recs))
        cfg = PipelineConfig(adir, device="cuda")
        banks = [AdapterBank.from_fasta(p, 0.1, "cuda")
                 for p in (cfg.sp5_fasta, cfg.sp27rc_fasta)]
        assert not D._use_fused(*banks), "fused demux on 70 bp banks"
        trees = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(WORK, "demux_long", dev)
            shutil.rmtree(out, ignore_errors=True)
            L.LAUNCHES.reset()
            BL.LAUNCHES.reset()
            t0 = time.perf_counter()
            rep = stage_demux(fq, out, "long",
                              PipelineConfig(adir, device=dev))
            wall = time.perf_counter() - t0
            counts = {"locate": L.LAUNCHES.snapshot(),
                      "batched": BL.LAUNCHES.snapshot()}
            trees[dev] = read_tree(os.path.join(out, "demuxed"))
            print(f"   stage_demux, {len(recs)} reads, 70 bp banks, device "
                  f"{dev}: {wall:.1f} s, {len(rep['final_bins'])} bins, "
                  f"{sum(rep['final_bins'].values())} binned reads; "
                  f"launches {counts}", flush=True)
            if dev == "cuda":
                cuda_counts = counts
                assert len(rep["final_bins"]) == 20, rep["final_bins"]
        on = {k: n for k, n in cuda_counts["locate"].items() if n}
        assert not on, f"locate kernels launched on 70 bp banks: {on}"
        bc = cuda_counts["batched"]
        assert bc["front"] and bc["back"], bc
        for label in ("", "_long", "_b70", "_long3584"):
            self.launches({f"batched_locate_{m}{label}": bc[m]
                           for m in ("front", "back")})
        a, b = trees["cuda"], trees["cpu"]
        assert sorted(a) == sorted(b), "demuxed/ trees differ"
        for rel in a:
            assert a[rel] == b[rel], f"demuxed/{rel} differs"
        print(f"   {len(a)} demuxed/ files byte-identical on the card and "
              f"on the CPU")

    # -- phase 12 --------------------------------------------------------
    def traced(self):
        """``run-all --trace`` on phase 6's COI plate: the same files as
        phase 6, and a trace whose CUDA kernel events are the run's
        launches, family by family; prints the device's busy share and
        the device time per kernel."""
        import glob
        import gzip
        import shutil
        out = os.path.join(WORK, "plate", "traced")
        tdir = os.path.join(WORK, "trace")
        shutil.rmtree(tdir, ignore_errors=True)
        rep, counts = self.coi_run(out, "native", trace=tdir)
        files = glob.glob(os.path.join(tdir, "*.pt.trace.json.gz"))
        assert len(files) == 1, files
        size = os.path.getsize(files[0])
        with gzip.open(files[0], "rt") as fh:
            events = json.load(fh)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        fam = trace_families(kern)
        counted = {
            "locate_kernel (wavefront)": sum(
                counts[f"locate_{m}"] for m in ("front", "back", "infix")),
            "myers_kernel": counts["myers_dense_thread"]
            + counts["myers_pairs_thread"],
            "myers_warp_kernel": counts["myers_dense_warp"]
            + counts["myers_pairs_warp"]}
        for name, n in counted.items():
            assert fam.get(name, 0) == n, \
                f"{name}: {fam.get(name, 0)} events in the trace, {n} launches"
        launched = [k for k, n in self.phase6_counts.items() if n]
        assert all(counts[k] == self.phase6_counts[k] for k in launched), \
            (counts, self.phase6_counts)
        ts = [e["ts"] for e in events if "ts" in e and e.get("ph") == "X"]
        te = [e["ts"] + e.get("dur", 0) for e in events
              if "ts" in e and e.get("ph") == "X"]
        window = max(te) - min(ts)
        busy = union_us(kern)
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
        per = {}
        for e in kern:
            k = trace_family(e["name"])
            per[k] = per.get(k, 0.0) + e["dur"]
        print(f"   trace {os.path.basename(files[0])}: {size} bytes gzipped, "
              f"{len(events)} events, {len(kern)} kernel events; every "
              f"kernel family of the run found, events = launches: "
              f"{counted}")
        print(f"   device busy share (union of kernel intervals over the "
              f"traced window): {busy / 1e3:.3f} ms of {window / 1e6:.3f} s"
              f" = {100 * busy / window:.4f}%; with copies "
              f"{100 * union_us(kern + copies) / window:.4f}%")
        print(f"   device time per kernel, ms: " + "; ".join(
            f"{k} {v / 1e3:.3f} ({fam[k]} launches)"
            for k, v in sorted(per.items(), key=lambda x: -x[1])))
        print(f"   run_all walls, traced: {rep['metrics']['total_wall_s']} s"
              f" of stage time (phase 6: {self.phase6_wall} s)")
        a, b = read_tree(self.native_out), read_tree(out)
        skip = ("metrics.json", "run_report.json")
        a = {k: v for k, v in a.items() if k not in skip}
        b = {k: v for k, v in b.items() if k not in skip}
        assert sorted(a) == sorted(b), "traced run_all tree differs"
        for rel in a:
            assert a[rel] == b[rel], f"{rel} differs with --trace"
        print(f"   {len(a)} files byte-identical to phase 6's (all but "
              f"metrics.json and run_report.json)")

    # -- phase 13 --------------------------------------------------------
    def downstream(self):
        """Stages 06-09 through the CLI on the plates' trees and on small
        inputs written here; each JSON line printed and checked."""
        import contextlib
        import importlib.util
        import io
        from tpu_orc_torch import cli

        def run(*argv):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                assert cli.main(list(argv)) == 0, argv
            line = log.getvalue().strip().splitlines()[-1]
            print(f"   cli {argv[0]}: {line}")
            return json.loads(line)

        d = os.path.join(WORK, "downstream")
        os.makedirs(d, exist_ok=True)
        coi = self.native_out
        got = run("extract-max", "coi", os.path.join(coi, "COI_gene"), "-o",
                  os.path.join(d, "coi_max"))
        with open(os.path.join(d, "coi_max", "coi_extraction_log.tsv")) as fh:
            logged = fh.read().count("_COI.fasta")
        # the plate's ~450 bp contigs fall in the discarded 350-599 band
        assert logged == 96 and got == {"moorea": 0, "sauron": 0}, \
            (logged, got)
        got = run("extract-max", "ribo", os.path.join(self.rrna_out,
                                                      "rRNA_genes"),
                  "-o", os.path.join(d, "ribo_max"))
        assert got == {"18S": 96, "28S": 96}, got
        for tree in (coi, self.rrna_out):
            got = run("summary", os.path.join(tree, "sorted"), "-o",
                      os.path.join(d, f"{os.path.basename(tree)}.tsv"))
            assert got == {"rows": 96, "found": 96}, got
        tsv = os.path.join(d, "blast.tsv")
        with open(tsv, "w") as fh:
            fh.write("".join(f"q{q}\t500\ts{i}\t{10.0 ** -i}\t50\t98\t1\n"
                             for q in range(3) for i in range(8)))
        got = run("blast-top5", tsv, "-o", os.path.join(d, "top5.tsv"))
        assert got == {"kept": 15}, got
        with open(os.path.join(d, "curated.csv"), "w") as fh:
            fh.write("sample,fasta_header,barcode,expected_taxon,name\n"
                     "SP27_001_SP5_001_plate,SP27_001_SP5_001_group1,COI,"
                     "Mollusca,snailA\n")
        fa = os.path.join(d, "coi.fa")
        with open(fa, "w") as fh:
            fh.write(">consensus_SP27_001_SP5_001_group1\nACGTACGT\n")
        got = run("reorganise", os.path.join(d, "curated.csv"), "--coi", fa,
                  "--r18s", fa + ".none", "--r28s", fa + ".none", "-o", d)
        assert got == {"Mollusca/COI": 1}, got
        with open(os.path.join(d, "aligned.fa"), "w") as fh:
            fh.write(">s1|x\nACGT\n>anch 1\nACGT\n")
        with open(os.path.join(d, "samples.fa"), "w") as fh:
            fh.write(">s1|x\nACGT\n")
        got = run("prep-anchors", os.path.join(d, "aligned.fa"),
                  os.path.join(d, "samples.fa"), "-g", "COI", "-o",
                  os.path.join(d, "anchors"))
        with open(got["metadata"]) as fh:
            meta = fh.read()
        assert "s1_x,sample" in meta and "anch_1,anchor" in meta, meta
        if importlib.util.find_spec("matplotlib") is None:
            print("   cli figures: not run, this host has no matplotlib "
                  "(the figures are tested on the CPU)")
        else:
            run("figures", "-o", os.path.join(d, "figs"), "--blast-csv",
                os.path.join(d, "curated.csv"))
        # prewarm: the build (done by phase 1, so ~0 s here), then one
        # fused demux per read-length bucket and one dense Myers per
        # length bucket on every card
        got = run("prewarm", "--adapters-dir", self.adapters)
        cards = [f"cuda:{k}" for k in range(self.torch.cuda.device_count())]
        want = {"nvcc_build"} | {f"fused_demux_L{L}_B2048_{c}"
                                 for L in (384, 512, 640) for c in cards} \
            | {f"myers_NW_L{L}_{c}" for L in (512, 4096, 8192)
               for c in cards}
        assert set(got) == want, sorted(got)

    # -- phase 14 --------------------------------------------------------
    def mesh_setup(self):
        """The mesh of phase 14: every visible card, or cuda:0 listed
        twice where only one card is visible (striping, padding and the
        gather run all the same; the stripes then run in order on the
        card's stream)."""
        torch = self.torch
        from tpu_orc_torch.dist.sharded import make_mesh
        self.n_cards = torch.cuda.device_count()
        self.mesh = (make_mesh() if self.n_cards > 1
                     else make_mesh(devices=["cuda:0", "cuda:0"]))
        self.mesh_devs = [str(d) for d in self.mesh.devices.flat]
        how = ("stripes on distinct cards, launched together" if
               self.n_cards > 1 else "one card listed twice: its stripes "
               "run one after another on its stream, not concurrently")
        print(f"   mesh {self.mesh_devs} ({self.n_cards} visible cards): "
              f"{how}")

    def mesh_banks(self, head=0):
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.demux.adapters import AdapterBank
        b = synthetic.banks(head=head)
        return (AdapterBank.from_pairs(b["sp5"], 0.1, "cuda"),
                AdapterBank.from_pairs(b["sp27rc"], 0.1, "cuda"))

    def mesh_decide(self):
        """(a) decide_multi on a flowcell chunk of 65,536 COI reads at the
        read-length bucket ``assign`` picks (L 640): the 8 vectors of
        single-device ``decide``; on 4,096 of them the plain path's;
        reads/s over one card (one stripe, two stripes) and over every
        card."""
        import numpy as np
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.align.locate import locate_plain
        from tpu_orc_torch.demux.fused import FusedDemux
        from tpu_orc_torch.io import encode
        sp5, sp27 = self.mesh_banks()
        t0 = time.perf_counter()
        recs, _ = synthetic.make_plate(683, seed=31, insert_len=450)
        seqs = [r.seq for r in recs[:65536]]
        # assign's bucket
        Lb = max(encode.bucket_len(max(len(x) for x in seqs)), 256)
        amat, lens = encode.ascii_matrix(seqs, max_len=Lb)
        masks = encode.read_masks_matrix(amat, lens)
        print(f"   {len(seqs)} reads made and packed at L {Lb} in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        assert Lb == 640, Lb
        fd = FusedDemux(sp5, sp27)
        want = fd.decide(masks, lens)
        L.LAUNCHES.reset()
        got = fd.decide_multi(masks, lens, self.mesh_devs)
        per = {d: n for d, n in L.LAUNCHES.by_device().items()}
        for name, g, w in zip(want._fields, got, want):
            assert np.array_equal(g, w), f"decide_multi {name} differs"
        assert sorted(per) == sorted(set(self.mesh_devs)), per
        n = 4096
        plain = FusedDemux(sp5, sp27, locate=locate_plain).decide(
            masks[:n], lens[:n])
        for name, g, w in zip(want._fields, got, plain):
            assert np.array_equal(g[:n], w), f"{name} differs from plain"
        print(f"   decide_multi over {self.mesh_devs}: 8 vectors equal to "
              f"decide on cuda:0 ({int((got.idx2 >= 0).sum())} reads binned"
              f"), to the plain path on the first {n}; "
              f"locate launches by device {per}")
        configs = [("1 card, 1 stripe", ["cuda:0"]),
                   ("1 card, 2 stripes", ["cuda:0", "cuda:0"])]
        if self.n_cards > 1:
            configs.append((f"{self.n_cards} cards",
                            [f"cuda:{k}" for k in range(self.n_cards)]))
        rates = {}
        for label, devs in configs:
            ms = host_ms(lambda devs=devs: fd.decide_multi(masks, lens, devs),
                         reps=3)
            rates[label] = len(seqs) / ms * 1e3
            print(f"   decide_multi, {label}: {ms:.1f} ms a chunk "
                  f"(host clock, upload to fetch), {rates[label]:.0f} "
                  f"reads/s")
        self.mesh_rates = rates

    def mesh_sharded_demux(self):
        """(b) sharded_dual_demux_step and sharded_demux_step on 70 bp
        banks (the batched kernel's route) at 16,384 reads: equal to the
        same steps on cuda:0 alone; the histograms sum to the reads and
        agree with the assignments."""
        import numpy as np
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import batched as BL
        from tpu_orc_torch.dist import sharded as S
        sp5, sp27 = self.mesh_banks(head=11)
        recs, _ = synthetic.make_plate(171, seed=37, insert_len=330, head=11)
        masks, lens = synthetic.read_masks([r.seq for r in recs[:16384]],
                                           640)
        one = S.make_mesh(devices=["cuda:0"])
        BL.LAUNCHES.reset()
        got = S.sharded_dual_demux_step(self.mesh, sp5, sp27, masks, lens)
        per = BL.LAUNCHES.by_device()
        want = S.sharded_dual_demux_step(one, sp5, sp27, masks, lens)
        for k, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), f"dual step output {k} differs"
        assert sorted(per) == sorted(set(self.mesh_devs)), per
        for idx, hist in ((got[0], got[8]), (got[3], got[9])):
            assert int(hist.sum()) == len(lens)
            assert all(int(hist[a + 1]) == int((idx == a).sum())
                       for a in range(-1, len(hist) - 1))
        assert (got[3] >= 0).sum() > 0.9 * len(lens), "too few binned"
        got1 = S.sharded_demux_step(self.mesh, sp5, masks, lens)
        want1 = S.sharded_demux_step(one, sp5, masks, lens)
        for k, (g, w) in enumerate(zip(got1, want1)):
            assert np.array_equal(g, w), f"demux step output {k} differs"
        assert int(got1[4].sum()) == len(lens)
        ms = {label: host_ms(lambda m=m: S.sharded_dual_demux_step(
            m, sp5, sp27, masks, lens), reps=3)
            for label, m in (("cuda:0", one), (str(self.mesh_devs),
                                               self.mesh))}
        print(f"   sharded_dual_demux_step and sharded_demux_step, 16,384 "
              f"reads, 70 bp banks: equal to cuda:0 alone, histograms "
              f"{got[8].tolist()} / {got[9].tolist()}; batched launches by "
              f"device {per}; dual step ms (host clock) {ms}")

    def mesh_pairwise(self):
        """(c) device_parallel_pairwise, dense and gated, on the 1,000-read
        COI bin (W 17) and the 400-read rRNA bin (W 112): equal on every
        gated entry to single-device distances_pairs / distances on
        cuda:0; sharded_pairwise_step on the COI bin; each stripe's time
        on its card."""
        import random
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import myers as M
        from tpu_orc_torch.cluster.scoring import pack_codes
        from tpu_orc_torch.dist import sharded as S
        from tpu_orc_torch.io import encode
        rnd = random.Random(3)
        tmpls = ["".join(rnd.choice("ACGT") for _ in range(500))
                 for _ in range(4)]
        seqs = sorted((synthetic.mutate(rnd, tmpls[k % 4], 0.03)
                       for k in range(1000)), key=len)
        coi = synthetic.codes(seqs, -(-max(len(x) for x in seqs) // 32) * 32)
        _, recs, _ = self.rrna_plate()
        rc, rl = pack_codes(sorted((encode.encode_codes(r.seq[:3584])
                                    for r in recs[:400]), key=len))
        devs = self.mesh_devs
        for label, (pc, pl) in (("COI 1,000 reads", coi),
                                ("rRNA 400 reads", (rc, rl))):
            n = len(pl)
            lo, hi = np.minimum.outer(pl, pl), np.maximum.outer(pl, pl)
            gate = (np.arange(n)[:, None] < np.arange(n)[None, :]) & \
                (lo * 1.05 >= hi)
            W = -(-pc.shape[1] // 32)
            TI, TJ = M.tile_shape(W)
            P, T = -(-n // TI) * TI, -(-n // TJ) * TJ
            gf = np.zeros((P, T), bool)
            gf[:n, :n] = gate
            need = gf.reshape(P // TI, TI, T // TJ, TJ).any(axis=(1, 3))
            want_g, _ = M.distances_pairs(pc, pl, pc, pl,
                                          np.argwhere(need).astype(np.int32),
                                          device="cuda:0", fetch_pos=False)
            want_d, _ = M.distances(pc, pl, pc, pl, device="cuda:0",
                                    fetch_pos=False)
            M.LAUNCHES.reset()
            got_g = S.device_parallel_pairwise(devs, pc, pl, pc, pl,
                                               gate=gate)
            got_d = S.device_parallel_pairwise(devs, pc, pl, pc, pl)
            per = M.LAUNCHES.by_device()
            assert np.array_equal(got_g[gate], want_g[:n, :n][gate]), \
                f"{label}: gated stripes differ"
            assert np.array_equal(got_d, want_d), \
                f"{label}: dense stripes differ"
            assert sorted(per) == sorted(set(devs)), per
            if label.startswith("COI"):
                got_s = S.sharded_pairwise_step(self.mesh, pc, pl, pc, pl)
                assert np.array_equal(got_s, want_d), "pairwise step differs"
            times = {k: self.stripe_ms(devs, pc, pl, g)
                     for k, g in (("gated", gate), ("dense", None))}
            walls = {k: host_ms(lambda d=d, g=g: S.device_parallel_pairwise(
                d, pc, pl, pc, pl, gate=g), reps=3)
                for k, d, g in (("gated, cuda:0", ["cuda:0"], gate),
                                (f"gated, {len(devs)} stripes", devs, gate),
                                ("dense, cuda:0", ["cuda:0"], None),
                                (f"dense, {len(devs)} stripes", devs, None))}
            print(f"   device_parallel_pairwise, {label} at W {W}: gated "
                  f"({int(gate.sum())} pairs, {int(need.sum())} tiles) and "
                  f"dense equal to cuda:0 alone; Myers launches by device "
                  f"{per}")
            print(f"      each stripe's ms on its card (CUDA events, upload "
                  f"and kernel, all stripes launched before any wait): "
                  f"{times}; host-clock ms a call: {walls}")

    def stripe_ms(self, devs, pc, pl, gate):
        """ms of each stripe of device_parallel_pairwise on its own card:
        CUDA events on the stripe's card before its upload and after its
        launch, every stripe launched before any event is waited for (the
        function's order); the median of 3 after a warm-up."""
        torch = self.torch
        from tpu_orc_torch.dist import sharded as S
        n = len(pl)
        stripe = -(-n // len(devs))

        def once():
            evs = []
            for k, dev in enumerate(devs):
                r0, r1 = k * stripe, min((k + 1) * stripe, n)
                s = torch.cuda.current_stream(torch.device(dev))
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record(s)
                S.pairwise_stripe(dev, pc[r0:r1], pl[r0:r1], pc, pl, "NW",
                                  None if gate is None else gate[r0:r1])
                b.record(s)
                evs.append((a, b))
            for _, b in evs:
                b.synchronize()
            return [a.elapsed_time(b) for a, b in evs]

        once()
        runs = [once() for _ in range(3)]
        return [round(sorted(r[k] for r in runs)[1], 3)
                for k in range(len(devs))]

    def mesh_run_all(self):
        """(d) run_all(use_mesh=True) and cli run-all --mesh on phase 6's
        COI plate: every file byte-identical to phase 6's but
        metrics.json, run_report.json and results.txt's pairs_ lines; the
        walls beside phase 6's, and each kernel's launches per device."""
        import contextlib
        import io
        import shutil
        from tpu_orc_torch.align import batched as BL
        from tpu_orc_torch.align import locate as L, myers as M
        from tpu_orc_torch.dist import sharded as S
        from tpu_orc_torch.pipeline import stages
        saved = stages.PipelineConfig.mesh
        if self.n_cards == 1:
            # make_mesh() is the one card: list it twice, as phase 14 does
            stages.PipelineConfig.mesh = lambda cfg: (
                S.make_mesh(devices=self.mesh_devs) if cfg.use_mesh
                else None)
        try:
            out = os.path.join(WORK, "plate", "mesh_run_all")
            shutil.rmtree(out, ignore_errors=True)
            counters = {"locate": L.LAUNCHES, "myers": M.LAUNCHES,
                        "batched": BL.LAUNCHES}
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rep = stages.run_all(self.fq, out, "plate", "COI",
                                     stages.PipelineConfig(
                                         self.adapters, device="cuda",
                                         use_mesh=True))
            wall = time.perf_counter() - t0
            per = per_device(counters)
            print(f"   run_all(use_mesh=True): {wall:.1f} s wall, "
                  f"{rep['metrics']['total_wall_s']} s of stage time "
                  f"(phase 6: {self.phase6_wall} s); launches by device "
                  f"{per}")
            self.check_mesh_tree(out, per)
            out2 = os.path.join(WORK, "plate", "mesh_cli")
            rep2, _ = self.coi_run(out2, "native", extra=("--mesh",))
            print(f"   cli run-all --mesh: {rep2['metrics']['total_wall_s']}"
                  f" s of stage time; launches by device {self.by_device}")
            self.check_mesh_tree(out2, self.by_device)
        finally:
            stages.PipelineConfig.mesh = saved

    def check_mesh_tree(self, out, per):
        """Phase 6's files, pairs_ lines of results.txt aside; every mesh
        device launched the demux locates and Myers."""
        a, b = read_tree(self.native_out), read_tree(out)
        skip = ("metrics.json", "run_report.json")
        a = {k: v for k, v in a.items() if os.path.basename(k) not in skip}
        b = {k: v for k, v in b.items() if os.path.basename(k) not in skip}
        assert sorted(a) == sorted(b), "mesh run_all tree differs"
        differ = 0
        for rel in a:
            x, y = a[rel], b[rel]
            if os.path.basename(rel) == "results.txt":
                keep = lambda t: [ln for ln in t.splitlines()
                                  if not ln.startswith(b"pairs_")]
                differ += x != y
                x, y = keep(x), keep(y)
            assert x == y, f"{rel} differs on the mesh"
        for dev in set(self.mesh_devs):
            n = per.get(dev, {})
            assert n.get("locate_front") and n.get("locate_back"), (dev, n)
            assert sum(v for k, v in n.items() if k.startswith("myers_")), \
                (dev, n)
        print(f"   {len(a)} files byte-identical to phase 6's (but "
              f"metrics.json and run_report.json; {differ} results.txt "
              f"differ in their pairs_ lines only)")

    def mesh_processes(self):
        """(e) two processes on localhost: gloo with both ranks on cuda:0
        on a one-card host, nccl with rank r on cuda:r on two cards or
        more. The all-reduced histogram equals the whole batch's,
        host_file_shard partitions the files, and the coordinator's
        consensusfile.fasta equals a one-process run over the same bins."""
        import glob
        import random
        import shutil
        import socket
        import numpy as np
        from tpu_orc_torch.cluster.engine import AmpliconSorter, SorterConfig
        from tpu_orc_torch.cluster.output import write_barcode_consensus
        from tpu_orc_torch.cluster.scoring import DeviceScorer
        from tpu_orc_torch.dist import sharded as S
        from tpu_orc_torch.io.fastq import Record, read_records, write_records
        from tpu_orc_torch import synthetic
        d = os.path.join(WORK, "multihost")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(os.path.join(d, "bins_in"))
        sp5, _ = self.mesh_banks()
        recs, _ = synthetic.make_plate(43, seed=41, insert_len=330)
        masks, lens = synthetic.read_masks([r.seq for r in recs[:4096]], 512)
        np.save(os.path.join(d, "masks.npy"), masks)
        np.save(os.path.join(d, "lens.npy"), lens)
        rnd = random.Random(99)
        for b in range(3):
            tm = ["".join(rnd.choice("ACGT") for _ in range(k))
                  for k in (360, 370)]
            rs = [synthetic.mutate(rnd, tm[i >= 12], 0.02) for i in range(24)]
            write_records(os.path.join(d, "bins_in",
                                       f"SP27_00{b + 1}_SP5_001.fastq"),
                          [Record(f"b{b}r{i}", f"b{b}r{i}", s, "I" * len(s))
                           for i, s in enumerate(rs)], fmt="fastq")
        ref = []
        for path in sorted(glob.glob(os.path.join(d, "bins_in", "*.fastq"))):
            barcode = os.path.splitext(os.path.basename(path))[0]
            srt = AmpliconSorter(SorterConfig(min_length=300, seed=7),
                                 scorer=DeviceScorer(device="cuda:0"),
                                 device="cuda:0")
            result = srt.sort_records(list(read_records(path)))
            p = write_barcode_consensus(result, os.path.join(d, "ref"),
                                        barcode, "e2e")
            with open(p) as fh:
                ref.append(fh.read())
        ref = "".join(ref)
        assert ref.count(">") >= 3, ref
        whole = S.sharded_demux_step(S.make_mesh(devices=["cuda:0"]), sp5,
                                     masks, lens)
        backend = "nccl" if self.n_cards > 1 else "gloo"
        worker = os.path.join(d, "worker.py")
        with open(worker, "w") as fh:
            fh.write(MULTIHOST_WORKER)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1")
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            env.pop(k, None)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", str(pid), backend,
             d], env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{o[-4000:]}"
        res = []
        for pid in range(2):
            with open(os.path.join(d, f"result_{pid}.json")) as fh:
                res.append(json.load(fh))
        print(f"   2 processes ({backend}), {time.perf_counter() - t0:.1f} s "
              f"wall: " + "; ".join(
                  f"rank {r['rank']} on {r['mesh']}, launches {r['launches']}"
                  for r in res))
        want_devs = ([["cuda:0"], ["cuda:1"]] if self.n_cards > 1
                     else [["cuda:0"], ["cuda:0"]])
        assert [r["mesh"] for r in res] == want_devs, res
        assert [r["world"] for r in res] == [2, 2]
        assert res[0]["is_coord"] and not res[1]["is_coord"]
        assert res[0]["hist"] == res[1]["hist"] == whole[4].tolist()
        idx = np.concatenate([np.load(os.path.join(d, f"idx_{p}.npy"))
                              for p in range(2)])
        assert np.array_equal(idx, whole[0]), "per-rank assignments differ"
        files = sorted(res[0]["files"] + res[1]["files"])
        assert files == [f"bin_{i:02d}.fastq" for i in range(7)]
        assert not set(res[0]["files"]) & set(res[1]["files"])
        assert len(res[0]["bins"]) + len(res[1]["bins"]) == 3
        assert not set(res[0]["bins"]) & set(res[1]["bins"])
        with open(os.path.join(d, "out", "consensusfile.fasta")) as fh:
            got = fh.read()
        assert got == ref, "merged consensusfile.fasta differs"
        print(f"   all-reduced histogram = the whole batch's "
              f"({sum(whole[4].tolist())} reads); files partitioned "
              f"{res[0]['files']} / {res[1]['files']}; consensusfile.fasta "
              f"({ref.count('>')} groups) byte-identical to one process")


    # -- phase 15 --------------------------------------------------------
    def oracles(self):
        """Every locate and Myers kernel against both oracles of the port,
        the C++ one (``native``) and the definitional Python one
        (``align/oracle.py``), at the card's shapes.

        Locate #1 (wavefront) and #2 (Kogge-Stone) through the demux's
        public batch path (``locate_batch_lazy``, on ``cuda``), the
        LocateResult fields valid, matches, errors, refstart, refstop,
        querystart and querystop of every (read, adapter) cell (the five
        location fields and the errors only where both sides are valid:
        the rest is unspecified), at phase 2's 16,384 reads x L 512 and
        phase 8's 2,048 rRNA reads x L 3,584 (the path pads them to 4,096
        columns): FRONT on the SP5 bank and BACK on the SP27-rc bank at
        min_overlap 3, BACK also at 0, and INFIX at 3 on the pychopper
        primers and their reverse complements. INFIX's bank is a plain
        AdapterBank at e 0.2: reorient's bank carries a custom k, which
        neither oracle takes. Every read against the C++ oracle; a seeded
        sample, with every empty read and every read shorter than the
        longest adapter, against the Python oracle. The only
        disagreements allowed are ROADMAP 3.4's: BACK at min_overlap 0 on
        exactly the empty reads, under the kernel whose Pallas original
        never evaluates cell (0, 0) (the wavefront, #1).

        The batched locate on phase 11's banks and reads (the SP5
        59-mers, 4 x 70 bp and the 64-300 bp bank at L 512; the 64-300
        bp bank at L 3,584), FRONT and BACK at min_overlap 3, through
        ``batched_locate`` on ``cuda``: every read against the C++ oracle,
        a sample against the Python oracle; and ROADMAP 3.6's case
        (BACK, a 300 bp adapter, refstop 260 and 290) equal to both.

        Myers #3 (pairs) and #4 (dense) through ``distances``,
        ``distances_pairs`` and ``myers_tile`` on ``cuda``, in NW, SHW and
        HW: the 1,000-read COI bin at W 17 in the design the wrapper
        picks (thread) and in the warp design, a seeded sample of pairs
        (from the gated tiles for the pairs entry) against the C++
        oracle and a smaller one against the Python oracle; the rRNA
        reads at W 112 (the ladder's dense 8 x 32, and the enlarged bin's
        listed tiles) in both designs against the C++ oracle only (the
        Python oracle's inner loop is too slow at 3.5 kb). The oracles
        give no end position, so positions stay held against the plain
        version (phase 3); here ``myers_tile``'s equal ``distances``'.
        ``similarity_matrix`` of the card's NW distances equals the
        Python oracle's ``similarity`` on the sampled COI pairs.

        The pileup (#5, #6) keeps phase 5's check against the native
        pileup; the Viterbi has no oracle in tpu_orc. The Python oracle
        runs in a pool of spawned processes while the card and the C++
        oracle work; the phase prints per case the cells compared, the
        disagreements and its time, then the C++ oracle's share and the
        Python oracle's."""
        import multiprocessing
        t0 = time.perf_counter()
        self.cpp_s = 0.0
        self.py_jobs = []       # (what is compared, pool jobs, compare)
        ctx = multiprocessing.get_context("spawn")
        nproc = os.cpu_count() or 1
        # the workers run niced, so that the C++ oracle (every core, in
        # this process) and the card's cases go first
        with ctx.Pool(nproc, initializer=os.nice, initargs=(10,)) as pool:
            self.pool = pool
            self.oracle_locate()
            self.oracle_batched()
            self.oracle_myers()
            t1 = time.perf_counter()
            busy = 0.0
            for compared, jobs, compare in self.py_jobs:
                res, secs = [], 0.0
                for job in jobs:
                    r, t = job.get(timeout=900)
                    res += r
                    secs += t
                busy += secs
                for name, bad, unexpected in compare(res):
                    print(f"   {name}: {compared} against the Python "
                          f"oracle, {bad} disagreements ({secs:.2f} CPU s "
                          f"in the workers)", flush=True)
                    assert unexpected == 0, \
                        f"{name}: {unexpected} disagreements not expected"
            waited = time.perf_counter() - t1
        print(f"   C++ oracle's share {self.cpp_s:.1f} s; Python oracle "
              f"{busy:.1f} CPU s over {nproc} processes, {waited:.1f} s "
              f"waited for after the card's cases; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def native_locate(self, refs, masks, lens, e, flags, mo):
        """The C++ oracle on every read, on every core: (out [B, A, 6],
        valid [B, A], its seconds)."""
        from tpu_orc_torch import native
        t0 = time.perf_counter()
        out, valid = native.locate_batch(refs, [masks[k, :lens[k]]
                                                for k in range(len(lens))],
                                         e, flags, mo, nthreads=0)
        secs = time.perf_counter() - t0
        self.cpp_s += secs
        return out, valid, secs

    def py_locate(self, refs, masks, lens, rows, e, flags, mo, results):
        """Queue the Python oracle's locate of ``refs`` in the reads
        ``rows`` (chunks of :data:`PY_CHUNK` reads a job); when the phase
        collects it, each of ``results`` [(name, LocateResult of every
        read, expected disagreement mask of every read or None)] is held
        against it."""
        import numpy as np
        jobs = [self.pool.apply_async(oracle_locate_rows, (
            refs, [masks[k, :lens[k]] for k in rows[i:i + PY_CHUNK]], e,
            int(flags), mo)) for i in range(0, len(rows), PY_CHUNK)]

        def compare(res):
            out = np.array([[r or (0,) * 6 for r in row] for row in res],
                           np.int64).reshape(len(rows), len(refs), 6)
            valid = np.array([[r is not None for r in row] for row in res],
                             bool).reshape(len(rows), len(refs))
            for name, got, known in results:
                sub = type(got)(*[np.asarray(v)[rows] for v in got])
                bad = locate_disagreements(sub, out, valid)
                want = np.zeros_like(bad) if known is None else known[rows]
                yield name, int(bad.sum()), int((bad != want).sum())

        self.py_jobs.append((f"{len(rows) * len(refs)} cells ({len(rows)} "
                             f"reads)", jobs, compare))

    def oracle_locate(self):
        import numpy as np
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.demux import demux as D
        from tpu_orc_torch.demux.adapters import AdapterBank
        from tpu_orc_torch.io import encode
        from tpu_orc_torch.io.fastq import read_fasta
        from tpu_orc_torch.align.spec import BACK, FRONT
        recs, _ = synthetic.make_plate(171, seed=7, insert_len=330)
        coi = [r.seq[:512] for r in recs[:16384]]     # phase 2's reads
        _, rrecs, _ = self.rrna_plate()
        rrna = [r.seq[:3584] for r in rrecs[:2048]]   # phase 8's reads
        rrna[::97] = [""] * len(rrna[::97])
        banks = self.banks()
        prim = []
        for rec in read_fasta(os.path.join(self.adapters,
                                           "M13_seqs_for_pychopper.fa")):
            prim += [(rec.id, rec.seq.upper()),
                     ("-" + rec.id, encode.revcomp(rec.seq.upper()))]
        infix = AdapterBank.from_pairs(prim, 0.2, "cuda")
        cases = (("front", banks["front"], FRONT, 3),
                 ("back", banks["back"], BACK, 3),
                 ("back", banks["back"], BACK, 0),
                 ("infix", infix, L.INFIX, 3))
        rng = np.random.default_rng(15)
        for label, seqs, n_py in (("16,384 reads x L 512", coi, PY_READS[0]),
                                  ("2,048 rRNA reads x L 3,584", rrna,
                                   PY_READS[1])):
            masks, lens = synthetic.read_masks(seqs, max(map(len, seqs)))
            longest = max(int(b.lens.max()) for _, b, _, _ in cases)
            must = np.flatnonzero(lens < longest)
            rest = np.setdiff1d(np.arange(len(lens)), must)
            rows = np.sort(np.concatenate([must, rng.choice(
                rest, max(n_py - len(must), 0), replace=False)]))
            empty = lens == 0
            for mode, bank, flags, mo in cases:
                refs = [encode.encode_ref_masks(s) for s in bank.seqs]
                e = bank.max_error_rate
                out, valid, cpp = self.native_locate(refs, masks, lens, e,
                                                     flags, mo)
                results = []
                for impl in ("wf", "ks"):
                    t0 = time.perf_counter()
                    L.LOCATE_IMPL = impl
                    before = L.LAUNCHES.snapshot()
                    try:
                        got = D.locate_batch_collect(D.locate_batch_lazy(
                            bank, seqs, flags, mo))
                    finally:
                        L.LOCATE_IMPL = "wf"
                    key = mode if impl == "wf" else f"ks_{mode}"
                    assert L.LAUNCHES.snapshot()[key] > before[key], \
                        f"{impl} {mode}: no kernel launch"
                    bad = locate_disagreements(got, out, valid)
                    # ROADMAP 3.4: the wavefront never evaluates cell (0, 0)
                    known = (impl == "wf" and mode == "back" and mo == 0)
                    want = np.broadcast_to(empty[:, None], bad.shape) \
                        if known else np.zeros_like(bad)
                    name = f"locate {impl} {mode} min_overlap {mo}, {label}"
                    print(f"   {name}: {bad.size} cells against the C++ "
                          f"oracle, {int(bad.sum())} disagreements"
                          + (f" (every adapter on the {int(empty.sum())} "
                             f"empty reads: ROADMAP 3.4)" if known else "")
                          + f"; C++ oracle {cpp:.2f} s, the card's run "
                          f"and the comparison {time.perf_counter() - t0:.2f}"
                          f" s", flush=True)
                    assert np.array_equal(bad, want), \
                        f"{name}: {int((bad != want).sum())} not expected"
                    results.append((name, got, want if known else None))
                self.py_locate(refs, masks, lens, rows, e, flags, mo,
                               results)

    def oracle_batched(self):
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import synthetic
        from tpu_orc_torch.align import batched as BL
        from tpu_orc_torch.align import oracle
        from tpu_orc_torch.align.spec import BACK, FRONT
        from tpu_orc_torch.demux.adapters import AdapterBank
        masks, lens, _ = self.batched_reads()
        rmasks, rlens = self.batched_long_reads()
        sp5 = AdapterBank.from_fasta(
            os.path.join(self.adapters, "M13_amplicon_indices_forward.fa"),
            0.1, "cuda")
        longb = AdapterBank([f"L{len(a)}" for a in self.longs], self.longs,
                            0.1, "cuda")
        b70 = AdapterBank.from_pairs(synthetic.banks(head=11)["sp5"][:4],
                                     0.1, "cuda")
        rng = np.random.default_rng(16)
        for label, bank, (qm, ql), n_py in (
                ("SP5 59-mers, 2,048 reads x L 512", sp5, (masks, lens),
                 PY_READS[2]),
                ("4 x 70 bp, 2,048 reads x L 512", b70, (masks, lens),
                 PY_READS[2]),
                ("64-300 bp, 2,048 reads x L 512", longb, (masks, lens),
                 PY_READS[2]),
                ("64-300 bp, 2,048 rRNA reads x L 3,584", longb,
                 (rmasks, rlens), PY_READS[3])):
            rows = np.sort(rng.choice(len(ql), n_py, replace=False))
            refs = [bank.masks[a, :bank.lens[a]] for a in range(len(bank))]
            tabs = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                    for x in (bank.masks, bank.lens, bank.k_table,
                              bank.n_prefix)]
            reads = [torch.from_numpy(x).cuda() for x in (qm, ql)]
            for flags in (FRONT, BACK):
                out, valid, cpp = self.native_locate(refs, qm, ql, 0.1,
                                                     flags, 3)
                t0 = time.perf_counter()
                got = BL.to_numpy(BL.batched_locate(*tabs, *reads,
                                                    int(flags), 3))
                bad = int(locate_disagreements(got, out, valid).sum())
                name = (f"batched locate {'front' if flags == FRONT else 'back'}"
                        f", {label}")
                print(f"   {name}: {out.shape[0] * out.shape[1]} cells "
                      f"against the C++ oracle, {bad} disagreements; C++ "
                      f"oracle {cpp:.2f} s, the card's run and the "
                      f"comparison {time.perf_counter() - t0:.2f} s",
                      flush=True)
                assert bad == 0, f"{name}: {bad} disagreements"
                self.py_locate(refs, qm, ql, rows, 0.1, flags, 3,
                               [(name, got, None)])
        # ROADMAP 3.6: BACK on 30 random bp and the first 260 (290) bp of a
        # 300 bp adapter (test_torch_batched.py's case): tpu_orc's 8-bit
        # row field gives refstop 4 there; the port both oracles' answer
        rng = np.random.default_rng(0)
        seq = lambda n: "".join(rng.choice(list("ACGT"), size=n))
        adapter = seq(300)
        reads = [seq(30) + adapter[:260], seq(30) + adapter[:290]]
        bank = AdapterBank(["a300"], [adapter], 0.1, "cuda")
        qm, ql = synthetic.read_masks(reads, 320)
        tabs = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in (bank.masks, bank.lens, bank.k_table,
                          bank.n_prefix)]
        got = BL.to_numpy(BL.batched_locate(
            *tabs, *[torch.from_numpy(x).cuda() for x in (qm, ql)],
            int(BACK), 3))
        refs = [bank.masks[0, :300]]
        out, valid, _ = self.native_locate(refs, qm, ql, 0.1, BACK, 3)
        py = [oracle.locate(adapter, r, 0.1, BACK, 3).astuple()
              for r in reads]
        assert valid.all() and not locate_disagreements(got, out,
                                                        valid).any()
        assert [tuple(out[k, 0]) for k in range(2)] == py
        assert py[0] == (0, 260, 30, 290, 260, 0), py
        print(f"   batched locate back, ROADMAP 3.6's case (a 300 bp adapter,"
              f" refstop 260 and 290): equal to both oracles {py}",
              flush=True)

    def oracle_myers(self):
        import random
        import numpy as np
        torch = self.torch
        from tpu_orc_torch import native, synthetic
        from tpu_orc_torch.align import myers as M
        from tpu_orc_torch.cluster.scoring import pack_codes
        from tpu_orc_torch.io import encode
        rnd = random.Random(3)                  # phase 3's COI bin
        tmpls = ["".join(rnd.choice("ACGT") for _ in range(500))
                 for _ in range(4)]
        seqs = sorted((synthetic.mutate(rnd, tmpls[k % 4], 0.03)
                       for k in range(1000)), key=len)
        pc, pl = synthetic.codes(seqs, -(-max(map(len, seqs)) // 32) * 32)
        _, rrecs, _ = self.rrna_plate()         # phase 3's rRNA reads
        codes = [encode.encode_codes(r.seq[:3584]) for r in rrecs[:64]]
        rp, rpl = pack_codes(codes[:8])
        rt, rtl = pack_codes(codes[8:40])
        big = sorted((encode.encode_codes(r.seq[:3584])
                      for r in rrecs[:400]), key=len)
        bc, bl = pack_codes(big, count_cap=512)
        rng = np.random.default_rng(17)
        # (label, patterns and texts, entry points, pairs sampled for the
        # C++ oracle and for the Python oracle in each mode and entry)
        for label, (P, PL, T, TL), entries, n_cpp, n_py in (
                ("COI 1,000 reads", (pc, pl, pc, pl), ("dense", "pairs"),
                 4096, PY_PAIRS),
                ("rRNA 8 x 32 reads", (rp, rpl, rt, rtl), ("dense",), 256,
                 0),
                ("rRNA 400 reads", (bc[:400], bl[:400], bc[:400], bl[:400]),
                 ("pairs",), 256, 0)):
            n, m = len(PL), len(TL)
            W = M.n_words(P.shape[1])
            label = f"{label}, W {W}"
            TI, TJ = M.tile_shape(W)
            lo, hi = np.minimum.outer(PL, TL), np.maximum.outer(PL, TL)
            gf = np.zeros((-(-n // TI) * TI, -(-m // TJ) * TJ), bool)
            gf[:n, :m] = (np.arange(n)[:, None] < np.arange(m)[None, :]) & \
                (lo * 1.05 >= hi)
            need = gf.reshape(gf.shape[0] // TI, TI, gf.shape[1] // TJ,
                              TJ).any(axis=(1, 3))
            tiles = np.argwhere(need).astype(np.int32)
            listed = np.kron(need, np.ones((TI, TJ), bool))[:n, :m]
            cand = {"dense": np.argwhere(np.ones((n, m), bool)),
                    "pairs": np.argwhere(listed)}
            for mode in ("NW", "SHW", "HW"):
                t0 = time.perf_counter()
                cpp = 0.0
                grids = {}
                if "dense" in entries:
                    up = M._upload(P, PL, T, TL, n, m, "cuda")
                    dist, pos = M.distances(P, PL, T, TL, mode, device="cuda")
                    peq = M.build_peq(torch.from_numpy(P).cuda(), W,
                                      torch.from_numpy(PL).cuda())
                    td, tp = M.myers_tile(
                        peq, torch.from_numpy(PL).cuda(),
                        torch.from_numpy(T).cuda(),
                        torch.from_numpy(TL).cuda(), mode, W)
                    assert np.array_equal(td.cpu().numpy(), dist) and \
                        np.array_equal(tp.cpu().numpy(), pos), \
                        f"myers_tile {label} {mode} differs from distances"
                    grids["dense"] = {"distances and myers_tile": dist}
                    for d in M.DESIGNS:
                        x, _ = M.myers_cuda(*up, mode, design=d)
                        grids["dense"][f"dense, {d} design"] = \
                            x.cpu().numpy()
                if "pairs" in entries:
                    gd, _ = M.distances_pairs(P, PL, T, TL, tiles, mode,
                                              device="cuda", fetch_pos=False)
                    grids["pairs"] = {"distances_pairs": gd}
                    upp = M._upload(P, PL, T, TL, gf.shape[0], gf.shape[1],
                                    "cuda")
                    tt = torch.from_numpy(tiles).cuda()
                    ti, tj = tt[:, 0].contiguous(), tt[:, 1].contiguous()
                    for d in M.DESIGNS:
                        x, _ = M.myers_cuda(*upp, mode, ti, tj, TI, TJ,
                                            design=d)
                        grids["pairs"][f"pairs, {d} design"] = \
                            x.cpu().numpy()
                for what, grid in grids.items():
                    c = cand[what]
                    k = min(n_cpp, len(c))
                    pairs = c[np.sort(rng.choice(len(c), k, replace=False))]
                    c0 = time.perf_counter()
                    want = np.array([native.edit_distance(
                        P[i, :PL[i]], T[j, :TL[j]], mode) for i, j in pairs])
                    cpp += time.perf_counter() - c0
                    for name, x in grid.items():
                        bad = int((x[pairs[:, 0], pairs[:, 1]] != want).sum())
                        print(f"   myers {mode} {label}, {name}: {k} pairs "
                              f"against the C++ oracle, {bad} disagreements",
                              flush=True)
                        assert bad == 0, (label, mode, name, bad)
                    if n_py:
                        sims = M.similarity_matrix(
                            grid["distances and myers_tile"], PL, TL) \
                            if mode == "NW" and what == "dense" else None
                        self.py_myers(f"myers {mode} {label}", grid,
                                      pairs[:n_py], P, PL, T, TL, mode, seqs,
                                      sims)
                self.cpp_s += cpp
                print(f"   myers {mode} {label}: {time.perf_counter() - t0:.2f}"
                      f" s, the C++ oracle {cpp:.2f} s of it", flush=True)

    def py_myers(self, label, grid, pairs, P, PL, T, TL, mode, strs, sims):
        """Queue the Python oracle's edit distances of ``pairs`` (and,
        where ``sims`` is given, its ``similarity`` of the strings ``strs``)
        in jobs of :data:`PY_CHUNK` pairs; every grid of ``grid`` (and
        ``sims``) held against them when the phase collects them."""
        import numpy as np
        args = [(P[i, :PL[i]], T[j, :TL[j]],
                 (strs[i], strs[j]) if sims is not None else None)
                for i, j in pairs]
        jobs = [self.pool.apply_async(oracle_edit_rows, (
            args[i:i + PY_CHUNK], mode)) for i in range(0, len(args),
                                                        PY_CHUNK)]

        def compare(res):
            d = np.array([r[0] for r in res])
            for name, x in grid.items():
                bad = int((x[pairs[:, 0], pairs[:, 1]] != d).sum())
                yield f"{label}, {name}", bad, bad
            if sims is not None:
                s = np.array([r[1] for r in res])
                bad = int((sims[pairs[:, 0], pairs[:, 1]] != s).sum())
                yield f"{label}, similarity_matrix", bad, bad

        self.py_jobs.append((f"{len(pairs)} pairs", jobs, compare))

    # -- phase 16 --------------------------------------------------------
    def bench(self):
        """The port's bench (``python3 -m tpu_orc_torch.bench --reps 1``)
        in this process: every section at bench.py's sizes, one timed rep
        each. Its JSON line is printed here; every key of BENCH_KEYS must
        be a number, ``correct`` true, the device this card, and each
        section must have launched the kernels of its path."""
        import contextlib
        import io
        torch = self.torch
        from tpu_orc_torch import bench
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--reps", "1"])
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        out = json.loads(line)
        d = out["details"]
        assert rc == 0 and d["correct"] is True, (rc, d["checks"])
        assert d["backend"] == "cuda"
        flat = dict(d, **{f"multidev_single_chip.{k}": v for k, v in
                          d["multidev_single_chip"].items()},
                    value=out["value"], vs_baseline=out["vs_baseline"])
        bad = [k for k in BENCH_KEYS
               if not isinstance(flat.get(k), (int, float))
               or isinstance(flat.get(k), bool)]
        assert not bad, f"not numbers: {bad}"
        assert d["pipeline_plate_stage_s"] and all(
            isinstance(v, float) for v in d["pipeline_plate_stage_s"].values())
        dev = d["device"]
        assert dev["name"] == torch.cuda.get_device_name(0), dev
        assert dev["count"] == torch.cuda.device_count() and dev["cpu_count"]
        assert dev["nvidia_smi_name"] + ", " + dev["power_limit"] == \
            bench.card_line(), dev
        dense, pairs = ("dense_thread", "dense_warp"), ("pairs_thread",
                                                       "pairs_warp")
        need = [("demux", "locate", ("front",)),
                ("demux", "locate", ("back",)),
                ("cluster", "myers", dense), ("cluster1", "myers", dense),
                ("sort", "myers", pairs), ("sort", "myers", dense),
                ("md_demux_1", "locate", ("front",)),
                ("md_demux_m", "locate", ("front",)),
                ("md_pw_1", "myers", dense), ("md_pw_m", "myers", dense),
                ("reorient", "locate", ("infix",)),
                ("longsort", "myers", pairs),
                ("plate", "locate", ("front",)),
                ("plate", "locate", ("back",)),
                ("plate", "locate", ("infix",))]
        for section, kernel, keys in need:
            got = d["launches"][section].get(kernel, {}).get("cuda:0", {})
            assert any(got.get(k) for k in keys), (section, kernel, keys,
                                                   d["launches"][section])
        print(f"   bench: {d['wall_s']:.1f} s; launches per section "
              f"{json.dumps(d['launches'])}", flush=True)


#: worker of phase 14 (e): one process of two on localhost
MULTIHOST_WORKER = r"""
import glob, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_orc_torch.align import batched as BL, myers as M
from tpu_orc_torch.cluster.engine import AmpliconSorter, SorterConfig
from tpu_orc_torch.cluster.output import write_barcode_consensus
from tpu_orc_torch.cluster.scoring import DeviceScorer
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.dist.multihost import (global_mesh, host_file_shard,
                                          init_multihost, is_coordinator)
from tpu_orc_torch.dist.sharded import sharded_demux_step
from tpu_orc_torch.io.fastq import read_records
from tpu_orc_torch import synthetic

coord, pid, backend, d = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
rank, world = init_multihost(coord, 2, pid, backend=backend)
mesh = global_mesh()
dev = str(mesh.devices.flat[0])
masks = np.load(os.path.join(d, "masks.npy"))
lens = np.load(os.path.join(d, "lens.npy"))
half = len(masks) // world
b = synthetic.banks()
sp5 = AdapterBank.from_pairs(b["sp5"], 0.1, dev)
out = sharded_demux_step(mesh, sp5, masks[rank * half:(rank + 1) * half],
                         lens[rank * half:(rank + 1) * half])
np.save(os.path.join(d, f"idx_{rank}.npy"), out[0])
bins = sorted(glob.glob(os.path.join(d, "bins_in", "*.fastq")))
done = []
for path in host_file_shard(bins):
    barcode = os.path.splitext(os.path.basename(path))[0]
    srt = AmpliconSorter(SorterConfig(min_length=300, seed=7),
                         scorer=DeviceScorer(device=dev), device=dev)
    result = srt.sort_records(list(read_records(path)))
    write_barcode_consensus(result, os.path.join(d, "out", "bins"),
                            barcode, "e2e")
    done.append(barcode)
dist.barrier()
if is_coordinator():
    parts = []
    for path in bins:
        barcode = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(d, "out", "bins",
                               f"{barcode}_consensus_e2e.fasta")) as fh:
            parts.append(fh.read())
    with open(os.path.join(d, "out", "consensusfile.fasta"), "w") as fh:
        fh.write("".join(parts))
dist.barrier()
res = {"rank": rank, "world": world, "mesh": [str(x) for x in mesh.devices.flat],
       "is_coord": is_coordinator(), "hist": out[4].tolist(),
       "files": host_file_shard([f"bin_{i:02d}.fastq" for i in range(7)]),
       "bins": done,
       "launches": {"batched": BL.LAUNCHES.by_device(),
                    "myers": M.LAUNCHES.by_device()}}
dist.destroy_process_group()
with open(os.path.join(d, f"result_{rank}.json"), "w") as fh:
    json.dump(res, fh)
print("ok", rank)
"""


def per_device(counters):
    """{device: {counter_key: launches}} over several launch counters
    ({name: LaunchCounter}), keys as in ``Smoke.run_all``'s counts."""
    out = {}
    for k, c in counters.items():
        for dev, n in c.by_device().items():
            for e, v in n.items():
                out.setdefault(dev, {})[f"{k}_{e}"] = v
    return {d: dict(sorted(n.items())) for d, n in sorted(out.items())}


def trace_family(name: str) -> str:
    """Kernel family of a trace event's name: the function name without
    its template arguments, the locate template split by contract."""
    base = name.split("(")[0].split("<")[0].replace("void ", "").strip()
    if base == "locate_kernel":
        ks = name.split("(")[0].rstrip(" >").endswith("true")
        return f"locate_kernel ({'KS' if ks else 'wavefront'})"
    return base


def trace_families(kernels):
    """{family: event count} of a trace's kernel events."""
    out = {}
    for e in kernels:
        k = trace_family(e["name"])
        out[k] = out.get(k, 0) + 1
    return out


def union_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    total, end = 0.0, None
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def locate_disagreements(res, out, valid):
    """[B, A] bool: the (read, adapter) cells where a LocateResult ``res``
    differs from an oracle's answer (``out`` [B, A, 6] in Location order,
    ``valid`` [B, A]): in validity, or where both are valid in one of the
    six location fields (an invalid cell's fields are unspecified)."""
    import numpy as np
    v = np.asarray(res.valid).astype(bool)
    got = np.stack([np.asarray(getattr(res, f)) for f in (
        "refstart", "refstop", "querystart", "querystop", "matches",
        "errors")], axis=-1)
    return (v != valid) | (v & valid & (got != out).any(axis=-1))


def oracle_locate_rows(refs, reads, e, flags, mo):
    """Phase 15's pool job: the Python oracle's locate of every adapter
    mask in each read mask ([[None or Location tuple]]), and its CPU
    seconds."""
    from tpu_orc_torch.align import oracle
    t0 = time.process_time()
    out = []
    for q in reads:
        row = [oracle.locate(r, q, e, flags, mo) for r in refs]
        out.append([None if x is None else x.astuple() for x in row])
    return out, time.process_time() - t0


def oracle_edit_rows(args, mode):
    """Phase 15's pool job: the Python oracle's edit distance of each
    (pattern codes, text codes, strings or None) in ``mode``, with its
    NW ``similarity`` of the strings where given; and its CPU seconds."""
    from tpu_orc_torch.align import oracle
    t0 = time.process_time()
    out = [(oracle.edit_distance(p, t, mode),
            None if ab is None else oracle.similarity(*ab))
           for p, t, ab in args]
    return out, time.process_time() - t0


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="GPU smoke run of "
                                 "tpu_orc_torch (see the module docstring)")
    ap.add_argument("--phases", default=None,
                    help="run only these phases after setup, e.g. '6,14' "
                         "or '15' (a check call: it prints no kernel line "
                         "and no result line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import tpu_orc_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: tpu_orc_torch not importable: {e}",
              file=sys.stderr)
        return 3
    only = None if args.phases is None else set(args.phases.split(","))
    os.makedirs(WORK, exist_ok=True)
    s = Smoke()
    t0 = time.perf_counter()

    def phase(name, fn, needs=()):
        """Run phase ``name`` (its number first) unless ``--phases`` left
        it out; a phase whose ``needs`` failed fails unrun."""
        if only is not None and name.split()[0].rstrip("abcde") not in only:
            return
        if set(needs) & set(s.failed):
            s.failed.append(f"{name} (not run)")
            return
        s.phase(name, fn)

    s.phase("1 setup", s.setup)
    if s.failed:
        return 1
    p6 = "6 run_all COI main path"
    p10 = "10 run_all RNA plate with the KS locate"
    phase("2 locate kernel vs plain", s.locate)
    phase("3 myers kernel vs plain", s.myers)
    phase("4 fused demux kernel path vs plain path", s.fused)
    phase("5 pileup kernel vs plain", s.pileup)
    phase(p6, s.main_path)
    phase("7 run_all with the device consensus pileup", s.device_path,
          [p6])
    phase("8 KS locate kernel vs plain", s.locate_ks)
    phase("9 Viterbi kernel vs plain", s.viterbi)
    phase(p10, s.rrna_path)
    phase("11 batched locate kernel vs plain, and stage_demux on 70 bp "
          "banks", s.batched)
    phase("12 run-all --trace on the COI plate", s.traced, [p6])
    phase("13 stages 06-09 and prewarm through the CLI", s.downstream,
          [p6, p10])
    p14 = "14 multi-device path: mesh"
    phase(p14, s.mesh_setup)
    phase("14a decide_multi", s.mesh_decide, [p14])
    phase("14b sharded demux steps on 70 bp banks", s.mesh_sharded_demux,
          [p14])
    phase("14c device_parallel_pairwise and sharded_pairwise_step",
          s.mesh_pairwise, [p14])
    phase("14d run_all and cli run-all on the mesh", s.mesh_run_all,
          [p14, p6])
    phase("14e two processes on localhost", s.mesh_processes, [p14])
    phase("15 locate and Myers kernels against both oracles", s.oracles)
    phase("16 bench sections at full size", s.bench)
    phase("17 KS INFIX locate, pychopper bank, at L 4,096 and 8,192",
          s.locate_ks_long)
    phase("18 pack kernel vs plain, and stage 01's scan batch packed on "
          "the card", s.pack)
    phase("19 emit kernel vs plain and format_records, and stage 01's "
          "block emitted on the card", s.emit)
    print(f"total {time.perf_counter() - t0:.1f} s")
    if s.failed:
        print(f"chip_smoke: failed phases: {s.failed}", file=sys.stderr)
        return 1
    if only is not None:
        print(f"chip_smoke: phases {sorted(only)} ok (a check call: no "
              f"result line)")
        return 0
    from tpu_orc_torch.bench import card_line
    print(json.dumps({"kernels": list(s.kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
