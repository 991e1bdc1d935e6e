"""GPU smoke run of tpu_orc_torch: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, then drive the COI main
path (run_all) on a synthetic 96-bin plate and check what comes out.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); imports no JAX.
Phases:
  1. setup: card name and power limit, versions, kernel build time;
  2. locate kernel vs plain: FRONT (SP5 bank), BACK (SP27-rc bank), INFIX
     (reorient primer bank, custom k), 16,384 reads at L = 512, half
     reverse-complemented; all 8 outputs must be equal;
  3. Myers kernel vs plain: dense 1000 x 1000 NW at ~500 bp, the listed-
     tile entry point over the gated upper triangle of the same block,
     smaller SHW and HW with end positions; equal;
  4. fused demux, kernel path vs plain path on the card, same reads: the
     8 decision vectors equal;
  5. path-bits pileup kernel vs plain at the consensus's shapes: one
     490 bp draft x 100 reads (16 words, 512 columns), 24 groups x 50
     reads in one launch, and one 1,700 bp draft (54 words, 2048
     columns) x 50 reads; equal on the region the traceback reads, and
     the native traceback of the planes gives the native pileup's
     counts; the planes' copy to the host and the two native pileups
     are timed too;
  6. run_all (COI, device cuda) on a plate of 12 SP5 x 8 SP27 bins x 80
     reads, one bin enlarged to 1000 reads of two species so it sorts
     through both Myers entry points: 96 bins, 1 species group per bin
     (2 in the big one), every consensus >= 0.97 identical to its planted
     insert, and every locate and Myers kernel launched during the run;
  7. run_all again with the consensus pileup's device backend
     (ORC_PILEUP_BACKEND=device): both path-bits contracts launched, and
     every consensusfile.fasta and primerless/ file byte-identical to
     phase 6's.
Prints a JSON line of per-kernel numbers, the card line, and last the
result line. Exits non-zero, printing no result, when any phase fails or
there is no CUDA device. Times are medians of 5 timed runs after a
warm-up, from CUDA events; the tolerance of every comparison is zero
(integer outputs). A kernel's ``launches`` are counted over the run_all
of its path (phase 6 for locate and Myers, phase 7 for the pileup).

``bound_ms`` is the least time the card could take for the kernel's work
at these inputs: the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and its integer
operations over the int32 issue rate, 132 SMs x 64 lanes x 1.98 GHz =
1.67e13/s (the float32 peak of 67 TFLOP/s is 132 x 128 lanes x 2 x 1.98
GHz; an SM has half as many int32 lanes). Operations are counted from
this run's data: per DP cell of locate 16 (compares, adds and selects of
csrc/locate.cu's inner loop), per 32-bit word step of Myers and of the
pileup 20 (the bit-vector recurrence). No single PyTorch call computes
these dynamic programs, so ``library_ms`` is null.
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
OPS_PER_CELL = {"locate": 16, "myers": 20, "pileup": 20}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def max_abs_err(x, y) -> int:
    return int((x.long() - y.long()).abs().max()) if x.numel() else 0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int32 issue rate."""
    tb, to = n_bytes / BYTES_PER_S * 1e3, n_ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
               n_ops):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        self.kernels[name] = {"name": name, "route": "cuda",
                              "source": source, "replaces": replaces,
                              "launches": 0, "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": None}
        print(f"   {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes:.4g} B, "
              f"{n_ops:.4g} int ops), max_abs_err {err}", flush=True)

    def launches(self, counts):
        """Set each kernel's ``launches`` from one run_all's counters."""
        for name, n in counts.items():
            self.kernels.setdefault(name, {"name": name})["launches"] = n

    # -- phase 1 ---------------------------------------------------------
    def setup(self):
        torch = self.torch
        from tpu_orc_torch import _build, synthetic
        print(card_line())
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)}")
        t = _build.build_all()
        print(f"kernel build (one nvcc per source, in parallel): "
              f"{t['build_s']:.1f} s")
        for name, log in _build.PTXAS_LOG.items():
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "stack frame" in ln]
            print(f"   {name} ptxas: " + " | ".join(regs[:4]))
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

    # -- phase 2 ---------------------------------------------------------
    def locate(self):
        import numpy as np
        torch = self.torch
        from tpu_orc_torch.align import locate as L
        from tpu_orc_torch.demux.adapters import AdapterBank
        from tpu_orc_torch.demux.reorient import build_primer_bank
        masks, lens = self.reads()
        a = self.adapters
        banks = {
            "front": AdapterBank.from_fasta(
                os.path.join(a, "M13_amplicon_indices_forward.fa"), 0.1),
            "back": AdapterBank.from_fasta(
                os.path.join(a, "M13_amplicon_indices_reverse_rc.fa"), 0.1),
            "infix": build_primer_bank(
                os.path.join(a, "M13_seqs_for_pychopper.fa"), 0.8)[0],
        }
        rt = torch.from_numpy(np.ascontiguousarray(masks.T)).cuda()
        ln = torch.from_numpy(lens).cuda()
        for mode, bank in banks.items():
            tabs = L.tables_for_bank(bank, mode, 3).tensors("cuda")
            A = len(bank)
            got = L.locate_cuda(tabs, rt, ln, mode, A)
            want = L.locate_plain(tabs, rt, ln, mode, A)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = [k for k in range(8) if not torch.equal(got[k],
                                                              want[k])]
                raise AssertionError(f"locate {mode}: outputs {bad} differ")
            hits = int(got[4].sum())
            ms = cuda_ms(lambda: L.locate_cuda(tabs, rt, ln, mode, A))
            pms = cuda_ms(lambda: L.locate_plain(tabs, rt, ln, mode, A))
            print(f"   locate {mode}: {A} adapters x {rt.shape[1]} reads "
                  f"x L {rt.shape[0]}, {hits} valid hits, equal")
            cells = float(ln.sum()) * float(tabs[4][:A].sum())
            self.record(f"locate_{mode}", "tpu_orc_torch/csrc/locate.cu",
                        "tpu_orc/align/pallas_locate.py:205",
                        max_abs_err(got, want), ms, pms,
                        nbytes(*tabs, rt, ln, got),
                        OPS_PER_CELL["locate"] * cells)

    # -- phase 3 ---------------------------------------------------------
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
        # dense NW, all pairs
        up = M._upload(pc, pl, pc, pl, 1000, 1000, "cuda")
        got = M.myers_cuda(*up, "NW")
        want = M.myers_plain(*up, "NW")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), "myers dense NW differs"
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        ms = cuda_ms(lambda: M.myers_cuda(*up, "NW"))
        pms = cuda_ms(lambda: M.myers_plain(*up, "NW"))
        print("   myers dense NW 1000 x 1000 at ~500 bp: equal")
        # word steps: each pattern's words up to row m, each text column
        nwp = (up[1].double() + 31).div(32).floor()
        ncol = up[3].double().clamp(max=up[2].shape[0])
        self.record("myers_dense", "tpu_orc_torch/csrc/myers.cu",
                    "tpu_orc/align/pallas_myers.py:56", err, ms, pms,
                    nbytes(*up, *got),
                    OPS_PER_CELL["myers"] * float(nwp.sum() * ncol.sum()))
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
        got = M.myers_cuda(*upp, "NW", ti, tj, TI, TJ)
        want = M.myers_plain(*upp, "NW", ti, tj, TI, TJ)
        torch.cuda.synchronize()
        mask = torch.from_numpy(np.kron(need, np.ones((TI, TJ), bool))
                                ).cuda()
        for g, w in zip(got, want):
            assert torch.equal(g[mask], w[mask]), "myers pairs differs"
        err = max(max_abs_err(g[mask], w[mask]) for g, w in zip(got, want))
        ms = cuda_ms(lambda: M.myers_cuda(*upp, "NW", ti, tj, TI, TJ))
        pms = cuda_ms(lambda: M.myers_plain(*upp, "NW", ti, tj, TI, TJ))
        print(f"   myers pairs NW: {tiles.shape[0]} of "
              f"{need.size} tiles listed ({TI} x {TJ}): equal")
        nwp = (upp[1].double() + 31).div(32).floor().view(-1, TI).sum(1)
        ncol = upp[3].double().clamp(max=upp[2].shape[0]).view(-1, TJ).sum(1)
        steps = float((nwp[ti.long()] * ncol[tj.long()]).sum())
        self.record("myers_pairs", "tpu_orc_torch/csrc/myers.cu",
                    "tpu_orc/align/pallas_myers.py:242", err, ms, pms,
                    nbytes(*upp, ti, tj) + 2 * 4 * ti.numel() * TI * TJ,
                    OPS_PER_CELL["myers"] * steps)
        # SHW and HW with end positions: reads within longer texts
        for mode in ("SHW", "HW"):
            pats = pc[:200, :480]
            texts, tl = synthetic.codes(
                ["".join(rnd.choice("ACGT") for _ in range(k % 40))
                 + seqs[(k * 7) % 1000][:400] for k in range(300)], W)
            u = M._upload(pats, np.minimum(pl[:200], 480), texts, tl, 200,
                          300, "cuda")
            got = M.myers_cuda(*u, mode)
            want = M.myers_plain(*u, mode)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), f"myers {mode} differs"
            print(f"   myers {mode} 200 x 300 with end positions: equal")

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
                  [group(1700, 50)]))
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

    def run_all(self, out, backend):
        """``cli run-all --device cuda`` in this process with the given
        consensus pileup backend, every launch counter set to 0 just
        before; returns (report, wall s, launch counts)."""
        import contextlib
        import io
        import shutil
        from tpu_orc_torch import cli
        from tpu_orc_torch.align import locate as L, myers as M, pileup as P
        from tpu_orc_torch.cluster import consensus
        if not hasattr(self, "fq"):
            self.fq, self.n_reads = self.plate()
        shutil.rmtree(out, ignore_errors=True)
        argv = ["run-all", self.fq, "-o", out, "-n", "plate", "-a", "COI",
                "--adapters-dir", self.adapters, "--device", "cuda"]
        log = io.StringIO()      # the CLI narrates stages, then the report
        counters = {"locate": L.LAUNCHES, "myers": M.LAUNCHES,
                    "pileup": P.LAUNCHES}
        saved = consensus.PILEUP_BACKEND
        consensus.PILEUP_BACKEND = backend
        try:
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            counts = {f"{k}_{e}": n for k, c in counters.items()
                      for e, n in c.snapshot().items()}
        finally:
            consensus.PILEUP_BACKEND = saved
        assert rc == 0, rc
        rep = json.loads(log.getvalue().strip().splitlines()[-1])
        print(f"   tpu_orc_torch.cli run-all --device cuda (in process), "
              f"pileup backend {backend}: {self.n_reads} reads, "
              f"{wall:.1f} s wall")
        print(f"   launch counts during run_all: {counts}")
        stages = rep["metrics"]["stages"]
        for st in stages:
            if not st["stage"].startswith(("03_sort/", "04_clean/")):
                print(f"   stage {st['stage']}: {st['wall_s']} s")
        big_comb = f"SP27_{self.big[1] + 1:03d}_SP5_{self.big[0] + 1:03d}"
        for kind in ("03_sort", "04_clean"):
            walls = {st["stage"].split("/")[1]: st["wall_s"]
                     for st in stages if st["stage"].startswith(kind + "/")}
            print(f"   stage {kind}: {len(walls)} bins, sum "
                  f"{sum(walls.values()):.2f} s, enlarged bin "
                  f"{walls.get(big_comb, 0.0):.2f} s, other bins max "
                  f"{max(v for k, v in walls.items() if k != big_comb):.2f}"
                  f" s (4 bin workers)")
        return rep, counts

    def main_path(self):
        from tpu_orc_torch import synthetic
        out = os.path.join(WORK, "plate", "native")
        rep, counts = self.run_all(out, "native")
        self.launches({k: n for k, n in counts.items()
                       if k.startswith(("locate_", "myers_"))})
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
        zero = [k for k, v in self.kernels.items()
                if k.startswith(("locate_", "myers_")) and v["launches"] == 0]
        assert not zero, f"kernels not launched during run_all: {zero}"
        self.native_out = out

    def device_path(self):
        out = os.path.join(WORK, "plate", "device")
        rep, counts = self.run_all(out, "device")
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


def main() -> int:
    import torch
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
    os.makedirs(WORK, exist_ok=True)
    s = Smoke()
    t0 = time.perf_counter()
    s.phase("1 setup", s.setup)
    if s.failed:
        return 1
    s.phase("2 locate kernel vs plain", s.locate)
    s.phase("3 myers kernel vs plain", s.myers)
    s.phase("4 fused demux kernel path vs plain path", s.fused)
    s.phase("5 pileup kernel vs plain", s.pileup)
    s.phase("6 run_all COI main path", s.main_path)
    if "6 run_all COI main path" not in s.failed:
        s.phase("7 run_all with the device consensus pileup",
                s.device_path)
    print(f"total {time.perf_counter() - t0:.1f} s")
    if s.failed:
        print(f"chip_smoke: failed phases: {s.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(s.kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
