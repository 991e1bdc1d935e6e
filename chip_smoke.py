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
  5. run_all (COI, device cuda) on a plate of 12 SP5 x 8 SP27 bins x 80
     reads, one bin enlarged to 1000 reads of two species so it sorts
     through both Myers entry points: 96 bins, 1 species group per bin
     (2 in the big one), every consensus >= 0.97 identical to its planted
     insert, and every kernel launched during the run.
Prints a JSON line of per-kernel numbers, the card line, and last the
result line. Exits non-zero, printing no result, when any phase fails or
there is no CUDA device. Times are medians of 5 timed runs after a
warm-up, from CUDA events; the tolerance of every comparison is zero
(integer outputs).
"""
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "smoke")


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

    def record(self, name, source, replaces, err, ms, plain_ms):
        self.kernels[name] = {"name": name, "route": "cuda",
                              "source": source, "replaces": replaces,
                              "launches": 0, "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms}
        print(f"   {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"max_abs_err {err}", flush=True)

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
            self.record(f"locate_{mode}", "tpu_orc_torch/csrc/locate.cu",
                        "tpu_orc/align/pallas_locate.py:205",
                        max_abs_err(got, want), ms, pms)

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
        self.record("myers_dense", "tpu_orc_torch/csrc/myers.cu",
                    "tpu_orc/align/pallas_myers.py:56", err, ms, pms)
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
        self.record("myers_pairs", "tpu_orc_torch/csrc/myers.cu",
                    "tpu_orc/align/pallas_myers.py:242", err, ms, pms)
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
    def main_path(self):
        import contextlib
        import io
        import shutil
        from tpu_orc_torch import cli, synthetic
        from tpu_orc_torch.align import locate as L, myers as M
        big = (3, 5)
        recs, planted = synthetic.make_plate(80, seed=11, big_bin=big)
        out = os.path.join(WORK, "plate")
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        fq = os.path.join(out, "plate.fastq")
        with open(fq, "w") as fh:
            fh.write("".join(f"@{r.desc}\n{r.seq}\n+\n{r.qual}\n"
                             for r in recs))
        argv = ["run-all", fq, "-o", os.path.join(out, "out"), "-n",
                "plate", "-a", "COI", "--adapters-dir", self.adapters,
                "--device", "cuda"]
        log = io.StringIO()      # the CLI narrates stages, then the report
        L.LAUNCHES.reset()
        M.LAUNCHES.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        loc, mye = L.LAUNCHES.snapshot(), M.LAUNCHES.snapshot()
        assert rc == 0, rc
        rep = json.loads(log.getvalue().strip().splitlines()[-1])
        print(f"   tpu_orc_torch.cli run-all --device cuda (in process): "
              f"{len(recs)} reads, {wall:.1f} s wall")
        print(f"   launch counts during run_all: locate {loc}, myers {mye}")
        counts = {**{f"locate_{k}": n for k, n in loc.items()},
                  **{f"myers_{k}": n for k, n in mye.items()}}
        for name, n in counts.items():
            self.kernels.setdefault(name, {"name": name})["launches"] = n
        stages = rep["metrics"]["stages"]
        for st in stages:
            if not st["stage"].startswith(("03_sort/", "04_clean/")):
                print(f"   stage {st['stage']}: {st['wall_s']} s")
        big_comb = (f"SP27_{big[1] + 1:03d}_SP5_{big[0] + 1:03d}")
        for kind in ("03_sort", "04_clean"):
            walls = {st["stage"].split("/")[1]: st["wall_s"]
                     for st in stages if st["stage"].startswith(kind + "/")}
            print(f"   stage {kind}: {len(walls)} bins, sum "
                  f"{sum(walls.values()):.2f} s, enlarged bin "
                  f"{walls.get(big_comb, 0.0):.2f} s, other bins max "
                  f"{max(v for k, v in walls.items() if k != big_comb):.2f}"
                  f" s (4 bin workers)")
        bins = rep["barcodes"]
        assert rep["demux"]["bins"] == 96, rep["demux"]
        worst = 1.0
        for (s5, s27), inserts in planted.items():
            comb = f"{s27}_{s5}"
            assert comb in bins, f"bin {comb} missing"
            assert bins[comb]["species_groups"] == len(inserts), \
                (comb, bins[comb])
            with open(os.path.join(out, "out", "sorted", comb,
                                   "consensusfile.fasta")) as fh:
                cons = [ln.strip() for ln in fh if not ln.startswith(">")]
            assert len(cons) == len(inserts), (comb, len(cons))
            for c in cons:
                worst = min(worst, max(synthetic.identity(c, p)
                                       for p in inserts))
        print(f"   96 bins, species groups as planted (2 in the enlarged "
              f"bin {big_comb}), lowest consensus identity {worst:.4f}")
        assert worst >= 0.97, worst
        zero = [k for k, v in self.kernels.items() if v["launches"] == 0]
        assert not zero, f"kernels not launched during run_all: {zero}"


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
    s.phase("5 run_all COI main path", s.main_path)
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
