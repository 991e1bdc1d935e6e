"""tpu_orc_torch's multi-device steps (dist/sharded.py, decide_multi),
multi-host on torch.distributed (dist/multihost.py) and prewarm,
against tpu_orc (the demux stream, the scorer and run_all
on a mesh are in test_torch_dist_run.py).

The port's meshes here are the CPU device listed several times (its
steps then run every stripe through the plain versions, one after
another); tpu_orc's are conftest's virtual 8-device CPU mesh, where its
shard_map steps run the XLA locate and Myers and its FusedDemux the
Pallas kernels in interpret mode. Banks come from
``tpu_orc_torch.synthetic``. Every comparison is exact. The multi-host
tests start two processes on localhost with the gloo backend.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_orc.demux import adapters as ref_adapters
from tpu_orc.demux import fused as ref_fused
from tpu_orc.dist import multihost as ref_multihost
from tpu_orc.dist import sharded as ref_sharded
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record as RefRecord
from tpu_orc.io.fastq import write_records
from tpu_orc_torch import cli, synthetic
from tpu_orc_torch.demux import fused as port_fused
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.dist import multihost, sharded
from tpu_orc_torch.pipeline import stages as port_stages

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    return synthetic.write_adapter_dir(
        str(tmp_path_factory.mktemp("adapters")))


@pytest.fixture(scope="module")
def banks(adapters):
    f5 = os.path.join(adapters, "M13_amplicon_indices_forward.fa")
    f27 = os.path.join(adapters, "M13_amplicon_indices_reverse_rc.fa")
    return ((AdapterBank.from_fasta(f5, 0.1, "cpu"),
             AdapterBank.from_fasta(f27, 0.1, "cpu")),
            (ref_adapters.AdapterBank.from_fasta(f5, 0.1),
             ref_adapters.AdapterBank.from_fasta(f27, 0.1)))


def cpu_mesh(n, shape=None):
    return sharded.make_mesh(shape, devices=["cpu"] * n)


def demux_seqs(seed, sp5, sp27, B):
    """tests/test_dist.py's read mix: both adapters around a random
    insert, every other read reverse-complemented, every 7th insert
    alone (unknown)."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(B):
        ins = "".join(rng.choice(list("ACGT"),
                                 size=int(rng.integers(60, 120))))
        s = sp5.seqs[i % 12] + ins + sp27.seqs[i % 8]
        if i % 2:
            s = encode.revcomp(s)
        if i % 7 == 0:
            s = ins
        seqs.append(s)
    return seqs


def demux_batch(seed, sp5, sp27, B, L=256):
    return encode.pack_batch(demux_seqs(seed, sp5, sp27, B), max_len=L,
                             pad_multiple=1,
                             encoder=encode.encode_read_masks, pad_value=0)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_make_mesh_shape_and_repeated_devices():
    mesh = cpu_mesh(8, (4, 2))
    assert mesh.shape == {"data": 4, "pair": 2}
    assert mesh.axis_names == ("data", "pair")
    assert mesh.devices.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert cpu_mesh(3).shape == {"data": 3, "pair": 1}


def test_make_mesh_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(devices=["cuda:0", "cuda:0"])


def test_make_mesh_names_every_card_by_index(monkeypatch):
    """Every stripe carries ``cuda:k``: ``cuda`` (the current card) is
    normalised to its index, and the default mesh is every card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert list(sharded.make_mesh().devices.flat) == \
        [torch.device("cuda", k) for k in range(3)]
    got = sharded.make_mesh(devices=["cuda", "cuda:0", "cuda"])
    assert list(got.devices.flat) == [torch.device("cuda", k)
                                      for k in (2, 0, 2)]
    with pytest.raises(RuntimeError, match="3 CUDA devices"):
        sharded.make_mesh(devices=["cuda:3"])


def test_choose_best_first_adapter_wins_ties():
    from tpu_orc_torch.align.tables import LocateResult
    t = lambda x: torch.tensor(x, dtype=torch.int32)
    valid = t([[1, 1, 1], [0, 0, 0], [1, 0, 1]])
    matches = t([[5, 7, 7], [9, 9, 9], [3, 9, 3]])
    z = torch.zeros_like(valid)
    res = LocateResult(valid, matches, t([[0, 1, 2]] * 3), z, z,
                       t([[10, 11, 12]] * 3), t([[20, 21, 22]] * 3), z, z)
    idx, m, qs, qe, e = sharded.choose_best(res)
    assert idx.tolist() == [1, -1, 0]
    assert m.tolist() == [7, -1, 3]
    assert qs.tolist() == [11, 10, 10] and qe.tolist() == [21, 20, 20]
    assert e.tolist() == [1, 0, 0]


# ---------------------------------------------------------------------------
# the sharded steps against tpu_orc's shard_map steps
# ---------------------------------------------------------------------------

def test_sharded_demux_step_equals_reference(banks):
    (sp5, sp27), (r5, r27) = banks
    masks, lens = demux_batch(1, sp5, sp27, 36)   # 36: 8 does not divide
    got = sharded.sharded_demux_step(cpu_mesh(8, (4, 2)), sp5, masks, lens)
    want = ref_sharded.sharded_demux_step(ref_sharded.make_mesh((4, 2)), r5,
                                          masks, lens)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    hist = got[4]
    assert int(hist.sum()) == 36
    for a in range(-1, len(sp5)):
        assert int(hist[a + 1]) == int((got[0] == a).sum())


def test_sharded_dual_demux_step_equals_reference(banks):
    (sp5, sp27), (r5, r27) = banks
    masks, lens = demux_batch(2, sp5, sp27, 36)
    got = sharded.sharded_dual_demux_step(cpu_mesh(8, (4, 2)), sp5, sp27,
                                          masks, lens)
    want = ref_sharded.sharded_dual_demux_step(
        ref_sharded.make_mesh((4, 2)), r5, r27, masks, lens)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # equal to the single-device fused program, histograms cover every read
    single = port_fused.FusedDemux(sp5, sp27).decide(masks, lens)
    for g, w in zip(got[:8], single):
        np.testing.assert_array_equal(g, w)
    assert int(got[8].sum()) == int(got[9].sum()) == 36
    assert int(got[8][0]) == int((single.idx1 < 0).sum())


def test_sharded_steps_refuse_rows_off_the_data_axis(banks):
    (sp5, sp27), _ = banks
    masks, lens = demux_batch(3, sp5, sp27, 6)
    with pytest.raises(ValueError, match="do not split over 4"):
        sharded.sharded_dual_demux_step(cpu_mesh(4), sp5, sp27, masks, lens)


def pair_codes(seed, n, width=256, base_len=200):
    """test_dist.py's pairwise case: n mutants of one random sequence,
    codes padded with 4."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=base_len))
    pat = np.full((n, width), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        s = list(base[:base_len - int(rng.integers(0, 40))])
        for _ in range(10):
            s[int(rng.integers(0, len(s)))] = str(rng.choice(list("ACGT")))
        c = encode.encode_codes("".join(s))
        pat[i, :len(c)] = c
        lens[i] = len(c)
    return pat, lens


def test_sharded_pairwise_step_equals_reference():
    pat, lens = pair_codes(4, 16)
    got = sharded.sharded_pairwise_step(cpu_mesh(8, (4, 2)), pat, lens,
                                        pat, lens)
    want = np.asarray(ref_sharded.sharded_pairwise_step(
        ref_sharded.make_mesh((4, 2)), pat, lens, pat, lens))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_pat", [3, 10])   # below, and not divided by, 4
@pytest.mark.parametrize("gated", [False, True])
def test_device_parallel_pairwise_equals_reference(n_pat, gated):
    pat, plens = pair_codes(5, n_pat)
    txt, tlens = pair_codes(6, 12)
    gate = None
    if gated:
        gate = np.random.default_rng(7).random((n_pat, 12)) < 0.3
        gate[0, :] = False             # a pattern row with no gated pair
    got = sharded.device_parallel_pairwise(["cpu"] * 4, pat, plens, txt,
                                           tlens, gate=gate)
    want = ref_sharded.device_parallel_pairwise(
        jax.devices()[:4], pat, plens, txt, tlens, gate=gate)
    assert got.shape == want.shape == (n_pat, 12)
    assert got.dtype == np.int32
    sel = gate if gated else np.ones_like(got, bool)
    np.testing.assert_array_equal(got[sel], want[sel])


def test_device_parallel_pairwise_skips_a_stripe_without_tiles(monkeypatch):
    """A stripe whose gate lists no tile launches nothing."""
    from tpu_orc_torch.align import myers
    calls = []
    real = myers.distances_pairs
    monkeypatch.setattr(myers, "distances_pairs",
                        lambda *a, **k: calls.append(k["device"]) or
                        real(*a, **k))
    pat, plens = pair_codes(8, 8)
    gate = np.zeros((8, 8), bool)
    gate[5, 6] = True                  # stripe 2 of 4 only
    got = sharded.device_parallel_pairwise(["cpu"] * 4, pat, plens, pat,
                                           plens, gate=gate)
    assert len(calls) == 1
    want = ref_sharded.device_parallel_pairwise(
        jax.devices()[:4], pat, plens, pat, plens, gate=gate)
    assert got[5, 6] == want[5, 6]


# ---------------------------------------------------------------------------
# the fused demux per device
# ---------------------------------------------------------------------------

def test_decide_multi_equals_reference_and_decide(banks):
    (sp5, sp27), (r5, r27) = banks
    masks, lens = demux_batch(9, sp5, sp27, 20)   # 3 stripes of 7, 7, 6
    got = port_fused.FusedDemux(sp5, sp27).decide_multi(masks, lens,
                                                        ["cpu"] * 3)
    want = ref_fused.FusedDemux(r5, r27, interpret=True).decide_multi(
        masks, lens, jax.devices()[:3])
    single = port_fused.FusedDemux(sp5, sp27).decide(masks, lens)
    for name, g, w, s in zip(got._fields, got, want, single):
        np.testing.assert_array_equal(g, w, name)
        np.testing.assert_array_equal(g, s, name)


# ---------------------------------------------------------------------------
# the demux stream, the scorer and run_all on a mesh
# ---------------------------------------------------------------------------

def test_pipeline_config_mesh(monkeypatch):
    cfg = port_stages.PipelineConfig("x", device="cpu")
    assert cfg.mesh() is None
    cfg.use_mesh = True
    assert list(cfg.mesh().devices.flat) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_stages.PipelineConfig("x", use_mesh=True).mesh()


# ---------------------------------------------------------------------------
# multi-host
# ---------------------------------------------------------------------------

def test_host_file_shard_equals_reference():
    files = [f"bin_{i:02d}.fastq" for i in (4, 0, 6, 2, 1, 5, 3)]
    for n in (1, 2, 3):
        parts = [multihost.host_file_shard(files, p, n) for p in range(n)]
        assert parts == [ref_multihost.host_file_shard(files, p, n)
                         for p in range(n)]
        assert sorted(sum(parts, [])) == sorted(files)
    assert multihost.host_file_shard(files) == sorted(files)   # no group
    assert multihost.is_coordinator()


def test_init_multihost_without_a_group_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_multihost() == (0, 1)
    with pytest.raises(ValueError, match="backend"):
        multihost.init_multihost("127.0.0.1:1", 2, 0, backend="mpi")


def test_init_multihost_nccl_needs_a_card_per_process(monkeypatch):
    """NCCL refuses two ranks on one card: more local processes than
    cards raises before any group starts."""
    with pytest.raises(RuntimeError, match="0 CUDA devices"):
        multihost.init_multihost("127.0.0.1:1", 2, 0, backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 processes on this host"):
        multihost.init_multihost("127.0.0.1:1", 2, 1, backend="nccl")
    assert not torch.distributed.is_initialized()


WORKER = r'''
import glob, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.dist.multihost import (global_mesh, host_file_shard,
                                          init_multihost, is_coordinator)
from tpu_orc_torch.dist.sharded import sharded_demux_step

mode, coord, nprocs, pid, indir, outdir = sys.argv[1:7]
nprocs, pid = int(nprocs), int(pid)
rank, world = init_multihost(coord, nprocs, pid, backend="gloo")
mesh = global_mesh(devices=["cpu", "cpu"])
res = {"pid": rank, "world": world, "ndev_local": mesh.devices.size,
       "is_coord": is_coordinator()}
if mode == "hist":
    # each process demuxes its own half of one batch; the histogram is
    # summed over both processes
    masks = np.load(os.path.join(indir, "masks.npy"))
    lens = np.load(os.path.join(indir, "lens.npy"))
    half = len(masks) // nprocs
    sp5 = AdapterBank.from_fasta(os.path.join(
        indir, "M13_amplicon_indices_forward.fa"), 0.1, "cpu")
    out = sharded_demux_step(mesh, sp5, masks[pid * half:(pid + 1) * half],
                             lens[pid * half:(pid + 1) * half])
    res["idx"] = out[0].tolist()
    res["hist"] = out[4].tolist()
    res["files"] = host_file_shard([f"bin_{i:02d}.fastq" for i in range(7)])
else:
    from tpu_orc_torch.cluster.engine import AmpliconSorter, SorterConfig
    from tpu_orc_torch.cluster.output import write_barcode_consensus
    from tpu_orc_torch.cluster.scoring import DeviceScorer
    from tpu_orc_torch.io.fastq import read_records
    bins = sorted(glob.glob(os.path.join(indir, "*.fastq")))
    done = []
    for path in host_file_shard(bins):
        barcode = os.path.splitext(os.path.basename(path))[0]
        srt = AmpliconSorter(SorterConfig(min_length=300, seed=7),
                             scorer=DeviceScorer(backend="native"),
                             device="cpu")
        result = srt.sort_records(list(read_records(path)))
        write_barcode_consensus(result, os.path.join(outdir, "bins"),
                                barcode, "e2e")
        done.append(barcode)
    dist.barrier()
    if is_coordinator():
        parts = []
        for path in bins:
            barcode = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(outdir, "bins",
                                   f"{barcode}_consensus_e2e.fasta")) as fh:
                parts.append(fh.read())
        with open(os.path.join(outdir, "consensusfile.fasta"), "w") as fh:
            fh.write("".join(parts))
    res["bins"] = done
dist.barrier()
dist.destroy_process_group()
with open(os.path.join(outdir, f"result_{pid}.json"), "w") as fh:
    json.dump(res, fh)
print("ok", rank)
'''


def run_two_processes(tmp_path, mode, indir, outdir):
    """Two worker processes on localhost (gloo); returns their results."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), mode, f"127.0.0.1:{port}", "2",
         str(pid), str(indir), str(outdir)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-3000:]}"
    return [json.load(open(outdir / f"result_{k}.json")) for k in range(2)]


def test_two_processes_all_reduce_histogram_and_shard_files(banks,
                                                            adapters,
                                                            tmp_path):
    """Two gloo processes on localhost: the all-reduced histogram equals
    the histogram of the whole batch in one process, and host_file_shard
    partitions the files disjointly and completely."""
    import shutil
    (sp5, sp27), _ = banks
    masks, lens = demux_batch(14, sp5, sp27, 32)
    indir = tmp_path / "in"
    shutil.copytree(adapters, indir)
    np.save(indir / "masks.npy", masks)
    np.save(indir / "lens.npy", lens)
    r0, r1 = run_two_processes(tmp_path, "hist", indir, tmp_path)
    assert r0["world"] == r1["world"] == 2
    assert r0["ndev_local"] == 2
    assert r0["is_coord"] and not r1["is_coord"]
    whole = sharded.sharded_demux_step(cpu_mesh(2), sp5, masks, lens)
    assert r0["idx"] + r1["idx"] == whole[0].tolist()
    assert r0["hist"] == r1["hist"] == whole[4].tolist()
    assert sum(r0["hist"]) == 32
    assert sorted(r0["files"] + r1["files"]) == \
        [f"bin_{i:02d}.fastq" for i in range(7)]
    assert not set(r0["files"]) & set(r1["files"])


def test_two_processes_e2e_consensusfile(tmp_path):
    """Two gloo processes sort disjoint host_file_shard bins, the
    coordinator merges the run-level consensusfile.fasta after a
    barrier: byte-identical to tpu_orc's one-process run over all bins
    (test_dist.py:215's case)."""
    from tpu_orc.cluster.engine import AmpliconSorter, SorterConfig
    from tpu_orc.cluster.output import write_barcode_consensus
    from tpu_orc.cluster.scoring import DeviceScorer as RefScorer
    from tpu_orc.io.fastq import read_records
    rng = np.random.default_rng(99)
    indir = tmp_path / "bins_in"
    indir.mkdir()
    for b in range(3):
        t1 = "".join(rng.choice(list("ACGT"), size=360))
        t2 = "".join(rng.choice(list("ACGT"), size=370))
        recs = []
        for i in range(24):
            s = list(t1 if i < 12 else t2)
            for p in rng.choice(len(s), 6, replace=False):
                s[int(p)] = "ACGT"[int(rng.integers(4))]
            recs.append(RefRecord(f"b{b}r{i}", f"b{b}r{i}", "".join(s),
                                  "I" * len(s)))
        write_records(str(indir / f"SP27_00{b + 1}_SP5_001.fastq"), recs,
                      fmt="fastq")
    ref_dir = tmp_path / "ref"
    for path in sorted(indir.glob("*.fastq")):
        srt = AmpliconSorter(SorterConfig(min_length=300, seed=7),
                             scorer=RefScorer(backend="native"))
        result = srt.sort_records(list(read_records(str(path))))
        write_barcode_consensus(result, str(ref_dir / "bins"), path.stem,
                                "e2e")
    ref = "".join(open(p).read() for p in sorted(
        (ref_dir / "bins").glob("*_consensus_e2e.fasta")))
    assert ref.count(">") >= 3
    outdir = tmp_path / "mh"
    outdir.mkdir()
    r0, r1 = run_two_processes(tmp_path, "e2e", indir, outdir)
    assert r0["is_coord"] and not r1["is_coord"]
    assert not set(r0["bins"]) & set(r1["bins"])
    assert len(r0["bins"]) + len(r1["bins"]) == 3
    assert (outdir / "consensusfile.fasta").read_text() == ref


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------

def test_prewarm_on_the_cpu(adapters, capsys):
    """The CPU has nothing to build and no Myers to warm (as tpu_orc's
    prewarm on the CPU): one fused demux per read-length bucket."""
    from tpu_orc_torch.utils.prewarm import prewarm
    got = prewarm(adapters, demux_lens=(128, 256), demux_batch=4,
                  devices=["cpu"], verbose=False)
    assert sorted(got) == ["fused_demux_L128_B4_cpu",
                           "fused_demux_L256_B4_cpu"]
    assert cli.main(["prewarm", "--adapters-dir", adapters, "--device",
                     "cpu", "--batch", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == [f"fused_demux_L{L}_B2_cpu"
                           for L in (384, 512, 640)]
