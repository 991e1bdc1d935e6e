"""tpu_orc_torch's stage 01 as a stream: ``reorient_stream``.

* Against the benchmark's plain reference of pychopper
  (``orc_bench/reference/pychopper.py``, which imports nothing of the
  port), on a small raw stream of every kind of read that
  ``orc_bench/gen_raw.py`` makes (fused, low quality, no primer,
  truncated), at a fixed q and with q autotuned: every read's route and
  records, and the stats, exactly. Each case runs in a fresh interpreter
  in which ``import jax`` and ``import tpu_orc`` fail, and checks that
  neither was loaded.
* ``reorient_file`` and ``reorient_stream`` write the same files and
  stats, in one block and in several.
* Under ``recording()``, the spans of stage 01 nest as the stream and
  ``Reorienter.run`` open them, and the counters agree with the stats.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from orc_bench import gen_raw
from orc_bench.reference import pychopper as ref
from tpu_orc_torch.demux import reorient as R
from tpu_orc_torch.io.fastq import write_records
from tpu_orc_torch.utils.profiling import recording

from reorient_cases import REPO, records, write_primers
from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

#: one case: the port, then the reference, in a fresh interpreter that
#: cannot import jax or tpu_orc
SCRIPT = r"""
import json, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["tpu_orc"] = None
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
from collections import Counter
from reorient_cases import read_outputs, records, write_primers
from orc_bench import gen_raw
from orc_bench.reference import pychopper as ref
from tpu_orc_torch.demux.reorient import ReorientConfig, reorient_stream

q = None if sys.argv[2] == "auto" else float(sys.argv[2])
cfg, pool, recs = records(int(sys.argv[3]), int(sys.argv[4]))
out = tempfile.mkdtemp()
pf = write_primers(os.path.join(out, "primers.fa"))
res = reorient_stream(iter(recs), pf, cfg["orientation_config"], out, "x",
                      ReorientConfig(q=q, device="cpu"))
chopper = ref.Pychopper(gen_raw.pychopper_primers(5),
                        cfg["orientation_config"])
reads = [(r.id, r.seq, r.qual) for r in recs]
low = ref.mean_q([r[2] for r in reads]) < chopper.qmin
rq = q if q is not None else chopper.autotune(
    [r[1] for r, l in zip(reads, low) if not l])
want = chopper.run(reads, rq)
got = read_outputs(out, "x")
print(json.dumps({
    "wrong": [r[0] for r, w in zip(reads, want)
              if sorted(got.get(r[0], [])) != sorted(w)],
    "stats": res.stats, "q": rq, "low": int(low.sum()),
    "routes": Counter("+".join(ref.route(w)) for w in want),
    "kinds": Counter(gen_raw.KINDS[k] for k in pool.kind.tolist()),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "tpu_orc")
                     and sys.modules[m] is not None)}))
"""


@pytest.mark.parametrize("q,seed,reads", [("0.8", 31, 240),
                                          ("auto", 32, 160)],
                         ids=["fixed_q", "autotuned_q"])
def test_reorient_stream_equals_reference(q, seed, reads):
    p = subprocess.run([sys.executable, "-c", SCRIPT, REPO, q, str(seed),
                        str(reads)], capture_output=True, text=True,
                       cwd=REPO, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["wrong"] == []
    assert set(got["kinds"]) == set(gen_raw.KINDS)
    assert got["routes"]["rescued"] >= 3 and got["routes"]["pass"] > 0
    assert got["routes"]["unclass"] > got["low"] > 0
    st = got["stats"]
    assert st["total"] == reads and st["low_q"] == got["low"]
    assert st["fused_reads"] == got["routes"]["rescued"]
    assert st["pass"] == got["routes"]["pass"]
    assert st["unclass"] == got["routes"]["unclass"]
    if q == "auto":
        assert st["autotuned_q_x100"] == round(got["q"] * 100)
    else:
        assert "autotuned_q_x100" not in st


@pytest.mark.parametrize("block", [65536, 25], ids=["one_block",
                                                    "several_blocks"])
def test_reorient_file_and_stream_write_the_same(tmp_path, block):
    """The file wrapper and the stream over the same reads: the same four
    files and stats file byte for byte, the same stats; one block returns
    its records, several return stats alone."""
    cfg, _, recs = records(33, 100)
    pf = write_primers(str(tmp_path / "primers.fa"))
    cp = str(tmp_path / "config.txt")
    with open(cp, "w") as fh:
        fh.write(cfg["orientation_config"] + "\n")
    fq = str(tmp_path / "raw.fastq")
    write_records(fq, recs, fmt="fastq")
    rc = R.ReorientConfig(q=0.85, device="cpu")
    a = R.reorient_file(fq, pf, cp, str(tmp_path / "file"), "x", rc, block)
    b = R.reorient_stream(iter(recs), pf, cfg["orientation_config"],
                          str(tmp_path / "stream"), "x", rc, block)
    assert a.stats == b.stats and a.stats["total"] == len(recs)
    assert a.stats["fused_reads"] > 0
    assert_same_tree(str(tmp_path / "file"), str(tmp_path / "stream"))
    lists = (b.passed, b.rescued, b.unclass, b.short)
    if block > len(recs):
        assert sum(map(len, lists)) == (a.stats["pass"]
                                        + a.stats["rescued_segments"]
                                        + a.stats["unclass"]
                                        + a.stats["short"])
    else:
        assert not any(lists)


def test_reorient_stream_spans_and_counters(tmp_path):
    """A small stream in three blocks (the last one empty) under
    ``recording()``: each span under its parent, once a block where it is
    a block's; the counters as the stats and the files say."""
    cfg, _, recs = records(34, 96)
    pf = write_primers(str(tmp_path / "primers.fa"))
    with recording() as rec:
        res = R.reorient_stream(iter(recs), pf, cfg["orientation_config"],
                                str(tmp_path / "out"), "x",
                                R.ReorientConfig(device="cpu"), 48)
    s, c = rec.spans(), rec.counters()
    st = res.stats
    for name, parent, n in (("reorient.input", None, 3),
                            ("reorient.block", None, 3),
                            ("reorient.write", None, 3),
                            ("reorient.finish", None, 1),
                            ("reorient.qfilter", "reorient.block", 3),
                            ("reorient.autotune", "reorient.block", 1),
                            ("reorient.scan", "reorient.block", 2),
                            ("reorient.fetch", "reorient.block", 2),
                            ("reorient.classify", "reorient.block", 2),
                            ("reorient.enumerate", "reorient.block", 3),
                            ("reorient.schedule", "reorient.block", 3),
                            ("reorient.segment", "reorient.block", 3)):
        assert s[name]["parent"] == parent, name
        assert s[name]["n"] == n, name
    assert c["reorient.reads"] == st["total"] == len(recs)
    assert c["reorient.blocks"] == 3
    assert c["reorient.low_q"] == st["low_q"] > 0
    assert c["reorient.q_x100"] == st["autotuned_q_x100"]
    # every read with a hit at the tuned q takes exactly one path
    chopper = ref.Pychopper(gen_raw.pychopper_primers(5),
                            cfg["orientation_config"])
    meanq = ref.mean_q([r.qual for r in recs])
    kept = [r.seq for r, mq in zip(recs, meanq) if mq >= chopper.qmin]
    best = ref.scan(chopper.seqs, kept,
                    [chopper.budgets(st["autotuned_q_x100"] / 100)])
    with_hit = int(best.found[0].any(axis=1).sum())
    assert (c["reorient.fast"] + c["reorient.sched_direct"]
            + c["reorient.slow"] + c["reorient.unpaired"]) == with_hit
    assert c["reorient.slow"] > 0
    assert c["reorient.enum_reads"] >= c["reorient.slow"]
    assert c["reorient.enum_rounds"] >= 1
    assert c["reorient.fused"] == st["fused_reads"] > 0
    assert c["reorient.segments"] == (st["pass"] + st["rescued_segments"]
                                      + st["short"])
    written = sum(os.path.getsize(tmp_path / "out" / f"x_{f}.fastq")
                  for f in ref.FILES)
    assert c["reorient.out_bytes"] == written
    assert not any(k.startswith("locate.") for k in c)   # no kernel here
