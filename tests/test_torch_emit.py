"""tpu_orc_torch's stage-01 segment emit (``demux/emit.py``) and the
segment plan of ``Reorienter.run``, on the CPU.

* The plain emit's bytes are ``format_records`` over the ``Record``s that
  ``tpu_orc``'s ``_make_segment`` builds from the same cuts, file by
  file: on blocks of ``tests/reorient_cases.py``'s raw stream (both
  signs, fused reads of 2-4 segments, short segments on single and
  fused reads, primers kept and trimmed, reads without qualities, an
  empty block) and on cut tables made here (segment numbers of several
  digits, empty slices, IUPAC codes and lower case).
* ``Reorienter.run``'s lists and stats are ``tpu_orc``'s, and
  ``reorient_stream``'s files and stats are those its per-record path
  writes, in one block and in several.
* ``emit_fastq`` refuses what its kernel does not take.

The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py``. Tolerance: none (byte equality). Inputs
come from fixed seeds.
"""
import os

import numpy as np
import pytest
import torch

from tpu_orc.demux import reorient as ref_reorient
from tpu_orc.io import encode as ref_encode
from tpu_orc_torch.demux import emit as E
from tpu_orc_torch.demux import reorient as R
from tpu_orc_torch.io import encode
from tpu_orc_torch.io.fastq import Record, format_records

from reorient_cases import cut_table, records, write_primers

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


def old_segment(rec, seq, qual, neg, s0, s1, seg_no):
    """``tpu_orc``'s ``Reorienter._make_segment`` with the configuration's
    sign given as ``neg``."""
    seg = seq[s0:s1]
    segq = qual[s0:s1] if qual else None
    if neg:
        seg = ref_encode.revcomp(seg)
        segq = segq[::-1] if segq else None
    name = rec.id if seg_no == 0 else f"{rec.id}|seg{seg_no}"
    return Record(name, name, seg, segq)


def old_files(plan):
    """The pass, rescued and short files' bytes of a plan, one
    ``Record`` a segment and ``format_records``."""
    out = []
    for dest in (R.PASS, R.RESCUED, R.SHORT):
        recs = [old_segment(plan.kept[c], plan.kept[c].seq.upper(),
                            plan.kept[c].qual, bool(plan.neg[k]),
                            int(plan.s0[k]), int(plan.s1[k]),
                            int(plan.seg_no[k]))
                for k, c in enumerate(plan.ci.tolist())
                if plan.dest[k] == dest]
        out.append(format_records(recs, "fastq").encode())
    return out


def block_case(name):
    """(reads, ReorientConfig) of one block case."""
    _, _, recs = records(35, 90)
    rc = dict(q=0.8, device="cpu")
    if name == "keep_primers":
        return recs, R.ReorientConfig(**rc)
    if name == "trimmed":
        return recs, R.ReorientConfig(keep_primers=False, **rc)
    if name == "short":        # segments under -z on single and fused reads
        return recs, R.ReorientConfig(min_len=420, **rc)
    if name == "no_quality":
        for k, r in enumerate(recs):
            if k % 3 == 1:
                recs[k] = Record(r.id, r.desc, r.seq, None if k % 2 else "")
        return recs, R.ReorientConfig(**rc)
    if name == "empty":
        return [], R.ReorientConfig(**rc)
    raise ValueError(name)


BLOCKS = ("keep_primers", "trimmed", "short", "no_quality", "empty")


@pytest.mark.parametrize("case", [f"block/{b}" for b in BLOCKS]
                         + [f"cuts/{s}" for s in range(3)])
def test_emit_equals_format_records(case, tmp_path):
    """The plain emit's bytes, file by file, against ``format_records``
    over ``tpu_orc``'s records of the same cuts."""
    kind, name = case.split("/")
    if kind == "cuts":
        seqs, quals, ids, read, s0, s1, neg, seg_no = cut_table(int(name))
        got, offs = E.Emitter("cpu")(seqs, quals, ids, read, s0, s1, neg,
                                     seg_no)
        kept = [Record(i, i, s, q) for i, s, q in zip(ids, seqs, quals)]
        want = format_records(
            [old_segment(kept[c], seqs[c], quals[c], n, a, b, g)
             for c, a, b, n, g in zip(read.tolist(), s0.tolist(),
                                      s1.tolist(), neg.tolist(),
                                      seg_no.tolist())], "fastq")
        assert bytes(got) == want.encode("utf-8")
        assert offs[-1] == len(got) and len(offs) == len(read) + 1
        return
    recs, rc = block_case(name)
    pf = write_primers(str(tmp_path / "primers.fa"))
    cfg_text = records(35, 1)[0]["orientation_config"]
    res = R.Reorienter(pf, cfg_text, rc).run(recs)
    plan = res.plan
    files = res.file_bytes()
    want = old_files(plan)
    assert [bytes(files[i]) for i in (0, 1, 3)] == want
    assert bytes(files[2]) == format_records(res.unclass, "fastq").encode()
    assert [format_records(x, "fastq").encode() for x in (
        res.passed, res.rescued, res.short)] == want
    st = res.stats
    assert len(plan) == st["pass"] + st["rescued_segments"] + st["short"]
    if name == "empty":
        assert len(plan) == 0 and st["total"] == 0
        return
    assert plan.neg.any() and not plan.neg.all()
    assert st["fused_reads"] > 0 and st["pass"] > 0
    segs = np.bincount(plan.ci)
    assert segs.max() >= 2
    if name == "short":
        fused = segs[plan.ci] > 1
        short = plan.dest == R.SHORT
        assert (short & fused).any() and (short & ~fused).any()
        assert st["short"] > 0 and st["rescued_segments"] > 0
    if name == "no_quality":
        assert any(r.qual in (None, "") for r in res.passed)


@pytest.mark.parametrize("name", ["keep_primers", "trimmed", "short",
                                  "no_quality"])
def test_run_lists_equal_tpu_orc(name, tmp_path):
    """``Reorienter.run``'s four lists and stats against ``tpu_orc``'s
    ``Reorienter.run`` (one ``Record`` a segment, routed read by read) on
    the same block at the same q."""
    recs, rc = block_case(name)
    pf = write_primers(str(tmp_path / "primers.fa"))
    cfg_text = records(35, 1)[0]["orientation_config"]
    got = R.Reorienter(pf, cfg_text, rc).run(recs)
    want = ref_reorient.Reorienter(pf, cfg_text, ref_reorient.ReorientConfig(
        q=rc.q, min_len=rc.min_len, keep_primers=rc.keep_primers)).run(recs)
    fields = lambda xs: [(x.id, x.desc, x.seq, x.qual) for x in xs]
    for f in ("passed", "rescued", "unclass", "short"):
        assert fields(getattr(got, f)) == fields(getattr(want, f)), f
    assert got.stats == want.stats


def old_stream(recs, pf, cfg_text, outdir, name, rc, block):
    """``reorient_stream``'s files and stats as its per-record path wrote
    them: each block's four lists through ``format_records`` into text
    handles."""
    r = ref_reorient.Reorienter(pf, cfg_text, ref_reorient.ReorientConfig(
        q=rc.q, min_len=rc.min_len, keep_primers=rc.keep_primers))
    os.makedirs(outdir)
    fh = {k: open(os.path.join(outdir, f"{name}_{k}.fastq"), "w")
          for k in R.OUTPUTS}
    stats = {}
    for s in range(0, len(recs) + 1, block):
        res = r.run(recs[s:s + block])
        for k, v in res.stats.items():
            stats[k] = stats.get(k, 0) + v
        for k, x in zip(R.OUTPUTS, (res.passed, res.rescued, res.unclass,
                                    res.short)):
            fh[k].write(format_records(x, "fastq"))
    for h in fh.values():
        h.close()
    with open(os.path.join(outdir, f"{name}_stats.out"), "w") as h:
        h.write("".join(f"{k}\t{v}\n" for k, v in stats.items()))


@pytest.mark.parametrize("block", [30, 90, 1000],
                         ids=["several_blocks", "whole_blocks",
                              "one_block"])
def test_stream_files_equal_per_record_path(block, tmp_path):
    """``reorient_stream``'s four files and stats file, byte for byte,
    against the per-record path's, in blocks that leave a short last
    block, that end with an empty block and in one block."""
    from test_torch_stages import assert_same_tree
    _, _, recs = records(36, 90)
    pf = write_primers(str(tmp_path / "primers.fa"))
    cfg_text = records(36, 1)[0]["orientation_config"]
    rc = R.ReorientConfig(q=0.8, min_len=380, device="cpu")
    res = R.reorient_stream(iter(recs), pf, cfg_text, str(tmp_path / "new"),
                            "x", rc, block)
    old_stream(recs, pf, cfg_text, str(tmp_path / "old"), "x", rc, block)
    assert_same_tree(str(tmp_path / "new"), str(tmp_path / "old"))
    assert res.stats["fused_reads"] > 0 and res.stats["short"] > 0


def _refusal(kind):
    data = torch.frombuffer(bytearray(b"ACGTACGTAC"), dtype=torch.uint8)
    recs = torch.tensor([[0, 4, 4, 4, 8, 2, 0]], dtype=torch.int64)
    offs = torch.from_numpy(E.record_offsets(recs.numpy()))
    tab = encode._COMP_TAB
    return {
        "tab": lambda: E.emit_fastq(data, recs, offs, tab[:255]),
        "data_dtype": lambda: E.emit_fastq(data.int(), recs, offs, tab),
        "recs_cols": lambda: E.emit_fastq(data, recs[:, :6], offs, tab),
        "offs_len": lambda: E.emit_fastq(data, recs, offs[:1], tab),
        "offs_wrong": lambda: E.emit_fastq(data, recs, offs + 1, tab),
        "outside": lambda: E.emit_fastq(
            data, recs + torch.tensor([[0, 0, 3, 0, 0, 0, 0]]), offs, tab),
        "negative": lambda: E.emit_fastq(
            data, recs * torch.tensor([[1, 1, 1, 1, 1, 1, -1]]) -
            torch.tensor([[0, 0, 0, 0, 0, 0, 2]]), offs, tab),
        "device": lambda: E.emit_fastq(data.to("meta"), recs, offs, tab),
    }[kind]


@pytest.mark.parametrize("kind", ["tab", "data_dtype", "recs_cols",
                                  "offs_len", "offs_wrong", "outside",
                                  "negative", "device"])
def test_emit_fastq_refuses(kind):
    with pytest.raises(ValueError):
        _refusal(kind)()


def test_emit_fastq_one_record():
    """One '-' record written out by hand: the slices of its row, the
    sequence complemented and reversed, the quality reversed, "|seg2"."""
    data = torch.frombuffer(bytearray(b"AACGTTIJKLrd"), dtype=torch.uint8)
    recs = torch.tensor([[0, 4, 6, 3, 10, 2, 5]], dtype=torch.int64)
    offs = torch.from_numpy(E.record_offsets(recs.numpy()))
    out = E.emit_fastq(data, recs, offs, encode._COMP_TAB)
    assert bytes(out.numpy()) == b"@rd|seg2\nCGTT\n+\nKJI\n"
