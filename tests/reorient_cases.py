"""Shared pieces of tests/test_torch_reorient_stream.py that its
subprocess imports too, in an interpreter where ``import jax`` and
``import tpu_orc`` fail: so nothing here imports either.

The reads are the benchmark cell ``rrna.reorient``'s kinds
(``orc_bench/gen_raw.py``) cut to 260-680 bp (fused ones to ~1.4 kb),
with more special reads than the cell's, so that a few hundred reads
hold every kind.
"""
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = {"insert_range": [100, 400]}
TINY_MIX = {"fused_share": 0.06, "low_q_share": 0.05,
            "no_primer_share": 0.05, "truncated_share": 0.05}


def records(seed: int, reads: int):
    """(configuration, pool, records) of a tiny raw stream."""
    from orc_bench import gen_raw
    from tpu_orc_torch.io.fastq import Record
    bench = os.path.join(REPO, "orc_bench")
    with open(os.path.join(bench, "configs", "rrna_pychopper96.json")) as fh:
        cfg = dict(json.load(fh), **TINY_CFG)
    with open(os.path.join(bench, "traffic", "raw_rrna_stream.json")) as fh:
        mix = dict(json.load(fh), reads=reads, **TINY_MIX)
    pool = gen_raw.raw_pool(seed, cfg, mix)
    recs = [Record(f"r{i}", f"r{i}", s, q)
            for i, (s, q) in enumerate(zip(pool.seqs, pool.quals))]
    return cfg, pool, recs


def write_primers(path: str) -> str:
    """The cell's pychopper FASTA at ``path``."""
    from orc_bench import gen_raw
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n"
                         for n, s in gen_raw.pychopper_primers(5)))
    return path


def read_outputs(outdir: str, name: str):
    """{read id: [(file, header, sequence, quality)]} of what stage 01
    wrote into ``outdir``."""
    from orc_bench.reference import files
    from orc_bench.reference.pychopper import FILES
    got = {}
    for f in FILES:
        for h, s, q in files.fastq(os.path.join(outdir,
                                                f"{name}_{f}.fastq")):
            got.setdefault(h.split("|", 1)[0], []).append((f, h, s, q))
    return got
