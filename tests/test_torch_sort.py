"""tpu_orc_torch stage 03 (cluster/engine.py + scoring.py) against tpu_orc.

One two-species bin of 150 reads (COI primers around two planted 450 bp
templates, 3% noise, every 20th read reverse-complemented so that the
rc retry runs) is sorted by the port's AmpliconSorter with
``DeviceScorer(backend="kernel")`` on the CPU (the plain Myers for the
gene-stage listed tiles and the ladder's dense blocks) and by tpu_orc's
with its native scorer. ``consensusfile.fasta`` and every file under
``sorted/`` must be byte-identical, except the ``pairs_scored`` line of
``results.txt``: that telemetry counts pairs differently on tpu_orc's own
device and native backends (the device path counts whole ladder blocks,
the native one only length-gated pairs), and the port's kernel backend
counts as tpu_orc's device path does.
"""
import os
import random

import torch

from tpu_orc.cluster import engine as ref_engine
from tpu_orc.cluster import output as ref_output
from tpu_orc.cluster import scoring as ref_scoring
from tpu_orc.io import encode
from tpu_orc.io.fastq import Record
from tpu_orc_torch import synthetic
from tpu_orc_torch.cluster import engine as port_engine
from tpu_orc_torch.cluster import output as port_output
from tpu_orc_torch.cluster import scoring as port_scoring

from test_torch_stages import assert_same_tree

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)


def _bin_reads(n=150, seed=9):
    rnd = random.Random(seed)
    b = synthetic.banks()
    f = synthetic.concretize(rnd, b["coi"][0][1])
    r = synthetic.concretize(rnd, b["coi"][2][1])
    tmpls = ["".join(rnd.choice("ACGT") for _ in range(450))
             for _ in range(2)]
    recs = []
    for k in range(n):
        s = f + synthetic.mutate(rnd, tmpls[k % 2], 0.03) + r
        if k % 20 == 19:
            s = encode.revcomp(s)
        recs.append(Record(f"b{k}", f"b{k}", s, "I" * len(s)))
    return recs


def _sort(engine, output, scorer, recs, outdir):
    sorter = engine.AmpliconSorter(engine.SorterConfig(), scorer=scorer)
    res = sorter.sort_records(recs)
    output.write_sort_outputs(res, recs, os.path.join(outdir, "bc"), "bc")
    output.write_barcode_consensus(res, outdir, "bc", "amplicons")
    return res


def test_sort_kernel_scorer_equals_reference_native(tmp_path):
    recs = _bin_reads()
    port = port_scoring.DeviceScorer(backend="kernel", device="cpu")
    got = _sort(port_engine, port_output, port, recs, str(tmp_path / "p"))
    want = _sort(ref_engine, ref_output,
                 ref_scoring.DeviceScorer(backend="native"), recs,
                 str(tmp_path / "r"))
    assert sum(len(s) for s in want.species) == 2
    assert got.pairs_scored >= want.pairs_scored > 0
    for side in ("p", "r"):   # drop the backend-specific telemetry line
        p = tmp_path / side / "bc" / "results.txt"
        p.write_text("".join(ln for ln in p.read_text().splitlines(True)
                             if not ln.startswith("pairs_scored:")))
    assert_same_tree(str(tmp_path / "p"), str(tmp_path / "r"))
