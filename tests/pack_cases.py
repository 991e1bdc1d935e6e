"""Shared inputs of tests/test_torch_pack.py (on the CPU) and the pack
tests of tests/test_torch_cuda.py (on the card): each encoder's table and
host packing, the batches of the equality cases, and raw reads around the
synthetic pychopper primers. Nothing here imports JAX or ``tpu_orc``.
"""
import random

from tpu_orc_torch import synthetic
from tpu_orc_torch.io import encode

#: (byte-to-mask table, tpu_orc's host packing of it) of each encoder
TABLES = {"read": (encode.mask_table(encode.encode_read_masks),
                   encode.read_masks_matrix),
          "iupac": (encode.mask_table(encode.encode_read_masks_iupac),
                    encode.iupac_masks_matrix)}
#: each table's encoder
ENCODERS = {"read": encode.encode_read_masks,
            "iupac": encode.encode_read_masks_iupac}
CASES = ("random", "empty", "all_empty", "full", "symbols")
#: every IUPAC code, upper and lower case, the re-scan's mask and bytes
#: that map to no base
SYMBOLS = "ACGTUNRYSWKMBDHVacgtunryswkmbdhvX*-."


def batch(case: str, L: int, seed: int = 0):
    """The reads of one case, each at most L long."""
    rnd = random.Random(f"{case}/{L}/{seed}")
    rand = lambda n, abc="ACGT": "".join(rnd.choice(abc) for _ in range(n))
    if case == "random":
        return [rand(rnd.randrange(L)) for _ in range(37)]
    if case == "empty":
        return ["", rand(5), "", rand(rnd.randrange(L)), "", rand(L), ""]
    if case == "all_empty":
        return ["", "", ""]
    if case == "full":
        return [rand(L), rand(L, SYMBOLS), rand(L - 1), rand(L)]
    if case == "symbols":
        out = [rand(rnd.randrange(L), SYMBOLS) for _ in range(11)]
        s = rand(L)              # a primer's span masked as the re-scan does
        out.append(s[:L // 3] + "X" * (L // 4) + s[L // 3 + L // 4:])
        return out
    raise ValueError(case)


def host_packing(seqs, L, table):
    """(``tpu_orc``'s host packing of ``seqs`` at L, transposed to
    [L, B], and the lengths) with the table named ``table``."""
    amat, lens = encode.ascii_matrix(seqs, max_len=L)
    return TABLES[table][1](amat, lens).T, lens


def pychopper_reads(n: int, seed: int, insert=(80, 200)):
    """Raw reads around the synthetic pychopper primers: SP5, an insert
    of ``insert`` bp (low, high), SP27-rc; every third fused with a
    second unit (reverse-complemented in every other), every fifth with a
    span masked by X, some empty, and N, IUPAC codes and lower case in a
    few."""
    b = synthetic.banks(5)
    rnd = random.Random(seed)
    unit = lambda k: (b["sp5"][k % 12][1]
                      + "".join(rnd.choice("ACGT")
                                for _ in range(rnd.randrange(*insert)))
                      + b["sp27rc"][k % 8][1])
    reads = []
    for k in range(n):
        s = "".join(rnd.choice("ACGT") for _ in range(rnd.randrange(30)))
        s += unit(k)
        if k % 3 == 0:
            s += unit(k + 1) if k % 2 else encode.revcomp(unit(k + 1))
        if k % 5 == 0:
            s = s[:20] + "X" * 40 + s[60:]
        if k % 7 == 0:
            s = s[:50] + "NRYk" + s[54:].lower()
        reads.append("" if k % 11 == 4 else s)
    return reads
