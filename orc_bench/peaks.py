"""The card's peaks and the least time a kernel's work can take.

The arithmetic of ``chip_smoke.py``'s ``bound`` (one NVIDIA H100 SXM):
int32 operations issue at 132 SMs x 64 lanes x 1.98 GHz = 1.67e13/s
(an SM has half as many int32 lanes as float32 lanes), HBM3 moves 3.35
TB/s. A locate DP cell (cutadapt's recurrence: compares, adds and
selects) costs 16 int32 operations, a Myers bit-vector step over one
32-bit pattern word 20. The counts of cells and word steps come from
what the contract needs for the inputs (:mod:`orc_bench.work`), never
from a kernel's tiles or padding.
"""
from __future__ import annotations

BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_LOCATE_CELL = 16
OPS_PER_MYERS_WORD_STEP = 20
WORD_BITS = 32


def least_seconds(n_ops: float, n_bytes: float) -> float:
    """The larger of operations over the int32 rate and bytes over the
    memory rate."""
    return max(n_ops / INT_OPS_PER_S, n_bytes / BYTES_PER_S)
