"""The card's float32 rate and the least time of the Viterbi's work.

``chip_smoke.py``'s arithmetic for ``csrc/viterbi.cu`` (one NVIDIA H100
SXM): float32 operations issue at 132 SMs x 128 lanes x 1.98 GHz =
3.35e13/s (no FMA: the step has adds and max only), and a (position,
node) cell of the local Viterbi costs 15 of them (9 adds and 6 max of
the step). The cells come from what the harness fed the program (each
sequence's own length by the profile's nodes), never from a launch's
padding. The bytes (a sequence's codes and the tables) are a few
hundred thousandths of the time the operations need, so operations
bound it.
"""
from __future__ import annotations

FP32_OPS_PER_S = 132 * 128 * 1.98e9
OPS_PER_VITERBI_CELL = 15


def viterbi_least_seconds(cells: float) -> float:
    """Operations of ``cells`` Viterbi cells over the float32 rate."""
    return cells * OPS_PER_VITERBI_CELL / FP32_OPS_PER_S
