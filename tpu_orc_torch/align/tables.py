"""Host-side locate tables and the locate result type, without JAX.

The numpy parts of ``tpu_orc/align/batched.py`` (:44-92):
``LocateResult``, ``make_k_table`` and ``make_n_prefix``, unchanged. The
JAX module imports ``jax`` at load time, so the port carries them here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LocateResult(NamedTuple):
    """Best location per (read, adapter); fields [B, A] int32 numpy.

    valid==0 rows have unspecified other fields. refstart/refstop/
    querystart/querystop follow spec.py conventions.

    ``nloc``/``nacc`` — hit-multiplicity evidence for the reorient
    fast path (demux/reorient.py): the number of RUNS of acceptable
    end columns (rising edges of the per-column acceptance series the
    scan already evaluates) and the total count of acceptable columns.
    Two acceptable locations with DISJOINT spans always either produce
    two runs or stretch one run wider than a single location can
    (span length >= len(adapter) - k), so ``nloc <= 1`` together with
    ``nacc <= len(adapter) - k`` proves the best hit is the ONLY
    disjoint acceptable location of that adapter — which is exactly
    the completeness precondition pychopper's enumeration establishes
    by masked re-scanning. Meaningful for STOP_WITHIN_SEQ2 modes
    (FRONT/INFIX); zeros on paths that don't compute them (the native
    small-batch shortcut, the BACK snapshot candidates).
    """
    valid: np.ndarray
    matches: np.ndarray
    errors: np.ndarray
    refstart: np.ndarray
    refstop: np.ndarray
    querystart: np.ndarray
    querystop: np.ndarray
    nloc: np.ndarray
    nacc: np.ndarray


def make_k_table(max_error_rate: float, ref_masks: np.ndarray,
                 ref_lens: np.ndarray) -> np.ndarray:
    """Host-side exact-double error-budget tables: [A, M+1] int32 with
    entry [a, eff] = floor(e * eff) in float64 (cutadapt's C-double
    semantics)."""
    A, M = ref_masks.shape
    eff = np.arange(M + 1, dtype=np.float64)
    row = np.floor(max_error_rate * eff).astype(np.int32)
    return np.broadcast_to(row, (A, M + 1)).copy()


def make_n_prefix(ref_masks: np.ndarray) -> np.ndarray:
    """[A, M+1] int32 prefix counts of N wildcards per adapter row."""
    is_n = (ref_masks & 0b1111) == 0b1111
    out = np.zeros((ref_masks.shape[0], ref_masks.shape[1] + 1), dtype=np.int32)
    np.cumsum(is_n, axis=1, out=out[:, 1:])
    return out
