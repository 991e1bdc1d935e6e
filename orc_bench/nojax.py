"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level part, whole: ``tpu_orc``
is forbidden and ``tpu_orc_torch``, which begins with it, is not.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_orc")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted (an
    entry set to None, which blocks an import, is not loaded)."""
    if names is None:
        names = [n for n, m in list(sys.modules.items()) if m is not None]
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
