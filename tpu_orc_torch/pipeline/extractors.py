"""Readcount parsing of consensus headers.

Copy of ``get_readcount`` from ``tpu_orc/pipeline/extractors.py`` (:19-26),
the one function of that module that the port's stages reach (through
``pipeline/summary.py``); the code is unchanged. The max-readcount
extractors of that module belong to CLI subcommands that are not ported.
"""
from __future__ import annotations

import re

_READCOUNT = re.compile(r"readcount_(\d+)")


def get_readcount(header: str) -> int:
    """readcount from a ``..._readcount_N`` header; 0 if absent
    (ribo_maxread_extractor.py:26-41)."""
    m = _READCOUNT.search(header)
    return int(m.group(1)) if m else 0
