"""Adapter/primer bank: device-ready encoding of a primer FASTA.

Copy of ``tpu_orc/demux/adapters.py``; the device seam: the tables come
from ``align/tables.py`` (the JAX module imports jax), and a bank carries
the torch ``device`` its locates run on (CPU: the plain version, CUDA:
the kernel).

The reference treats its primer FASTAs as configuration (SURVEY.md §5):
M13_amplicon_indices_forward.fa (12 SP5 5'-adapters),
M13_amplicon_indices_reverse_rc.fa (12 SP27-rc 3'-adapters),
COI_primers.fa / RNA_primers.fa (degenerate primer pairs). A bank is the
replicated-per-chip constant of the demux kernels.

A bank is treated as IMMUTABLE once any locate has run against it: the
locate path caches derived tables (and their device copies) per bank
instance (align/locate.py::tables_for_bank takes defensive copies).
Callers that need different thresholds should build a new bank rather
than mutating ``k_table`` in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..io import encode
from ..io.fastq import read_fasta

from ..align.tables import make_k_table, make_n_prefix


@dataclass
class AdapterBank:
    names: List[str]
    seqs: List[str]
    max_error_rate: float
    device: str = "cuda"                       # where its locates run
    masks: np.ndarray = field(init=False)      # [A, M] uint8
    lens: np.ndarray = field(init=False)       # [A] int32
    k_table: np.ndarray = field(init=False)    # [A, M+1] int32
    n_prefix: np.ndarray = field(init=False)   # [A, M+1] int32

    def __post_init__(self):
        A = len(self.seqs)
        if A == 0:
            raise ValueError("empty adapter bank")
        M = max(len(s) for s in self.seqs)
        self.masks = np.zeros((A, M), dtype=np.uint8)
        self.lens = np.zeros(A, dtype=np.int32)
        for i, s in enumerate(self.seqs):
            m = encode.encode_ref_masks(s)
            self.masks[i, : len(m)] = m
            self.lens[i] = len(m)
        self.k_table = make_k_table(self.max_error_rate, self.masks, self.lens)
        self.n_prefix = make_n_prefix(self.masks)

    def __len__(self):
        return len(self.seqs)

    @classmethod
    def from_fasta(cls, path, max_error_rate: float,
                   device: str = "cuda") -> "AdapterBank":
        names, seqs = [], []
        for rec in read_fasta(path):
            names.append(rec.id)
            seqs.append(rec.seq.upper())
        return cls(names, seqs, max_error_rate, device)

    @classmethod
    def from_pairs(cls, pairs, max_error_rate: float,
                   device: str = "cuda") -> "AdapterBank":
        names = [p[0] for p in pairs]
        seqs = [p[1].upper() for p in pairs]
        return cls(names, seqs, max_error_rate, device)
