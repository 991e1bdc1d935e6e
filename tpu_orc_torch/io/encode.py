"""Base encoding and batching for TPU alignment kernels.

Encodings
---------
Two parallel encodings of nucleotide sequences are used throughout:

* **code**: uint8 in {0:A, 1:C, 2:G, 3:T, 4:other/N}. Used to build Myers
  bit-parallel Peq masks and for consensus pileups.
* **match mask**: uint8 bitmask used for cutadapt-style wildcard-aware
  comparison. Read-side: A=1, C=2, G=4, T=8, anything else (incl. N)=16.
  Reference/adapter-side: IUPAC code expanded to its ACGT mask; a literal
  ``N`` additionally carries bit 16 so that reference-N matches read-N
  (an adapter N matches *any* read character). Two characters match iff
  ``(ref_mask & read_mask) != 0``.

This mirrors the comparison semantics of the reference pipeline's demux
stage (cutadapt ``-e 0.1 -g file:...``, the reference pipeline's
scripts/02_cutadapt_loop.sh:64-72): adapter wildcards enabled, read
wildcards disabled.

All functions are pure NumPy on the host side; device code consumes the
resulting fixed-shape uint8 arrays.

Copy of ``tpu_orc/io/encode.py`` without what no port module calls: the
2-bit upload format (``codes_matrix``, ``pack_codes_2bit``), the matrix
transforms that ``demux.materialize_batch``'s gathers replace
(``revcomp_matrix``, ``reverse_matrix``, ``shift_left_matrix``) and
``length_buckets``. The port adds :func:`bucket_len`, the padded length
of a read batch in stages 01 and 02.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Lookup tables (built once at import time)
# ---------------------------------------------------------------------------

A, C, G, T, OTHER = 0, 1, 2, 3, 4

_IUPAC_TO_ACGT_MASK = {
    "A": 0b0001, "C": 0b0010, "G": 0b0100, "T": 0b1000, "U": 0b1000,
    "R": 0b0101, "Y": 0b1010, "S": 0b0110, "W": 0b1001,
    "K": 0b1100, "M": 0b0011,
    "B": 0b1110, "D": 0b1101, "H": 0b1011, "V": 0b0111,
    "N": 0b1111,
}

_COMPLEMENT = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N",
}

N_MATCH_BIT = 0b10000  # bit 4: the "non-ACGT" read-character class


def _build_tables():
    code = np.full(256, OTHER, dtype=np.uint8)
    read_mask = np.full(256, N_MATCH_BIT, dtype=np.uint8)
    ref_mask = np.zeros(256, dtype=np.uint8)
    comp = np.arange(256, dtype=np.uint8)  # identity for unknown bytes
    for ch, m in _IUPAC_TO_ACGT_MASK.items():
        for c in (ch, ch.lower()):
            b = ord(c)
            ref_mask[b] = m | (N_MATCH_BIT if ch == "N" else 0)
    for ch, base in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
        for c in (ch, ch.lower()):
            code[ord(c)] = base
            read_mask[ord(c)] = 1 << base
    for ch, cc in _COMPLEMENT.items():
        comp[ord(ch)] = ord(cc)
        comp[ord(ch.lower())] = ord(cc)  # normalize to upper on complement
    return code, read_mask, ref_mask, comp


_CODE_TAB, _READ_MASK_TAB, _REF_MASK_TAB, _COMP_TAB = _build_tables()

# code -> read match mask (A..T -> 1,2,4,8 ; OTHER -> 16)
CODE_TO_READ_MASK = np.array([1, 2, 4, 8, N_MATCH_BIT], dtype=np.uint8)


def _as_bytes(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8)


def encode_codes(seq) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0..4}."""
    return _CODE_TAB[_as_bytes(seq)]


def encode_read_masks(seq) -> np.ndarray:
    """ASCII read -> uint8 match masks (literal; non-ACGT -> N class bit)."""
    return _READ_MASK_TAB[_as_bytes(seq)]


def revcomp_read_masks(masks: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse-complement packed match-mask rows [B, L] (vectorized host
    equivalent of align.batched.revcomp_masks_device)."""
    m = masks.astype(np.int32)
    comp = (((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1)
            | ((m & 4) >> 1) | (m & 16))
    out = np.zeros_like(masks)
    L = masks.shape[1]
    for i, n in enumerate(np.asarray(lens)):
        out[i, :n] = comp[i, :n][::-1]
    return out


def encode_read_masks_iupac(seq) -> np.ndarray:
    """ASCII read -> IUPAC-expanded masks (cutadapt --match-read-wildcards:
    wildcards in the *read* also match)."""
    return _REF_MASK_TAB[_as_bytes(seq)]


def mask_table(encoder):
    """The 256 byte-to-mask entries behind ``encoder``: ``_READ_MASK_TAB``
    for :func:`encode_read_masks`, ``_REF_MASK_TAB`` for
    :func:`encode_read_masks_iupac`; None for any other encoder (a batch
    of it is packed read by read)."""
    if encoder is encode_read_masks:
        return _READ_MASK_TAB
    if encoder is encode_read_masks_iupac:
        return _REF_MASK_TAB
    return None


def encode_ref_masks(seq) -> np.ndarray:
    """ASCII adapter/primer -> uint8 IUPAC match masks (wildcards expanded)."""
    return _REF_MASK_TAB[_as_bytes(seq)]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string ('N' for OTHER)."""
    return bytes(np.array([65, 67, 71, 84, 78], dtype=np.uint8)[codes]).decode()


def revcomp(seq: str) -> str:
    """IUPAC-aware reverse complement (superset of the reference's
    ``compl_reverse``, amplicon_sorter.py:237-242, which handles RYKMSW)."""
    b = _as_bytes(seq)
    return bytes(_COMP_TAB[b][::-1]).decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


#: the padded lengths of a read batch, finer in the amplicon range
LEN_CAPS = (128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096, 8192)


def bucket_len(n: int) -> int:
    """The padded length L of a read batch whose longest read has ``n``
    bases: the least of :data:`LEN_CAPS` that holds it, past 8,192 the
    next multiple of 8,192. The locate kernels scan every one of the L
    columns, so the steps are fine where COI amplicons fall (300-900 bp
    with adapters: 384 scans a quarter fewer columns than 512 on ~380 bp
    reads); few distinct L keep the launch shapes, and the
    ``locate.launches/.../L<L>`` counters, few."""
    for cap in LEN_CAPS:
        if n <= cap:
            return cap
    return pad_to(n, 8192)


def pack_batch(seqs, max_len: int | None = None, pad_multiple: int = 128,
               encoder=encode_codes, pad_value: int = 4):
    """Pack variable-length sequences into a fixed [B, L] uint8 array.

    Returns (array [B, L], lengths [B] int32). Sequences longer than
    ``max_len`` are truncated (callers should length-bucket first).
    L is rounded up to ``pad_multiple`` for TPU lane alignment.
    """
    enc = [encoder(s) for s in seqs]
    lens = np.array([len(e) for e in enc], dtype=np.int32)
    L = int(lens.max()) if max_len is None else max_len
    L = max(L, 1)
    L = pad_to(L, pad_multiple)
    out = np.full((len(enc), L), pad_value, dtype=np.uint8)
    for i, e in enumerate(enc):
        n = min(len(e), L)
        out[i, :n] = e[:n]
        lens[i] = n
    return out, lens


def ascii_matrix(seqs, max_len: int | None = None, pad_multiple: int = 1,
                 pad_value: int = 0):
    """Pack ASCII sequences into a fixed [B, L] uint8 byte matrix without
    per-read Python loops (one join + one vectorized gather).

    Returns (bytes [B, L] uint8, lengths [B] int32). The demux hot path
    (8192-read batches) was spending ~0.2 s/batch in per-read packing +
    string slicing; this is the vectorized replacement (BENCH.md debt).
    """
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=B) \
        if B else np.zeros(0, np.int64)
    L = int(lens.max()) if (max_len is None and B) else (max_len or 1)
    L = pad_to(max(L, 1), pad_multiple)
    if B == 0:
        return np.zeros((0, L), np.uint8), np.zeros(0, np.int32)
    # per-row frombuffer+copy beats a [B, L] int64 index gather ~6x
    # (memcpy vs 1M-element fancy indexing; measured r5)
    out = np.full((B, L), np.uint8(pad_value))
    for i, s in enumerate(seqs):
        b = s.encode("ascii") if isinstance(s, str) else bytes(s)
        n = min(len(b), L)
        out[i, :n] = np.frombuffer(b, np.uint8, count=n)
    return out, np.minimum(lens, L).astype(np.int32)


def read_masks_matrix(ascii_mat: np.ndarray, lens: np.ndarray,
                      pad_value: int = 0) -> np.ndarray:
    """[B, L] ASCII bytes -> read match masks, vectorized; padding -> 0."""
    m = _READ_MASK_TAB[ascii_mat]
    valid = np.arange(ascii_mat.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(valid, m, np.uint8(pad_value))


def iupac_masks_matrix(ascii_mat: np.ndarray, lens: np.ndarray,
                       pad_value: int = 0) -> np.ndarray:
    """[B, L] ASCII bytes -> IUPAC-expanded read masks (vectorized
    equivalent of encode_read_masks_iupac per row; cutadapt
    --match-read-wildcards); padding -> 0."""
    m = _REF_MASK_TAB[ascii_mat]
    valid = np.arange(ascii_mat.shape[1])[None, :] < np.asarray(lens)[:, None]
    return np.where(valid, m, np.uint8(pad_value))
