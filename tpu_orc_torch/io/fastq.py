"""FASTQ/FASTA(.gz) streaming reader/writer (host side, no dependencies).

Replaces the reference's reliance on BioPython/dnaio parsing
(amplicon_sorter.py:519-646 ``read_file`` autodetects fasta/fastq/.gz);
same autodetection behavior, plus batch iteration sized for device feeds.

Copy of ``tpu_orc/io/fastq.py``; the port adds :func:`format_records`,
the one place its FASTQ and FASTA text is built (``write_records``,
stage 02's bin writers, stage 01's stream). ``Record`` is this
package's own class: nothing in the port tests ``isinstance`` or class
identity, so records of either package go through it.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional


@dataclass
class Record:
    """One sequencing read. ``qual`` is None for FASTA records."""
    id: str              # header up to first whitespace, without '>'/'@'
    desc: str            # full header line without the leading '>'/'@'
    seq: str
    qual: Optional[str] = None

    def mean_q(self) -> float:
        """Mean Phred quality (arithmetic mean of Q values, matching
        pychopper's -Q mean-quality filter semantics, 01_pychopper.sh:16,51).

        Vectorized: the per-character Python sum was the single biggest
        host cost of the reorient stage (1.4 s per 8192-read batch —
        more than its device time)."""
        if not self.qual:
            return 0.0
        import numpy as np
        q = np.frombuffer(self.qual.encode("ascii"), np.uint8)
        return float(q.mean()) - 33.0


def mean_q_batch(quals) -> "np.ndarray":
    """Mean Phred quality of MANY quality strings in one pass
    (float64 [N]); entries that are None or empty give 0.0, matching
    ``Record.mean_q``. One join + one segmented reduction — the
    per-record numpy mean was ~0.14 s per 8192-read reorient batch
    (8192 tiny-array dispatches), this is ~5 ms.
    """
    import numpy as np
    n = len(quals)
    out = np.zeros(n, np.float64)
    if n == 0:
        return out
    lens = np.fromiter((len(q) if q else 0 for q in quals), np.int64, n)
    total = int(lens.sum())
    if total == 0:
        return out
    buf = np.frombuffer(
        b"".join(q.encode("ascii") for q in quals if q), np.uint8)
    offs = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    # reduceat quirk: a zero-length segment returns buf[offs[i]] and an
    # offset == len(buf) is out of range — clamp, then overwrite the
    # empty rows below
    sums = np.add.reduceat(buf.astype(np.int64),
                           np.minimum(offs, total - 1))
    nz = lens > 0
    out[nz] = sums[nz] / lens[nz] - 33.0
    return out


def _open(path, mode="rt"):
    if str(path).endswith(".gz"):
        if "w" in mode:
            # level 2 ~3x faster than the gzip default (9) on the
            # 2-core host; output CONTENT is the contract, compression
            # ratio is not (02_cutadapt_loop.sh just pipes through gz)
            return gzip.open(path, mode, compresslevel=2)
        return gzip.open(path, mode)
    return open(path, mode)


def sniff_format(path) -> str:
    """Return 'fastq' or 'fasta' by first byte (reference autodetects the
    same way, amplicon_sorter.py:528-546)."""
    with _open(path) as fh:
        first = fh.read(1)
    if first == "@":
        return "fastq"
    if first == ">":
        return "fasta"
    raise ValueError(f"{path}: not FASTA/FASTQ (first char {first!r})")


def read_records(path) -> Iterator[Record]:
    fmt = sniff_format(path)
    if fmt == "fastq":
        yield from read_fastq(path)
    else:
        yield from read_fasta(path)


def read_fastq(path) -> Iterator[Record]:
    with _open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            h = h.rstrip("\n")
            if not h:
                continue
            if not h.startswith("@"):
                raise ValueError(f"{path}: bad FASTQ header {h!r}")
            seq = fh.readline().rstrip("\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                raise ValueError(f"{path}: bad FASTQ separator after {h!r}")
            qual = fh.readline().rstrip("\n")
            desc = h[1:]
            yield Record(desc.split()[0] if desc else "", desc, seq, qual)


def read_fasta(path) -> Iterator[Record]:
    with _open(path) as fh:
        desc = None
        chunks: List[str] = []
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if desc is not None:
                    seq = "".join(chunks)
                    yield Record(desc.split()[0] if desc else "", desc, seq)
                desc = line[1:].strip()
                chunks = []
            elif line:
                chunks.append(line.strip())
        if desc is not None:
            yield Record(desc.split()[0] if desc else "", desc, "".join(chunks))


def write_records(path, records: Iterable[Record], fmt: Optional[str] = None):
    """Write records as FASTQ if they have qualities (unless fmt forces)."""
    records = list(records)
    if fmt is None:
        fmt = "fastq" if (records and records[0].qual is not None) else "fasta"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "wt") as fh:
        # one buffered write per file: per-record writes through the
        # gzip text wrapper were a measurable host term at 96 bins
        fh.write(format_records(records, fmt))


def format_records(records: Iterable[Record], fmt: str) -> str:
    """The text of ``records``: FASTQ for ``fmt`` 'fastq' (a record
    without qualities gets an empty quality line), FASTA otherwise."""
    if fmt == "fastq":
        return "".join(f"@{r.desc}\n{r.seq}\n+\n{r.qual or ''}\n"
                       for r in records)
    return "".join(f">{r.desc}\n{r.seq}\n" for r in records)


def iter_batches(records: Iterable[Record], batch_size: int) -> Iterator[List[Record]]:
    batch: List[Record] = []
    for r in records:
        batch.append(r)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
