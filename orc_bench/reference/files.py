"""Reading back what the program wrote: FASTQ and FASTA files, gzipped
or not, parsed here and not by the program's reader."""
from __future__ import annotations

import gzip
from typing import Callable, Dict, Iterator, Optional, Tuple


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def fastq(path: str, keep: Optional[Callable[[str], bool]] = None
          ) -> Iterator[Tuple[str, str, str]]:
    """(header without '@', sequence, quality) of each record whose read
    id (the header up to its first space) passes ``keep``."""
    with _open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            s = fh.readline()
            fh.readline()
            q = fh.readline()
            desc = h[1:].rstrip("\n")
            if keep is None or keep(desc.split(" ", 1)[0]):
                yield desc, s.rstrip("\n"), q.rstrip("\n")


def fasta(path: str) -> Dict[str, str]:
    """{header without '>': sequence} of a FASTA file."""
    out: Dict[str, str] = {}
    name, seq = None, []
    with _open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if ln.startswith(">"):
                if name is not None:
                    out[name] = "".join(seq)
                name, seq = ln[1:], []
            elif ln:
                seq.append(ln)
    if name is not None:
        out[name] = "".join(seq)
    return out
