"""Stage 01's segment records as FASTQ bytes, emitted on the block's device
from its cut plan.

``tpu_orc`` builds a ``Record`` for every segment (``_make_segment``: a
slice of the read's sequence and quality, ``encode.revcomp`` for a '-'
configuration) and one f-string a record when the files are written.
Here a block's records are rows of a table over one byte buffer
(:func:`pack_segments`), and :func:`emit_fastq` writes each record's
FASTQ text at its offset; the device of its tensors picks the version:

* a CPU tensor goes to :func:`emit_plain`, a plain host version
  (one ``bytes`` slice a field, ``bytes.translate`` and a reversal for a
  '-' record, one join);
* a CUDA tensor to :func:`emit_cuda`, the hand-written kernel of
  ``csrc/emit.cu``.

:class:`Emitter` joins a block's reads, uploads them and their table
once, emits and brings the bytes back in one copy into a pinned host
buffer that the next block reuses. Both versions give the bytes of
``io/fastq.py::format_records`` over the records ``tpu_orc`` builds.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..io import encode
from ..utils.profiling import count

#: launches of ``orc_emit_fastq`` (csrc/emit.cu)
LAUNCHES = _build.LaunchCounter(("emit",))

#: the columns of a record's row in the table
SEQ_OFF, SEQ_LEN, QUAL_OFF, QUAL_LEN, NAME_OFF, NAME_LEN, SEG = range(7)
NCOL = 7


def header_lens(name_len: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Bytes of each record's header line: '@', the name, "|seg" and the
    decimal ``seg_no`` where it is above 0, '\\n'."""
    seg_no = seg >> 1
    digits = np.ones_like(seg_no)
    for k in range(1, 19):
        digits += seg_no >= 10 ** k
    return 2 + name_len + np.where(seg_no > 0, 4 + digits, 0)


def record_offsets(recs: np.ndarray) -> np.ndarray:
    """[R + 1] int64: where each record of the table starts in the output,
    and the output's length last."""
    lens = (header_lens(recs[:, NAME_LEN], recs[:, SEG]) + recs[:, SEQ_LEN]
            + 3 + recs[:, QUAL_LEN] + 1)
    offs = np.zeros(len(recs) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs


def emit_plain(data: torch.Tensor, recs: torch.Tensor, offs: torch.Tensor,
               tab: np.ndarray) -> torch.Tensor:
    """The records' FASTQ text on the host, on CPU tensors: each field a
    ``bytes`` slice of ``data``, a '-' record's sequence translated
    through the table and reversed and its quality reversed, joined.
    [offs[R]] uint8."""
    d = data.numpy().tobytes()
    comp = bytes(tab)
    parts = []
    for so, sl, qo, ql, no, nl, sg in recs.numpy().tolist():
        s, q = d[so:so + sl], d[qo:qo + ql]
        if sg & 1:
            s, q = s.translate(comp)[::-1], q[::-1]
        name = d[no:no + nl] + (b"|seg%d" % (sg >> 1) if sg >> 1 else b"")
        parts += (b"@", name, b"\n", s, b"\n+\n", q, b"\n")
    return _tensor(bytearray().join(parts))


def _lib():
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    return _build.load("emit", "orc_emit_fastq",
                       [vp, i64, vp, vp, i64, vp, vp, vp]).orc_emit_fastq


def emit_cuda(data: torch.Tensor, recs: torch.Tensor, offs: torch.Tensor,
              tab: np.ndarray, total: int) -> torch.Tensor:
    """Launch ``orc_emit_fastq`` of ``csrc/emit.cu`` on the current stream;
    same contract and output as :func:`emit_plain`. ``total`` is
    ``offs[R]``, known to the caller, who checked the inputs on the host
    before uploading them."""
    R = recs.shape[0]
    out = torch.empty(total, dtype=torch.uint8, device=data.device)
    if R == 0:
        return out                            # nothing to launch
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(data.data_ptr(), data.shape[0], recs.data_ptr(),
                     offs.data_ptr(), R, tab.ctypes.data, out.data_ptr(),
                     stream)
    _build.check(err, "emit kernel")
    LAUNCHES.add("emit", data.device)
    count("reorient.device_emits")
    return out


def emit_fastq(data: torch.Tensor, recs: torch.Tensor, offs: torch.Tensor,
               tab, total: Optional[int] = None) -> torch.Tensor:
    """``out[offs[r]:offs[r + 1]]`` = record r's FASTQ text:
    ``@name[|seg<n>]\\nseq\\n+\\nqual\\n``, with seq and qual the slices
    ``data[off:off + len]`` of the row's columns, the sequence reversed
    through ``tab`` and the quality reversed where the row's ``SEG`` is
    odd, and "|seg<n>" for ``n = SEG >> 1`` above 0.

    data [N] uint8; recs [R, 7] int64, the rows of :func:`pack_segments`;
    offs [R + 1] int64, :func:`record_offsets` of the rows (checked here
    for CPU tensors, with every slice inside data; the caller checks them
    on the host before it uploads CUDA ones and passes ``total``); tab:
    256 bytes (``encode._COMP_TAB``). A CPU tensor goes to the plain
    version, a CUDA tensor to the kernel."""
    tab = np.ascontiguousarray(tab, np.uint8)
    if tab.shape != (256,):
        raise ValueError("tab must hold 256 bytes")
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError("data must be [N] uint8")
    if recs.dim() != 2 or recs.shape[1] != NCOL or recs.dtype != torch.int64:
        raise ValueError(f"recs must be [R, {NCOL}] int64")
    R = recs.shape[0]
    if offs.shape != (R + 1,) or offs.dtype != torch.int64:
        raise ValueError("offs must be [R + 1] int64")
    if recs.device != data.device or offs.device != data.device:
        raise ValueError("emit inputs lie on more than one device")
    if data.device.type == "cpu":
        check_table(recs.numpy(), data.shape[0])
        if not np.array_equal(offs.numpy(), record_offsets(recs.numpy())):
            raise ValueError("offs are not the records' offsets")
        return emit_plain(data, recs, offs, tab)
    if data.device.type != "cuda":
        raise ValueError(f"no emit kernel for device {data.device}")
    if total is None:
        raise ValueError("the kernel needs the output's length")
    if not all(t.is_contiguous() for t in (data, recs, offs)):
        raise ValueError("emit kernel inputs must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("the kernel's data must be 16-byte aligned")
    return emit_cuda(data, recs, offs, tab, total)


def check_table(recs: np.ndarray, n: int) -> None:
    """Raise unless every slice of the rows lies inside ``n`` bytes and
    ``SEG`` is not negative."""
    if not len(recs):
        return
    for off, ln in ((SEQ_OFF, SEQ_LEN), (QUAL_OFF, QUAL_LEN),
                    (NAME_OFF, NAME_LEN)):
        if (recs[:, off].min() < 0 or recs[:, ln].min() < 0
                or (recs[:, off] + recs[:, ln]).max() > n):
            raise ValueError("a slice lies outside data")
    if recs[:, SEG].min() < 0:
        raise ValueError("a negative segment number")


def _ascii(strs: Sequence[str]) -> bytes:
    return "".join(strs).encode("ascii")


def _tensor(buf: bytearray) -> torch.Tensor:
    return (torch.frombuffer(buf, dtype=torch.uint8) if buf
            else torch.zeros(0, dtype=torch.uint8))


def pack_segments(seqs: Sequence[str], quals: Sequence[Optional[str]],
                  ids: Sequence[str], read: np.ndarray, s0: np.ndarray,
                  s1: np.ndarray, neg: np.ndarray, seg_no: np.ndarray):
    """(data chunks, recs [R, 7] int64) of R segment records over reads
    ``seqs`` (ASCII; the slices' source, as scanned), their qualities
    (None or '' where a read has none) and ids: record k is
    ``seqs[read[k]][s0[k]:s1[k]]`` (0 <= s0 <= s1 <= the read's length),
    its quality the same slice of the read's quality (cut to that
    quality's length), reverse-complemented where ``neg``, named
    ``ids[read[k]]`` with "|seg<n>" for ``seg_no`` n above 0. ``data
    chunks`` are the bytes of the buffer the rows index, in order: the
    reads' sequences, their qualities and their ids, each joined once."""
    n = len(seqs)
    slen = np.fromiter(map(len, seqs), np.int64, n)
    qlen = np.fromiter((len(q) if q else 0 for q in quals), np.int64, n)
    seq_b = _ascii(seqs)
    qual_b = _ascii([q or "" for q in quals])
    id_s = "".join(ids)
    if id_s.isascii():
        id_b = id_s.encode("ascii")
        nlen = np.fromiter(map(len, ids), np.int64, n)
    else:
        enc = [i.encode("utf-8") for i in ids]
        id_b = b"".join(enc)
        nlen = np.fromiter(map(len, enc), np.int64, n)
    # where each read's sequence, quality and id start in the buffer
    base = np.zeros((3, n), np.int64)
    for row, lens, start in ((0, slen, 0), (1, qlen, len(seq_b)),
                             (2, nlen, len(seq_b) + len(qual_b))):
        base[row, 0] = start
        base[row, 1:] = start + np.cumsum(lens[:-1])
    read = np.asarray(read, np.int64)
    s0 = np.asarray(s0, np.int64)
    s1 = np.asarray(s1, np.int64)
    q0 = np.minimum(s0, qlen[read])
    q1 = np.minimum(s1, qlen[read])
    recs = np.empty((len(read), NCOL), np.int64)
    recs[:, SEQ_OFF] = base[0, read] + s0
    recs[:, SEQ_LEN] = s1 - s0
    recs[:, QUAL_OFF] = base[1, read] + q0
    recs[:, QUAL_LEN] = q1 - q0
    recs[:, NAME_OFF] = base[2, read]
    recs[:, NAME_LEN] = nlen[read]
    recs[:, SEG] = np.asarray(seg_no, np.int64) * 2 + np.asarray(neg, bool)
    return (seq_b, qual_b, id_b), recs


class Emitter:
    """Emits segment records on one device (:meth:`__call__`). On CUDA it
    owns the pinned host buffers that a call's uploads and download go
    through, grown as a block needs and reused by the next call; one
    caller at a time (stage 01's stream)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned: Dict[str, torch.Tensor] = {}

    def _buffer(self, kind: str, n: int) -> torch.Tensor:
        buf = self._pinned.get(kind)
        if buf is None or buf.shape[0] < n:
            buf = torch.empty(max(n + n // 4, 1 << 20), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[kind] = buf
        return buf[:n]

    def __call__(self, seqs: Sequence[str], quals: Sequence[Optional[str]],
                 ids: Sequence[str], read, s0, s1, neg, seg_no) -> tuple:
        """(out, offs): the FASTQ bytes of the segment records of
        :func:`pack_segments`, in order (uint8 [total]), and where each
        record starts in them (int64 [R + 1], ``total`` last). On CUDA
        the buffer and the rows go up in two copies, the kernel runs, and
        one copy brings the bytes into a pinned host buffer; ``out`` is
        a view of that buffer, valid until the next call."""
        device = self.device
        chunks, recs = pack_segments(seqs, quals, ids, read, s0, s1, neg,
                                     seg_no)
        offs = record_offsets(recs)
        total = int(offs[-1])
        count("reorient.emit_records", len(recs))
        tab = encode._COMP_TAB
        if device.type == "cpu":
            return emit_fastq(_tensor(bytearray().join(chunks)),
                              torch.from_numpy(recs), torch.from_numpy(offs),
                              tab).numpy(), offs
        if device.type != "cuda":
            raise ValueError(f"no emit route for device {device}")
        n = sum(map(len, chunks))
        check_table(recs, n)
        meta = np.concatenate([recs.ravel(), offs])
        with torch.cuda.device(device):
            # the bytes, then the rows and offsets, staged in one pinned
            # buffer and uploaded in two copies; on the card the rows
            # start at a multiple of 16
            host = self._buffer("in", n + meta.nbytes)
            h, put = host.numpy(), 0
            for c in (*chunks, meta.view(np.uint8)):
                h[put:put + len(c)] = np.frombuffer(c, np.uint8)
                put += len(c)
            pad = -n % 16
            dev = torch.empty(n + pad + meta.nbytes, dtype=torch.uint8,
                              device=device)
            dev[:n].copy_(host[:n], non_blocking=True)
            dev[n + pad:].copy_(host[n:], non_blocking=True)
            m = dev[n + pad:].view(torch.int64)
            out = emit_fastq(dev[:n], m[:recs.size].view(-1, NCOL),
                             m[recs.size:], tab, total)
            back = self._buffer("out", total)
            back.copy_(out, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        count("reorient.emit_h2d_bytes", n + meta.nbytes)
        count("reorient.emit_d2h_bytes", total)
        return back.numpy(), offs
