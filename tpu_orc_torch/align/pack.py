"""A locate batch's read match masks, packed on the batch's device in the
[L, B] layout that :func:`align.locate.locate_tiles` takes.

``tpu_orc`` packs every batch on the host: ``io/encode.py::ascii_matrix``
(a [B, L] byte matrix), ``read_masks_matrix`` or ``iupac_masks_matrix``
(each byte's match mask, the padding 0) and the transpose to [L, B] in
``pallas_locate.py::locate_dispatch``. :func:`pack_masks_T` computes the
same matrix from the batch's bytes as they are, concatenated, with each
read's offset and length; the device of its tensors picks the version:

* a CPU tensor goes to :func:`pack_masks_plain`, that host packing
  itself (per-row copy, table lookup, padding, transpose);
* a CUDA tensor to :func:`pack_masks_cuda`, the hand-written kernel of
  ``csrc/pack.cu`` (a shared-memory tiled transpose through the table).

:func:`pack_reads_T` joins and encodes a list of reads, uploads their
bytes, offsets and lengths once and packs them there: on CUDA the host
moves each read's bytes once instead of the padded [B, L] matrix three
times. ``demux/demux.py::locate_batch_lazy`` takes this route for a bank
on the locate kernels' route with either standard encoder, on either
device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils.profiling import count
from .locate import MAX_COLUMNS, check_read_lens

#: launches of ``orc_pack_masks_T`` (csrc/pack.cu)
LAUNCHES = _build.LaunchCounter(("pack",))


def pack_masks_plain(data: torch.Tensor, offs: torch.Tensor,
                     lens: torch.Tensor, tab: np.ndarray,
                     L: int) -> torch.Tensor:
    """The host packing as ``tpu_orc`` does it, on CPU tensors: each
    read's bytes copied into a zero [B, L] row, the table looked up
    where a column lies inside its read (``read_masks_matrix``'s
    ``np.where``), then transposed. [L, B] uint8."""
    d, o, n = data.numpy(), offs.numpy(), lens.numpy()
    amat = np.zeros((len(n), L), np.uint8)
    for i in range(len(n)):
        amat[i, :n[i]] = d[o[i]:o[i] + n[i]]
    valid = np.arange(L)[None, :] < n[:, None]
    masks = np.where(valid, tab[amat], np.uint8(0))
    return torch.from_numpy(np.ascontiguousarray(masks.T))


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("pack", "orc_pack_masks_T",
                       [vp, vp, vp, vp, ci, ci, vp, vp]).orc_pack_masks_T


def pack_masks_cuda(data: torch.Tensor, offs: torch.Tensor,
                    lens: torch.Tensor, tab: np.ndarray,
                    L: int) -> torch.Tensor:
    """Launch ``orc_pack_masks_T`` of ``csrc/pack.cu`` on the current
    stream; same contract and output as :func:`pack_masks_plain`. Inputs
    are checked by :func:`pack_masks_T`."""
    B = lens.shape[0]
    out = torch.empty((L, B), dtype=torch.uint8, device=data.device)
    if B == 0:
        return out                            # nothing to launch
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(data.data_ptr(), offs.data_ptr(), lens.data_ptr(),
                     tab.ctypes.data, L, B, out.data_ptr(), stream)
    _build.check(err, "pack kernel")
    LAUNCHES.add("pack", data.device)
    count("locate.device_packs")
    return out


def pack_masks_T(data: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
                 tab, L: int) -> torch.Tensor:
    """``out[l, b] = tab[data[offs[b] + l]]`` for ``l < lens[b]``, 0 from
    ``lens[b]`` to L: the [L, B] uint8 read masks of a batch.

    data [N] uint8, the reads' bytes; offs [B] int64 and lens [B] int32,
    each read's start in data and its length, with 0 <= lens <= L and
    every read inside data (checked here for CPU tensors; the caller
    checks them on the host before it uploads CUDA ones); tab: the 256
    masks of the byte values (``encode.mask_table`` of an encoder). A
    CPU tensor goes to the plain version, a CUDA tensor to the kernel."""
    tab = np.ascontiguousarray(tab, np.uint8)
    if tab.shape != (256,):
        raise ValueError("tab must hold 256 masks")
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError("data must be [N] uint8")
    if lens.dim() != 1 or lens.dtype != torch.int32:
        raise ValueError("lens must be [B] int32")
    B = lens.shape[0]
    if offs.shape != (B,) or offs.dtype != torch.int64:
        raise ValueError("offs must be [B] int64")
    if not 0 < L < MAX_COLUMNS:
        raise ValueError(f"L {L} out of range")
    if offs.device != data.device or lens.device != data.device:
        raise ValueError("pack inputs lie on more than one device")
    if data.device.type == "cpu":
        check_read_lens(lens.numpy(), L)
        if B and (int(offs.min()) < 0
                  or int((offs + lens).max()) > data.shape[0]):
            raise ValueError("a read lies outside data")
        return pack_masks_plain(data, offs, lens, tab, L)
    if data.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {data.device}")
    if not all(t.is_contiguous() for t in (data, offs, lens)):
        raise ValueError("pack kernel inputs must be contiguous")
    return pack_masks_cuda(data, offs, lens, tab, L)


def pack_reads_T(seqs, L: int, tab, device) -> tuple:
    """(reads_T [L, B] uint8, lens [B] int32) of the ASCII reads ``seqs``
    on ``device``, for :func:`align.locate.locate_dispatch_T`.

    The reads are joined and encoded once; their bytes, offsets and
    lengths go to ``device`` as they are (on CUDA: ~3.7 kB a stage-01
    read instead of L bytes) and :func:`pack_masks_T` packs them there.
    Lengths outside [0, L] raise before anything is uploaded."""
    B = len(seqs)
    lens = np.fromiter(map(len, seqs), np.int32, count=B)
    check_read_lens(lens, L)
    offs = np.zeros(B, np.int64)
    np.cumsum(lens[:-1], dtype=np.int64, out=offs[1:])
    buf = bytearray("".join(seqs), "ascii")
    device = torch.device(device)
    host = torch.frombuffer(buf, dtype=torch.uint8) if buf else \
        torch.zeros(0, dtype=torch.uint8)
    data, offs_t, lens_t = (t.to(device) for t in (
        host, torch.from_numpy(offs), torch.from_numpy(lens)))
    if device.type == "cuda":
        count("locate.pack_h2d_bytes", len(buf) + offs.nbytes + lens.nbytes)
    return pack_masks_T(data, offs_t, lens_t, tab, L), lens_t
