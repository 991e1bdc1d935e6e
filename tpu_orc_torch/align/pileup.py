"""Star-alignment path bits for the consensus pileup: CUDA kernel and its
plain PyTorch version.

Port of ``tpu_orc/align/pallas_pileup.py``: ``_bucket`` (:112),
``path_bits`` (:265) and ``path_bits_groups`` (:217). :func:`pileup_bits`
takes the place of the two Pallas launches (one draft :92, many groups
:209) and dispatches by the device of its tensors:

* a CPU tensor goes to :func:`path_bits_plain`, the word-parallel Myers
  recurrence over a batch of reads in int64 words with 32-bit masks,
  walked as a wavefront over (read position, draft word);
* a CUDA tensor goes to :func:`path_bits_cuda`, the hand-written kernel
  in ``csrc/pileup.cu`` (one warp per read, walking the same wavefront
  with the draft words spread over the lanes), or the wrapper raises.

The planes are bit-identical to the Pallas kernels on the region the host
traceback (``native.pileup_from_bits``) reads: read positions below the
read's length and words below ``ceil(len(draft) / 32)``. The uint32 bits
travel in ``torch.int32`` tensors and reach the host as numpy uint32
views. The Pallas ``_pick_nc`` (a VMEM budget) has no counterpart.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from .. import _build
from .myers import (MAX_WORDS, NCHAN, WORD, build_peq_packed,
                    check_codes, check_peq)

TR = 8  # reads per tile of one group (csrc/pileup.cu); groups pad to it

#: kernel launches by contract (csrc/pileup.cu): "single" for one draft
#: (Pallas _kernel), "multi" for many groups (Pallas _kernel_multi);
#: counted by path_bits_cuda
LAUNCHES = _build.LaunchCounter(("single", "multi"))

_M32 = 0xFFFFFFFF


def _bucket(n: int, caps=(128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    for c in caps:
        if n <= c:
            return c
    return -(-n // 8192) * 8192


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def path_bits_plain(peqs, dwords, tile_gid, texts_T, n_lens):
    """Plain version of :func:`pileup_bits`: planes [T, N, 4, W] int32.

    Computes every draft word (words above a draft's own ``dwords`` have
    zero Peq, as in the Pallas kernels) for read positions below the
    longest read (past a read's end its pad code 5 matches nothing, as in
    the Pallas kernels); positions from the longest read on are zero.
    ``dwords`` is not read.

    Word ``w`` of column ``j`` needs word ``w`` of column ``j - 1`` and
    word ``w - 1`` of column ``j``, so step ``s`` of a wavefront updates
    every word ``w`` at once, at column ``s - w``. A word whose column is
    still below 0 sees a zero Peq word and a zero carry, which leave its
    initial state (VP all ones, VN 0) as it is and carry 0 out; what a
    word computes past the last column is never read."""
    del dwords
    dev = peqs.device
    i64 = torch.int64
    G, W8 = peqs.shape
    W = W8 // NCHAN
    N, T = texts_T.shape
    ncols = min(N, int(n_lens.max())) if T else 0
    planes = torch.empty((T, N, 4, W), dtype=torch.int32, device=dev)
    planes[:, ncols:] = 0
    if ncols == 0:
        return planes
    gid = tile_gid.to(i64).repeat_interleave(TR)                  # [T]
    peq = (peqs.view(G, W, NCHAN).to(i64) & _M32)[gid]           # [T, W, 8]
    S = ncols + W - 1
    # eq[s, t, w]: Peq word w of read t's draft at the code of column s - w
    jj = torch.arange(S, device=dev)[:, None] - torch.arange(W, device=dev)
    live = (jj >= 0) & (jj < ncols)                               # [S, W]
    codes = texts_T[:ncols].to(i64)                               # [ncols, T]
    cod = torch.where(live[:, :, None], codes[jj.clamp(0, ncols - 1)],
                      5).permute(0, 2, 1)                         # [S, T, W]
    eqs = peq.expand(S, T, W, NCHAN).gather(3, cod[..., None]).unbind(0)
    # out[s] holds the planes (VP, VN, PH, MH) of step s; its VP/VN are
    # the state that step s + 1 reads. out[S] (= out[-1], read by step 0)
    # is the initial state.
    out = torch.empty((S + 1, 4, T, W), dtype=i64, device=dev)
    out[S] = 0
    out[S, 0] = _M32
    vps, vns, phs, mhs = (out[:, p].unbind(0) for p in range(4))
    pms = out[:, 2:].unbind(0)
    # carries (PH, MH), double-buffered: h[:, :, w + 1] is the carry out
    # of word w at the previous step; column 0 is the +1 delta into word
    # 0 (NW)
    hs = torch.zeros((2, 2, T, W + 1), dtype=i64, device=dev)
    hs[:, 0, :, 0] = 1
    hins = [h[:, :, :W] for h in hs]
    hms = [h[1] for h in hins]
    houts = [h[:, :, 1:] for h in hs]
    for s in range(S):
        e, pv, mv = eqs[s][..., 0], vps[s - 1], vns[s - 1]
        hin, hout = hins[s % 2], houts[1 - s % 2]
        xv = e | mv
        e2 = e | hms[s % 2]
        xh = e2 & pv
        xh += pv
        xh &= _M32
        xh ^= pv
        xh |= e2
        ph = torch.bitwise_or(xh, pv, out=phs[s])  # PH = MV | ~(XH | PV)
        ph ^= _M32
        ph |= mv
        torch.bitwise_and(pv, xh, out=mhs[s])      # MH = PV & XH
        torch.bitwise_right_shift(pms[s], 31, out=hout)
        sh = pms[s] << 1                           # PH, MH shifted in
        sh &= _M32
        sh |= hin
        shp = sh[0]
        torch.bitwise_and(shp, xv, out=vns[s])     # VN = PH & XV
        xv |= shp
        xv ^= _M32
        torch.bitwise_or(sh[1], xv, out=vps[s])    # VP = MH | ~(XV | PH)
    # uint32 bits -> the int32 of the same bits, exactly
    out ^= 1 << 31
    out -= 1 << 31
    out = out.to(torch.int32)
    # planes[t, j, p, w] = out[j + w, p, t, w]: a strided view of out
    planes[:, :ncols] = out.as_strided(
        (ncols, 4, T, W), (4 * T * W, T * W, W, 4 * T * W + 1)).permute(
            2, 0, 1, 3)
    return planes


def specified(dwords, tile_gid, n_lens, N: int, W: int):
    """The region of :func:`pileup_bits`' output that its contract fixes
    (and the host traceback reads): bool [T, N, 1, W], true at read
    positions below the read's length and words below its draft's
    ``dwords``."""
    dev = n_lens.device
    nw = dwords.to(torch.int64)[tile_gid.to(torch.int64).repeat_interleave(
        TR)]
    pos = torch.arange(N, device=dev)[None, :, None, None]
    word = torch.arange(W, device=dev)[None, None, None, :]
    return ((pos < n_lens.to(torch.int64)[:, None, None, None])
            & (word < nw[:, None, None, None]))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("pileup", "orc_pileup",
                       [vp] * 5 + [ci] * 3 + [vp, vp])


def path_bits_cuda(peqs, dwords, tile_gid, texts_T, n_lens):
    """Launch ``csrc/pileup.cu`` on the current stream. Same contract as
    :func:`path_bits_plain` on the specified region; the rest of the
    output is left unwritten."""
    G, W8 = peqs.shape
    W = W8 // NCHAN
    N, T = texts_T.shape
    planes = torch.empty((T, N, 4, W), dtype=torch.int32, device=peqs.device)
    if T == 0 or N == 0:
        return planes                         # nothing to launch
    with torch.cuda.device(peqs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().orc_pileup(
            peqs.data_ptr(), dwords.data_ptr(), tile_gid.data_ptr(),
            texts_T.data_ptr(), n_lens.data_ptr(), T, N, W,
            planes.data_ptr(), stream)
    _build.check(err, "pileup kernel")
    LAUNCHES.add("single" if G == 1 else "multi", peqs.device)
    return planes


def pileup_bits(peqs, dwords, tile_gid, texts_T, n_lens):
    """Myers NW path bit-planes of every read against its group's draft:
    planes [T, N, 4, W] int32 (uint32 bits), per read and read position
    VP, VN (after the update), PH, MH (before the shift) over the draft
    words.

    peqs [G, W*NCHAN] int32 (:func:`build_peq_packed` at the widest
    draft's W), dwords [G] int32 (each draft's ceil(len / 32)), tile_gid
    [T / TR] int32 (the group of each tile of TR reads), texts_T [N, T]
    uint8 codes 0..4 (5 = pad), n_lens [T] int32. A CPU tensor goes to
    :func:`path_bits_plain`; a CUDA tensor to the kernel. A Peq or codes
    that ``myers.check_peq`` or ``myers.check_codes`` reject raise: CPU
    tensors are checked here; for CUDA tensors :func:`_upload` checks the
    codes on the host and builds the Peq valid."""
    if peqs.dim() != 2 or peqs.dtype != torch.int32 or peqs.shape[1] % NCHAN:
        raise ValueError("peqs must be [G, W*8] int32")
    G, W = peqs.shape[0], peqs.shape[1] // NCHAN
    if texts_T.dim() != 2 or texts_T.dtype != torch.uint8:
        raise ValueError("texts_T must be [N, T] uint8")
    T = texts_T.shape[1]
    if (T % TR or tile_gid.shape != (T // TR,) or n_lens.shape != (T,)
            or dwords.shape != (G,)):
        raise ValueError("dwords [G] / tile_gid [T/TR] / n_lens [T] shape "
                         "mismatch")
    ts = [peqs, dwords, tile_gid, texts_T, n_lens]
    if any(t.dtype != torch.int32 for t in ts if t is not texts_T):
        raise ValueError("pileup index tensors must be int32")
    if any(t.device != peqs.device for t in ts):
        raise ValueError("pileup inputs lie on more than one device")
    if W == 0 or W > MAX_WORDS:
        raise ValueError(f"draft width must be 1..{MAX_WORDS} words")
    if peqs.device.type == "cpu":
        check_peq(peqs.numpy())
        check_codes(texts_T.numpy())
        return path_bits_plain(*ts)
    if peqs.device.type != "cuda":
        raise ValueError(f"no pileup kernel for device {peqs.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pileup kernel inputs must be contiguous")
    return path_bits_cuda(*ts)


# ---------------------------------------------------------------------------
# host wrappers
# ---------------------------------------------------------------------------

def _upload(drafts_codes, groups_reads, device):
    """The inputs of :func:`pileup_bits` on ``device``: every group padded
    to whole tiles of TR reads (pad reads have length 0), N = the Pallas
    bucket of the longest read. The read codes are checked on the host
    (``myers.check_codes``) for every device. Returns (tensors, first row
    of each group)."""
    drafts = [np.asarray(d, np.uint8) for d in drafts_codes]
    W = max(1, max(-(-len(d) // WORD) for d in drafts))
    peqs = np.stack([build_peq_packed(d[None, :], np.array([len(d)]), W)[0]
                     for d in drafts])                      # [G, W*NCHAN]
    dwords = np.array([-(-len(d) // WORD) for d in drafts], np.int32)
    ntiles = [max(1, -(-len(rs) // TR)) for rs in groups_reads]
    tile_gid = np.repeat(np.arange(len(drafts), dtype=np.int32), ntiles)
    T = int(tile_gid.size) * TR
    N = _bucket(max((len(r) for rs in groups_reads for r in rs), default=1))
    tt = np.full((N, T), 5, np.uint8)
    nl = np.zeros(T, np.int32)
    starts = []
    row = 0
    for rs, nt in zip(groups_reads, ntiles):
        starts.append(row)
        for i, r in enumerate(rs):
            tt[:len(r), row + i] = np.asarray(r, np.uint8)
            nl[row + i] = len(r)
        row += nt * TR
    check_codes(tt)
    dev = torch.device(device)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return ((put(peqs.view(np.int32)), put(dwords), put(tile_gid), put(tt),
             put(nl)), starts)


def path_bits_groups(drafts_codes, groups_reads, device) -> List[np.ndarray]:
    """Path bits of many groups in ONE launch: per group planes
    [Rg, N, 4, W] uint32 (W of the widest draft), ready for
    ``native.pileup_from_bits`` (the traceback reads only words below
    the group's own ceil(len(draft) / 32))."""
    if len(drafts_codes) != len(groups_reads) or not drafts_codes:
        raise ValueError("one draft per group, at least one group")
    tensors, starts = _upload(drafts_codes, groups_reads, device)
    planes = pileup_bits(*tensors).cpu().numpy().view(np.uint32)
    return [planes[s:s + len(rs)] for s, rs in zip(starts, groups_reads)]


def path_bits(draft_codes: np.ndarray, read_codes_list: Sequence[np.ndarray],
              device) -> np.ndarray:
    """Path bits of all reads of one group against its draft: planes
    [R, N, 4, W] uint32 (N >= every read length)."""
    return path_bits_groups([draft_codes], [read_codes_list], device)[0]
