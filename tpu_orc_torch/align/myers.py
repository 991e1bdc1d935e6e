"""Myers bit-parallel edit distance (NW/SHW/HW): CUDA kernel and its plain
PyTorch version.

Port of ``tpu_orc/align/pallas_myers.py``: ``build_peq_packed`` (:37),
``tile_shape`` (:377), ``distances_pallas`` (:395, here
:func:`distances`) and ``distances_pallas_pairs`` (:327, here
:func:`distances_pairs`). :func:`myers_tiles` takes the place of the two
Pallas launches (dense grid :164, listed tile pairs :256) and dispatches
by the device of its tensors:

* a CPU tensor goes to :func:`myers_plain`, the word-parallel recurrence
  over [W, P, T] int64 words (two packed 32-bit Peq words per int64);
* a CUDA tensor goes to :func:`myers_cuda`, the hand-written kernel in
  ``csrc/myers.cu``, or the wrapper raises.

Distances and positions are bit-identical to the Pallas kernels: the
word width changes how the DP is cut into words, not its values.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

WORD = 32
NCHAN = 8  # channel stride in the packed Peq (0..4 used, 5..7 zero)
MODES = {"NW": 0, "SHW": 1, "HW": 2}
MAX_WORDS = 512  # csrc/myers.cu instantiations: patterns up to 16384 bp

#: kernel launches per entry point (csrc/myers.cu), counted by myers_cuda
LAUNCHES = _build.LaunchCounter(("dense", "pairs"))


def build_peq_packed(codes: np.ndarray, m_lens: np.ndarray,
                     W: int) -> np.ndarray:
    """codes [P, M] uint8 -> packed Peq [P, W*NCHAN] uint32 (host side)."""
    P, M = codes.shape
    Mp = W * WORD
    c = np.full((P, Mp), 5, np.uint8)
    c[:, :M] = codes[:, :Mp]
    pos = np.arange(Mp)[None, :]
    c = np.where(pos < np.asarray(m_lens)[:, None], c, 5)
    out = np.zeros((P, W * NCHAN), np.uint32)
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))
    for w in range(W):
        blk = c[:, w * WORD:(w + 1) * WORD]
        for ch in range(5):
            out[:, w * NCHAN + ch] = ((blk == ch) * weights).sum(
                axis=1, dtype=np.uint64).astype(np.uint32)
    return out


def tile_shape(W: int, TI: int | None = None, TJ: int | None = None):
    """(patterns, texts) per listed tile of the pairs entry point.

    One tile is 4 x 4 blocks of the CUDA kernel (8 patterns x 32 texts
    each); small tiles keep the gene stage's upper-triangle and length
    gate tight. ``W`` is kept in the signature of the Pallas version,
    whose tile grew and shrank with VMEM; here it does not matter."""
    return (32 if TI is None else TI), (128 if TJ is None else TJ)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _core(peq, mlen, texts, nlen, mode: str):
    """The recurrence on a batch of pair grids.

    peq [G, I, W*NCHAN] int32 (uint32 bits), mlen [G, I], texts
    [G, N, J] codes, nlen [G, J]. Returns (dist, pos) [G, I, J] int32."""
    G, I, W8 = peq.shape
    W = W8 // NCHAN
    _, N, J = texts.shape
    dev = peq.device
    i64 = torch.int64
    p32 = peq.view(G, I, W, NCHAN).to(i64) & 0xFFFFFFFF
    if W % 2:
        p32 = torch.cat([p32, torch.zeros_like(p32[:, :, :1])], dim=2)
    p64 = p32[:, :, 0::2] | (p32[:, :, 1::2] << 32)    # [G, I, W64, 8]
    W64 = p64.shape[2]
    m = mlen.to(i64).view(G, I, 1)
    nl = nlen.to(i64).view(G, 1, J)
    # row m lives in 64-bit word wl at bit r; rows above it never
    # influence it. Tracked only where the 32-bit word (m-1)//32 < W,
    # as in the Pallas kernel.
    track = (m >= 1) & (torch.div(m - 1, WORD, rounding_mode="floor") < W)
    wl = torch.where(track, torch.div(m - 1, 64, rounding_mode="floor"), -1)
    r = torch.where(track, (m - 1) % 64, 0)
    nw = int(wl.max()) + 1 if wl.numel() else 0
    hin0 = 0 if mode == "HW" else 1
    shape = (G, I, J)
    vp = [torch.full(shape, -1, dtype=i64, device=dev) for _ in range(nw)]
    vn = [torch.zeros(shape, dtype=i64, device=dev) for _ in range(nw)]
    score = m.expand(shape).clone()
    best = score.clone()
    bpos = torch.zeros(shape, dtype=i64, device=dev)
    ncols = min(N, int(nl.max())) if nl.numel() else 0
    codes = torch.clamp(texts.to(i64), max=NCHAN - 1)  # pad 5 -> zero chan
    for j in range(ncols if nw else 0):
        c = codes[:, j].view(G, 1, 1, J).expand(G, I, W64, J)
        eq_all = p64.gather(3, c)                      # [G, I, W64, J]
        hp = torch.full(shape, hin0, dtype=i64, device=dev)
        hm = torch.zeros(shape, dtype=i64, device=dev)
        d = torch.zeros(shape, dtype=i64, device=dev)
        for w in range(nw):
            eq = eq_all[:, :, w]
            pv, mv = vp[w], vn[w]
            xv = eq | mv
            e2 = eq | hm
            xh = (((e2 & pv) + pv) ^ pv) | e2
            ph = mv | ~(xh | pv)
            mh = pv & xh
            d = torch.where(wl == w, ((ph >> r) & 1) - ((mh >> r) & 1), d)
            hpo = (ph >> 63) & 1
            hmo = (mh >> 63) & 1
            ph = (ph << 1) | hp
            mh = (mh << 1) | hm
            vp[w] = mh | ~(xv | ph)
            vn[w] = ph & xv
            hp, hm = hpo, hmo
        valid = (j + 1) <= nl
        score = score + torch.where(valid, d, 0)
        if mode != "NW":
            improved = valid & (score < best)
            best = torch.where(improved, score, best)
            bpos = torch.where(improved, j + 1, bpos)
    if mode == "NW":
        return score.to(torch.int32), nl.expand(shape).to(torch.int32)
    return best.to(torch.int32), bpos.to(torch.int32)


def myers_plain(peq, m_lens, texts_T, n_lens, mode: str = "NW",
                tile_i=None, tile_j=None, TI: int = 0, TJ: int = 0):
    """Plain version of both entry points: (dist, pos) [P, T] int32.

    Dense when ``tile_i`` is None; otherwise only the listed
    (tile_i[g], tile_j[g]) blocks of TI x TJ are computed and the rest
    of the output is zero (unspecified by contract)."""
    P = peq.shape[0]
    N, T = texts_T.shape
    if tile_i is None:
        d, p = _core(peq[None], m_lens[None], texts_T[None], n_lens[None],
                     mode)
        return d[0], p[0]
    dev = peq.device
    ti = tile_i.to(torch.int64)
    tj = tile_j.to(torch.int64)
    pi = (ti[:, None] * TI + torch.arange(TI, device=dev)[None])  # [G, TI]
    tjx = (tj[:, None] * TJ + torch.arange(TJ, device=dev)[None])  # [G, TJ]
    d, p = _core(peq[pi], m_lens[pi], texts_T[:, tjx].permute(1, 0, 2),
                 n_lens[tjx], mode)
    dist = torch.zeros((P, T), dtype=torch.int32, device=dev)
    pos = torch.zeros((P, T), dtype=torch.int32, device=dev)
    rows = pi[:, :, None].expand(d.shape)
    cols = tjx[:, None, :].expand(d.shape)
    dist[rows, cols] = d
    pos[rows, cols] = p
    return dist, pos


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("myers", "orc_myers",
                       [vp] * 4 + [ci] * 5 + [vp, vp] + [ci] * 3
                       + [vp, vp, vp])


def myers_cuda(peq, m_lens, texts_T, n_lens, mode: str = "NW",
               tile_i=None, tile_j=None, TI: int = 0, TJ: int = 0):
    """Launch ``csrc/myers.cu`` on the current stream: the dense grid, or
    one grid row per listed tile. Same contract as :func:`myers_plain`
    except that unlisted blocks are left unwritten."""
    P = peq.shape[0]
    N, T = texts_T.shape
    W = peq.shape[1] // NCHAN
    dist = torch.empty((P, T), dtype=torch.int32, device=peq.device)
    pos = torch.empty((P, T), dtype=torch.int32, device=peq.device)
    pairs = tile_i is not None
    G = int(tile_i.shape[0]) if pairs else 0
    if P == 0 or T == 0 or (pairs and G == 0):
        return dist, pos                      # nothing to launch
    with torch.cuda.device(peq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().orc_myers(
            peq.data_ptr(), m_lens.data_ptr(), texts_T.data_ptr(),
            n_lens.data_ptr(), P, T, N, W, MODES[mode],
            tile_i.data_ptr() if pairs else None,
            tile_j.data_ptr() if pairs else None, G, TI, TJ,
            dist.data_ptr(), pos.data_ptr(), stream)
    _build.check(err, f"myers kernel ({'pairs' if pairs else 'dense'})")
    LAUNCHES.add("pairs" if pairs else "dense")
    return dist, pos


def myers_tiles(peq, m_lens, texts_T, n_lens, mode: str = "NW",
                tile_i=None, tile_j=None, TI: int = 0, TJ: int = 0):
    """Edit distance of every pattern against every text, or of the
    listed tiles only; (dist, pos) [P, T] int32.

    peq [P, W*NCHAN] int32 (uint32 bits, :func:`build_peq_packed`),
    m_lens [P] int32, texts_T [N, T] uint8 codes 0..4 (5 = pad), n_lens
    [T] int32, tile_i/tile_j [G] int32 tile coordinates of TI x TJ
    blocks (P % TI == 0 and T % TJ == 0). A CPU tensor goes to
    :func:`myers_plain`; a CUDA tensor to the kernel."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    if peq.dim() != 2 or peq.dtype != torch.int32 or peq.shape[1] % NCHAN:
        raise ValueError("peq must be [P, W*8] int32")
    P = peq.shape[0]
    if texts_T.dim() != 2 or texts_T.dtype != torch.uint8:
        raise ValueError("texts_T must be [N, T] uint8")
    T = texts_T.shape[1]
    if m_lens.shape != (P,) or n_lens.shape != (T,):
        raise ValueError("m_lens [P] / n_lens [T] shape mismatch")
    ts = [peq, m_lens, texts_T, n_lens]
    if tile_i is not None:
        if (tile_j is None or tile_i.shape != tile_j.shape
                or tile_i.dim() != 1 or TI % 8 or TJ % 32 or TI <= 0
                or TJ <= 0 or P % TI or T % TJ):
            raise ValueError("tile list / tile shape mismatch")
        ts += [tile_i, tile_j]
    if any(t.dtype != torch.int32 for t in ts if t is not texts_T):
        raise ValueError("myers index tensors must be int32")
    if any(t.device != peq.device for t in ts):
        raise ValueError("myers inputs lie on more than one device")
    if peq.shape[1] // NCHAN > MAX_WORDS:
        raise ValueError(f"pattern width over {MAX_WORDS * WORD} bp")
    if peq.device.type == "cpu":
        return myers_plain(peq, m_lens, texts_T, n_lens, mode, tile_i,
                           tile_j, TI, TJ)
    if peq.device.type != "cuda":
        raise ValueError(f"no myers kernel for device {peq.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("myers kernel inputs must be contiguous")
    return myers_cuda(peq, m_lens, texts_T, n_lens, mode, tile_i, tile_j,
                      TI, TJ)


def _upload(patterns_codes, m_lens, texts_codes, n_lens, P: int, T: int,
            device):
    """Pad to [P] patterns / [T] texts (pattern pad m=1, text pad code 5
    and n=1, as the Pallas wrappers do) and move to ``device``."""
    P0 = patterns_codes.shape[0]
    T0 = texts_codes.shape[0]
    W = max(1, -(-int(patterns_codes.shape[1]) // WORD))
    m = np.ones(P, np.int32)
    m[:P0] = np.asarray(m_lens, np.int32)
    peq = np.zeros((P, W * NCHAN), np.uint32)
    peq[:P0] = build_peq_packed(np.asarray(patterns_codes), m_lens, W)
    N = texts_codes.shape[1]
    tt = np.full((N, T), 5, np.uint8)
    tt[:, :T0] = np.asarray(texts_codes, np.uint8).T
    nl = np.ones(T, np.int32)
    nl[:T0] = np.asarray(n_lens, np.int32)
    dev = torch.device(device)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return put(peq.view(np.int32)), put(m), put(tt), put(nl)


def distances(patterns_codes: np.ndarray, m_lens: np.ndarray,
              texts_codes: np.ndarray, n_lens: np.ndarray,
              mode: str = "NW", device="cpu", fetch_pos: bool = True):
    """Host wrapper mirroring ``distances_pallas``: codes in, numpy
    ([P, T] distances, [P, T] positions or None) out."""
    P0, T0 = patterns_codes.shape[0], texts_codes.shape[0]
    d, p = myers_tiles(*_upload(patterns_codes, m_lens, texts_codes, n_lens,
                                P0, T0, device), mode)
    return d.cpu().numpy(), (p.cpu().numpy() if fetch_pos else None)


def distances_pairs(patterns_codes: np.ndarray, m_lens: np.ndarray,
                    texts_codes: np.ndarray, n_lens: np.ndarray,
                    tile_pairs: np.ndarray, mode: str = "NW",
                    TI: int | None = None, TJ: int | None = None,
                    device="cpu", fetch_pos: bool = True):
    """Host wrapper for the listed-tile entry point. ``tile_pairs`` is
    [G, 2] int32 of (pattern-tile, text-tile) indices at the (TI, TJ)
    granularity of :func:`tile_shape`. Returns numpy (dist, pos) padded
    to [P, T]; unlisted blocks hold unspecified values."""
    W = max(1, -(-int(patterns_codes.shape[1]) // WORD))
    TI, TJ = tile_shape(W, TI, TJ)
    P = -(-patterns_codes.shape[0] // TI) * TI
    T = -(-texts_codes.shape[0] // TJ) * TJ
    up = _upload(patterns_codes, m_lens, texts_codes, n_lens, P, T, device)
    pairs = torch.from_numpy(np.ascontiguousarray(tile_pairs, np.int32))
    pairs = pairs.to(up[0].device)
    d, p = myers_tiles(*up, mode, pairs[:, 0].contiguous(),
                       pairs[:, 1].contiguous(), TI, TJ)
    return d.cpu().numpy(), (p.cpu().numpy() if fetch_pos else None)
