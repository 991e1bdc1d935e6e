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
  ``csrc/myers.cu``, or the wrapper raises. The kernel has two designs,
  one thread or one warp per pair; :func:`choose_design` picks one from
  the launch's shape.

Distances and positions are bit-identical to the Pallas kernels: the
word width changes how the DP is cut into words, not its values.

``tpu_orc/align/myers.py``'s public API is here too: :func:`n_words`
(:35), :func:`build_peq` (:39, its ``[P, W, 6]`` layout), :func:`myers_tile`
(:66, the XLA Myers, here an adapter onto :func:`myers_tiles`) and
:func:`similarity_matrix` (:162).
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

DESIGNS = ("thread", "warp")  # index = csrc/myers.cu DESIGN_THREAD, _WARP
#: kernel launches by entry point and design (csrc/myers.cu), e.g.
#: "dense_warp"; counted by myers_cuda
LAUNCHES = _build.LaunchCounter(tuple(f"{e}_{d}" for e in ("dense", "pairs")
                                      for d in DESIGNS))

#: The thread design takes launches of at least THREAD_MIN_PAIRS pairs at
#: W <= THREAD_MAX_WORDS, where one thread per pair fills the card; every
#: other launch goes to the warp design. Crossover from chip_smoke.py
#: phase 3 (dense NW, ~500 bp reads at W 17, NVIDIA H100 80GB HBM3 at
#: 700 W): thread 0.674 / 0.663 / 0.668 ms and warp 0.402 / 0.592 / 0.730
#: ms at 8,192 / 12,288 / 16,384 pairs; the warp design's time grows with
#: the pairs from there on, the thread design's stays flat up to ~25,000.
#: Above 32 words the thread design keeps VP/VN in local memory and the
#: warp design wins at every size measured there (W 112, the same card:
#: 0.60 vs 76.7 ms at 256 pairs, 1.55 vs 76.7 ms at 4,096, 70.2 vs 330.6
#: ms at 151,552).
THREAD_MAX_WORDS = 32
THREAD_MIN_PAIRS = 16384


def choose_design(pairs: int, W: int) -> str:
    """The design of ``csrc/myers.cu`` for a launch of ``pairs`` (pattern,
    text) pairs at ``W`` pattern words: "thread" or "warp"."""
    if W <= THREAD_MAX_WORDS and pairs >= THREAD_MIN_PAIRS:
        return "thread"
    return "warp"


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


def check_peq(peq: np.ndarray) -> None:
    """Reject a packed Peq [rows, W*NCHAN] (uint32 or int32 bits) that the
    kernel's designs would read differently: a pattern row set in more
    than one of the channels 0..4, or any bit in the channels 5..7. The
    thread design looks a text code up in channels 0..4, the warp designs
    (and the pileup kernel's) in four bit-planes that equal that lookup
    only when each row sits in at most one channel, and the plain version
    in all eight. :func:`build_peq_packed` puts each row in at most one of
    the channels 0..4 (rows past the pattern in none)."""
    x = np.asarray(peq).view(np.uint32).reshape(len(peq), -1, NCHAN)
    if x[:, :, 5:].any():
        raise ValueError("Peq bits in channels 5..7: the kernel reads "
                         "channels 0..4 only")
    seen = x[:, :, 0].copy()
    for ch in range(1, 5):
        if (seen & x[:, :, ch]).any():
            raise ValueError("a Peq row is set in more than one channel")
        seen |= x[:, :, ch]


def check_codes(codes: np.ndarray) -> None:
    """Reject text codes of 8 or more. Codes 0..4 are bases and N, 5..7
    match nothing in every version; the warp designs look a code up by its
    low three bits, so a code of 8 or more would match ``code & 7``."""
    codes = np.asarray(codes)
    if codes.size and int(codes.max()) >= NCHAN:
        raise ValueError(f"text code {int(codes.max())} >= {NCHAN}: codes "
                         f"are 0..4 (5..7 pad)")


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
                       [vp] * 4 + [ci] * 5 + [vp, vp] + [ci] * 4
                       + [vp, vp, vp])


def myers_cuda(peq, m_lens, texts_T, n_lens, mode: str = "NW",
               tile_i=None, tile_j=None, TI: int = 0, TJ: int = 0,
               design: str | None = None):
    """Launch ``csrc/myers.cu`` on the current stream: the dense grid, or
    one grid row per listed tile. Same contract as :func:`myers_plain`
    except that unlisted blocks are left unwritten. ``design`` forces
    "thread" or "warp" (the card's tests and ``chip_smoke.py`` compare
    them); by default :func:`choose_design` picks it."""
    P = peq.shape[0]
    N, T = texts_T.shape
    W = peq.shape[1] // NCHAN
    dist = torch.empty((P, T), dtype=torch.int32, device=peq.device)
    pos = torch.empty((P, T), dtype=torch.int32, device=peq.device)
    pairs = tile_i is not None
    G = int(tile_i.shape[0]) if pairs else 0
    if design is None:
        design = choose_design(G * TI * TJ if pairs else P * T, W)
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} not in {DESIGNS}")
    if P == 0 or T == 0 or (pairs and G == 0):
        return dist, pos                      # nothing to launch
    entry = "pairs" if pairs else "dense"
    with torch.cuda.device(peq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().orc_myers(
            peq.data_ptr(), m_lens.data_ptr(), texts_T.data_ptr(),
            n_lens.data_ptr(), P, T, N, W, MODES[mode],
            tile_i.data_ptr() if pairs else None,
            tile_j.data_ptr() if pairs else None, G, TI, TJ,
            DESIGNS.index(design), dist.data_ptr(), pos.data_ptr(), stream)
    _build.check(err, f"myers kernel ({entry}, {design} design)")
    LAUNCHES.add(f"{entry}_{design}", peq.device)
    return dist, pos


def myers_tiles(peq, m_lens, texts_T, n_lens, mode: str = "NW",
                tile_i=None, tile_j=None, TI: int = 0, TJ: int = 0):
    """Edit distance of every pattern against every text, or of the
    listed tiles only; (dist, pos) [P, T] int32.

    peq [P, W*NCHAN] int32 (uint32 bits, :func:`build_peq_packed`),
    m_lens [P] int32, texts_T [N, T] uint8 codes 0..4 (5 = pad), n_lens
    [T] int32, tile_i/tile_j [G] int32 tile coordinates of TI x TJ
    blocks (P % TI == 0 and T % TJ == 0). A CPU tensor goes to
    :func:`myers_plain`; a CUDA tensor to the kernel. A Peq or codes that
    :func:`check_peq` or :func:`check_codes` reject raise: CPU tensors are
    checked here; for CUDA tensors :func:`_upload` checks the codes on the
    host and builds the Peq valid (checking a CUDA tensor here would cost
    a copy to the host per launch)."""
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
        check_peq(peq.numpy())
        check_codes(texts_T.numpy())
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
    and n=1, as the Pallas wrappers do) and move to ``device``. The text
    codes are checked on the host (:func:`check_codes`) for every device;
    :func:`build_peq_packed` puts each pattern row in one channel at
    most."""
    P0 = patterns_codes.shape[0]
    T0 = texts_codes.shape[0]
    W = max(1, -(-int(patterns_codes.shape[1]) // WORD))
    m = np.ones(P, np.int32)
    m[:P0] = np.asarray(m_lens, np.int32)
    peq = np.zeros((P, W * NCHAN), np.uint32)
    peq[:P0] = build_peq_packed(np.asarray(patterns_codes), m_lens, W)
    N = texts_codes.shape[1]
    check_codes(texts_codes)
    tt = np.full((N, T), 5, np.uint8)
    tt[:, :T0] = np.asarray(texts_codes, np.uint8).T
    nl = np.ones(T, np.int32)
    nl[:T0] = np.asarray(n_lens, np.int32)
    dev = torch.device(device)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return put(peq.view(np.int32)), put(m), put(tt), put(nl)


def _fetch(d, p, fetch_pos: bool, lazy: bool):
    """(dist, pos or None) as numpy, or as the device tensors when
    ``lazy`` (no copy to the host, no wait for the launch)."""
    if lazy:
        return d, (p if fetch_pos else None)
    return d.cpu().numpy(), (p.cpu().numpy() if fetch_pos else None)


def distances(patterns_codes: np.ndarray, m_lens: np.ndarray,
              texts_codes: np.ndarray, n_lens: np.ndarray,
              mode: str = "NW", device="cuda", fetch_pos: bool = True,
              lazy: bool = False):
    """Host wrapper mirroring ``distances_pallas``: codes in, numpy
    ([P, T] distances, [P, T] positions or None) out. ``lazy=True``
    returns the [P, T] int32 tensors on ``device`` instead, so that a
    caller can launch on several devices before it fetches any."""
    P0, T0 = patterns_codes.shape[0], texts_codes.shape[0]
    d, p = myers_tiles(*_upload(patterns_codes, m_lens, texts_codes, n_lens,
                                P0, T0, device), mode)
    return _fetch(d, p, fetch_pos, lazy)


def distances_pairs(patterns_codes: np.ndarray, m_lens: np.ndarray,
                    texts_codes: np.ndarray, n_lens: np.ndarray,
                    tile_pairs: np.ndarray, mode: str = "NW",
                    TI: int | None = None, TJ: int | None = None,
                    device="cuda", fetch_pos: bool = True,
                    lazy: bool = False):
    """Host wrapper for the listed-tile entry point. ``tile_pairs`` is
    [G, 2] int32 of (pattern-tile, text-tile) indices at the (TI, TJ)
    granularity of :func:`tile_shape`. Returns numpy (dist, pos) padded
    to [P, T], or with ``lazy`` the tensors on ``device`` (as
    :func:`distances`); unlisted blocks hold unspecified values."""
    W = max(1, -(-int(patterns_codes.shape[1]) // WORD))
    TI, TJ = tile_shape(W, TI, TJ)
    P = -(-patterns_codes.shape[0] // TI) * TI
    T = -(-texts_codes.shape[0] // TJ) * TJ
    up = _upload(patterns_codes, m_lens, texts_codes, n_lens, P, T, device)
    pairs = torch.from_numpy(np.ascontiguousarray(tile_pairs, np.int32))
    pairs = pairs.to(up[0].device)
    d, p = myers_tiles(*up, mode, pairs[:, 0].contiguous(),
                       pairs[:, 1].contiguous(), TI, TJ)
    return _fetch(d, p, fetch_pos, lazy)


def distances_with_pos(patterns_codes: np.ndarray, m_lens: np.ndarray,
                       texts_codes: np.ndarray, n_lens: np.ndarray,
                       mode: str = "NW", device="cuda"):
    """``tpu_orc/align/myers.py::distances_with_pos`` (:147, the XLA
    ``myers_tile``) on the dense entry point: codes in, ([P, T]
    distances, [P, T] text end positions) out. Pattern positions at or
    past ``m_lens`` go to the pad channel; text code 4 (N) matches N; a
    column counts only while j <= n_len. For NW the position is the text
    length; for SHW/HW the earliest 1-based column at the minimum, and 0
    (with distance m) when no column beats column 0."""
    return distances(patterns_codes, m_lens, texts_codes, n_lens, mode,
                     device)


# ---------------------------------------------------------------------------
# tpu_orc/align/myers.py's public API
# ---------------------------------------------------------------------------

def n_words(max_len: int) -> int:
    """32-bit words of a pattern of ``max_len`` bp (at least one)."""
    return max(1, -(-max_len // WORD))


def build_peq(codes, W: int, m_lens=None) -> torch.Tensor:
    """codes [P, M] uint8 (0..3 bases, 4 = N) -> Peq [P, W, 6] int64.

    ``tpu_orc``'s layout (``build_peq``, :39): channel c of word w holds
    bit i when pattern position 32w + i has code c. Channel 4 is the N
    channel (N matches N, as edlib compares bytes); channel 5 is the dead
    pad channel, always zero. Positions at or beyond ``m_lens`` (and past
    M) are forced onto the pad channel. The 32-bit words are held as
    int64 values in [0, 2**32), torch's uint32 having few operations.
    ``codes`` is a tensor or a numpy array; the Peq lies on its device."""
    codes = torch.as_tensor(codes)
    P, M = codes.shape
    dev = codes.device
    Mp = W * WORD
    c = torch.full((P, Mp), 5, dtype=torch.int64, device=dev)
    k = min(M, Mp)
    c[:, :k] = codes[:, :k].to(torch.int64)
    if m_lens is not None:
        m = torch.as_tensor(m_lens, device=dev).to(torch.int64)
        c = torch.where(torch.arange(Mp, device=dev)[None, :] < m[:, None],
                        c, 5)
    c = c.view(P, W, WORD)
    onehot = c[..., None] == torch.arange(5, device=dev)
    weights = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        WORD, dtype=torch.int64, device=dev)
    peq5 = (onehot * weights[None, None, :, None]).sum(dim=2)   # [P, W, 5]
    return torch.cat([peq5, torch.zeros_like(peq5[..., :1])], dim=2)


def myers_tile(peq, m_lens, texts, n_lens, mode: str = "NW",
               W: int | None = None):
    """Edit distance of every pattern against every text, ``tpu_orc``'s
    ``myers_tile`` (:66): ([P, T] int32 distances, [P, T] int32 text end
    positions).

    peq [P, >= W, 6] (:func:`build_peq`; int64 values or int32 bits of
    the 32-bit words), m_lens [P] pattern lengths (>= 1), texts [T, N]
    uint8 codes (pad 4), n_lens [T] text lengths, all on one device. For
    NW the position is ``n_lens``; for SHW/HW the earliest 1-based column
    at the minimum (0 when no column beats column 0). The Peq goes to the
    packed layout and the texts are transposed for :func:`myers_tiles`:
    on CUDA tensors the dense entry of ``csrc/myers.cu`` (counted under
    its ``dense_*`` launch key), on CPU tensors its plain version."""
    if W is None:
        W = peq.shape[1]
    P = peq.shape[0]
    words = peq[:, :W, :5].to(torch.int64) & 0xFFFFFFFF
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    packed = torch.zeros((P, W, NCHAN), dtype=torch.int32,
                         device=peq.device)
    packed[:, :, :5] = words.to(torch.int32)
    return myers_tiles(packed.view(P, W * NCHAN),
                       torch.as_tensor(m_lens).to(torch.int32).contiguous(),
                       texts.t().contiguous(),
                       torch.as_tensor(n_lens).to(torch.int32).contiguous(),
                       mode)


def similarity_matrix(dist: np.ndarray, m_lens: np.ndarray,
                      n_lens: np.ndarray) -> np.ndarray:
    """Reference similarity: round(1 - d/len(longer), 3)
    (amplicon_sorter.py:225-235). Rounding matches Python round-half-even
    on the float64 quotient."""
    longer = np.maximum(np.asarray(m_lens)[:, None], np.asarray(n_lens)[None, :])
    sim = 1.0 - dist / np.maximum(longer, 1)
    return np.round(sim, 3)
