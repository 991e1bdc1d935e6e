"""Device scoring services for clustering (the O(N^2) hot path).

Copy of ``tpu_orc/cluster/scoring.py``; the device seam: ``DeviceScorer``
has the backends ``"kernel"`` (``align/myers.py`` on the scorer's torch
device: the CUDA kernels on a CUDA device, their plain version on the
CPU), ``"native"`` (the C++ oracle) and ``"mesh"`` (a mesh of more than
one device, :71-98: pattern stripes over its devices through
``dist/sharded.py::device_parallel_pairwise``); ``_tile_distances`` and
``_gated_block`` call the dense and listed-tile Myers entry points.

Replaces the reference's multiprocessing+edlib pairwise engine
(amplicon_sorter.py:648-808 ``process_list``/``similarity``) with tiled
Myers kernels: pair enumeration becomes a 2-D grid of [tile x tile]
device calls; the pickle .todo machinery disappears (SURVEY.md §2.4).

Similarity semantics are the reference's ``distance()`` (:225-235):
sim = round(1 - d/len(longer), 3); reverse-complement retry only when the
forward similarity is < 0.5 (:791-799, :1698-1708).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..io import encode

from ..align import myers


def _bucket(n: int, caps=(128, 256, 512, 1024, 2048, 2560, 3072, 3584,
                          4096, 5120, 6144, 7168, 8192, 16384)) -> int:
    """Finer caps in the >2 kb range (r4): a 3.5 kb rRNA bin packed to
    4096 columns paid 17% wasted scan plus text streaming; 3584 stays
    under NC_MAX and in the fast TJ=256 tile band (pallas_myers r4
    sweep)."""
    for c in caps:
        if n <= c:
            return c
    return myers.WORD * (-(-n // myers.WORD))


def pack_codes(codes_list: Sequence[np.ndarray], cap: int | None = None,
               count_cap: int | None = None):
    """Pack code arrays to [N, L] with pad=4; lens padded entries get 1."""
    n = len(codes_list)
    L = _bucket(max((len(c) for c in codes_list), default=1))
    if cap is not None:
        L = cap
    N = count_cap if count_cap is not None else n
    out = np.full((N, L), 4, dtype=np.uint8)
    lens = np.ones(N, dtype=np.int32)
    for i, c in enumerate(codes_list):
        m = min(len(c), L)
        out[i, :m] = c[:m]
        lens[i] = max(m, 1)
    return out, lens


@dataclass
class PairHits:
    """Edges above threshold: (i, j, sim, reverse) arrays."""
    i: np.ndarray
    j: np.ndarray
    sim: np.ndarray
    reverse: np.ndarray


class DeviceScorer:
    """Tiled Myers scoring; one instance caches packing decisions.

    backend='kernel' runs the Myers entry points of align/myers.py on
    ``device`` (CUDA: the kernels; CPU: their plain version), or, given
    a ``mesh`` of more than one device, on pattern stripes over the
    mesh's devices (backend 'mesh'); backend='native' the C++ oracle
    (bit-identical, parity-tested).
    """

    def __init__(self, tile: int = 256, backend: str = "kernel",
                 device: str = "cuda", mesh=None):
        if backend not in ("kernel", "native"):
            raise ValueError(f"scorer backend {backend!r} not in "
                             f"('kernel', 'native')")
        self.tile = tile
        self.pairs_scored = 0  # telemetry for bench
        self.mesh = mesh if (mesh is not None
                             and mesh.devices.size > 1) else None
        self.backend = ("mesh" if self.mesh is not None
                        and backend == "kernel" else backend)
        self.device = device

    def _tile_distances(self, pat, plens, txt, tlens):
        """All-vs-all tile dispatch: the dense Myers entry point on the
        scorer's device, or striped over the mesh."""
        if self.backend == "mesh":
            from ..dist.sharded import device_parallel_pairwise
            return device_parallel_pairwise(
                list(self.mesh.devices.flat), pat, plens, txt, tlens)
        d, _ = myers.distances(pat, plens, txt, tlens, "NW",
                               device=self.device, fetch_pos=False)
        return d

    # -- all-vs-all within a block (gene stage) ---------------------------
    def allvsall_effective_sims(self, codes_list: Sequence[np.ndarray],
                                band: float = 1.05,
                                keep_threshold: float = 0.80) -> PairHits:
        """Upper-triangle effective similarities >= keep_threshold.

        Applies the reference 5% length gate (pairs whose length ratio
        exceeds ``band`` are skipped) and the rc-retry-below-0.5 rule.
        """
        n = len(codes_list)
        if n < 2:
            z = np.zeros(0)
            return PairHits(z.astype(int), z.astype(int), z, z.astype(bool))
        if self.backend == "native":
            return self._allvsall_native(codes_list, band, keep_threshold)
        # bucket the row count so batch shapes quantize across bins
        NB = _count_cap(n)
        packed, lens = pack_codes(codes_list, count_cap=NB)
        # upper-triangle + 5% length gate, applied per (TI, TJ) tile: only
        # surviving tiles are listed -> ONE device dispatch for the block
        lo = np.minimum.outer(lens[:n], lens[:n])
        hi = np.maximum.outer(lens[:n], lens[:n])
        tri = np.arange(n)[:, None] < np.arange(n)[None, :]
        gate = tri & (lo * band >= hi)                     # [n, n] fwd gate
        if not gate.any():
            z = np.zeros(0)
            return PairHits(z.astype(int), z.astype(int), z, z.astype(bool))
        # Phase 1: FORWARD orientations only. The rc score is consulted
        # only for pairs whose forward sim is < 0.5 (reference :791-799)
        # — in a reoriented bin that is a rare chimera artifact, so
        # scoring the rc block for every pair up front (as r3 did)
        # doubled the gene stage's device work; the rare low pairs get a
        # second, much smaller dispatch below.
        D = self._gated_block(packed, lens, packed[:NB], lens[:NB], gate,
                              n, n, NB)
        gi, gj = np.nonzero(gate)          # work on gated pairs only
        self.pairs_scored += len(gi)
        longer = hi[gi, gj].astype(np.float64)
        sf = np.round(1.0 - D[gi, gj] / longer, 3)
        low = sf < 0.5
        sr = np.full_like(sf, -1.0)
        if low.any():
            # Phase 2: rc retry for the low pairs only
            rc_codes = [encode.revcomp_codes(np.asarray(c))
                        for c in codes_list]
            packed_rc, _ = pack_codes(rc_codes, cap=packed.shape[1],
                                      count_cap=NB)
            gate2 = np.zeros_like(gate)
            gate2[gi[low], gj[low]] = True
            D2 = self._gated_block(packed, lens, packed_rc, lens, gate2,
                                   n, n, NB)
            self.pairs_scored += int(low.sum())
            sr = np.round(1.0 - D2[gi, gj] / longer, 3)
        eff = np.where(low, np.maximum(sf, sr), sf)
        rev = low & (sr > sf)
        keep = eff >= keep_threshold
        return PairHits(gi[keep], gj[keep], eff[keep], rev[keep])

    def _gated_block(self, packed, lens, texts, tlens, gate, np_, nt,
                     NB) -> np.ndarray:
        """[NB, >=nt] distance block for the True entries of ``gate``
        ([np_, nt]); ungated entries are unspecified. Only the surviving
        (TI, TJ) tiles are listed, in one launch of the pairs entry
        point; on a mesh, one launch per pattern stripe and device, the
        host gathering for the union-find."""
        if self.backend == "mesh":
            from ..dist.sharded import device_parallel_pairwise
            gfull = np.zeros((NB, texts.shape[0]), bool)
            gfull[:np_, :nt] = gate
            return device_parallel_pairwise(
                list(self.mesh.devices.flat), packed, lens, texts,
                tlens, "NW", gate=gfull)
        W = max(1, -(-packed.shape[1] // myers.WORD))
        TI, TJ = myers.tile_shape(W)
        P = -(-NB // TI) * TI
        T = -(-texts.shape[0] // TJ) * TJ
        gfull = np.zeros((P, T), bool)
        gfull[:np_, :nt] = gate
        need = gfull.reshape(P // TI, TI, T // TJ, TJ).any(axis=(1, 3))
        pairs = np.argwhere(need).astype(np.int32)
        d, _ = myers.distances_pairs(packed, lens, texts, tlens, pairs,
                                     "NW", TI=TI, TJ=TJ, device=self.device,
                                     fetch_pos=False)
        return d   # one fetch (pos stays on device)

    def _allvsall_native(self, codes_list, band, keep_threshold) -> PairHits:
        from .. import native
        n = len(codes_list)
        D = native.all_vs_all(codes_list, band=band)
        lens = np.array([len(c) for c in codes_list])
        longer = np.maximum.outer(lens, lens)
        computed = D >= 0
        self.pairs_scored += int(computed.sum())
        sims = np.where(computed, np.round(1.0 - D / longer, 3), -1.0)
        # rc retry only for computed pairs with fwd sim < 0.5 — one
        # threaded native crossing per source read instead of one
        # ctypes call per pair (a 2-species 80-read bin has ~1600 low
        # cross-species pairs; the per-call overhead was the profile's
        # second-largest term after the pileups, r5)
        rev = np.zeros_like(computed)
        low_i, low_j = np.nonzero(computed & (sims < 0.5))
        from collections import defaultdict

        from ..io import encode as _enc
        rc_cache: dict = {}
        byi = defaultdict(list)
        for i, j in zip(low_i, low_j):
            byi[int(i)].append(int(j))
        for i, js in byi.items():
            rcs = []
            for j in js:
                r = rc_cache.get(j)
                if r is None:
                    r = rc_cache[j] = _enc.revcomp_codes(
                        np.asarray(codes_list[j]))
                rcs.append(r)
            ds = native.nw_dist_batch(np.asarray(codes_list[i]), rcs)
            self.pairs_scored += len(js)
            for j, dj in zip(js, ds):
                s = round(1.0 - dj / longer[i, j], 3)
                if s > sims[i, j]:
                    sims[i, j] = s
                    rev[i, j] = True
        keep = computed & (sims >= keep_threshold)
        ii, jj = np.nonzero(keep)
        return PairHits(ii, jj, sims[keep], rev[keep])

    # -- reads vs consensuses (species ladder) ----------------------------
    # Chunk sizes bound one launch: R_CHUNK reads x C_CHUNK consensuses.
    # Unlike the JAX version, a chunk is padded only to the next
    # _count_cap bucket, not to the full chunk: eager launches take any
    # shape, so padding to R_CHUNK for jit-shape reuse would only add
    # work (results are per pair and do not depend on the padding).
    R_CHUNK = 2048
    C_CHUNK = 64

    def reads_vs_consensus_sims(self, read_codes: Sequence[np.ndarray],
                                cons_codes: Sequence[np.ndarray],
                                band: float = 1.05) -> np.ndarray:
        """Effective NW sims [R, C] with the rc-retry rule; NaN where the
        length gate skips the pair (reference :1664)."""
        R, C = len(read_codes), len(cons_codes)
        out = np.full((R, C), np.nan)
        if R == 0 or C == 0:
            return out
        if self.backend == "native":
            return self._rvc_native(read_codes, cons_codes, band, out)
        L = _bucket(max(max(len(x) for x in read_codes),
                        max(len(x) for x in cons_codes)))
        rlen = np.array([len(x) for x in read_codes])
        clen = np.array([len(x) for x in cons_codes])
        for r0 in range(0, R, self.R_CHUNK):
            r1 = min(r0 + self.R_CHUNK, R)
            sub = [np.asarray(x) for x in read_codes[r0:r1]]
            RC = min(self.R_CHUNK, _count_cap(r1 - r0))
            rp = np.full((RC, L), 4, dtype=np.uint8)
            rl = np.ones(RC, dtype=np.int32)
            for k, x in enumerate(sub):
                m = min(len(x), L)
                rp[k, :m] = x[:m]
                rl[k] = max(m, 1)
            rp_rc = None  # built lazily: rc is consulted only for
            # sf < 0.5 pairs (reference :1698-1708), rare in a
            # reoriented bin — scoring the rc rows in every ladder
            # dispatch (as r3 did) doubled the device work
            for c0 in range(0, C, self.C_CHUNK):
                c1 = min(c0 + self.C_CHUNK, C)
                cp, cl = pack_codes(cons_codes[c0:c1], cap=L,
                                    count_cap=_count_cap(c1 - c0))
                D = self._tile_distances(cp, cl, rp, rl)
                nr = r1 - r0
                Df = D[:c1 - c0, :nr].T
                longer = np.maximum(rlen[r0:r1, None], clen[None, c0:c1])
                sf = np.round(1.0 - Df / longer, 3)
                self.pairs_scored += nr * (c1 - c0)
                lo_g = np.minimum(rlen[r0:r1, None], clen[None, c0:c1])
                gated = lo_g * band >= longer
                # rc retry only for pairs that SURVIVE the length gate —
                # a gated pair's sf is trivially low (result discarded
                # as NaN below) and must not trigger the rc dispatch
                low = (sf < 0.5) & gated
                if low.any():
                    if rp_rc is None:
                        rp_rc = np.full_like(rp, 4)
                        for k, x in enumerate(sub):
                            y = encode.revcomp_codes(x)
                            m = min(len(y), L)
                            rp_rc[k, :m] = y[:m]
                    D2 = self._tile_distances(cp, cl, rp_rc, rl)
                    Dr = D2[:c1 - c0, :nr].T
                    sr = np.round(1.0 - Dr / longer, 3)
                    self.pairs_scored += nr * (c1 - c0)
                    eff = np.where(low, np.maximum(sf, sr), sf)
                else:
                    eff = sf
                out[r0:r1, c0:c1] = np.where(gated, eff, np.nan)
        return out


    def _rvc_native(self, read_codes, cons_codes, band, out):
        """One threaded native crossing per read (all gated consensuses
        batched) + one per rc-retry subset, instead of one ctypes call
        per (read, consensus) pair — identical per-pair arithmetic."""
        from .. import native
        from ..io import encode as _enc
        ccods = [np.asarray(c) for c in cons_codes]
        for r, rcod in enumerate(read_codes):
            rcod = np.asarray(rcod)
            gated = []
            his = []
            for c, ccod in enumerate(ccods):
                lo, hi = sorted((len(rcod), len(ccod)))
                if lo * band < hi or lo == 0:
                    continue
                gated.append(c)
                his.append(hi)
            if not gated:
                continue
            ds = native.nw_dist_batch(rcod, [ccods[c] for c in gated])
            self.pairs_scored += len(gated)
            ss = [round(1.0 - d / h, 3) for d, h in zip(ds, his)]
            low = [k for k, s in enumerate(ss) if s < 0.5]
            if low:
                rcrev = _enc.revcomp_codes(rcod)
                dr = native.nw_dist_batch(rcrev,
                                          [ccods[gated[k]] for k in low])
                self.pairs_scored += len(low)
                for k, d in zip(low, dr):
                    sr = round(1.0 - d / his[k], 3)
                    if sr > ss[k]:
                        ss[k] = sr
            for c, s in zip(gated, ss):
                out[r, c] = s
        return out


def _count_cap(n: int, caps=(8, 16, 32, 64, 128, 256, 512, 1024)) -> int:
    for c in caps:
        if n <= c:
            return c
    return -(-n // 1024) * 1024


