"""Profile-HMM scoring (barrnap/nhmmer-equivalent core): the batched local
Viterbi as a CUDA kernel and its plain PyTorch version.

Copy of ``tpu_orc/rrna/hmm.py``: ``ProfileHMM``, :func:`parse_hmmer3`,
:func:`profile_from_seqs` (on the port's ``cluster.consensus``) and
:func:`viterbi_host` as they are. The device seam is the jitted
``_viterbi_kernel`` (:169-237), an XLA ``lax.scan`` over positions with
a (max,+) ``associative_scan`` over nodes; :func:`viterbi_tiles` takes
its place and dispatches by the device of its tensors:

* a CPU tensor goes to :func:`viterbi_plain`, the same recurrence as
  torch ops over [B, K] planes, one step per position;
* a CUDA tensor goes to :func:`viterbi_cuda`, the hand-written kernel in
  ``csrc/viterbi.cu``, or the wrapper raises. The kernel has two designs,
  one warp per sequence (a systolic array over the lanes, profiles of up
  to ``MAX_WARP_NODES`` nodes) and one block per sequence (up to
  ``MAX_NODES``); :func:`choose_viterbi_design` picks one.

Scores are float32 and bit-identical to ``_viterbi_kernel``: every
version adds in its order, ``(v + S) + DM``, ``shift1(M) + shift1(MM)``,
``cand + em``, and max/argmax are exact in any order. The one sum whose
order XLA chooses, the D->D prefix ``S``, is computed once on the host
by :func:`dd_prefix` and handed to both versions.
:func:`profile_from_reference` carries a ``tpu_orc`` profile over.

Scores are natural-log odds vs a 0.25-uniform background.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..utils.profiling import count, span

NEG = -1e9
DD_FLOOR = -30.0  # finite clamp for 'impossible' D->D (see dd_prefix)


@dataclass
class ProfileHMM:
    name: str
    match_scores: np.ndarray   # [K, 4] log-odds emission scores (A C G T)
    t: np.ndarray              # [K, 7] log transition (MM MI MD IM II DM DD)
    insert_scores: Optional[np.ndarray] = None  # [K, 4], default zeros (bg)

    @property
    def K(self) -> int:
        return self.match_scores.shape[0]


# ---------------------------------------------------------------------------
# HMMER3 parser (HMMER3/f DNA profiles, e.g. barrnap's euk.hmm entries)
# ---------------------------------------------------------------------------

def parse_hmmer3(path: str) -> List[ProfileHMM]:
    """Parse all models in a HMMER3 .hmm text file (DNA alphabet).

    Verified against the real HMMER3/f layout (HMMER User Guide "HMM
    file format"; tests/fixtures/gen_euk_hmm_fixture.py writes a
    full-annotation multi-model fixture):

    * header block: NAME/ACC/DESC/LENG/MAXL/ALPH/RF/MM/CONS/CS/MAP/
      DATE/COM/NSEQ/EFFN/CKSUM/STATS/GA/TC/NC lines in any order;
    * ``HMM  A  C  G  T`` alphabet line (DNA enforced — protein models
      are rejected, not silently mis-read) + the transition-name line;
    * optional COMPO line; node-0 insert-emission + transition lines;
    * per node: match-emission line ``k  eA eC eG eT  MAP CONS RF MM
      CS`` (annotation columns present or absent), insert-emission
      line, 7-column transition line; node indices are VERIFIED;
    * ``*`` = -inf (zero probability; e.g. the last node's m->d/d->d).

    HMMER stores negative natural-log probabilities. Emission scores
    are converted to log-odds against the 0.25 background.
    """
    models = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("HMMER3"):
            i += 1
            continue
        name = "model"
        K = 0
        while i < len(lines) and not lines[i].strip().startswith("HMM "):
            if lines[i].startswith("NAME"):
                name = lines[i].split()[1]
            if lines[i].startswith("LENG"):
                K = int(lines[i].split()[1])
            i += 1
        if i >= len(lines):
            raise ValueError(f"{path}: model {name!r}: no HMM table")
        if K <= 0:
            raise ValueError(f"{path}: model {name!r}: missing LENG")
        alpha = lines[i].split()[1:]
        if alpha[:4] != ["A", "C", "G", "T"]:
            raise ValueError(
                f"{path}: model {name!r}: not a DNA profile "
                f"(alphabet {alpha[:4]})")
        # "HMM A C G T" line + transition-name line
        i += 2
        def val(tok: str) -> float:
            return NEG if tok == "*" else -float(tok)
        # optional COMPO line (average match emissions)
        if i < len(lines) and lines[i].strip().startswith("COMPO"):
            i += 1
        # node 0: insert emissions + begin transitions
        i += 2
        match = np.zeros((K, 4))
        trans = np.full((K, 7), NEG)
        for k in range(K):
            toks = lines[i].split()
            if not toks or toks[0] != str(k + 1):
                raise ValueError(
                    f"{path}: model {name!r}: expected node {k + 1} "
                    f"match line, got: {lines[i]!r}")
            ems = [val(t) for t in toks[1:5]]
            match[k] = [e - math.log(0.25) for e in ems]
            i += 1
            i += 1  # insert emissions (background in practice)
            toks = lines[i].split()
            if len(toks) < 7:
                raise ValueError(
                    f"{path}: model {name!r}: node {k + 1} transition "
                    f"line has {len(toks)} columns, expected 7")
            trans[k] = [val(t) for t in toks[:7]]
            i += 1
        models.append(ProfileHMM(name, match, trans))
        while i < len(lines) and not lines[i].startswith("//"):
            i += 1
        i += 1
    return models


# ---------------------------------------------------------------------------
# Profile builder from example sequences
# ---------------------------------------------------------------------------

def profile_from_seqs(seq_codes: Sequence[np.ndarray], name: str = "profile",
                      pseudocount: float = 1.0,
                      p_gap: float = 0.05, device="cuda") -> ProfileHMM:
    """Build a profile from example gene sequences via star-alignment
    pileup (no external MSA tool). Columns with majority-gap are treated
    as insert states and dropped from the match profile. ``device`` is
    the consensus pileup's (``cluster/consensus.py``)."""
    from ..cluster.consensus import _align_rows, build_consensus

    cons = build_consensus(list(seq_codes), device=device)
    aln = _align_rows(cons, list(seq_codes))  # [n+1, W], GAP=255
    n = aln.shape[0]
    keep = (aln != 255).sum(axis=0) > n / 2
    cols = aln[:, keep]
    K = cols.shape[1]
    match = np.zeros((K, 4))
    for b in range(4):
        match[:, b] = (cols == b).sum(axis=0)
    freq = (match + pseudocount) / (match.sum(axis=1, keepdims=True)
                                    + 4 * pseudocount)
    match_scores = np.log(freq) - math.log(0.25)
    lg = math.log(p_gap)
    l1 = math.log(1 - 2 * p_gap)
    lstay = math.log(0.5)
    t = np.tile(np.array([l1, lg, lg,            # MM MI MD
                          lstay, lstay,          # IM II
                          lstay, lstay]),        # DM DD
                (K, 1))
    return ProfileHMM(name, match_scores, t)


def viterbi_host(profile: ProfileHMM, seq_codes: np.ndarray
                 ) -> Tuple[float, int, int]:
    """Naive host Viterbi (float64 numpy), the parity reference for
    :func:`viterbi_scan`. Same local semantics: free start at any
    node, best M anywhere is the end; N emits background (0); DD uses
    the same finite clamp. Returns (score, end_pos_1based, end_node)."""
    ms = profile.match_scores.astype(np.float64)
    t = profile.t.astype(np.float64)
    K = profile.K
    MM, MI, MD, IM, II, DM, DD = [t[:, i] for i in range(7)]
    DDc = np.maximum(DD, DD_FLOOR)
    M = np.full(K, NEG)
    I = np.full(K, NEG)
    best, bpos, bnode = NEG, 0, 0
    seq = np.asarray(seq_codes)
    for j, c in enumerate(seq, start=1):
        em = ms[:, int(c)] if c < 4 else np.zeros(K)
        # D states from the previous column's M (no emission)
        D = np.full(K, NEG)
        for k in range(1, K):
            entry = M[k - 1] + MD[k - 1]
            chain = D[k - 1] + DDc[k - 1]
            D[k] = max(entry, chain)
        Mn = np.full(K, NEG)
        for k in range(K):
            cand = 0.0  # free local start
            if k > 0:
                cand = max(cand, M[k - 1] + MM[k - 1],
                           I[k - 1] + IM[k - 1], D[k - 1] + DM[k - 1])
            Mn[k] = cand + em[k]
        In = np.maximum(M + MI, I + II)
        M, I = Mn, In
        k_best = int(np.argmax(M))
        if M[k_best] > best:
            best, bpos, bnode = float(M[k_best]), j, k_best
    return best, bpos, bnode


# ---------------------------------------------------------------------------
# Batched local Viterbi: plain version and CUDA kernel
# ---------------------------------------------------------------------------

MAX_NODES = 4096   # csrc/viterbi.cu: 16 nodes x 256 threads, shared tables
#: The warp design takes profiles of up to MAX_WARP_NODES nodes (16 on each
#: of 32 lanes), the block design everything above. The warp design is the
#: faster one wherever it fits; chip_smoke.py phase 9, 8 sequences x 3,584
#: positions, NVIDIA H100 80GB HBM3 at 700 W: warp 0.414 ms vs block 2.306
#: ms at K 74 (the default 18S profile), warp 1.526 vs block 3.257 ms at
#: K 512; at K 1,800 (a user's HMMER3 profile size) the block design takes
#: 4.448 ms.
MAX_WARP_NODES = 512
DESIGNS = ("warp", "block")  # index = csrc/viterbi.cu DESIGN_WARP, _BLOCK

#: kernel launches by design (csrc/viterbi.cu), "scan_warp" and
#: "scan_block"; counted by viterbi_cuda
LAUNCHES = _build.LaunchCounter(tuple(f"scan_{d}" for d in DESIGNS))


def choose_viterbi_design(K: int) -> str:
    """The design of ``csrc/viterbi.cu`` for a profile of ``K`` nodes:
    "warp" up to :data:`MAX_WARP_NODES`, where it fits, "block" above."""
    return "warp" if K <= MAX_WARP_NODES else "block"


def _blocked_cumsum(x: np.ndarray) -> np.ndarray:
    n = len(x)
    nb = max(1, -(-n // 16))
    xp = np.zeros(nb * 16, np.float32)
    xp[:n] = x
    inner = np.cumsum(xp.reshape(nb, 16), axis=1, dtype=np.float32)
    if nb > 1:
        tot = _blocked_cumsum(inner[:, -1].copy())
        inner[1:] += tot[:-1, None]
    return inner.ravel()[:n]


def dd_prefix(trans: np.ndarray) -> np.ndarray:
    """S[k] = sum_{t<k} max(DD[t], DD_FLOOR) in float32 [K], in the order
    of ``_viterbi_kernel``'s ``concat([0], jnp.cumsum(DDc[:-1]))``.

    XLA lowers that cumsum to a reduce-window scan whose float32 sums
    differ from a running sum (``np.cumsum``, ``torch.cumsum``) in most
    entries. It equals a blocked scan with base 16, which this
    reproduces: pad to a multiple of 16 with zeros, take running sums
    inside each block of 16, scan the block totals the same way
    (recursively), and add each block's exclusive prefix to its
    elements. ``tests/test_torch_rrna.py`` holds it bit for bit against
    ``jnp.cumsum``, so a JAX that changes the order fails a test."""
    dd = np.maximum(np.asarray(trans, np.float32)[:, 6], np.float32(DD_FLOOR))
    return np.concatenate([np.zeros(1, np.float32), _blocked_cumsum(dd[:-1])])


def viterbi_plain(match_s: torch.Tensor, trans: torch.Tensor,
                  S: torch.Tensor, seqs: torch.Tensor, lens: torch.Tensor):
    """``_viterbi_kernel``'s recurrence as torch ops.

    match_s [K, 4], trans [K, 7] and S [K] float32 (:func:`dd_prefix`);
    seqs [B, L] uint8 codes (4 = N or pad; N emits background 0); lens
    [B] int32. Returns (best [B] float32, end position [B] int32
    (1-based), end node [B] int32). A position j > len leaves a
    sequence's state as it is; the loop stops at the longest length."""
    dev = match_s.device
    f32 = torch.float32
    B, L = seqs.shape
    K = match_s.shape[0]
    MM, MI, MD, IM, II, DM = (trans[:, i] for i in range(6))

    def shift1(x):  # along the model axis: out[k] = x[k-1], out[0] = NEG
        return torch.cat([torch.full((x.shape[0], 1), NEG, dtype=f32,
                                     device=dev), x[:, :-1]], dim=1)

    sMM, sIM = shift1(MM.view(1, K)), shift1(IM.view(1, K))
    # emission rows by code: 0..3 the bases, 4 (N / pad) background 0
    em_rows = torch.cat([match_s.t(), torch.zeros((1, K), dtype=f32,
                                                  device=dev)])
    M = torch.full((B, K), NEG, dtype=f32, device=dev)
    I = M.clone()
    best = torch.full((B,), NEG, dtype=f32, device=dev)
    bpos = torch.zeros(B, dtype=torch.int32, device=dev)
    bnode = torch.zeros(B, dtype=torch.int32, device=dev)
    codes = seqs.to(torch.int64).clamp(max=4)
    ncols = min(L, int(lens.max())) if B else 0
    for j in range(1, ncols + 1):
        em = em_rows[codes[:, j - 1]]
        base = torch.clamp_min(torch.maximum(shift1(M) + sMM,
                                             shift1(I) + sIM), 0.0)
        # D-chain: D[k] = max_{k'<=k}(entry[k'] + S[k] - S[k']), a
        # prefix max of entry - S
        v = torch.cummax(shift1(M + MD) - S, dim=1).values
        cand = torch.maximum(base, shift1((v + S) + DM))
        valid = j <= lens
        Mn = torch.where(valid[:, None], cand + em, M)
        In = torch.where(valid[:, None], torch.maximum(M + MI, I + II), I)
        mrow, node = Mn.max(dim=1)       # first index on ties
        better = (mrow > best) & valid
        best = torch.where(better, mrow, best)
        bpos = torch.where(better, j, bpos)
        bnode = torch.where(better, node.to(torch.int32), bnode)
        M, I = Mn, In
    return best, bpos, bnode


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("viterbi", "orc_viterbi",
                       [vp] * 5 + [ci] * 4 + [vp] * 4).orc_viterbi


def viterbi_cuda(match_s, trans, S, seqs, lens, design: str | None = None):
    """Launch ``csrc/viterbi.cu`` on the current stream; same contract
    and outputs as :func:`viterbi_plain`. Inputs are checked by
    :func:`viterbi_tiles`. ``design`` forces "warp" or "block" (the
    card's tests and ``chip_smoke.py`` compare them); by default
    :func:`choose_viterbi_design` picks it."""
    B, L = seqs.shape
    K = match_s.shape[0]
    if design is None:
        design = choose_viterbi_design(K)
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} not in {DESIGNS}")
    if design == "warp" and K > MAX_WARP_NODES:
        raise ValueError(f"the warp design takes up to {MAX_WARP_NODES} "
                         f"nodes, not {K}")
    dev = seqs.device
    best = torch.empty(B, dtype=torch.float32, device=dev)
    bpos = torch.empty(B, dtype=torch.int32, device=dev)
    bnode = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return best, bpos, bnode              # nothing to launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(match_s.data_ptr(), trans.data_ptr(), S.data_ptr(),
                     seqs.data_ptr(), lens.data_ptr(), K, B, L,
                     DESIGNS.index(design), best.data_ptr(), bpos.data_ptr(),
                     bnode.data_ptr(), stream)
    _build.check(err, f"viterbi kernel ({design} design)")
    LAUNCHES.add(f"scan_{design}", dev)
    _count_launch(design, B, L, K)
    return best, bpos, bnode


def _count_launch(design: str, B: int, L: int, K: int) -> None:
    """The counters of one scan: ``viterbi.cells_launched`` (B x L x K,
    the padded length) and ``viterbi.launches/<design>/K<K>`` ("plain" for
    the CPU version)."""
    count("viterbi.cells_launched", B * L * K)
    count(f"viterbi.launches/{design}/K{K}")


def viterbi_tiles(match_s, trans, S, seqs, lens):
    """Local Viterbi of every sequence against one profile: (best [B]
    float32, end position [B], end node [B] int32). A CPU tensor goes
    to :func:`viterbi_plain`; a CUDA tensor to the kernel."""
    K = match_s.shape[0]
    if match_s.shape != (K, 4) or trans.shape != (K, 7) or S.shape != (K,):
        raise ValueError("match_s [K, 4], trans [K, 7], S [K] expected")
    if not 0 < K <= MAX_NODES:
        raise ValueError(f"profile of {K} nodes; 1..{MAX_NODES} supported")
    if any(t.dtype != torch.float32 for t in (match_s, trans, S)):
        raise ValueError("profile tables must be float32")
    if seqs.dim() != 2 or seqs.dtype != torch.uint8:
        raise ValueError("seqs must be [B, L] uint8")
    if lens.shape != (seqs.shape[0],) or lens.dtype != torch.int32:
        raise ValueError("lens must be [B] int32")
    ts = (match_s, trans, S, seqs, lens)
    if any(t.device != seqs.device for t in ts):
        raise ValueError("viterbi inputs lie on more than one device")
    if seqs.device.type == "cpu":
        if seqs.shape[0]:
            _count_launch("plain", *seqs.shape, K)
        return viterbi_plain(*ts)
    if seqs.device.type != "cuda":
        raise ValueError(f"no viterbi kernel for device {seqs.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("viterbi kernel inputs must be contiguous")
    return viterbi_cuda(*ts)


def viterbi_scan(profile: ProfileHMM, seqs_codes: np.ndarray,
                 lens: np.ndarray, device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score contigs [B, L] against the profile on ``device``. Returns
    (score float32, end_pos int32, end_node int32) numpy arrays [B]. The
    span ``rrna.viterbi``: the tables and sequences up, the scan, the
    results back."""
    lens = np.asarray(lens, np.int32)
    if len(lens) and (lens.min() < 0 or lens.max() > seqs_codes.shape[1]):
        raise ValueError("sequence lengths must lie in [0, L]")
    dev = torch.device(device)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    with span("rrna.viterbi"):
        best, bpos, bnode = viterbi_tiles(
            put(np.asarray(profile.match_scores, np.float32)),
            put(np.asarray(profile.t, np.float32)),
            put(dd_prefix(profile.t)),
            put(np.asarray(seqs_codes, np.uint8)), put(lens))
        return best.cpu().numpy(), bpos.cpu().numpy(), bnode.cpu().numpy()


def profile_from_reference(p) -> ProfileHMM:
    """The port's profile from a ``tpu_orc`` ``ProfileHMM`` (its fields,
    read by name), so both packages can score one model."""
    ins = getattr(p, "insert_scores", None)
    return ProfileHMM(p.name, np.array(p.match_scores), np.array(p.t),
                      None if ins is None else np.array(ins))
