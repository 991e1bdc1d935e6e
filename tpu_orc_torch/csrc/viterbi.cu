// Batched local Viterbi of contigs against one profile HMM (barrnap-style
// rRNA scoring), float32.
//
// Replaces tpu_orc/rrna/hmm.py::_viterbi_kernel (lines 169-237), a jitted
// XLA program: a lax.scan over sequence positions whose step resolves the
// D->D chain with a (max,+) associative_scan over the K model nodes.
// Outputs per sequence: best score (float32), its 1-based end position
// and its end node (int32).
//
// What bounds it on this card: neither bytes nor operations. A step is
// ~15 float operations per node and a sequence of ~3,600 positions
// against a 75-node profile is ~4 MFLOP; the chain of positions (step j
// needs step j-1) and the chain of nodes inside a step (the D->D max)
// set the time, so the kernel is latency-bound by design. Two designs:
//
// Warp design (K <= 512, every default profile): one warp per sequence,
// a systolic array over the lanes. Lane l owns the P = ceil(K / 32)
// consecutive nodes l*P .. l*P+P-1 (P <= 16) with M and I in registers,
// and at step s it handles position j = s - l. At the top of a step it
// receives from lane l-1 (__shfl_up_sync), all computed at step s-1:
//   * v, the running max of entry - S, at node l*P-1 and position j;
//   * M and I of node l*P-1 at position j, which it keeps for the next
//     step, where they are position j-1's (the "from" node of its first
//     node);
//   * the sequence's code of position j, packed with the lane's code of
//     a block of 32 positions that the lanes load every 32 steps, from
//     which lane 0 takes its own (one __shfl_sync).
// So the D->D chain is a serial max across the lane's P nodes and one
// hop per lane: no scan, no barrier and no shared-memory hop per
// position. The tables, staged once in shared memory ([field][p][lane],
// conflict-free), are copied to registers for P <= 4; emissions are
// looked up in shared memory by the code. Each lane keeps its own best
// (strict >, over its positions in order and its nodes in order); a warp
// reduction at the end orders the lanes' candidates by score, then
// position, then node, which is the sequential rule's "first position,
// first node". Lane l idles where j < 1 or j > len.
//
// Block design (any K up to 4,096): one block per sequence. Thread t owns
// the P consecutive nodes t*P .. t*P+P-1 (P = 1..16, so K up to 4,096
// with 256 threads); M and I stay in registers. Emissions, the six
// transitions used and S (the D->D prefix sums, computed on the host in
// XLA's order) sit in shared memory, stored [field][p][t] so that a warp
// reads 32 neighbouring words. Per position:
//   * node k-1 of the previous position: the thread's own lower node or,
//     for its first node, lane l-1's last (__shfl_up_sync) or the last
//     node of the warp below (shared memory);
//   * entry - S, then its inclusive max-scan: inside the thread, over the
//     warp (__shfl_up_sync), then over the warps' totals (shared memory);
//   * cand = max(max(M[k-1] + MM[k-1], I[k-1] + IM[k-1]), 0) against
//     ((v[k-1] + S[k-1]) + DM[k-1]); Mn = cand + em; In = max(M + MI,
//     I + II), each sum in _viterbi_kernel's order;
//   * the block's max and first argmax of Mn, and the best update
//     (strict >) by thread 0.
// Positions past the sequence's length change nothing, so the block stops
// there. Two __syncthreads per position.
//
// Both designs do the same float operations as the XLA program in its
// order; only max, which is exact in any order, is regrouped. The step has
// adds and max only (no multiply to contract into an FMA) and is built
// without fast-math, so every result is bit-identical to the XLA program.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#define NEG (-1e9f)
#define MAXT 256                 // threads per block (block design)
#define FULL 0xffffffffu
#define NF 13                    // warp design's table fields, below

enum { DESIGN_WARP = 0, DESIGN_BLOCK = 1 };

// Warp design. Table fields of node k, [field][p][lane] in shared memory:
// emissions of codes 0..4 (4: N / pad, 0), then MM, IM, MD of node k-1
// (node 0: NEG, NEG, 0, so that its entry is NEG and its from-terms
// NEG + NEG, as _viterbi_kernel's shift1 pads), MI, II, S, then S and DM
// of node k-1 (node 0: 0, 0). Nodes k >= K are pads: finite, never a best.
enum { F_MM = 5, F_IM, F_MD, F_MI, F_II, F_S, F_SP, F_DM };

template <int P>
__global__ void __launch_bounds__(32)
viterbi_warp_kernel(const float* __restrict__ ms,      // [K, 4] match log-odds
                    const float* __restrict__ tr,      // [K, 7] MM MI MD IM II DM DD
                    const float* __restrict__ S,       // [K] D->D prefix sums
                    const uint8_t* __restrict__ seqs,  // [B, L] codes, 4 = N / pad
                    const int* __restrict__ lens,      // [B]
                    int K, int L,
                    float* __restrict__ best_out, int* __restrict__ bpos_out,
                    int* __restrict__ bnode_out)
{
  constexpr bool REG = P <= 4;             // transitions in registers
  __shared__ float s_tab[NF * P * 32];
  const int lane = threadIdx.x;
  for (int p = 0; p < P; ++p) {
    const int k = lane * P + p;
    const bool in = k < K, pr = in && k > 0;
    float* t = s_tab + p * 32 + lane;
    for (int c = 0; c < 4; ++c) t[c * P * 32] = in ? ms[k * 4 + c] : 0.f;
    t[4 * P * 32] = 0.f;
    t[F_MM * P * 32] = pr ? tr[(k - 1) * 7 + 0] : NEG;
    t[F_IM * P * 32] = pr ? tr[(k - 1) * 7 + 3] : NEG;
    t[F_MD * P * 32] = pr ? tr[(k - 1) * 7 + 2] : 0.f;
    t[F_MI * P * 32] = in ? tr[k * 7 + 1] : NEG;
    t[F_II * P * 32] = in ? tr[k * 7 + 4] : NEG;
    t[F_S * P * 32] = in ? S[k] : 0.f;
    t[F_SP * P * 32] = pr ? S[k - 1] : 0.f;
    t[F_DM * P * 32] = pr ? tr[(k - 1) * 7 + 5] : 0.f;
  }
  __syncthreads();
  float tb[NF - F_MM][REG ? P : 1];
  if constexpr (REG) {
#pragma unroll
    for (int f = F_MM; f < NF; ++f)
#pragma unroll
      for (int p = 0; p < P; ++p)
        tb[f - F_MM][p] = s_tab[(f * P + p) * 32 + lane];
  }
  auto T = [&](int f, int p) -> float {
    if constexpr (REG) return tb[f - F_MM][p];
    else return s_tab[(f * P + p) * 32 + lane];
  };

  const int b = blockIdx.x;
  const int len = lens[b];
  const uint8_t* seq = seqs + (size_t)b * L;
  const int last = len + (K + P - 1) / P - 1;   // the last node's lane ends
  float M[P], I[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    M[p] = NEG;
    I[p] = NEG;
  }
  float vlast = NEG;              // v of this lane's last node, latest step
  float Mlo = NEG, Ilo = NEG;     // M, I of node lane*P-1, position j-1
  float lb = NEG;                 // this lane's best, its position and node
  int lpos = 0, lnode = 0;
  uint32_t blk = lane < len ? seq[lane] : 4u;
  uint32_t nblk = 32 + lane < len ? seq[32 + lane] : 4u;
  uint32_t cur = 4u;              // code of this lane's position
  for (int s = 1; s <= last; ++s) {
    const int q = (s - 1) & 31;   // lane 0's code: seq[s - 1]
    const uint32_t got = __shfl_sync(FULL, cur | (blk << 8), lane ? lane - 1 : q);
    const float vin = __shfl_up_sync(FULL, vlast, 1);
    const float Min = __shfl_up_sync(FULL, M[P - 1], 1);
    const float Iin = __shfl_up_sync(FULL, I[P - 1], 1);
    if (q == 31) {                // next block of 32 positions
      blk = nblk;
      const int jj = s + 32 + lane;
      nblk = jj < len ? seq[jj] : 4u;
    }
    const uint32_t c = min(lane ? got & 0xffu : got >> 8, 4u);
    const int j = s - lane;
    if (j >= 1 && j <= len) {
      float v = lane ? vin : NEG;   // v of node k-1 at position j
      float Mn[P], In[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float pM = p ? M[p - 1] : Mlo;
        const float pI = p ? I[p - 1] : Ilo;
        const float dsh = (v + T(F_SP, p)) + T(F_DM, p);
        const float ve = (pM + T(F_MD, p)) - T(F_S, p);
        const float fromM = pM + T(F_MM, p);
        const float fromI = pI + T(F_IM, p);
        const float cand = fmaxf(fmaxf(fmaxf(fromM, fromI), 0.f), dsh);
        Mn[p] = cand + s_tab[(c * P + p) * 32 + lane];
        In[p] = fmaxf(M[p] + T(F_MI, p), I[p] + T(F_II, p));
        v = fmaxf(v, ve);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        M[p] = Mn[p];
        I[p] = In[p];
        if (lane * P + p < K && M[p] > lb) {
          lb = M[p];
          lpos = j;
          lnode = lane * P + p;
        }
      }
      vlast = v;
    }
    Mlo = lane ? Min : NEG;
    Ilo = lane ? Iin : NEG;
    cur = c;
  }
  // the lanes' candidates: max score, then first position, then first node
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float ob = __shfl_xor_sync(FULL, lb, d);
    const int op = __shfl_xor_sync(FULL, lpos, d);
    const int on = __shfl_xor_sync(FULL, lnode, d);
    if (ob > lb || (ob == lb && (op < lpos || (op == lpos && on < lnode)))) {
      lb = ob;
      lpos = op;
      lnode = on;
    }
  }
  if (lane == 0) {
    best_out[b] = lb;
    bpos_out[b] = lpos;
    bnode_out[b] = lnode;
  }
}

template <int P>
__global__ void __launch_bounds__(MAXT)
viterbi_kernel(const float* __restrict__ ms,      // [K, 4] match log-odds
               const float* __restrict__ tr,      // [K, 7] MM MI MD IM II DM DD
               const float* __restrict__ S,       // [K] D->D prefix sums
               const uint8_t* __restrict__ seqs,  // [B, L] codes, 4 = N / pad
               const int* __restrict__ lens,      // [B]
               int K, int L,
               float* __restrict__ best_out, int* __restrict__ bpos_out,
               int* __restrict__ bnode_out)
{
  extern __shared__ float sm[];
  __shared__ float w_tot[MAXT / 32];   // each warp's scan total
  __shared__ float w_best[MAXT / 32];  // each warp's max of Mn
  __shared__ int w_node[MAXT / 32];    // ... and its first node
  __shared__ float w_M[MAXT / 32];     // each warp's last node: M, I
  __shared__ float w_I[MAXT / 32];
  const int NT = blockDim.x;
  const int NP = P * NT;
  float* s_em = sm;                    // [5][NP], code 4 emits 0
  float* s_mm = s_em + 5 * NP;
  float* s_mi = s_mm + NP;
  float* s_md = s_mi + NP;
  float* s_im = s_md + NP;
  float* s_ii = s_im + NP;
  float* s_dm = s_ii + NP;
  float* s_S = s_dm + NP;
  // node k = t * P + p lives at slot p * NT + t
  for (int k = threadIdx.x; k < NP; k += NT) {
    const int s = (k % P) * NT + k / P;
    const bool in = k < K;
    for (int c = 0; c < 4; ++c) s_em[c * NP + s] = in ? ms[k * 4 + c] : 0.f;
    s_em[4 * NP + s] = 0.f;
    s_mm[s] = in ? tr[k * 7 + 0] : NEG;
    s_mi[s] = in ? tr[k * 7 + 1] : NEG;
    s_md[s] = in ? tr[k * 7 + 2] : NEG;
    s_im[s] = in ? tr[k * 7 + 3] : NEG;
    s_ii[s] = in ? tr[k * 7 + 4] : NEG;
    s_dm[s] = in ? tr[k * 7 + 5] : NEG;
    s_S[s] = in ? S[k] : 0.f;
  }
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = NT >> 5;
  if (lane == 31) {
    w_M[w] = NEG;
    w_I[w] = NEG;
  }
  __syncthreads();

  const int b = blockIdx.x;
  const int len = lens[b];
  const uint8_t* seq = seqs + (size_t)b * L;
  float M[P], I[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    M[p] = NEG;
    I[p] = NEG;
  }
  float best = NEG;
  int bpos = 0, bnode = 0;
  // slot of node t*P - 1 (the previous thread's last node)
  const int sprev = (P - 1) * NT + t - 1;

  for (int j = 1; j <= len; ++j) {
    const int c = min((int)seq[j - 1], 4);
    float pm = __shfl_up_sync(FULL, M[P - 1], 1);
    float pi = __shfl_up_sync(FULL, I[P - 1], 1);
    if (lane == 0) {
      pm = w ? w_M[w - 1] : NEG;
      pi = w ? w_I[w - 1] : NEG;
    }
    // v = entry - S with entry[k] = M[k-1] + MD[k-1] (NEG at node 0),
    // then its inclusive max-scan over the nodes
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = t * P + p;
      const float entry = k == 0 ? NEG
          : (p ? M[p - 1] : pm) + s_md[p ? (p - 1) * NT + t : sprev];
      v[p] = entry - s_S[p * NT + t];
      if (p) v[p] = fmaxf(v[p], v[p - 1]);
    }
    float tot = v[P - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(FULL, tot, d);
      if (lane >= d) tot = fmaxf(tot, o);
    }
    if (lane == 31) w_tot[w] = tot;
    float excl = __shfl_up_sync(FULL, tot, 1);
    __syncthreads();
    float wpre = -CUDART_INF_F;
    for (int u = 0; u < w; ++u) wpre = fmaxf(wpre, w_tot[u]);
    excl = lane ? fmaxf(excl, wpre) : wpre;   // max over nodes < t*P
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = fmaxf(v[p], excl);

    float mloc = -CUDART_INF_F;
    int kloc = 0;
    float Mn[P], In[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = t * P + p;
      const int sk = p * NT + t;
      float fromM, fromI, dsh;
      if (k == 0) {                      // shift1 fills node 0 with NEG
        fromM = NEG + NEG;
        fromI = NEG + NEG;
        dsh = NEG;
      } else {
        const int sp = p ? (p - 1) * NT + t : sprev;
        fromM = (p ? M[p - 1] : pm) + s_mm[sp];
        fromI = (p ? I[p - 1] : pi) + s_im[sp];
        dsh = ((p ? v[p - 1] : excl) + s_S[sp]) + s_dm[sp];
      }
      const float cand = fmaxf(fmaxf(fmaxf(fromM, fromI), 0.f), dsh);
      Mn[p] = cand + s_em[c * NP + sk];
      In[p] = fmaxf(M[p] + s_mi[sk], I[p] + s_ii[sk]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      M[p] = Mn[p];
      I[p] = In[p];
      if (t * P + p < K && M[p] > mloc) {
        mloc = M[p];
        kloc = t * P + p;
      }
    }
    // warp max with the first node on ties
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float om = __shfl_down_sync(FULL, mloc, d);
      const int ok = __shfl_down_sync(FULL, kloc, d);
      if (om > mloc || (om == mloc && ok < kloc)) {
        mloc = om;
        kloc = ok;
      }
    }
    if (lane == 0) {
      w_best[w] = mloc;
      w_node[w] = kloc;
    }
    if (lane == 31) {
      w_M[w] = M[P - 1];
      w_I[w] = I[P - 1];
    }
    __syncthreads();
    if (t == 0) {
      float mb = w_best[0];
      int nb = w_node[0];
      for (int u = 1; u < nw; ++u) {
        if (w_best[u] > mb) {            // warps hold ascending nodes
          mb = w_best[u];
          nb = w_node[u];
        }
      }
      if (mb > best) {
        best = mb;
        bpos = j;
        bnode = nb;
      }
    }
  }
  if (t == 0) {
    best_out[b] = best;
    bpos_out[b] = bpos;
    bnode_out[b] = bnode;
  }
}

template <int P>
static int launch(const void* ms, const void* tr, const void* S,
                  const void* seqs, const void* lens, int K, int B, int L,
                  void* best, void* bpos, void* bnode, cudaStream_t stream) {
  const int per = (K + P - 1) / P;
  const int NT = ((per + 31) / 32) * 32;
  const size_t smem = (size_t)12 * P * NT * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_kernel<P><<<B, NT, smem, stream>>>(
      (const float*)ms, (const float*)tr, (const float*)S,
      (const uint8_t*)seqs, (const int*)lens, K, L, (float*)best,
      (int*)bpos, (int*)bnode);
  return (int)cudaGetLastError();
}

template <int P>
static int launch_warp(const void* ms, const void* tr, const void* S,
                       const void* seqs, const void* lens, int K, int B, int L,
                       void* best, void* bpos, void* bnode, cudaStream_t stream) {
  viterbi_warp_kernel<P><<<B, 32, 0, stream>>>(
      (const float*)ms, (const float*)tr, (const float*)S,
      (const uint8_t*)seqs, (const int*)lens, K, L, (float*)best,
      (int*)bpos, (int*)bnode);
  return (int)cudaGetLastError();
}

extern "C" int orc_viterbi(const void* ms, const void* tr, const void* S,
                           const void* seqs, const void* lens, int K, int B,
                           int L, int design, void* best, void* bpos,
                           void* bnode, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == DESIGN_WARP) {
#define ORC_VITERBI_WARP(PP)                                              \
  if (K <= PP * 32)                                                       \
    return launch_warp<PP>(ms, tr, S, seqs, lens, K, B, L, best, bpos,    \
                           bnode, s);
    ORC_VITERBI_WARP(1)
    ORC_VITERBI_WARP(2)
    ORC_VITERBI_WARP(3)
    ORC_VITERBI_WARP(4)
    ORC_VITERBI_WARP(6)
    ORC_VITERBI_WARP(8)
    ORC_VITERBI_WARP(12)
    ORC_VITERBI_WARP(16)
#undef ORC_VITERBI_WARP
    return (int)cudaErrorInvalidValue;
  }
  if (design != DESIGN_BLOCK) return (int)cudaErrorInvalidValue;
#define ORC_VITERBI_CASE(PP)                                              \
  if (K <= PP * MAXT)                                                     \
    return launch<PP>(ms, tr, S, seqs, lens, K, B, L, best, bpos, bnode, s);
  ORC_VITERBI_CASE(1)
  ORC_VITERBI_CASE(2)
  ORC_VITERBI_CASE(4)
  ORC_VITERBI_CASE(8)
  ORC_VITERBI_CASE(16)
#undef ORC_VITERBI_CASE
  return (int)cudaErrorInvalidValue;
}
