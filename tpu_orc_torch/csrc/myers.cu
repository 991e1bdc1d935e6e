// Myers/Hyyro bit-parallel edit distance, patterns x texts, NW/SHW/HW.
//
// Replaces the Pallas kernels tpu_orc/align/pallas_myers.py::_kernel
// (line 56, dense grid, launched by myers_tile_pallas at :164/:222) and
// ::_kernel_pairs (:242, listed tile pairs, myers_tile_pallas_pairs
// :256/:308). Outputs per pair: distance and text end position.
//
// What bounds it on this card: integer ALU work and the serial word chain
// (the horizontal delta of word w feeds word w+1 in the same column, and
// each column needs the previous one), not bytes: a text is one byte per
// column and every byte feeds ~20 word operations per pattern word.
//
// Two designs compute the same recurrence; align/myers.py::choose_design
// picks one from the launch's shape (pairs launched, W). Both serve both
// entry points and all three modes, with the same outputs bit for bit.
//
// Thread design: one thread per (pattern, text) pair. A block is 8
// patterns x 32 texts; the 8 patterns' Peq words sit in shared memory and
// the warp's 32 threads share one pattern, so Peq reads broadcast. Each
// thread walks its whole text and stops its word loop at the word holding
// row m; VP/VN sit in a stack frame in local memory from 16 words up. Its
// time is one thread's serial chain of ncols x nw dependent word steps, so
// it is fast only when many pairs fill the card: at W <= 32 and ~16,000
// pairs or more (the COI gene stage's 1000 x 1000 block: 17 ms on an H100,
// 1.8x its operations bound) it beats the warp design, which there wastes
// its idle lanes (W 17 fills 17 of 32) and its per-step shuffles. It stays
// for those launches. At the rRNA bins' W ~ 112 a launch has 256-4,096
// pairs: a few warps walked ~3,400 columns x ~107 words each through local
// memory, ~75 ms a launch on an H100.
//
// Warp design: one warp per pair. Lane l owns pattern words
// [l*WPL, (l+1)*WPL) (WPL 1-16 words per lane for W up to 512) and keeps
// their VP/VN and Peq (four bit-planes per word, see peq_bits) in
// registers: no shared memory, no stack. At step s lane l updates its words
// for text column j = s - l. The carry out of its top word (bit 31 of PH/MH
// before the shift) goes to lane l+1 with one __shfl_up_sync, packed with
// the code of lane l's next column, which is lane l+1's column a step
// later: so every lane knows its code a step ahead and looks up its Peq
// words while the carry is in flight, and the step is branch-free (an idle
// lane computes and does not commit). Lane 0 takes the top row's delta and
// its codes from 32 columns loaded once per 32 steps (lane k loads column
// base+k: [N, T] is strided per text), passed by a broadcast shuffle. The
// lane that owns row m keeps the score (and best/bpos, strict < at the
// earliest column); lanes above it stay idle, and the warp stops at step
// ncols + lane(row m). Blocks hold 4 warps, so a launch of a few hundred
// pairs puts one warp on each scheduler of as many SMs. What bounds it is
// the step's latency: one instruction stream of ~30 + ~25 WPL instructions
// per step, mostly dependent (the WPL-word carry chain and the shuffle):
// ~165 ns a step at WPL 4 on an H100 (0.60 ms for the ~3,600 steps of an
// rRNA read). With few pairs the card is mostly idle; that is the price of
// a serial DP over one text.
//
// Texts are stored [N, T] so a warp of the thread design loads 32
// neighbouring bytes per column. The pairs entry point maps blockIdx.x to
// a listed (tile_i, tile_j) and blockIdx.y to a part of that tile;
// unlisted tiles are not written.
#include <cstdint>
#include <cuda_runtime.h>

#define BT 32     // thread design: texts per block (threadIdx.x)
#define BP 8      // thread design: patterns per block (threadIdx.y)
#define WARPS 4   // warp design: warps (pairs) per block
#define NCHAN 8   // channel stride of the packed Peq (0..4 used)
#define FULL 0xffffffffu

enum { MODE_NW = 0, MODE_SHW = 1, MODE_HW = 2 };
enum { DESIGN_THREAD = 0, DESIGN_WARP = 1 };

template <int MAXW>
__global__ void __launch_bounds__(BT * BP)
myers_kernel(const uint32_t* __restrict__ peq,    // [P, W * NCHAN]
             const int* __restrict__ mlen,        // [P]
             const uint8_t* __restrict__ texts,   // [N, T] codes 0..4, pad 5
             const int* __restrict__ nlen,        // [T]
             int P, int T, int N, int W, int mode,
             const int* __restrict__ tile_i,      // [G] or null (dense)
             const int* __restrict__ tile_j,
             int TI, int TJ,
             int* __restrict__ dist, int* __restrict__ pos)  // [P, T]
{
  extern __shared__ uint32_t s_peq[];             // [BP][W][5]
  int p0, t0;
  if (tile_i != nullptr) {
    const int nsx = TJ / BT;
    const int sub = blockIdx.y;
    p0 = tile_i[blockIdx.x] * TI + (sub / nsx) * BP;
    t0 = tile_j[blockIdx.x] * TJ + (sub % nsx) * BT;
  } else {
    p0 = blockIdx.y * BP;
    t0 = blockIdx.x * BT;
  }
  const int tid = threadIdx.y * BT + threadIdx.x;
  for (int k = tid; k < BP * W * 5; k += BP * BT) {
    const int pp = k / (W * 5);
    const int rem = k - pp * (W * 5);
    const int w = rem / 5;
    const int ch = rem - w * 5;
    const int p = p0 + pp;
    s_peq[k] = p < P ? peq[(size_t)p * W * NCHAN + w * NCHAN + ch] : 0u;
  }
  __syncthreads();
  const int p = p0 + threadIdx.y;
  const int t = t0 + threadIdx.x;
  if (p >= P || t >= T) return;

  const uint32_t* my = s_peq + threadIdx.y * W * 5;
  const int m = mlen[p];
  const int nl = nlen[t];
  // row m lives in word wl at bit r; rows above it never influence it
  const int wl = m >= 1 ? (m - 1) / 32 : -1;
  const int r = m >= 1 ? (m - 1) % 32 : 0;
  const bool track = wl >= 0 && wl < W;
  const int nw = track ? wl + 1 : 0;
  const uint32_t hin0 = mode == MODE_HW ? 0u : 1u;
  const int ncols = nl < N ? nl : N;

  uint32_t vp[MAXW], vn[MAXW];
#pragma unroll (MAXW <= 32 ? MAXW : 1)
  for (int w = 0; w < MAXW; ++w) {
    vp[w] = 0xFFFFFFFFu;
    vn[w] = 0u;
  }
  int score = m, best = m, bpos = 0;
  if (nw > 0) {
    for (int j = 0; j < ncols; ++j) {
      const int c = texts[(size_t)j * T + t];
      uint32_t hp = hin0, hm = 0u;
      int d = 0;
#pragma unroll (MAXW <= 32 ? MAXW : 1)
      for (int w = 0; w < MAXW; ++w) {
        if (w >= nw) break;
        const uint32_t eq = c < 5 ? my[w * 5 + c] : 0u;
        const uint32_t pv = vp[w], mv = vn[w];
        const uint32_t xv = eq | mv;
        const uint32_t e2 = eq | hm;
        const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
        uint32_t ph = mv | ~(xh | pv);
        uint32_t mh = pv & xh;
        if (w == wl) d = (int)((ph >> r) & 1u) - (int)((mh >> r) & 1u);
        const uint32_t hpo = ph >> 31, hmo = mh >> 31;
        ph = (ph << 1) | hp;
        mh = (mh << 1) | hm;
        vp[w] = mh | ~(xv | ph);
        vn[w] = ph & xv;
        hp = hpo;
        hm = hmo;
      }
      score += d;
      if (mode != MODE_NW && score < best) {
        best = score;
        bpos = j + 1;
      }
    }
  }
  const size_t o = (size_t)p * T + t;
  if (mode == MODE_NW) {
    dist[o] = score;
    pos[o] = nl;
  } else {
    dist[o] = best;
    pos[o] = bpos;
  }
}

// The warp design's Peq words in registers, as four bit-planes per word
// instead of five channels (build_peq_packed puts each row in at most one
// channel): pb[0] the valid rows (codes 0..4), pb[1..3] bits 0..2 of each
// row's code. Text code c then matches the valid rows whose code bits all
// equal c's: three LOP3s per word. Pad (5) matches no valid row, as no row
// code 0..4 has bits 101.
template <int WPL>
__device__ __forceinline__ void peq_bits(const uint32_t (&ch)[5],
                                         uint32_t (&pb)[4][WPL], int q) {
  pb[0][q] = ch[0] | ch[1] | ch[2] | ch[3] | ch[4];
  pb[1][q] = ch[1] | ch[3];
  pb[2][q] = ch[2] | ch[3];
  pb[3][q] = ch[4];
}

template <int WPL>
__device__ __forceinline__ void peq_lookup(int c, const uint32_t (&pb)[4][WPL],
                                           uint32_t (&eq)[WPL]) {
  const uint32_t m0 = 0u - (uint32_t)(c & 1);
  const uint32_t m1 = 0u - (uint32_t)((c >> 1) & 1);
  const uint32_t m2 = 0u - (uint32_t)((c >> 2) & 1);
#pragma unroll
  for (int q = 0; q < WPL; ++q)
    eq[q] = pb[0][q] & ~(pb[1][q] ^ m0) & ~(pb[2][q] ^ m1) & ~(pb[3][q] ^ m2);
}

template <int WPL>
__global__ void __launch_bounds__(WARPS * 32)
myers_warp_kernel(const uint32_t* __restrict__ peq,    // [P, W * NCHAN]
                  const int* __restrict__ mlen,        // [P]
                  const uint8_t* __restrict__ texts,   // [N, T]
                  const int* __restrict__ nlen,        // [T]
                  int P, int T, int N, int W, int mode,
                  const int* __restrict__ tile_i,      // [G] or null
                  const int* __restrict__ tile_j,
                  int TI, int TJ,
                  int* __restrict__ dist, int* __restrict__ pos)
{
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  int p, t;                                        // the same on every lane
  if (tile_i != nullptr) {
    const int e = blockIdx.y * WARPS + wi;         // pair within the tile
    p = tile_i[blockIdx.x] * TI + e / TJ;
    t = tile_j[blockIdx.x] * TJ + e % TJ;
  } else {
    const long long e = (long long)blockIdx.x * WARPS + wi;
    if (e >= (long long)P * T) return;
    p = (int)(e / T);
    t = (int)(e - (long long)p * T);
  }
  const int m = mlen[p];
  const int nl = nlen[t];
  const int wl = m >= 1 ? (m - 1) / 32 : -1;
  const int r = m >= 1 ? (m - 1) % 32 : 0;
  const bool track = wl >= 0 && wl < W;
  const int ncols = nl < N ? nl : N;
  const int lw = track ? wl / WPL : 0;             // the lane of row m
  int score = m, best = m, bpos = 0;
  if (track && ncols > 0) {
    const int kl = wl - lw * WPL;                  // row m's word in lw
    const uint32_t* pp = peq + (size_t)p * W * NCHAN;
    uint32_t pb[4][WPL], vp[WPL], vn[WPL];
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      const int w = lane * WPL + q;
      uint32_t ch[5];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        ch[k] = lane <= lw && w < W ? pp[w * NCHAN + k] : 0u;
      peq_bits(ch, pb, q);
      vp[q] = 0xFFFFFFFFu;
      vn[q] = 0u;
    }
    const uint32_t hin0 = mode == MODE_HW ? 0u : 1u;
    const uint8_t* tx = texts + t;                 // column j at tx[j * T]
    int cur = lane < ncols ? tx[(size_t)lane * T] : 5;
    int nxt = 32 + lane < ncols ? tx[(size_t)(32 + lane) * T] : 5;
    // cn: this lane's code at its next step. Lane l + 1 works on lane l's
    // column one step later, so the link carries lane l's cn (bits 2-4)
    // beside its carry out (bits 0-1): a lane knows each step's code a
    // step ahead and looks up its Peq words before the carry arrives.
    const int c00 = __shfl_sync(FULL, cur, 0);
    int cn = lane == 0 ? c00 : 5;
    int link = cn << 2;
    const int steps = ncols + lw;
    for (int s = 0; s < steps; ++s) {
      const int sn = s + 1;                        // lane 0's next column
      if ((sn & 31) == 0) {                        // columns sn .. sn + 31
        cur = nxt;
        const int jn = sn + 32 + lane;
        nxt = jn < ncols ? tx[(size_t)jn * T] : 5;
      }
      const int c0n = __shfl_sync(FULL, cur, sn & 31);
      uint32_t eq[WPL];
      peq_lookup(cn, pb, eq);
      const int in = __shfl_up_sync(FULL, link, 1);
      cn = lane == 0 ? c0n : in >> 2;
      const int j = s - lane;
      const bool on = lane <= lw && j >= 0 && j < ncols;
      uint32_t hp = lane == 0 ? hin0 : (uint32_t)in & 1u;
      uint32_t hm = lane == 0 ? 0u : (uint32_t)(in >> 1) & 1u;
      uint32_t phk = 0u, mhk = 0u;                // row m's word's deltas
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        const uint32_t pv = vp[q], mv = vn[q];
        const uint32_t xv = eq[q] | mv;
        const uint32_t e2 = eq[q] | hm;
        const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
        uint32_t ph = mv | ~(xh | pv);
        uint32_t mh = pv & xh;
        phk = q == kl ? ph : phk;
        mhk = q == kl ? mh : mhk;
        const uint32_t hpo = ph >> 31, hmo = mh >> 31;
        ph = (ph << 1) | hp;
        mh = (mh << 1) | hm;
        vp[q] = on ? mh | ~(xv | ph) : pv;
        vn[q] = on ? ph & xv : mv;
        hp = hpo;
        hm = hmo;
      }
      link = cn << 2 | (int)hp | (int)(hm << 1);
      if (on && lane == lw) {
        score += (int)((phk >> r) & 1u) - (int)((mhk >> r) & 1u);
        if (mode != MODE_NW && score < best) {
          best = score;
          bpos = j + 1;
        }
      }
    }
  }
  if (lane == lw) {
    const size_t o = (size_t)p * T + t;
    if (mode == MODE_NW) {
      dist[o] = score;
      pos[o] = nl;
    } else {
      dist[o] = best;
      pos[o] = bpos;
    }
  }
}

template <int MAXW>
static int launch(const void* peq, const void* mlen, const void* texts,
                  const void* nlen, int P, int T, int N, int W, int mode,
                  const void* tile_i, const void* tile_j, int G, int TI,
                  int TJ, void* dist, void* pos, cudaStream_t stream) {
  const size_t smem = (size_t)BP * W * 5 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        myers_kernel<MAXW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 block(BT, BP);
  dim3 grid;
  if (tile_i != nullptr) {
    grid = dim3(G, (TI / BP) * (TJ / BT));
  } else {
    grid = dim3((T + BT - 1) / BT, (P + BP - 1) / BP);
  }
  myers_kernel<MAXW><<<grid, block, smem, stream>>>(
      (const uint32_t*)peq, (const int*)mlen, (const uint8_t*)texts,
      (const int*)nlen, P, T, N, W, mode, (const int*)tile_i,
      (const int*)tile_j, TI, TJ, (int*)dist, (int*)pos);
  return (int)cudaGetLastError();
}

template <int WPL>
static int launch_warp(const void* peq, const void* mlen, const void* texts,
                       const void* nlen, int P, int T, int N, int W, int mode,
                       const void* tile_i, const void* tile_j, int G, int TI,
                       int TJ, void* dist, void* pos, cudaStream_t stream) {
  dim3 grid;
  if (tile_i != nullptr) {
    grid = dim3(G, TI * TJ / WARPS);
  } else {
    const long long pairs = (long long)P * T;
    grid = dim3((unsigned)((pairs + WARPS - 1) / WARPS));
  }
  myers_warp_kernel<WPL><<<grid, WARPS * 32, 0, stream>>>(
      (const uint32_t*)peq, (const int*)mlen, (const uint8_t*)texts,
      (const int*)nlen, P, T, N, W, mode, (const int*)tile_i,
      (const int*)tile_j, TI, TJ, (int*)dist, (int*)pos);
  return (int)cudaGetLastError();
}

// G == 0 and tile_i == null: dense grid over all [P, T] pairs.
// G > 0: one grid row per listed tile (tile_i[g], tile_j[g]) of TI x TJ.
// design: DESIGN_THREAD or DESIGN_WARP.
extern "C" int orc_myers(const void* peq, const void* mlen, const void* texts,
                         const void* nlen, int P, int T, int N, int W,
                         int mode, const void* tile_i, const void* tile_j,
                         int G, int TI, int TJ, int design, void* dist,
                         void* pos, void* stream) {
  if (P == 0 || T == 0) return (int)cudaSuccess;
  if (tile_i != nullptr && (G == 0 || TI % BP != 0 || TJ % BT != 0))
    return G == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == DESIGN_WARP) {
#define ORC_MYERS_WARP_CASE(WPL)                                           \
  if (W <= 32 * WPL)                                                       \
    return launch_warp<WPL>(peq, mlen, texts, nlen, P, T, N, W, mode,      \
                            tile_i, tile_j, G, TI, TJ, dist, pos, s);
    ORC_MYERS_WARP_CASE(1)
    ORC_MYERS_WARP_CASE(2)
    ORC_MYERS_WARP_CASE(4)
    ORC_MYERS_WARP_CASE(8)
    ORC_MYERS_WARP_CASE(16)
#undef ORC_MYERS_WARP_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (design != DESIGN_THREAD) return (int)cudaErrorInvalidValue;
#define ORC_MYERS_CASE(MW)                                                 \
  if (W <= MW)                                                             \
    return launch<MW>(peq, mlen, texts, nlen, P, T, N, W, mode, tile_i,    \
                      tile_j, G, TI, TJ, dist, pos, s);
  ORC_MYERS_CASE(4)
  ORC_MYERS_CASE(8)
  ORC_MYERS_CASE(16)
  ORC_MYERS_CASE(32)
  ORC_MYERS_CASE(64)
  ORC_MYERS_CASE(128)
  ORC_MYERS_CASE(256)
  ORC_MYERS_CASE(512)
#undef ORC_MYERS_CASE
  return (int)cudaErrorInvalidValue;
}
