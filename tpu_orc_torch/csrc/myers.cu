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
// Design: one thread per (pattern, text) pair. A block is 8 patterns x 32
// texts; the 8 patterns' Peq words sit in shared memory and the warp's 32
// threads share one pattern, so Peq reads broadcast. VP/VN (one 32-bit
// word per 32 pattern rows) live in registers for short patterns and spill
// to local memory for long ones. Each thread walks its whole text and stops
// its word loop at the word holding row m, so there is no NC_MAX chunking,
// no carry across blocks and no padding work above the pattern. Texts are
// stored [N, T] so a warp loads 32 neighbouring bytes per column. The
// pairs entry point maps blockIdx.x to a listed (tile_i, tile_j) and
// blockIdx.y to a sub-block of that tile; unlisted tiles are not written.
#include <cstdint>
#include <cuda_runtime.h>

#define BT 32     // texts per block (threadIdx.x)
#define BP 8      // patterns per block (threadIdx.y)
#define NCHAN 8   // channel stride of the packed Peq (0..4 used)

enum { MODE_NW = 0, MODE_SHW = 1, MODE_HW = 2 };

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

// G == 0 and tile_i == null: dense grid over all [P, T] pairs.
// G > 0: one grid row per listed tile (tile_i[g], tile_j[g]) of TI x TJ.
extern "C" int orc_myers(const void* peq, const void* mlen, const void* texts,
                         const void* nlen, int P, int T, int N, int W,
                         int mode, const void* tile_i, const void* tile_j,
                         int G, int TI, int TJ, void* dist, void* pos,
                         void* stream) {
  if (P == 0 || T == 0) return (int)cudaSuccess;
  if (tile_i != nullptr && (G == 0 || TI % BP != 0 || TJ % BT != 0))
    return G == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
