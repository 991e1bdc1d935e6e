// Star-alignment path bits for the consensus pileup: the Myers NW forward
// pass of every read (text) against its group's draft (pattern), storing
// per read position the four delta bit-planes over the draft words
//   plane 0/1: VP/VN after the column's update (vertical deltas),
//   plane 2/3: PH/MH before the shift (horizontal deltas).
// The O(m + n) traceback and the pileup accumulation then run on the host
// (native/oracle.cpp orc_pileup_from_bits).
//
// Replaces the Pallas kernels tpu_orc/align/pallas_pileup.py::_kernel (line
// 38, one draft, launched by _path_bits_call at :92) and ::_kernel_multi
// (:132, many groups in one launch, :209). One entry point serves both: a
// tile -> group map; the single-draft contract is the case G = 1.
//
// Contract, bit for bit with the Pallas kernels on the region the traceback
// reads: read positions j < nlen[t] and words w < dwords[g] (the draft's
// ceil(len / 32)). VP starts as all ones and VN as zeros; the horizontal
// delta into word 0 is +1 in every column (NW: the top row counts up); the
// carry between words is bit 31 of PH/MH before the shift; text code 5
// (pad) matches no channel, code 4 (N) matches N in the draft. Outside that
// region the output is left unwritten (the Pallas kernels also fill words
// above a short draft and positions past a read's end).
//
// What bounds it on this card: per read base, the kernel stores 16 bytes per
// draft word (4 planes x 32 bits) and does ~20 integer operations per word,
// so the bytes bound it (12.8 MB per pass for 100 reads x 500 bp x 16
// words: ~4 us at 3.35 TB/s). A pass has only 50-100 reads, though, so in
// practice the serial chain of N x W dependent word steps of one thread
// sets the time, not either bound.
//
// Design: one thread per read walks its whole read, so nothing carries
// across blocks (the Pallas kernel streamed [NC, 4, W, TJ] blocks over a
// sequential chunk axis and kept VP/VN in VMEM scratch). A tile is TR reads
// of one group (the host pads each group to a multiple of TR); a block is
// TPB tiles, and their drafts' Peq words (W x 5 channels each) sit in
// shared memory. VP/VN live in registers up to 32 words (the word loop is
// unrolled) and in local memory above. Texts are [N, T], so a warp loads 32
// neighbouring bytes per column. The output is per read, [T, N, 4, W]:
// exactly the layout orc_pileup_from_bits reads, so the planes go to the
// host in one copy with no transpose, at the cost of stores that are not
// coalesced across the warp (each thread writes 16 W contiguous bytes per
// column). A lane-per-read layout would coalesce the stores but need a
// transpose before the host can use it.
#include <cstdint>
#include <cuda_runtime.h>

#define TR 8            // reads per tile, all of one group
#define TPB 4           // tiles per block
#define BT (TR * TPB)   // threads per block, one read each
#define NCHAN 8         // channel stride of the packed Peq (0..4 used)

__device__ __forceinline__ void word_step(uint32_t eq, uint32_t& vp,
                                          uint32_t& vn, uint32_t& hp,
                                          uint32_t& hm, uint32_t* o, int W,
                                          int w) {
  const uint32_t pv = vp, mv = vn;
  const uint32_t xv = eq | mv;
  const uint32_t e2 = eq | hm;
  const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  o[2 * W + w] = ph;                     // pre-shift horizontal deltas
  o[3 * W + w] = mh;
  const uint32_t hpo = ph >> 31, hmo = mh >> 31;
  ph = (ph << 1) | hp;
  mh = (mh << 1) | hm;
  vp = mh | ~(xv | ph);
  vn = ph & xv;
  o[w] = vp;                             // post-update vertical deltas
  o[W + w] = vn;
  hp = hpo;
  hm = hmo;
}

template <int MAXW>
__global__ void __launch_bounds__(BT)
pileup_kernel(const uint32_t* __restrict__ peqs,   // [G, W * NCHAN]
              const int* __restrict__ dwords,      // [G]
              const int* __restrict__ tile_gid,    // [T / TR]
              const uint8_t* __restrict__ texts,   // [N, T] codes 0..4, pad 5
              const int* __restrict__ nlen,        // [T]
              int T, int N, int W,
              uint32_t* __restrict__ planes)       // [T, N, 4, W]
{
  extern __shared__ uint32_t s_peq[];              // [TPB][W][5]
  const int ntiles = T / TR;
  const int tile0 = blockIdx.x * TPB;
  for (int k = threadIdx.x; k < TPB * W * 5; k += BT) {
    const int tl = k / (W * 5);
    const int rem = k - tl * (W * 5);
    const int w = rem / 5;
    const int ch = rem - w * 5;
    const int tile = tile0 + tl;
    s_peq[k] = tile < ntiles
        ? peqs[(size_t)tile_gid[tile] * W * NCHAN + w * NCHAN + ch] : 0u;
  }
  __syncthreads();
  const int t = blockIdx.x * BT + threadIdx.x;
  if (t >= T) return;
  const int g = tile_gid[t / TR];
  const int nw = dwords[g] < W ? dwords[g] : W;
  const int ncols = nlen[t] < N ? nlen[t] : N;
  const uint32_t* my = s_peq + (threadIdx.x / TR) * W * 5;
  uint32_t* out = planes + (size_t)t * N * 4 * W;

  uint32_t vp[MAXW], vn[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    vp[w] = 0xFFFFFFFFu;
    vn[w] = 0u;
  }
  for (int j = 0; j < ncols; ++j) {
    const int c = texts[(size_t)j * T + t];
    uint32_t* o = out + (size_t)j * 4 * W;
    uint32_t hp = 1u, hm = 0u;
    if constexpr (MAXW <= 32) {
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        if (w >= nw) break;
        word_step(c < 5 ? my[w * 5 + c] : 0u, vp[w], vn[w], hp, hm, o, W,
                  w);
      }
    } else {
      for (int w = 0; w < nw; ++w)
        word_step(c < 5 ? my[w * 5 + c] : 0u, vp[w], vn[w], hp, hm, o, W,
                  w);
    }
  }
}

template <int MAXW>
static int launch(const void* peqs, const void* dwords, const void* tile_gid,
                  const void* texts, const void* nlen, int T, int N, int W,
                  void* planes, cudaStream_t stream) {
  const size_t smem = (size_t)TPB * W * 5 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pileup_kernel<MAXW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (T + BT - 1) / BT;
  pileup_kernel<MAXW><<<blocks, BT, smem, stream>>>(
      (const uint32_t*)peqs, (const int*)dwords, (const int*)tile_gid,
      (const uint8_t*)texts, (const int*)nlen, T, N, W, (uint32_t*)planes);
  return (int)cudaGetLastError();
}

// peqs [G, W * NCHAN] uint32, dwords [G] int32, tile_gid [T / TR] int32,
// texts [N, T] uint8, nlen [T] int32 -> planes [T, N, 4, W] uint32.
// T must be a multiple of TR (the host pads each group to whole tiles).
extern "C" int orc_pileup(const void* peqs, const void* dwords,
                          const void* tile_gid, const void* texts,
                          const void* nlen, int T, int N, int W,
                          void* planes, void* stream) {
  if (T == 0 || N == 0) return (int)cudaSuccess;
  if (T % TR != 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ORC_PILEUP_CASE(MW)                                                \
  if (W <= MW)                                                             \
    return launch<MW>(peqs, dwords, tile_gid, texts, nlen, T, N, W,        \
                      planes, s);
  ORC_PILEUP_CASE(4)
  ORC_PILEUP_CASE(8)
  ORC_PILEUP_CASE(16)
  ORC_PILEUP_CASE(32)
  ORC_PILEUP_CASE(64)
  ORC_PILEUP_CASE(128)
  ORC_PILEUP_CASE(256)
  ORC_PILEUP_CASE(512)
#undef ORC_PILEUP_CASE
  return (int)cudaErrorInvalidValue;
}
