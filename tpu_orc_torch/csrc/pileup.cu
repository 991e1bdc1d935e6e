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
// so the bytes bound it (12.6 MB per pass for 100 reads x 490 bp x 16
// words: ~4 us at 3.35 TB/s). A pass has only 50-100 reads, though, so one
// read's serial chain of ~ncols + 31 steps sets the time: each step one
// lane's WPL-word carry chain, a shuffle, and the ring's stores and loads,
// in one warp's instruction stream.
//
// Design: one warp per read (the wavefront that align/pileup.py::
// path_bits_plain walks), as the warp design of csrc/myers.cu. Lane l owns
// draft words [l*WPL, (l+1)*WPL) (WPL 1-16 for W up to 512) and keeps
// their VP/VN and Peq (four bit-planes per word) in registers. At step s
// lane l updates its words for read position j = s - l; the carry out of
// its top word goes to lane l+1 with one __shfl_up_sync, packed with the
// code of lane l's next position (lane l+1's a step later), so the Peq
// lookup runs while the carry is in flight; lane 0 takes the +1 top-row
// delta and codes loaded 32 per 32 steps, passed by a broadcast shuffle.
// The planes of a position are thus made by different lanes at different
// steps, so each lane puts its 4 x WPL words into a per-warp ring in shared
// memory, and a band's 32 words of a position (the lanes that own words
// 32b..32b+31) go to planes[t, j] with one coalesced 128-byte store per
// plane once the band's top lane has made them. A band of B = 32 / WPL
// lanes has at most B positions in flight, so the ring is WPL bands x B
// slots x 4 planes x 32 words (16 KB per warp, whatever W); a band's words
// sit rotated by b within their 32-word row so that the lanes' stores into
// the ring hit 32 banks. The output is per read, [T, N, 4, W]: exactly the
// layout orc_pileup_from_bits reads, so the planes go to the host in one
// copy. Nothing carries across blocks (the Pallas kernel streamed
// [NC, 4, W, TJ] blocks over a sequential chunk axis and kept VP/VN in VMEM
// scratch).
#include <cstdint>
#include <cuda_runtime.h>

#define TR 8            // reads per tile, all of one group
#define PW 2            // warps (reads) per block
#define RING 4096       // ring words per warp: 32 slots x 4 planes x 32
#define NCHAN 8         // channel stride of the packed Peq (0..4 used)
#define FULL 0xffffffffu

// The draft's Peq words in registers, as four bit-planes per word instead
// of five channels (build_peq_packed puts each row in at most one
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
__global__ void __launch_bounds__(PW * 32)
pileup_kernel(const uint32_t* __restrict__ peqs,   // [G, W * NCHAN]
              const int* __restrict__ dwords,      // [G]
              const int* __restrict__ tile_gid,    // [T / TR]
              const uint8_t* __restrict__ texts,   // [N, T] codes 0..4, pad 5
              const int* __restrict__ nlen,        // [T]
              int T, int N, int W,
              uint32_t* __restrict__ planes)       // [T, N, 4, W]
{
  constexpr int B = 32 / WPL;                      // lanes per 32-word band
  __shared__ uint32_t s_ring[PW * RING];           // [PW][WPL][B][4][32]
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * PW + (threadIdx.x >> 5);
  if (t >= T) return;                              // the whole warp
  const int g = tile_gid[t / TR];
  const int nw = dwords[g] < W ? dwords[g] : W;
  const int ncols = nlen[t] < N ? nlen[t] : N;
  if (nw <= 0 || ncols <= 0) return;
  const int lanes = (nw + WPL - 1) / WPL;          // lanes that own words
  uint32_t* ring = s_ring + (threadIdx.x >> 5) * RING;
  const int band = lane / B;
  const int bi = lane % B;

  const uint32_t* pp = peqs + (size_t)g * W * NCHAN;
  uint32_t pb[4][WPL], vp[WPL], vn[WPL];
#pragma unroll
  for (int q = 0; q < WPL; ++q) {
    const int w = lane * WPL + q;
    uint32_t ch[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) ch[k] = w < nw ? pp[w * NCHAN + k] : 0u;
    peq_bits(ch, pb, q);
    vp[q] = 0xFFFFFFFFu;
    vn[q] = 0u;
  }
  uint32_t* out = planes + (size_t)t * N * 4 * W;
  const uint8_t* tx = texts + t;                   // position j at tx[j * T]
  int cur = lane < ncols ? tx[(size_t)lane * T] : 5;
  int nxt = 32 + lane < ncols ? tx[(size_t)(32 + lane) * T] : 5;
  // cn: this lane's code at its next step. Lane l + 1 works on lane l's
  // position one step later, so the link carries lane l's cn (bits 2-4)
  // beside its carry out (bits 0-1): a lane knows each step's code a step
  // ahead and looks up its Peq words before the carry arrives.
  const int c00 = __shfl_sync(FULL, cur, 0);
  int cn = lane == 0 ? c00 : 5;
  int link = cn << 2;
  const int steps = ncols + lanes - 1;
  for (int s = 0; s < steps; ++s) {
    const int sn = s + 1;                          // lane 0's next position
    if ((sn & 31) == 0) {                          // positions sn .. sn + 31
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
    const bool on = lane < lanes && j >= 0 && j < ncols;
    uint32_t hp = lane == 0 ? 1u : (uint32_t)in & 1u;
    uint32_t hm = lane == 0 ? 0u : (uint32_t)(in >> 1) & 1u;
    uint32_t nvp[WPL], nvn[WPL], oph[WPL], omh[WPL];
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      const uint32_t pv = vp[q], mv = vn[q];
      const uint32_t xv = eq[q] | mv;
      const uint32_t e2 = eq[q] | hm;
      const uint32_t xh = (((e2 & pv) + pv) ^ pv) | e2;
      oph[q] = mv | ~(xh | pv);                    // pre-shift horizontal
      omh[q] = pv & xh;
      const uint32_t phs = (oph[q] << 1) | hp, mhs = (omh[q] << 1) | hm;
      nvp[q] = mhs | ~(xv | phs);                  // post-update vertical
      nvn[q] = phs & xv;
      vp[q] = on ? nvp[q] : pv;
      vn[q] = on ? nvn[q] : mv;
      hp = oph[q] >> 31;
      hm = omh[q] >> 31;
    }
    if (on) {
      // this band's slot of position j; word bi*WPL+q of the band at
      // (bi*WPL + q + band) % 32 in each plane's row
      uint32_t* o = ring + (band * B + (j & (B - 1))) * 128;
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        const int x = (bi * WPL + q + band) & 31;
        o[x] = nvp[q];
        o[32 + x] = nvn[q];
        o[64 + x] = oph[q];
        o[96 + x] = omh[q];
      }
    }
    link = cn << 2 | (int)hp | (int)(hm << 1);
    __syncwarp();
    // band b's position s - top(b) is complete: its top lane made it now
#pragma unroll
    for (int b = 0; b < WPL; ++b) {
      if (b * B < lanes) {
        const int top = (b * B + B < lanes ? b * B + B : lanes) - 1;
        const int jb = s - top;
        const int w = b * 32 + lane;
        if (jb >= 0 && jb < ncols && w < nw) {
          const uint32_t* src =
              ring + (b * B + (jb & (B - 1))) * 128 + ((lane + b) & 31);
          uint32_t* dst = out + (jb * 4 * W + w);    // < N * 4 * W < 2^31
          dst[0] = src[0];
          dst[W] = src[32];
          dst[2 * W] = src[64];
          dst[3 * W] = src[96];
        }
      }
    }
    __syncwarp();
  }
}

template <int WPL>
static int launch(const void* peqs, const void* dwords, const void* tile_gid,
                  const void* texts, const void* nlen, int T, int N, int W,
                  void* planes, cudaStream_t stream) {
  const int blocks = (T + PW - 1) / PW;
  pileup_kernel<WPL><<<blocks, PW * 32, 0, stream>>>(
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
  if (T % TR != 0 || W <= 0 || (long long)N * 4 * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ORC_PILEUP_CASE(WPL)                                               \
  if (W <= 32 * WPL)                                                       \
    return launch<WPL>(peqs, dwords, tile_gid, texts, nlen, T, N, W,       \
                       planes, s);
  ORC_PILEUP_CASE(1)
  ORC_PILEUP_CASE(2)
  ORC_PILEUP_CASE(4)
  ORC_PILEUP_CASE(8)
  ORC_PILEUP_CASE(16)
#undef ORC_PILEUP_CASE
  return (int)cudaErrorInvalidValue;
}
