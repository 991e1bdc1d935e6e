// A scan batch's read match masks, built on the card in the [L, B] layout
// the locate kernels read, from the batch's bytes as they are.
//
// Replaces no TPU kernel. tpu_orc packs a batch on the host: one [B, L]
// byte matrix (io/encode.py::ascii_matrix), the lookup of each byte's
// match mask with the padding set to 0 (read_masks_matrix, or
// iupac_masks_matrix under --match-read-wildcards), and the transpose to
// [L, B] (pallas_locate.py::locate_dispatch). At stage 01's L 8,192 that
// is 16 MB a 2,048-read batch through three host passes, half of it
// padding. Here the host joins the reads' bytes and uploads them with
// their offsets and lengths; orc_pack_masks_T writes
//   out[l, b] = tab[bytes[offs[b] + l]]   for l < lens[b],
//   out[l, b] = 0                         for lens[b] <= l < L,
// which is bit for bit the host packing's [L, B] matrix.
//
// What bounds it on this card: bytes. Each read byte is read once and
// each of the L x B outputs written once (about 23 MB at L 8,192 and
// 2,048 reads of ~3.7 kb); there is one table lookup a byte.
//
// Design: a shared-memory tiled transpose. A block of 256 threads takes
// a tile of TB reads x TL columns. Each warp reads one read's run of TL
// bytes at a time, its lanes on neighbouring bytes, maps each through
// the 256-byte table held in shared memory (0 past the read's end, with
// no load there) and stores it into the tile at [column][read]. The
// block then writes the tile out row by row: the lanes of a warp store
// neighbouring reads of one column, coalesced along B. A tile row is
// padded by 4 bytes, so that the 32 lanes of the first pass, on 32
// columns of one read, store into 32 banks. A tile wholly past its
// reads' ends reads nothing and writes zeros.
// The kernel's name must not start with "locate_kernel": the benchmark's
// locate roofline sums the device time of kernels with that prefix.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int TB = 64;         // reads a tile
constexpr int TL = 64;         // columns a tile
constexpr int THREADS = 256;   // one table byte a thread

struct Table {
  uint8_t v[256];
};

__global__ void __launch_bounds__(THREADS)
    pack_masks_T_kernel(const uint8_t* __restrict__ bytes,
                        const int64_t* __restrict__ offs,
                        const int* __restrict__ lens, const Table tab, int L,
                        int B, uint8_t* __restrict__ out) {
  __shared__ uint8_t stab[256];
  __shared__ uint8_t tile[TL][TB + 4];
  __shared__ int64_t soff[TB];
  __shared__ int slen[TB];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = blockIdx.x * TB, l0 = blockIdx.y * TL;
  stab[t] = tab.v[t];
  if (t < TB) {
    const int b = b0 + t;
    soff[t] = b < B ? offs[b] : 0;
    slen[t] = b < B ? lens[b] : 0;
  }
  __syncthreads();
  for (int r = warp; r < TB; r += THREADS / 32) {
    const int n = slen[r] - l0;   // columns of read r inside this tile
    const uint8_t* src = bytes + soff[r] + l0;
    for (int c = lane; c < TL; c += 32)
      tile[c][r] = c < n ? stab[src[c]] : 0;
  }
  __syncthreads();
  for (int i = t; i < TL * TB; i += THREADS) {
    const int c = i / TB, r = i % TB;
    const int l = l0 + c, b = b0 + r;
    if (l < L && b < B) out[(size_t)l * B + b] = tile[c][r];
  }
}

// bytes [N] uint8, offs [B] int64, lens [B] int32 (0 <= lens <= L, every
// read inside bytes), all on the device; tab: 256 bytes on the host,
// passed to the kernel by value; out [L, B] uint8 on the device. Runs on
// `stream`; returns the launch's cudaError_t.
extern "C" int orc_pack_masks_T(const void* bytes, const void* offs,
                                const void* lens, const void* tab, int L,
                                int B, void* out, void* stream) {
  if (L <= 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const dim3 grid((B + TB - 1) / TB, (L + TL - 1) / TL);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  Table t;
  for (int k = 0; k < 256; ++k) t.v[k] = ((const uint8_t*)tab)[k];
  pack_masks_T_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int64_t*)offs, (const int*)lens, t, L, B,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
