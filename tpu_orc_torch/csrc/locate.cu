// Cutadapt-equivalent semi-global adapter locate, reads x bank adapters,
// as an anti-diagonal wavefront across the lanes of a warp.
//
// Replaces the Pallas kernel tpu_orc/align/pallas_locate.py::_kernel_wf
// (line 205, launched by locate_tiles at :394/:426) and computes the same
// contract as its Kogge-Stone sibling ::_kernel (:55). Modes FRONT, BACK
// and INFIX; eight int32 outputs per (adapter, read): matches, errors,
// origin, querystop, valid, refstop row, nloc, nacc.
//
// What bounds it on this card: integer ALU work and the serial chain of
// the DP (cell (i, j) needs (i-1, j-1), (i, j-1) and (i-1, j)), not
// bytes: a read is one byte per column and each (read, adapter) touches
// len x m cells.
//
// Design: one warp per (read, adapter), in _kernel_wf's own layout with
// the anti-diagonals spread over lanes instead of sublanes. Lane l owns
// the K = R / 32 consecutive rows l*K .. l*K+K-1 (R 64: 2, R 128: 4);
// cost, matches and origin of its rows stay in registers. At step s lane
// l evaluates column j = s - l, top row first, so a cell's vertical
// neighbour inside the lane is the row just computed. For its first row:
//   * up, row l*K-1 at column j, is lane l-1's last row after step s-1,
//     and comes by one shuffle at the top of the step;
//   * diagonal, the same row at column j-1, is what the lane received a
//     step earlier;
//   * left is the lane's own row from its previous step.
// The shuffled word packs cost (7 bits: cost <= row), matches (<= row)
// and the read byte of the column, which so travels up the lanes one
// lane per step; origin (-127 .. L) takes a second shuffle. Lane 0 takes
// its byte in the same shuffle from the lane that holds it: the lanes
// load 32 columns of the read every 32 steps (one byte each, the next
// block one block ahead), and each packs its byte of the block into a
// field of the word. Reads stay [L, B], so a warp's byte loads are
// strided, one sector per byte; the 4 warps of a block are neighbouring
// reads of one adapter and share those sectors in L1, and a block loads
// once per 32 columns, off the step's chain.
// Row m's lane evaluates the row-m candidate of every column (column 0
// included), keeping best, nloc and nacc as _kernel_wf does; a warp stops
// when row m reached column len(read) (len + m/K + 1 steps). BACK then
// reduces the final column over rows <= m with one warp min (max
// matches, then min cost, then min row); an empty read's final column is
// column 0, whose row 0 the wavefront never evaluates, so it is skipped.
// Within a cell the diagonal comes first, the horizontal move only when
// strictly cheaper, then the vertical only when strictly cheaper: the
// sequential DP's order, which _kernel_wf reproduces.
#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 28)
#define WARPS 4                  // warps (reads) per block
#define FULL 0xffffffffu
#define OFF 128                  // offset of the BACK key's matches field

enum { MODE_FRONT = 0, MODE_BACK = 1, MODE_INFIX = 2 };

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
locate_kernel(const uint8_t* __restrict__ reads,   // [L, B] match masks
              const int* __restrict__ lens,        // [B], 0 <= len <= L
              const int* __restrict__ ref,         // [Ap, R]: row i = char i-1
              const int* __restrict__ kbyrs,       // [Ap, R] FRONT by refstart
              const int* __restrict__ kfin,        // [Ap, R] BACK final column
              const int* __restrict__ kconst,      // [Ap] BACK/INFIX row m
              const int* __restrict__ mrow,        // [Ap] adapter lengths
              int B, int A, int mode,
              int* __restrict__ out)               // [8, A, B]
{
  constexpr int R = 32 * K;
  __shared__ int s_kbyrs[R];
  __shared__ int s_kfin[R];
  const int a = blockIdx.y;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_kbyrs[i] = kbyrs[a * R + i];
    s_kfin[i] = kfin[a * R + i];
  }
  __syncthreads();
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                      // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int r0 = lane * K;                 // this lane's first row
  const int m = mrow[a];
  const int kc = kconst[a];
  const int len = lens[b];
  const bool front = mode == MODE_FRONT;
  const int ml = m / K, mk = m % K;        // lane and slot of row m

  uint32_t refm[K];
  int cost[K], mat[K], org[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = r0 + k;
    refm[k] = (uint32_t)ref[a * R + i];
    // column 0: FRONT skips an adapter prefix for free (origin -i),
    // BACK/INFIX pay one deletion per adapter character
    cost[k] = front ? 0 : i;
    mat[k] = 0;
    org[k] = front ? -i : 0;
  }

  int bv = 0, bm = -1, bc = BIG, bo = 0, bq = 0;
  int nloc = 0, nacc = 0, pok = 0;
  // the row-m candidate of column j, on row m's lane
  auto candidate = [&](int j) {
    int cs = cost[0], ms = mat[0], os = org[0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (mk == k) {
        cs = cost[k];
        ms = mat[k];
        os = org[k];
      }
    }
    // FRONT: threshold by the candidate's refstart
    const int kmax = front ? s_kbyrs[os < 0 ? -os : 0] : kc;
    const int ok = cs <= kmax;
    if (ok && (ms > bm || (ms == bm && cs < bc))) {
      bv = 1; bm = ms; bc = cs; bo = os; bq = j;
    }
    nloc += ok & (1 - pok);
    nacc += ok;
    pok = ok;
  };
  if (lane == ml) candidate(0);            // column 0 is an evaluated column

  // read bytes: this lane's byte of the current and the next 32 columns
  uint32_t blk = lane < len ? reads[(size_t)lane * B + b] : 0u;
  uint32_t nblk = 32 + lane < len ? reads[(size_t)(32 + lane) * B + b] : 0u;
  uint32_t cur = 0;                        // byte of this lane's column
  int dc = 0, dm = 0, dor = 0;             // lane l-1's last row, column j-1
  const int last = len + ml;               // row m reaches column len
  for (int s = 1; s <= last; ++s) {
    const int q = (s - 1) & 31;            // lane 0's byte: read[s - 1]
    const uint32_t w = (uint32_t)cost[K - 1] | ((uint32_t)mat[K - 1] << 8)
        | (cur << 16) | (blk << 24);
    const uint32_t got = __shfl_sync(FULL, w, lane ? lane - 1 : q);
    const int uo = __shfl_up_sync(FULL, org[K - 1], 1);
    if (q == 31) {                         // next block of 32 columns
      blk = nblk;
      const int jj = s + 32 + lane;        // s = 32 c + 32: block c + 2
      nblk = jj < len ? reads[(size_t)jj * B + b] : 0u;
    }
    const uint32_t c = lane ? (got >> 16) & 0xffu : got >> 24;
    const int uc = got & 0xff, um = (got >> 8) & 0xff;
    const int j = s - lane;
    if (j >= 1 && j <= len) {
      int pc = dc, pm = dm, po = dor;      // diagonal of the first row
      int vc = uc, vm = um, vo = uo;       // up of the first row
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int lc = cost[k], lm = mat[k], lo = org[k];
        const int eq = (refm[k] & c) != 0;
        int cc = pc + 1 - eq, cm = pm + eq, co = po;
        if (lc + 1 < cc) {                 // horizontal only when cheaper
          cc = lc + 1; cm = lm; co = lo;
        }
        if (vc + 1 < cc) {                 // vertical only when cheaper
          cc = vc + 1; cm = vm; co = vo;
        }
        if (r0 + k == 0) {                 // START_WITHIN_SEQ2 reset
          cc = 0; cm = 0; co = j;
        }
        cost[k] = cc; mat[k] = cm; org[k] = co;
        pc = lc; pm = lm; po = lo;
        vc = cc; vm = cm; vo = co;
      }
      if (lane == ml) candidate(j);
    }
    dc = uc; dm = um; dor = uo;            // the next step's diagonal
    cur = c;
  }

  int br = m;
  if (mode == MODE_BACK) {
    // STOP_WITHIN_SEQ1: every row <= m of column len is a candidate; the
    // key orders max matches, then min cost, then min row. The lanes up
    // to row m's hold column len now.
    int fk = BIG, fo = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = r0 + k;
      if (i > m || (i == 0 && len == 0) || cost[k] > s_kfin[i]) continue;
      const int key = ((OFF - mat[k]) << 16) + (cost[k] << 8) + i;
      if (key < fk) {
        fk = key;
        fo = org[k];
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ok_ = __shfl_xor_sync(FULL, fk, d);
      const int oo = __shfl_xor_sync(FULL, fo, d);
      if (ok_ < fk) {
        fk = ok_;
        fo = oo;
      }
    }
    if (fk < BIG) {
      const int fm = OFF - (fk >> 16), fc = (fk >> 8) & 255;
      if (fm > bm || (fm == bm && fc < bc)) {
        bv = 1; bm = fm; bc = fc; bo = fo; bq = len; br = fk & 255;
      }
    }
  }

  if (lane == ml) {
    const size_t plane = (size_t)A * B;
    const size_t o = (size_t)a * B + b;
    out[0 * plane + o] = bm;
    out[1 * plane + o] = bc;
    out[2 * plane + o] = bo;
    out[3 * plane + o] = bq;
    out[4 * plane + o] = bv;
    out[5 * plane + o] = br;
    out[6 * plane + o] = nloc;
    out[7 * plane + o] = nacc;
  }
}

extern "C" int orc_locate(const void* reads, const void* lens, const void* ref,
                          const void* kbyrs, const void* kfin,
                          const void* kconst, const void* mrow, int R, int B,
                          int A, int mode, void* out, void* stream) {
  if (R != 64 && R != 128) return (int)cudaErrorInvalidValue;
  if (A == 0 || B == 0) return (int)cudaSuccess;
  dim3 grid((B + WARPS - 1) / WARPS, A);
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 64)
    locate_kernel<2><<<grid, 32 * WARPS, 0, s>>>(
        (const uint8_t*)reads, (const int*)lens, (const int*)ref,
        (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
        (const int*)mrow, B, A, mode, (int*)out);
  else
    locate_kernel<4><<<grid, 32 * WARPS, 0, s>>>(
        (const uint8_t*)reads, (const int*)lens, (const int*)ref,
        (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
        (const int*)mrow, B, A, mode, (int*)out);
  return (int)cudaGetLastError();
}
