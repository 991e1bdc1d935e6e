// Cutadapt-equivalent semi-global adapter locate, reads x bank adapters,
// as an anti-diagonal wavefront across the lanes of a warp: both locate
// contracts of tpu_orc from one kernel template.
//
// Replaces the Pallas kernels of tpu_orc/align/pallas_locate.py, both
// launched by locate_tiles (:394):
//   * _kernel_wf (line 205, launch :426): orc_locate, the instances
//     G 32, KS false;
//   * _kernel (line 55, launch :443), the per-column Kogge-Stone scan,
//     under TPU_ORC_LOCATE_IMPL=ks: orc_locate_ks, the instances G 16,
//     KS true.
// The two contracts differ in one place: in BACK, an empty read's final
// column is column 0, whose row 0 _kernel counts as a candidate (it
// seeds its final-column snapshot with column 0) and _kernel_wf never
// evaluates. So the KS contract needs no column scan: it is the same
// recurrence on the same schedule, with that row kept. Modes FRONT, BACK
// and INFIX; eight int32 outputs per (adapter, read): matches, errors,
// origin, querystop, valid, refstop row, nloc, nacc.
//
// What bounds it on this card: integer ALU work and the serial chain of
// the DP (cell (i, j) needs (i-1, j-1), (i, j-1) and (i-1, j)), not
// bytes: a read is one byte per column and each (read, adapter) touches
// len x m cells.
//
// Design: G lanes per (read, adapter), in _kernel_wf's own layout with
// the anti-diagonals spread over lanes instead of sublanes. Lane l of an
// alignment owns the K = R / G consecutive rows l*K .. l*K+K-1; cost,
// matches and origin of its rows stay in registers. At step s lane l
// evaluates column j = s - l, top row first, so a cell's vertical
// neighbour inside the lane is the row just computed. For its first row:
//   * up, row l*K-1 at column j, is lane l-1's last row after step s-1,
//     and comes by one shuffle at the top of the step;
//   * diagonal, the same row at column j-1, is what the lane received a
//     step earlier;
//   * left is the lane's own row from its previous step.
// The shuffled word packs cost (7 bits: cost <= row <= 127), matches
// (<= row) and the read byte of the column, which so travels up the
// lanes one lane per step; origin (-127 .. L) takes a second shuffle.
// Lane 0 takes its byte in the same shuffle from the lane that holds it:
// the lanes load G columns of the read every G steps (one byte each, the
// next block one block ahead), and each packs its byte of the block into
// a field of the word. Every shuffle has width G, so it stays inside its
// alignment. Reads stay [L, B], so a warp's byte loads are strided, one
// sector per read; the warps of a block are neighbouring reads of one
// adapter and share those sectors in L1, and a lane loads once per G
// columns, off the step's chain.
// Row m's lane evaluates the row-m candidate of every column (column 0
// included), keeping best, nloc and nacc as the Pallas kernels do. BACK
// then reduces the final column over rows <= m with one min over the
// alignment's lanes (max matches, then min cost, then min row).
// Within a cell the diagonal comes first, the horizontal move only when
// strictly cheaper, then the vertical only when strictly cheaper: the
// sequential DP's order, which both Pallas kernels reproduce.
//
// G 32 (orc_locate): one alignment a warp, K 2 at R 64 and 4 at R 128.
// G 16 (orc_locate_ks): two alignments a warp, neighbouring reads of one
// adapter, K 4 and 8. A step's fixed work (the two shuffles, the byte's
// field, the block refill, the loop and its active-column test, row m's
// candidate on one lane of each half, which share m and so take that
// branch together) is paid once for two alignments. The warp runs until
// the longer read's row m reached its final column (max(len) + m/K
// steps); the shorter half is gated by its own 1 <= j <= len. A second
// half past B (odd B) takes part in every shuffle and writes nothing.
// The KS kernel was timed at G 32 and G 16 on the card and keeps the
// faster, G 16 (PERF.md); orc_locate_ks_lanes runs either, to time them.
#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 28)
#define WARPS 4                  // warps per block
#define FULL 0xffffffffu
#define OFF 128                  // offset of the BACK key's matches field
#define KS_LANES 16              // lanes an alignment of orc_locate_ks

enum { MODE_FRONT = 0, MODE_BACK = 1, MODE_INFIX = 2 };

template <int K, int G, bool KS>
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
  constexpr int R = G * K;
  constexpr int PER = 32 / G;              // alignments a warp
  __shared__ int s_kbyrs[R];
  __shared__ int s_kfin[R];
  const int a = blockIdx.y;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_kbyrs[i] = kbyrs[a * R + i];
    s_kfin[i] = kfin[a * R + i];
  }
  __syncthreads();
  const int wb = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * PER;
  if (wb >= B) return;                     // uniform over the warp
  const int b = wb + (threadIdx.x & 31) / G;
  const bool live = G == 32 || b < B;      // a second half may have no read
  const int lane = threadIdx.x & (G - 1);  // lane within the alignment
  const int r0 = lane * K;                 // this lane's first row
  const int m = mrow[a];
  const int kc = kconst[a];
  const int len = live ? lens[b] : 0;
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

  // read bytes: this lane's byte of the current and the next G columns
  uint32_t blk = lane < len ? reads[(size_t)lane * B + b] : 0u;
  uint32_t nblk = G + lane < len ? reads[(size_t)(G + lane) * B + b] : 0u;
  uint32_t cur = 0;                        // byte of this lane's column
  int dc = 0, dm = 0, dor = 0;             // lane l-1's last row, column j-1
  int last = len + ml;                     // row m reaches column len
  if constexpr (G < 32) {                  // ... in the longer read
    const int other = __shfl_xor_sync(FULL, len, G);
    last = (other > len ? other : len) + ml;
  }
  for (int s = 1; s <= last; ++s) {
    const int q = (s - 1) & (G - 1);       // lane 0's byte: read[s - 1]
    const uint32_t w = (uint32_t)cost[K - 1] | ((uint32_t)mat[K - 1] << 8)
        | (cur << 16) | (blk << 24);
    const uint32_t got = __shfl_sync(FULL, w, lane ? lane - 1 : q, G);
    const int uo = __shfl_up_sync(FULL, org[K - 1], 1, G);
    if (q == G - 1) {                      // next block of G columns
      blk = nblk;
      const int jj = s + G + lane;         // s = G c + G: block c + 2
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
    // to row m's hold column len now. An empty read's final column is
    // column 0: the KS contract counts its row 0, the wavefront's does
    // not (it never evaluates cell (0, 0)).
    int fk = BIG, fo = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = r0 + k;
      if (i > m || (!KS && i == 0 && len == 0) || cost[k] > s_kfin[i])
        continue;
      const int key = ((OFF - mat[k]) << 16) + (cost[k] << 8) + i;
      if (key < fk) {
        fk = key;
        fo = org[k];
      }
    }
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) {
      const int ok_ = __shfl_xor_sync(FULL, fk, d, G);
      const int oo = __shfl_xor_sync(FULL, fo, d, G);
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

  if (lane == ml && live) {
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

template <int G, bool KS>
static int launch(const void* reads, const void* lens, const void* ref,
                  const void* kbyrs, const void* kfin, const void* kconst,
                  const void* mrow, int R, int B, int A, int mode, void* out,
                  void* stream) {
  if (R != 64 && R != 128) return (int)cudaErrorInvalidValue;
  if (A == 0 || B == 0) return (int)cudaSuccess;
  constexpr int per_block = WARPS * (32 / G);   // reads a block
  dim3 grid((B + per_block - 1) / per_block, A);
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 64)
    locate_kernel<64 / G, G, KS><<<grid, 32 * WARPS, 0, s>>>(
        (const uint8_t*)reads, (const int*)lens, (const int*)ref,
        (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
        (const int*)mrow, B, A, mode, (int*)out);
  else
    locate_kernel<128 / G, G, KS><<<grid, 32 * WARPS, 0, s>>>(
        (const uint8_t*)reads, (const int*)lens, (const int*)ref,
        (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
        (const int*)mrow, B, A, mode, (int*)out);
  return (int)cudaGetLastError();
}

// _kernel_wf's contract: one alignment a warp
extern "C" int orc_locate(const void* reads, const void* lens, const void* ref,
                          const void* kbyrs, const void* kfin,
                          const void* kconst, const void* mrow, int R, int B,
                          int A, int mode, void* out, void* stream) {
  return launch<32, false>(reads, lens, ref, kbyrs, kfin, kconst, mrow, R, B,
                           A, mode, out, stream);
}

// _kernel's contract, same arguments and output
extern "C" int orc_locate_ks(const void* reads, const void* lens,
                             const void* ref, const void* kbyrs,
                             const void* kfin, const void* kconst,
                             const void* mrow, int R, int B, int A, int mode,
                             void* out, void* stream) {
  return launch<KS_LANES, true>(reads, lens, ref, kbyrs, kfin, kconst, mrow,
                                R, B, A, mode, out, stream);
}

// _kernel's contract at `lanes` (16 or 32) lanes an alignment: both
// designs of the KS kernel, so that they can be timed side by side
extern "C" int orc_locate_ks_lanes(const void* reads, const void* lens,
                                   const void* ref, const void* kbyrs,
                                   const void* kfin, const void* kconst,
                                   const void* mrow, int R, int B, int A,
                                   int mode, int lanes, void* out,
                                   void* stream) {
  if (lanes == 16)
    return launch<16, true>(reads, lens, ref, kbyrs, kfin, kconst, mrow, R,
                            B, A, mode, out, stream);
  if (lanes == 32)
    return launch<32, true>(reads, lens, ref, kbyrs, kfin, kconst, mrow, R,
                            B, A, mode, out, stream);
  return (int)cudaErrorInvalidValue;
}
