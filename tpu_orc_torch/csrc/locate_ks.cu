// Cutadapt-equivalent semi-global adapter locate by a per-column
// Kogge-Stone scan, reads x bank adapters.
//
// Replaces the Pallas kernel tpu_orc/align/pallas_locate.py::_kernel
// (line 55, launched by locate_tiles at :443-458 under
// TPU_ORC_LOCATE_IMPL=ks). Modes FRONT, BACK and INFIX; eight int32
// outputs per (adapter, read): matches, errors, origin, querystop, valid,
// refstop row, nloc, nacc. Same arguments and output layout as
// orc_locate (csrc/locate.cu).
//
// What bounds it on this card: integer ALU work and the chain of columns
// (column j needs column j-1), not bytes: a read is one byte per column
// and every byte feeds the R DP rows of each adapter.
//
// Design: the TPU kernel scans the DP rows of one column along sublanes;
// here a warp is one (read, adapter) and the scan runs across its lanes.
// Lane l owns the K = R / 32 consecutive rows l*K .. l*K+K-1 (R = 64: 2,
// R = 128: 4), and cost and payload stay in registers. Per column:
//   * the read's byte: one load per lane brings 32 columns, handed out
//     by __shfl_sync;
//   * the diagonal and horizontal candidates of each row, with row i-1
//     of the previous column from the lane's own lower row or, for its
//     first row, from lane l-1 (__shfl_up_sync by 1); the row-0 reset;
//   * the vertical chain: an inclusive (min,+) scan of the key
//     ((cand - row + 128) << 7) | (127 - row), whose low field makes ties
//     go to the larger row, first inside the lane, then over the lanes'
//     totals with __shfl_up_sync in 5 steps; the payload
//     (matches << 20 | origin + 128) travels with the key;
//   * row m's candidate from the lane that owns it (__shfl_sync), with
//     best, nloc and nacc kept as in the Pallas kernel.
// A warp stops at column len(read): later columns are gated off by
// j <= len. BACK reduces the final column over rows with a warp min
// (max matches, then min cost, then min row); as in _kernel, an empty
// read's final column is column 0 with row 0 included.
#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 28)
#define WARPS 4                  // warps (reads) per block
#define FULL 0xffffffffu
#define OFF 128                  // offset of origin and key fields
#define PAYB 20                  // payload: matches << PAYB | origin + OFF
#define PAYMASK ((1 << PAYB) - 1)

enum { MODE_FRONT = 0, MODE_BACK = 1, MODE_INFIX = 2 };

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
locate_ks_kernel(const uint8_t* __restrict__ reads,   // [L, B] match masks
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
  int cost[K], pay[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = r0 + k;
    refm[k] = (uint32_t)ref[a * R + i];
    // column 0: FRONT skips an adapter prefix for free (origin -i),
    // BACK/INFIX pay one deletion per adapter character
    cost[k] = front ? 0 : i;
    pay[k] = front ? OFF - i : OFF;
  }

  int bv = 0, bm = -1, bc = BIG, bo = 0, bq = 0, br = m;
  int nloc = 0, nacc = 0, pok = 0;
  uint32_t buf = 0;                        // read bytes of 32 columns

  for (int j = 0; j <= len; ++j) {
    if (j > 0) {
      const int jl = (j - 1) & 31;
      if (jl == 0) {
        const int jj = j - 1 + lane;
        buf = jj < len ? reads[(size_t)jj * B + b] : 0u;
      }
      const uint32_t c = __shfl_sync(FULL, buf, jl);
      // row r0 - 1 of the previous column, from the lane below
      const int uc = __shfl_up_sync(FULL, cost[K - 1], 1);
      const int up = __shfl_up_sync(FULL, pay[K - 1], 1);
      int key[K], np[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = r0 + k;
        const int dc = k ? cost[k - 1] : uc;
        const int dp = k ? pay[k - 1] : up;
        const bool eq = (refm[k] & c) != 0;
        int cc = eq ? dc : dc + 1;
        int cp = eq ? dp + (1 << PAYB) : dp;
        if (cost[k] + 1 < cc) {            // horizontal only when cheaper
          cc = cost[k] + 1;
          cp = pay[k];
        }
        if (i == 0) {                      // START_WITHIN_SEQ2 reset
          cc = 0;
          cp = j + OFF;
        }
        key[k] = ((cc - i + OFF) << 7) | (127 - i);
        np[k] = cp;
      }
      // inclusive (min,+) scan: inside the lane, then across lanes
#pragma unroll
      for (int k = 1; k < K; ++k) {
        if (key[k - 1] < key[k]) {
          key[k] = key[k - 1];
          np[k] = np[k - 1];
        }
      }
      int tk = key[K - 1], tp = np[K - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ok_ = __shfl_up_sync(FULL, tk, d);
        const int op = __shfl_up_sync(FULL, tp, d);
        if (lane >= d && ok_ < tk) {
          tk = ok_;
          tp = op;
        }
      }
      const int ek = __shfl_up_sync(FULL, tk, 1);   // lanes below, inclusive
      const int ep = __shfl_up_sync(FULL, tp, 1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane > 0 && ek < key[k]) {
          key[k] = ek;
          np[k] = ep;
        }
        cost[k] = (key[k] >> 7) - OFF + r0 + k;
        pay[k] = np[k];
      }
    }
    // row-m candidate at column j
    int cs = cost[0], ps = pay[0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (mk == k) {
        cs = cost[k];
        ps = pay[k];
      }
    }
    const int cm = __shfl_sync(FULL, cs, ml);
    const int pm = __shfl_sync(FULL, ps, ml);
    const int mm = pm >> PAYB;
    const int om = (pm & PAYMASK) - OFF;
    int kmax;
    if (front) {
      const int rs = om < 0 ? -om : 0;     // refstart
      kmax = s_kbyrs[rs < R ? rs : R - 1];
    } else {
      kmax = kc;
    }
    const int ok = cm <= kmax;
    if (ok && (mm > bm || (mm == bm && cm < bc))) {
      bv = 1; bm = mm; bc = cm; bo = om; bq = j;
    }
    nloc += ok & (1 - pok);
    nacc += ok;
    pok = ok;
  }

  if (mode == MODE_BACK) {
    // STOP_WITHIN_SEQ1: every row of column len is a candidate; the key
    // orders max matches, then min cost, then min row
    int fk = BIG, fp = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = r0 + k;
      if (cost[k] > s_kfin[i]) continue;
      const int sc = cost[k] < 255 ? cost[k] : 255;
      const int key = ((OFF - (pay[k] >> PAYB)) << 16) + (sc << 8) + i;
      if (key < fk) {
        fk = key;
        fp = pay[k];
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ok_ = __shfl_xor_sync(FULL, fk, d);
      const int op = __shfl_xor_sync(FULL, fp, d);
      if (ok_ < fk) {
        fk = ok_;
        fp = op;
      }
    }
    if (fk < BIG) {
      const int fm = OFF - (fk >> 16), fc = (fk >> 8) & 255;
      if (fm > bm || (fm == bm && fc < bc)) {
        bv = 1; bm = fm; bc = fc; bo = (fp & PAYMASK) - OFF; bq = len;
        br = fk & 255;
      }
    }
  }

  if (lane == 0) {
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

extern "C" int orc_locate_ks(const void* reads, const void* lens,
                             const void* ref, const void* kbyrs,
                             const void* kfin, const void* kconst,
                             const void* mrow, int R, int B, int A, int mode,
                             void* out, void* stream) {
  if (R != 64 && R != 128) return (int)cudaErrorInvalidValue;
  if (A == 0 || B == 0) return (int)cudaSuccess;
  dim3 grid((B + WARPS - 1) / WARPS, A);
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 64)
    locate_ks_kernel<2><<<grid, 32 * WARPS, 0, s>>>(
        (const uint8_t*)reads, (const int*)lens, (const int*)ref,
        (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
        (const int*)mrow, B, A, mode, (int*)out);
  else
    locate_ks_kernel<4><<<grid, 32 * WARPS, 0, s>>>(
        (const uint8_t*)reads, (const int*)lens, (const int*)ref,
        (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
        (const int*)mrow, B, A, mode, (int*)out);
  return (int)cudaGetLastError();
}
