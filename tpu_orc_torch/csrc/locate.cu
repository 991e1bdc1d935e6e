// Cutadapt-equivalent semi-global adapter locate, reads x bank adapters.
//
// Replaces the Pallas kernel tpu_orc/align/pallas_locate.py::_kernel_wf
// (line 205, launched by locate_tiles at :394/:426) and computes the same
// contract as its Kogge-Stone sibling ::_kernel (:55). Modes FRONT, BACK
// and INFIX; eight int32 outputs per (adapter, read): matches, errors,
// origin, querystop, valid, refstop row, nloc, nacc.
//
// What bounds it on this card: integer ALU work and the serial row chain
// of the DP (cell (i, j) needs (i-1, j) of the same column), not bytes.
// A read is one byte per column and each thread touches L * m cells.
//
// Design: one thread per (read, adapter). The thread walks the columns
// j = 0..len(read) of the sequential DP, keeping the m+1 rows of
// (cost, matches, origin) in local memory (L1-resident), and evaluates the
// row-m candidate at every column. There is no wavefront, no
// tie-break emulation and no payload packing: the sequential order IS the
// DP order that the TPU wavefront reproduced. Reads are stored [L, B] so
// that the 32 threads of a warp load 32 neighbouring bytes per column; the
// adapter's threshold tables sit in shared memory (one adapter per block
// row of the grid).
#include <cstdint>
#include <cuda_runtime.h>

#define MAX_ROWS 128            // DP rows: adapters up to MAX_ROWS - 1 bp
#define BIG (1 << 28)
#define THREADS 128

enum { MODE_FRONT = 0, MODE_BACK = 1, MODE_INFIX = 2 };

__global__ void __launch_bounds__(THREADS)
locate_kernel(const uint8_t* __restrict__ reads,   // [L, B] match masks
              const int* __restrict__ lens,        // [B], 0 <= len <= L
              const int* __restrict__ ref,         // [Ap, R]: row i = char i-1
              const int* __restrict__ kbyrs,       // [Ap, R] FRONT by refstart
              const int* __restrict__ kfin,        // [Ap, R] BACK final column
              const int* __restrict__ kconst,      // [Ap] BACK/INFIX row m
              const int* __restrict__ mrow,        // [Ap] adapter lengths
              int R, int B, int A, int mode,
              int* __restrict__ out)               // [8, A, B]
{
  __shared__ uint8_t s_ref[MAX_ROWS];
  __shared__ int s_kbyrs[MAX_ROWS];
  __shared__ int s_kfin[MAX_ROWS];
  const int a = blockIdx.y;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_ref[i] = (uint8_t)ref[a * R + i];
    s_kbyrs[i] = kbyrs[a * R + i];
    s_kfin[i] = kfin[a * R + i];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const int m = mrow[a];
  const int kc = kconst[a];
  const int len = lens[b];
  const bool front = mode == MODE_FRONT;

  short cst[MAX_ROWS];
  short mt[MAX_ROWS];
  int org[MAX_ROWS];
  // column j = 0: FRONT skips an adapter prefix for free (origin -i),
  // BACK/INFIX pay one deletion per adapter character
  for (int i = 0; i <= m; ++i) {
    cst[i] = front ? 0 : i;
    mt[i] = 0;
    org[i] = front ? -i : 0;
  }

  int bv = 0, bm = -1, bc = BIG, bo = 0, bq = 0, br = m;
  int nloc = 0, nacc = 0, pok = 0;

  // column 0 is itself an evaluated column (the wavefront reaches its
  // row-m cell at anti-diagonal m)
  for (int j = 0; j <= len; ++j) {
    if (j > 0) {
      const uint8_t c = reads[(size_t)(j - 1) * B + b];
      // diagonal source of row 1 is row 0 of column j-1
      int dc = cst[0], dm = mt[0], dor = org[0];
      // row 0: START_WITHIN_SEQ2 reset (cost 0, matches 0, origin j)
      cst[0] = 0;
      mt[0] = 0;
      org[0] = j;
      int uc = 0, um = 0, uo = j;
      for (int i = 1; i <= m; ++i) {
        const int lc = cst[i], lm = mt[i], lo = org[i];
        const bool eq = (s_ref[i] & c) != 0;
        int cc = eq ? dc : dc + 1;
        int cm = eq ? dm + 1 : dm;
        int co = dor;
        if (lc + 1 < cc) {          // horizontal only when strictly cheaper
          cc = lc + 1; cm = lm; co = lo;
        }
        if (uc + 1 < cc) {          // vertical only when strictly cheaper
          cc = uc + 1; cm = um; co = uo;
        }
        cst[i] = (short)cc;
        mt[i] = (short)cm;
        org[i] = co;
        dc = lc; dm = lm; dor = lo;
        uc = cc; um = cm; uo = co;
      }
    }
    // row-m candidate at column j
    const int cm = cst[m], mm = mt[m], om = org[m];
    int kmax;
    if (front) {
      const int rs = om < 0 ? -om : 0;    // refstart
      kmax = s_kbyrs[rs];
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
    // STOP_WITHIN_SEQ1: every row of the final column (j == len) is a
    // candidate; max matches, then min cost, then min row. For an empty
    // read the wavefront never evaluates cell (0, 0), so row 0 is skipped.
    int fm = -1, fc = BIG, fr = -1;
    for (int r = (len == 0 ? 1 : 0); r <= m; ++r) {
      const int sc = cst[r];
      if (sc > s_kfin[r]) continue;
      const int sm = mt[r];
      if (fr < 0 || sm > fm || (sm == fm && sc < fc)) {
        fm = sm; fc = sc; fr = r;
      }
    }
    if (fr >= 0 && (fm > bm || (fm == bm && fc < bc))) {
      bv = 1; bm = fm; bc = fc; bo = org[fr]; bq = len; br = fr;
    }
  }

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

extern "C" int orc_locate(const void* reads, const void* lens, const void* ref,
                          const void* kbyrs, const void* kfin,
                          const void* kconst, const void* mrow, int R, int B,
                          int A, int mode, void* out, void* stream) {
  if (R > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (A == 0 || B == 0) return (int)cudaSuccess;
  dim3 grid((B + THREADS - 1) / THREADS, A);
  locate_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (const int*)lens, (const int*)ref,
      (const int*)kbyrs, (const int*)kfin, (const int*)kconst,
      (const int*)mrow, R, B, A, mode, (int*)out);
  return (int)cudaGetLastError();
}
