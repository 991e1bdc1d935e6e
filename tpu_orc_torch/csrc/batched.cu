// Cutadapt-equivalent semi-global locate for every flag set and any
// adapter length: one thread per (read, adapter).
//
// Replaces tpu_orc/align/batched.py::batched_locate (line 121), the XLA
// locate that tpu_orc runs on the accelerator for the flag sets other
// than FRONT/BACK/INFIX and for banks of 63 bp or more (a fori_loop over
// read columns with a Kogge-Stone (min,+) scan down each column). Nine
// int32 outputs per (read, adapter), [9, B, A]: valid, matches, errors,
// refstart, refstop, querystart, querystop, nloc, nacc.
//
// Design (simple first): each thread runs the sequential column DP of
// align/spec.py, the loop of native/oracle.cpp, over rows 0..m of its
// own adapter and columns 1..len of its own read:
//   * within a cell the diagonal comes first (+1 on a mismatch), the
//     horizontal move only when strictly cheaper, then the vertical only
//     when strictly cheaper: the order the XLA scan reproduces with its
//     tie to the larger row;
//   * row 0 and column 0 follow the flags (START_WITHIN_SEQ2: row 0 is
//     cost 0 and origin j; START_WITHIN_SEQ1: column 0 is cost 0 and
//     origin -i);
//   * row m's candidate is taken at every column 0..len, and at j == len
//     only without STOP_WITHIN_SEQ2; columns past len add nothing, so the
//     thread stops there;
//   * with STOP_WITHIN_SEQ1 every row of column len (column 0 for an
//     empty read) is a candidate, reduced exactly: max matches, then min
//     cost, then min row (the XLA key packs the row into 8 bits, which
//     is wrong from row 256 on; this kernel keeps the row in a word).
// Column state (cost, matches, origin of rows 1..M) lives in a global
// scratch laid out [field][row][alignment], alignment = a * nb + read:
// a block is BLOCK neighbouring reads of one adapter, so a warp loads and
// stores one coalesced 128-byte line per row and field. The adapter's
// mask row and its error-budget tables k_table / n_prefix sit in shared
// memory and are read by direct index (the TPU needed one-hot reductions
// there). Reads come in as [L, B], so a warp's read bytes of one column
// are one sector. The wrapper launches chunks of nb reads so that the
// scratch (3 x 4 B x M per alignment) stays within a bounded size.
//
// What bounds it on this card: the serial chain of the DP inside a thread
// (about 16 integer operations per cell, each cell waiting on the
// scratch loads of its row) and the scratch traffic of six 4-byte
// accesses per cell, in L2 while a launch's scratch fits there (50 MB).
// With one thread per alignment, a call of B reads and A adapters has
// only B x A threads in flight: 2,048 reads x 12 adapters fill a fifth of
// the card's 270,336 thread slots.
#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 28)
#define BLOCK 128                // reads a block, of one adapter

template <int FLAGS>
__global__ void __launch_bounds__(BLOCK)
locate_flags_kernel(const uint8_t* __restrict__ reads,     // [L, B]
                    const int* __restrict__ read_lens,     // [B]
                    const uint8_t* __restrict__ ref_masks, // [A, M]
                    const int* __restrict__ ref_lens,      // [A]
                    const int* __restrict__ k_table,       // [A, M+1]
                    const int* __restrict__ n_prefix,      // [A, M+1]
                    int B, int A, int M, int b0, int nb, int min_overlap,
                    int* __restrict__ scratch,             // [3, M, A*nb]
                    int* __restrict__ out) {               // [9, B, A]
  constexpr bool SIR = FLAGS & 1;     // START_WITHIN_SEQ1
  constexpr bool SIQ = FLAGS & 2;     // START_WITHIN_SEQ2
  constexpr bool STR = FLAGS & 4;     // STOP_WITHIN_SEQ1
  constexpr bool STQ = FLAGS & 8;     // STOP_WITHIN_SEQ2
  extern __shared__ int shm[];
  int* ktab = shm;                    // k_table row of this adapter
  int* npre = shm + (M + 1);          // n_prefix row
  uint8_t* ref = reinterpret_cast<uint8_t*>(shm + 2 * (M + 1));
  const int a = blockIdx.y;
  for (int i = threadIdx.x; i <= M; i += blockDim.x) {
    ktab[i] = k_table[(long)a * (M + 1) + i];
    npre[i] = n_prefix[(long)a * (M + 1) + i];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    ref[i] = ref_masks[(long)a * M + i];
  __syncthreads();
  const int bl = blockIdx.x * BLOCK + threadIdx.x;
  if (bl >= nb) return;
  const int b = b0 + bl;
  const int m = ref_lens[a];
  const int n = read_lens[b];
  const int npm = npre[m];
  const long stride = (long)A * nb;               // one row of one field
  int* sc = scratch + (long)a * nb + bl;          // row i at (i-1)*stride
  int* sm = sc + (long)M * stride;
  int* so = sm + (long)M * stride;

  // acceptance of the row-m candidate at column j
  auto row_m_ok = [&](int c, int og, int j) {
    const int refstart = og < 0 ? -og : 0;
    const int length = m - refstart;
    const int eff = length - (npm - npre[refstart]);
    const int kmax = ktab[min(max(eff, 0), M)];
    return length >= min_overlap && c <= kmax && j <= n && (STQ || j == n);
  };
  // the final column's best (STOP_WITHIN_SEQ1): rows in increasing order,
  // a row replaces the best only when strictly better
  int f_ok = 0, f_m = -1, f_c = BIG, f_row = 0, f_o = 0;
  auto final_cand = [&](int i, int c, int mt, int og) {
    const int refstart = og < 0 ? -og : 0;
    const int length = i - refstart;
    const int eff = length - npre[i];
    if (length < min_overlap || c > ktab[min(max(eff, 0), M)]) return;
    if (!f_ok || mt > f_m || (mt == f_m && c < f_c)) {
      f_ok = 1; f_m = mt; f_c = c; f_row = i; f_o = og;
    }
  };

  // column 0
  for (int i = 1; i <= m; ++i) {
    sc[(i - 1) * stride] = SIR ? 0 : i;
    sm[(i - 1) * stride] = 0;
    so[(i - 1) * stride] = SIR ? -i : 0;
  }
  int b_valid = 0, b_m = -1, b_c = BIG, b_o = 0, b_q = 0;
  int c = SIR ? 0 : m, mt = 0, og = SIR ? -m : 0;    // row m, column 0
  int prev = row_m_ok(c, og, 0);
  if (prev) { b_valid = 1; b_m = mt; b_c = c; b_o = og; }
  int nloc = prev, nacc = prev;
  if (STR && n == 0)
    for (int i = 0; i <= m; ++i) final_cand(i, SIR ? 0 : i, 0, SIR ? -i : 0);

  for (int j = 1; j <= n; ++j) {
    const uint8_t q = reads[(long)(j - 1) * B + b];
    const bool last = STR && j == n;
    // the diagonal of row 1 is row 0 of column j-1; up starts at row 0
    int dc = SIQ ? 0 : j - 1, dm = 0, dg = SIQ ? j - 1 : 0;
    int uc = SIQ ? 0 : j, um = 0, ug = SIQ ? j : 0;
    if (last) final_cand(0, uc, um, ug);
    for (int i = 1; i <= m; ++i) {
      const long k = (long)(i - 1) * stride;
      const int hc = sc[k], hm = sm[k], hg = so[k];   // row i, column j-1
      const bool eq = (ref[i - 1] & q) != 0;
      int cc = eq ? dc : dc + 1, cm = eq ? dm + 1 : dm, cg = dg;
      if (hc + 1 < cc) { cc = hc + 1; cm = hm; cg = hg; }
      if (uc + 1 < cc) { cc = uc + 1; cm = um; cg = ug; }
      sc[k] = cc; sm[k] = cm; so[k] = cg;
      dc = hc; dm = hm; dg = hg;
      uc = cc; um = cm; ug = cg;
      if (last) final_cand(i, cc, cm, cg);
    }
    // uc/um/ug now hold row m of column j
    const int ok = row_m_ok(uc, ug, j);
    if (ok && (um > b_m || (um == b_m && uc < b_c))) {
      b_valid = 1; b_m = um; b_c = uc; b_o = ug; b_q = j;
    }
    nloc += ok & !prev;
    nacc += ok;
    prev = ok;
  }

  int b_row = m;
  if (STR && f_ok && (f_m > b_m || (f_m == b_m && f_c < b_c))) {
    b_valid = 1; b_m = f_m; b_c = f_c; b_o = f_o; b_q = n; b_row = f_row;
  }
  const long BA = (long)B * A, o = (long)b * A + a;
  out[o] = b_valid;
  out[BA + o] = b_m;
  out[2 * BA + o] = b_c;
  out[3 * BA + o] = b_o < 0 ? -b_o : 0;
  out[4 * BA + o] = b_row;
  out[5 * BA + o] = b_o > 0 ? b_o : 0;
  out[6 * BA + o] = b_q;
  out[7 * BA + o] = nloc;
  out[8 * BA + o] = nacc;
}

template <int FLAGS>
static int launch(const void* reads, const void* read_lens,
                  const void* ref_masks, const void* ref_lens,
                  const void* k_table, const void* n_prefix, int B, int A,
                  int M, int b0, int nb, int min_overlap, void* scratch,
                  void* out, cudaStream_t stream) {
  const size_t shared = 8 * (size_t)(M + 1) + M;
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        locate_flags_kernel<FLAGS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((nb + BLOCK - 1) / BLOCK, A);
  locate_flags_kernel<FLAGS><<<grid, BLOCK, shared, stream>>>(
      (const uint8_t*)reads, (const int*)read_lens,
      (const uint8_t*)ref_masks, (const int*)ref_lens, (const int*)k_table,
      (const int*)n_prefix, B, A, M, b0, nb, min_overlap, (int*)scratch,
      (int*)out);
  return (int)cudaGetLastError();
}

// Reads b0 .. b0+nb-1 of reads [L, B] against every adapter; writes their rows
// of out [9, B, A]. scratch holds 3 * M * A * nb ints. flags is the
// four-bit set of align/spec.py; START_WITHIN_SEQ1 with STOP_WITHIN_SEQ1
// (5, 7, 13, 15) is refused, as in tpu_orc.
extern "C" int orc_locate_flags(const void* reads, const void* read_lens,
                                const void* ref_masks, const void* ref_lens,
                                const void* k_table, const void* n_prefix,
                                int B, int A, int M, int b0, int nb,
                                int flags, int min_overlap, void* scratch,
                                void* out, void* stream) {
  if (nb <= 0 || b0 < 0 || b0 + nb > B || A <= 0 || A > 65535 || M < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ORC_CASE(F)                                                        \
  case F:                                                                  \
    return launch<F>(reads, read_lens, ref_masks, ref_lens, k_table,       \
                     n_prefix, B, A, M, b0, nb, min_overlap, scratch, out, \
                     s);
  switch (flags) {
    ORC_CASE(0) ORC_CASE(1) ORC_CASE(2) ORC_CASE(3) ORC_CASE(4) ORC_CASE(6)
    ORC_CASE(8) ORC_CASE(9) ORC_CASE(10) ORC_CASE(11) ORC_CASE(12)
    ORC_CASE(14)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ORC_CASE
}
