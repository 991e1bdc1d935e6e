// Cutadapt-equivalent semi-global locate for every flag set and any
// adapter length, as an anti-diagonal wavefront across the lanes of a warp
// with the adapter's rows cut into bands.
//
// Replaces tpu_orc/align/batched.py::batched_locate (line 121), the XLA
// locate that tpu_orc runs on the accelerator for the flag sets other
// than FRONT/BACK/INFIX and for banks of 63 bp or more (a fori_loop over
// read columns with a Kogge-Stone (min,+) scan down each column). Nine
// int32 outputs per (read, adapter), [9, B, A]: valid, matches, errors,
// refstart, refstop, querystart, querystop, nloc, nacc.
//
// What bounds it on this card: integer ALU work and the serial chain of
// the DP (cell (i, j) needs (i-1, j-1), (i, j-1) and (i-1, j)), not
// bytes: a read is one byte per column and each (read, adapter) touches
// len x m cells.
//
// Design: csrc/locate.cu's wavefront, extended to this contract. G = 16
// lanes per (read, adapter), two neighbouring reads of one adapter a warp
// (as orc_locate_ks; 16 lanes beat 32 at every shape timed). Lane l owns
// K consecutive rows of a band of R = G*K rows; cost, matches and origin
// of its rows stay in registers. At step s lane l evaluates column
// j = s - l, top row first. A cell's up neighbour on the lane's first
// row is lane l-1's last row after step s-1 (shuffled at the top of the
// step), its diagonal what the lane received a step earlier, its left the
// lane's own row. The read
// byte travels up the lanes with the matches of that row; lane 0 takes its
// byte from the lane that holds it (the lanes load G columns every G
// steps, one block ahead). Within a cell the diagonal comes first (+1 on a
// mismatch), the horizontal move only when strictly cheaper, then the
// vertical only when strictly cheaper: the sequential DP's order, which
// the XLA scan reproduces with its tie to the larger row.
//
// Bands: an adapter of m bp has rows 0..m, run as m / R + 1 bands of R
// rows over columns 0..len, one after the other in the same lanes. Band
// 0's row 0 follows the row-0 rule (START_WITHIN_SEQ2: cost 0, origin j;
// otherwise cost j, origin 0). Band k > 0 needs row kR-1 at every column,
// band k-1's last row: band k-1's lane G-1 writes it as (cost, matches,
// origin) into a handoff of one 16-byte word per column, and band k's
// lanes load it a block of G columns ahead with the read bytes; lane 0
// takes it by three shuffles from the lane that holds it. A bank whose
// adapters all fit one band runs no handoff. The handoff lies in a global
// scratch sized by the wrapper: a band boundary moves 32 B a column
// against R cells a column, read back by the same warp one band later.
// (A handoff in shared memory was no faster at L 512, where it fits, and
// slower where it cuts the warps an SM holds.) The wrapper takes the
// fewest K of 4, 5 and 8 that hold the bank in one band, else 8: each
// band pads its rows past m and pays a pipeline fill of G-1 steps.
//
// Row m's lane (in band m / R) takes the row-m candidate of every column
// 0..len with its refstart-dependent budget (k_table at the effective
// length after N wildcards, folded with min_overlap into one table by
// refstart), counting nloc and nacc and keeping the best (max matches,
// then min cost). With STOP_WITHIN_SEQ1 every row <= m of column len
// (column 0 for an empty read) is a candidate: each lane keeps its best
// over its own rows in increasing order, over every band, then one
// reduction over the alignment's lanes picks max matches, then min cost,
// then min row, exactly at every row (the XLA key packs the row into 8
// bits, which is wrong from row 256 on). Apart from the handoff rows,
// column state never touches global memory; cost, matches and origin keep
// 32 bits (the shuffled word packs matches, <= M < 2^16 under the
// shared-memory bound, with the bytes).
#include <cstdint>
#include <cuda_runtime.h>

#define BIG (1 << 28)
#define WARPS 4                  // warps per block
#define FULL 0xffffffffu
constexpr int G = 16;            // lanes per (read, adapter)

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
locate_flags_kernel(const uint8_t* __restrict__ reads,     // [L, B]
                    const int* __restrict__ read_lens,     // [B]
                    const uint8_t* __restrict__ ref_masks, // [A, M]
                    const int* __restrict__ ref_lens,      // [A]
                    const int* __restrict__ k_table,       // [A, M+1]
                    const int* __restrict__ n_prefix,      // [A, M+1]
                    const int* __restrict__ hslot,         // [A], -1: one band
                    int B, int A, int M, int L, int b0, int nb, int flags,
                    int min_overlap,
                    int4* __restrict__ scratch,            // [slots, nb, L]
                    int* __restrict__ out) {               // [9, B, A]
  constexpr int R = G * K;
  const bool SIR = flags & 1;            // START_WITHIN_SEQ1
  const bool SIQ = flags & 2;            // START_WITHIN_SEQ2
  const bool STR = flags & 4;            // STOP_WITHIN_SEQ1
  const bool STQ = flags & 8;            // STOP_WITHIN_SEQ2
  extern __shared__ int shm[];
  // row m's budget by refstart and the final column's by row, -1 where
  // the overlap is under min_overlap (a cost is never below 0)
  int* kbyrs = shm;
  int* kfin = shm + (M + 1);
  uint8_t* ref = reinterpret_cast<uint8_t*>(shm + 2 * (M + 1));
  const int a = blockIdx.y;
  const int m = ref_lens[a];
  const int* kt = k_table + (long)a * (M + 1);
  const int* np = n_prefix + (long)a * (M + 1);
  const int npm = np[m];
  for (int i = threadIdx.x; i <= M; i += blockDim.x) {
    if (i <= m) {
      const int length = m - i;          // row m with refstart i
      const int eff = length - (npm - np[i]);
      kbyrs[i] = length < min_overlap ? -1 : kt[min(max(eff, 0), M)];
      const int effi = i - np[i];        // row i with refstart 0
      kfin[i] = i < min_overlap ? -1 : kt[min(max(effi, 0), M)];
    }
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    ref[i] = ref_masks[(long)a * M + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int wb = (blockIdx.x * WARPS + warp) * 2;
  if (wb >= nb) return;                  // uniform over the warp
  const int half = (threadIdx.x & 31) / G;
  const int bl = wb + half;              // read within the launch
  const bool live = bl < nb;             // a second half may have no read
  const int b = b0 + bl;
  const int lane = threadIdx.x & (G - 1);
  const int len = live ? read_lens[b] : 0;
  const int other = __shfl_xor_sync(FULL, len, G);
  const int lmax = other > len ? other : len;  // the warp runs to the longer
  const int nbands = m / R + 1;
  // this alignment's handoff (unused where the adapter fits one band)
  int4* hd = scratch + ((long)(hslot[a] < 0 ? 0 : hslot[a]) * nb + bl) * L;

  int bv = 0, bm = -1, bc = BIG, bo = 0, bq = 0;
  int nloc = 0, nacc = 0, pok = 0;
  // the row-m candidate of column j, on row m's lane
  auto candidate = [&](int cs, int ms, int os, int j) {
    const int ok = (STQ || j == len) && cs <= kbyrs[os < 0 ? -os : 0];
    if (ok && (ms > bm || (ms == bm && cs < bc))) {
      bv = 1; bm = ms; bc = cs; bo = os; bq = j;
    }
    nloc += ok & (1 - pok);
    nacc += ok;
    pok = ok;
  };
  // the final column's best over this lane's rows (STOP_WITHIN_SEQ1,
  // which excludes START_WITHIN_SEQ1: every origin is >= 0, refstart 0)
  int fm = -1, fc = BIG, fr = 0, fo = 0;
  auto final_cand = [&](int i, int c, int mt, int og) {
    if (c > kfin[i]) return;
    if (mt > fm || (mt == fm && c < fc)) {
      fm = mt; fc = c; fr = i; fo = og;
    }
  };

  for (int band = 0; band < nbands; ++band) {
    const int base = band * R;
    const int r0 = base + lane * K;      // this lane's first row
    const bool last_band = band == nbands - 1;
    const bool hin = band > 0;           // lane 0's up row is the handoff
    const bool hout = !last_band;        // lane G-1 writes the handoff
    const int ml = (m - base) / K, mk = (m - base) % K;  // row m, last band
    uint32_t refm[K];
    int cost[K], mat[K], org[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = r0 + k;
      refm[k] = i >= 1 && i <= M ? ref[i - 1] : 0u;
      cost[k] = SIR ? 0 : i;             // column 0
      mat[k] = 0;
      org[k] = SIR ? -i : 0;
    }
    if (last_band && lane == ml) {       // column 0 is an evaluated column
      int cs = cost[0], os = org[0];
#pragma unroll
      for (int k = 1; k < K; ++k)
        if (mk == k) { cs = cost[k]; os = org[k]; }
      candidate(cs, 0, os, 0);
    }
    if (STR && len == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (r0 + k <= m) final_cand(r0 + k, cost[k], 0, org[k]);
    }

    // this lane's read byte and handoff word of the current and the next
    // G columns; column j's are at index j - 1
    const int4 zero = make_int4(0, 0, 0, 0);
    uint32_t blk = lane < len ? reads[(size_t)lane * B + b] : 0u;
    uint32_t nblk = G + lane < len ? reads[(size_t)(G + lane) * B + b] : 0u;
    int4 hb = hin && lane < len ? hd[lane] : zero;
    int4 nhb = hin && G + lane < len ? hd[G + lane] : zero;
    uint32_t cur = 0;                    // byte of this lane's column
    // lane l-1's last row at column j-1: for lane 0 of band k > 0, row
    // kR-1 of column 0
    int dc = SIR ? 0 : base - 1, dm = 0, dor = SIR ? 1 - base : 0;
    const int last = lmax + (last_band ? ml : G - 1);
    for (int s = 1; s <= last; ++s) {
      const int q = (s - 1) & (G - 1);   // lane 0's column: index s - 1
      const uint32_t w = (uint32_t)mat[K - 1] | (cur << 16) | (blk << 24);
      const uint32_t got = __shfl_sync(FULL, w, lane ? lane - 1 : q, G);
      int uc = __shfl_up_sync(FULL, cost[K - 1], 1, G);
      int uo = __shfl_up_sync(FULL, org[K - 1], 1, G);
      int um = got & 0xffff;
      const uint32_t c = lane ? (got >> 16) & 0xffu : got >> 24;
      if (hin) {                         // uniform over the warp
        const int hc = __shfl_sync(FULL, hb.x, q, G);
        const int hm = __shfl_sync(FULL, hb.y, q, G);
        const int ho = __shfl_sync(FULL, hb.z, q, G);
        if (lane == 0) { uc = hc; um = hm; uo = ho; }
      }
      if (q == G - 1) {                  // next block of G columns
        const int jj = s + G + lane;     // s = G c + G: block c + 2
        blk = nblk;
        nblk = jj < len ? reads[(size_t)jj * B + b] : 0u;
        if (hin) {
          hb = nhb;
          nhb = jj < len ? hd[jj] : zero;
        }
      }
      const int j = s - lane;
      if (j >= 1 && j <= len) {
        int pc = dc, pm = dm, po = dor;  // diagonal of the first row
        int vc = uc, vm = um, vo = uo;   // up of the first row
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int lc = cost[k], lm = mat[k], lo = org[k];
          const int eq = (refm[k] & c) != 0;
          int cc = pc + 1 - eq, cm = pm + eq, co = po;
          if (lc + 1 < cc) {             // horizontal only when cheaper
            cc = lc + 1; cm = lm; co = lo;
          }
          if (vc + 1 < cc) {             // vertical only when cheaper
            cc = vc + 1; cm = vm; co = vo;
          }
          if (k == 0 && r0 == 0) {       // row 0
            cc = SIQ ? 0 : j; cm = 0; co = SIQ ? j : 0;
          }
          cost[k] = cc; mat[k] = cm; org[k] = co;
          pc = lc; pm = lm; po = lo;
          vc = cc; vm = cm; vo = co;
        }
        if (hout && lane == G - 1)
          hd[j - 1] = make_int4(cost[K - 1], mat[K - 1], org[K - 1], 0);
        if (last_band && lane == ml) {
          int cs = cost[0], ms = mat[0], os = org[0];
#pragma unroll
          for (int k = 1; k < K; ++k)
            if (mk == k) { cs = cost[k]; ms = mat[k]; os = org[k]; }
          candidate(cs, ms, os, j);
        }
        if (STR && j == len) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (r0 + k <= m) final_cand(r0 + k, cost[k], mat[k], org[k]);
        }
      }
      dc = uc; dm = um; dor = uo;        // the next step's diagonal
      cur = c;
    }
    __syncwarp();                        // the handoff is written
  }

  int br = m;
  if (STR) {
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) {
      const int om = __shfl_xor_sync(FULL, fm, d, G);
      const int oc = __shfl_xor_sync(FULL, fc, d, G);
      const int orr = __shfl_xor_sync(FULL, fr, d, G);
      const int oo = __shfl_xor_sync(FULL, fo, d, G);
      if (om > fm || (om == fm && (oc < fc || (oc == fc && orr < fr)))) {
        fm = om; fc = oc; fr = orr; fo = oo;
      }
    }
    if (fm >= 0 && (fm > bm || (fm == bm && fc < bc))) {
      bv = 1; bm = fm; bc = fc; bo = fo; bq = len; br = fr;
    }
  }
  if (live && lane == (m % R) / K) {     // row m's lane of the last band
    const long BA = (long)B * A, o = (long)b * A + a;
    out[o] = bv;
    out[BA + o] = bm;
    out[2 * BA + o] = bc;
    out[3 * BA + o] = bo < 0 ? -bo : 0;
    out[4 * BA + o] = br;
    out[5 * BA + o] = bo > 0 ? bo : 0;
    out[6 * BA + o] = bq;
    out[7 * BA + o] = nloc;
    out[8 * BA + o] = nacc;
  }
}

template <int K>
static int launch(const void* reads, const void* read_lens,
                  const void* ref_masks, const void* ref_lens,
                  const void* k_table, const void* n_prefix,
                  const void* hslot, int B, int A, int M, int L, int b0,
                  int nb, int flags, int min_overlap, void* scratch,
                  void* out, cudaStream_t stream) {
  const size_t shared = 8 * (size_t)(M + 1) + M;
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        locate_flags_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int per_block = WARPS * 32 / G;     // reads a block
  dim3 grid((nb + per_block - 1) / per_block, A);
  locate_flags_kernel<K><<<grid, 32 * WARPS, shared, stream>>>(
      (const uint8_t*)reads, (const int*)read_lens,
      (const uint8_t*)ref_masks, (const int*)ref_lens, (const int*)k_table,
      (const int*)n_prefix, (const int*)hslot, B, A, M, L, b0, nb, flags,
      min_overlap, (int4*)scratch, (int*)out);
  return (int)cudaGetLastError();
}

// Reads b0 .. b0+nb-1 of reads [L, B] against every adapter; writes their
// rows of out [9, B, A]. rows_per_lane (4, 5 or 8) picks the instance;
// hslot[a] is adapter a's handoff slot in scratch ([slots, nb, L] of
// 16-byte words) or -1 where the adapter fits one band of
// 16 * rows_per_lane rows (scratch may then be null). flags is the
// four-bit set of align/spec.py; START_WITHIN_SEQ1 with STOP_WITHIN_SEQ1
// (5, 7, 13, 15) is refused, as in tpu_orc.
extern "C" int orc_locate_flags(const void* reads, const void* read_lens,
                                const void* ref_masks, const void* ref_lens,
                                const void* k_table, const void* n_prefix,
                                const void* hslot, int B, int A, int M,
                                int L, int b0, int nb, int flags,
                                int min_overlap, int rows_per_lane,
                                void* scratch, void* out, void* stream) {
  if (nb <= 0 || b0 < 0 || b0 + nb > B || A <= 0 || A > 65535 || M < 0 ||
      M >= (1 << 16) || L < 0 || flags < 0 || flags > 15 ||
      ((flags & 1) && (flags & 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ORC_CASE(KK)                                                        \
  if (rows_per_lane == KK)                                                  \
    return launch<KK>(reads, read_lens, ref_masks, ref_lens, k_table,       \
                      n_prefix, hslot, B, A, M, L, b0, nb, flags,           \
                      min_overlap, scratch, out, s);
  ORC_CASE(4) ORC_CASE(5) ORC_CASE(8)
#undef ORC_CASE
  return (int)cudaErrorInvalidValue;
}
