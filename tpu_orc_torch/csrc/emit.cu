// Stage 01's segment records as FASTQ bytes, written on the card from a
// block's cut plan.
//
// Replaces no TPU kernel. tpu_orc builds every segment of a reoriented
// read on the host: a Python slice of the read's sequence and quality, a
// reverse complement for a '-' configuration, a Record, and one f-string
// a record when the files are written. Here the host joins the block's
// reads once (sequences, qualities and read ids, in one byte buffer),
// uploads them with one row of seven int64 a record,
//   seq_off, seq_len, qual_off, qual_len, name_off, name_len, seg,
// (offsets into the buffer; seg = seg_no * 2 + 1 for a '-' configuration)
// and the records' output offsets, and orc_emit_fastq writes each record
//   '@' name ["|seg" seg_no] '\n' seq '\n' '+' '\n' qual '\n'
// at out[offs[r] .. offs[r + 1]): the sequence forward, or reversed
// through the complement table; the quality forward or reversed; "|seg"
// and the decimal seg_no only for seg_no > 0. Bit for bit the text of
// io/fastq.py::format_records over the records tpu_orc builds.
//
// What bounds it on this card: bytes. Each byte of a slice is read once
// and each output byte written once (about 1 GB each way for a
// 65,536-read block of ~3.6 kb reads); a '-' record adds one table
// lookup a sequence byte.
//
// Design: one CTA of 256 threads a run of RUN consecutive records, whose
// rows and offsets it first takes into shared memory with the 256-byte
// complement table. The run's output [offs[r0], offs[r0 + RUN]) is cut
// into the 16-byte aligned chunks of the output buffer, one a thread at a
// time, so that a warp stores 512 contiguous bytes. A chunk that lies
// wholly inside one record's sequence or quality is the common case: its
// 16 source bytes (contiguous, forward or backward) come from the two
// aligned 16-byte loads that cover them, a funnel shift, and for a
// reversed slice a byte swap and the table; one 16-byte store. Any other
// chunk (a header, a field's edge, a record's edge, a run's edge) is
// built byte by byte: 16-byte store if the run owns all of it, byte
// stores of the owned bytes otherwise, so that two CTAs sharing a chunk
// write disjoint bytes.
// The kernel's name must not start with "locate_kernel": the benchmark's
// locate roofline sums the device time of kernels with that prefix.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 256;   // one table byte a thread
// records a CTA: with 4, a 2,048-record batch runs at 3.4x its byte
// bound (8: 4.3x, the card a quarter full), a 65,536-read block at 2.3x
// (8: 2.2x); 1, 2, 4 and 8 timed on an H100 (PERF.md, section 6)
constexpr int RUN = 4;
enum { SEQ_OFF, SEQ_LEN, QUAL_OFF, QUAL_LEN, NAME_OFF, NAME_LEN, SEG, NCOL };

struct Table {
  uint8_t v[256];
};

__device__ __forceinline__ int64_t ndigits(int64_t v) {
  int64_t n = 1;
  while (v >= 10) {
    v /= 10;
    ++n;
  }
  return n;
}

// '@' name ["|seg" digits] '\n'
__device__ __forceinline__ int64_t header_len(const int64_t* rec) {
  const int64_t seg = rec[SEG] >> 1;
  return 2 + rec[NAME_LEN] + (seg ? 4 + ndigits(seg) : 0);
}

// Byte q of record rec (0 <= q < the record's length).
__device__ uint8_t byte_at(const uint8_t* __restrict__ data,
                           const uint8_t* stab, const int64_t* rec,
                           int64_t q) {
  const int64_t nl = rec[NAME_LEN], sl = rec[SEQ_LEN], ql = rec[QUAL_LEN];
  const int64_t seg = rec[SEG] >> 1;
  const bool neg = rec[SEG] & 1;
  const int64_t H = header_len(rec);
  if (q < H) {
    if (q == 0) return '@';
    if (q <= nl) return data[rec[NAME_OFF] + q - 1];
    if (q == H - 1) return '\n';
    const int64_t k = q - 1 - nl;   // inside "|seg<digits>"
    if (k < 4) return k == 0 ? '|' : k == 1 ? 's' : k == 2 ? 'e' : 'g';
    int64_t v = seg;                // the digit H - 2 - q places from the end
    for (int64_t i = H - 2 - q; i > 0; --i) v /= 10;
    return (uint8_t)('0' + v % 10);
  }
  q -= H;
  if (q < sl)
    return neg ? stab[data[rec[SEQ_OFF] + sl - 1 - q]]
               : data[rec[SEQ_OFF] + q];
  q -= sl;
  if (q < 3) return q == 1 ? '+' : '\n';
  q -= 3;
  if (q < ql)
    return neg ? data[rec[QUAL_OFF] + ql - 1 - q] : data[rec[QUAL_OFF] + q];
  return '\n';
}

__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d, int k) {
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

// data[x .. x + 16) from the two aligned 16-byte words covering it; the
// caller has checked that both lie inside the buffer.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ data,
                                        int64_t x) {
  const int64_t a = x & ~int64_t(15);
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(data + a));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(data + a + 16));
  const int k = (int)(x - a), wa = k >> 2, sh = (k & 3) * 8;
  const uint32_t u0 = pick(lo.x, lo.y, lo.z, lo.w, wa);
  const uint32_t u1 = pick(lo.y, lo.z, lo.w, hi.x, wa);
  const uint32_t u2 = pick(lo.z, lo.w, hi.x, hi.y, wa);
  const uint32_t u3 = pick(lo.w, hi.x, hi.y, hi.z, wa);
  const uint32_t u4 = pick(hi.x, hi.y, hi.z, hi.w, wa);
  return make_uint4(__funnelshift_r(u0, u1, sh), __funnelshift_r(u1, u2, sh),
                    __funnelshift_r(u2, u3, sh), __funnelshift_r(u3, u4, sh));
}

__device__ __forceinline__ uint32_t bswap(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

__device__ __forceinline__ uint32_t comp4(uint32_t w, const uint8_t* stab) {
  return (uint32_t)stab[w & 255] | (uint32_t)stab[(w >> 8) & 255] << 8 |
         (uint32_t)stab[(w >> 16) & 255] << 16 |
         (uint32_t)stab[w >> 24] << 24;
}

// The 16 bytes of a slice [off, off + len) from its position i on, read
// forward, or backward from its end (rev); complemented if comp. False
// where an aligned load would leave the buffer of n bytes.
__device__ __forceinline__ bool slice16(const uint8_t* __restrict__ data,
                                        int64_t n, const uint8_t* stab,
                                        int64_t off, int64_t len, int64_t i,
                                        bool rev, bool comp, uint4* out) {
  const int64_t x = rev ? off + len - 16 - i : off + i;
  if ((x & ~int64_t(15)) + 32 > n) return false;
  uint4 v = load16(data, x);
  if (rev) v = make_uint4(bswap(v.w), bswap(v.z), bswap(v.y), bswap(v.x));
  if (comp)
    v = make_uint4(comp4(v.x, stab), comp4(v.y, stab), comp4(v.z, stab),
                   comp4(v.w, stab));
  *out = v;
  return true;
}

__global__ void __launch_bounds__(THREADS)
    emit_fastq_kernel(const uint8_t* __restrict__ data, int64_t n,
                      const int64_t* __restrict__ recs,
                      const int64_t* __restrict__ offs, int64_t R,
                      const Table tab, uint8_t* __restrict__ out) {
  __shared__ uint8_t stab[256];
  __shared__ int64_t srec[RUN][NCOL];
  __shared__ int64_t soff[RUN + 1];
  const int t = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * RUN;
  const int nr = (int)min((int64_t)RUN, R - r0);
  stab[t] = tab.v[t];
  if (t < nr * NCOL) srec[t / NCOL][t % NCOL] = recs[r0 * NCOL + t];
  if (t <= nr) soff[t] = offs[r0 + t];
  __syncthreads();
  const int64_t G0 = soff[0], G1 = soff[nr];
  int r = 0;   // the record holding this thread's chunk (chunks only grow)
  for (int64_t g = (G0 & ~int64_t(15)) + 16 * t; g < G1;
       g += 16 * THREADS) {
    const int64_t lo = g > G0 ? g : G0;
    while (soff[r + 1] <= lo) ++r;
    const int64_t* rec = srec[r];
    const int64_t o = soff[r];
    if (g >= o && g + 16 <= soff[r + 1]) {
      const int64_t p = g - o, H = header_len(rec);
      const int64_t sl = rec[SEQ_LEN], ql = rec[QUAL_LEN], Q = H + sl + 3;
      const bool neg = rec[SEG] & 1;
      uint4 v;
      if (p >= H && p + 16 <= H + sl &&
          slice16(data, n, stab, rec[SEQ_OFF], sl, p - H, neg, neg, &v)) {
        *reinterpret_cast<uint4*>(out + g) = v;
        continue;
      }
      if (p >= Q && p + 16 <= Q + ql &&
          slice16(data, n, stab, rec[QUAL_OFF], ql, p - Q, neg, false, &v)) {
        *reinterpret_cast<uint4*>(out + g) = v;
        continue;
      }
    }
    uint32_t w[4] = {0, 0, 0, 0};
    unsigned own = 0;
    int rr = r;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int64_t pos = g + j;
      if (pos < G0 || pos >= G1) continue;
      while (soff[rr + 1] <= pos) ++rr;
      const uint32_t b = byte_at(data, stab, srec[rr], pos - soff[rr]);
      w[j >> 2] |= b << (8 * (j & 3));
      own |= 1u << j;
    }
    if (own == 0xffffu) {
      *reinterpret_cast<uint4*>(out + g) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (own >> j & 1) out[g + j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// data [n] uint8 (16-byte aligned), recs [R, 7] int64, offs [R + 1] int64
// (offs[r + 1] - offs[r] the length of record r; every slice inside
// data), all on the device; tab: the 256-byte complement table on the
// host, passed to the kernel by value; out [offs[R]] uint8 on the device,
// 16-byte aligned. Runs on `stream`; returns the launch's cudaError_t.
extern "C" int orc_emit_fastq(const void* data, int64_t n, const void* recs,
                              const void* offs, int64_t R, const void* tab,
                              void* out, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int64_t blocks = (R + RUN - 1) / RUN;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Table t;
  for (int k = 0; k < 256; ++k) t.v[k] = ((const uint8_t*)tab)[k];
  emit_fastq_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, (const int64_t*)recs, (const int64_t*)offs, R,
      t, (uint8_t*)out);
  return (int)cudaGetLastError();
}
