// tpu_orc native oracle: CPU reference implementations with edlib/cutadapt
// semantics (see tpu_orc/align/spec.py for the single semantic spec).
//
// Roles:
//   * fast CPU parity oracle for the JAX/Pallas device kernels
//   * the CPU baseline used by bench.py (reference stack proxy: the
//     reference outsources these exact computations to edlib C/C++ and
//     cutadapt's C aligner, SURVEY.md §2.3)
//   * NW traceback for the consensus star-alignment host path
//
// Build: tpu_orc/native/build.py (g++ -O3 -shared), loaded via ctypes.
// No external dependencies.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

// Thread-count resolution: explicit request > ORC_THREADS env > hardware.
static int orc_nthreads(int req) {
    if (req > 0) return req;
    const char* e = std::getenv("ORC_THREADS");
    if (e && std::atoi(e) > 0) return std::atoi(e);
    unsigned h = std::thread::hardware_concurrency();
    return h ? (int)h : 1;
}

// Dynamic-scheduled parallel map over [0, n) (atomic work counter, so
// unbalanced items — e.g. all-vs-all triangle rows — stay load-balanced).
template <class F>
static void parallel_for(int n, int nthreads, F f) {
    nthreads = std::min(nthreads, n);
    if (nthreads <= 1) {
        for (int i = 0; i < n; i++) f(i);
        return;
    }
    std::atomic<int> next(0);
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    for (int t = 0; t < nthreads; t++)
        ts.emplace_back([&]() {
            int i;
            while ((i = next.fetch_add(1)) < n) f(i);
        });
    for (auto& th : ts) th.join();
}

extern "C" {

// ---------------------------------------------------------------------------
// Myers bit-parallel edit distance over uint8 code sequences (0..4; 4 = N).
// mode: 0 = NW (global), 1 = SHW (free target suffix), 2 = HW (free both).
// Byte-literal comparison: N==N matches (edlib semantics on ASCII bytes).
// ---------------------------------------------------------------------------
int orc_edit_distance(const uint8_t* p, int m, const uint8_t* t, int n,
                      int mode) {
    if (m == 0) return (mode == 0) ? n : 0;
    int W = (m + 63) / 64;
    std::vector<uint64_t> Peq((size_t)W * 5, 0);
    for (int i = 0; i < m; i++)
        Peq[(size_t)(i / 64) * 5 + p[i]] |= 1ull << (i % 64);
    std::vector<uint64_t> VP(W, ~0ull), VN(W, 0);
    int score = m, best = m;
    const int wm = (m - 1) / 64, rm = (m - 1) % 64;
    const int hin0 = (mode == 2) ? 0 : 1;
    for (int j = 0; j < n; j++) {
        int hin = hin0;
        const uint8_t c = t[j];
        for (int w = 0; w < W; w++) {
            uint64_t Eq = Peq[(size_t)w * 5 + c];
            const uint64_t hinNeg = hin < 0 ? 1ull : 0ull;
            const uint64_t hinPos = hin > 0 ? 1ull : 0ull;
            const uint64_t Pv = VP[w], Mv = VN[w];
            const uint64_t Xv = Eq | Mv;
            const uint64_t Eq_ = Eq | hinNeg;
            const uint64_t Xh = (((Eq_ & Pv) + Pv) ^ Pv) | Eq_;
            uint64_t Ph = Mv | ~(Xh | Pv);
            uint64_t Mh = Pv & Xh;
            if (w == wm)
                score += (int)((Ph >> rm) & 1) - (int)((Mh >> rm) & 1);
            const int hout =
                (int)((Ph >> 63) & 1) - (int)((Mh >> 63) & 1);
            Ph = (Ph << 1) | hinPos;
            Mh = (Mh << 1) | hinNeg;
            VP[w] = Mh | ~(Xv | Ph);
            VN[w] = Ph & Xv;
            hin = hout;
        }
        if (mode != 0 && score < best) best = score;
    }
    return mode == 0 ? score : best;
}

// All-vs-all upper-triangle distances with the reference's 5% length-band
// gate (amplicon_sorter.py:680: skip pair if len_short*1.05 < len_long).
// seqs: concatenated codes; offs/lens per read; out[n*n] row-major int32,
// -1 where gated/not computed. Returns number of pairs computed.
long orc_all_vs_all(const uint8_t* seqs, const long* offs, const int* lens,
                    int nreads, double band, int* out, int nthreads) {
    std::atomic<long> pairs(0);
    parallel_for(nreads, orc_nthreads(nthreads), [&](int i) {
        long local = 0;
        for (int j = i + 1; j < nreads; j++) {
            int li = lens[i], lj = lens[j];
            int lo = std::min(li, lj), hi = std::max(li, lj);
            if (band > 0 && (double)lo * band < (double)hi) {
                out[(long)i * nreads + j] = -1;
                continue;
            }
            out[(long)i * nreads + j] = orc_edit_distance(
                seqs + offs[i], li, seqs + offs[j], lj, 0);
            local++;
        }
        pairs.fetch_add(local);
    });
    return pairs.load();
}

// ---------------------------------------------------------------------------
// cutadapt-equivalent locate (see spec.py). Inputs are match-mask arrays
// (ref via IUPAC expansion, query literal); match iff (ref & qry) != 0.
// flags: 1=START_WITHIN_SEQ1, 2=START_WITHIN_SEQ2, 4=STOP_WITHIN_SEQ1,
// 8=STOP_WITHIN_SEQ2. out6 = {refstart, refstop, querystart, querystop,
// matches, errors}. Returns 1 if an acceptable match exists.
// ---------------------------------------------------------------------------
int orc_locate(const uint8_t* ref, int m, const uint8_t* qry, int n,
               double max_error_rate, int flags, int min_overlap,
               int* out6) {
    const bool sir = flags & 1, siq = flags & 2, str_ = flags & 4,
               stq = flags & 8;
    std::vector<int> cost(m + 1), match(m + 1, 0), orig(m + 1, 0);
    std::vector<int> npre(m + 1, 0);
    for (int i = 0; i < m; i++)
        npre[i + 1] = npre[i] + (((ref[i] & 15) == 15) ? 1 : 0);
    for (int i = 0; i <= m; i++) {
        if (sir) { cost[i] = 0; orig[i] = -i; }
        else { cost[i] = i; orig[i] = 0; }
    }
    long bestKeyM = -1; int bestC = 1 << 30;
    int bi = -1, bj = -1, bm = 0, bc = 0, bo = 0;
    auto consider = [&](int i, int j, int c, int mt, int og) {
        int refstart = og < 0 ? -og : 0;
        int length = i - refstart;
        if (length < min_overlap) return;
        int eff = length - (npre[i] - npre[refstart]);
        if ((double)c > max_error_rate * (double)eff) return;
        if (mt > bestKeyM || (mt == bestKeyM && c < bestC)) {
            bestKeyM = mt; bestC = c;
            bi = i; bj = j; bm = mt; bc = c; bo = og;
        }
    };
    consider(m, 0, cost[m], match[m], orig[m]);
    for (int j = 1; j <= n; j++) {
        const uint8_t qc = qry[j - 1];
        int dc = cost[0], dm = match[0], dg = orig[0];
        if (siq) { cost[0] = 0; match[0] = 0; orig[0] = j; }
        else { cost[0] = j; match[0] = 0; orig[0] = 0; }
        for (int i = 1; i <= m; i++) {
            const int pc = cost[i], pm = match[i], pg = orig[i];
            int nc, nm, ng;
            if (ref[i - 1] & qc) {
                nc = dc; nm = dm + 1; ng = dg;
            } else {
                const int cd = dc + 1, ch = pc + 1, cv = cost[i - 1] + 1;
                if (cd <= ch && cd <= cv) { nc = cd; nm = dm; ng = dg; }
                else if (ch <= cv) { nc = ch; nm = pm; ng = pg; }
                else { nc = cv; nm = match[i - 1]; ng = orig[i - 1]; }
            }
            cost[i] = nc; match[i] = nm; orig[i] = ng;
            dc = pc; dm = pm; dg = pg;
        }
        if (stq || j == n) consider(m, j, cost[m], match[m], orig[m]);
    }
    if (str_)
        for (int i = 0; i <= m; i++)
            consider(i, n, cost[i], match[i], orig[i]);
    if (bi < 0) return 0;
    out6[0] = bo < 0 ? -bo : 0;
    out6[1] = bi;
    out6[2] = bo > 0 ? bo : 0;
    out6[3] = bj;
    out6[4] = bm;
    out6[5] = bc;
    return 1;
}

// Batch locate: B reads x A adapters; out fields [B*A*6], valid [B*A].
void orc_locate_batch(const uint8_t* refs, const int* ref_offs,
                      const int* ref_lens, int A,
                      const uint8_t* qrys, const long* qry_offs,
                      const int* qry_lens, int B,
                      double e, int flags, int min_overlap,
                      int* out, uint8_t* valid, int nthreads) {
    parallel_for(B, orc_nthreads(nthreads), [&](int b) {
        for (int a = 0; a < A; a++) {
            int* o = out + ((long)b * A + a) * 6;
            valid[(long)b * A + a] = (uint8_t)orc_locate(
                refs + ref_offs[a], ref_lens[a], qrys + qry_offs[b],
                qry_lens[b], e, flags, min_overlap, o);
        }
    });
}

// ---------------------------------------------------------------------------
// Global (NW) alignment with traceback, for consensus star alignment.
// Banded: callers pass band >= final distance (e.g. from orc_edit_distance).
// ops out: 0 = diag (match/mismatch), 1 = consume A only (deletion in B),
// 2 = consume B only (insertion in B). Written start-to-end. Returns op
// count, or -1 if the band overflowed or cap too small.
// ---------------------------------------------------------------------------
int orc_nw_path(const uint8_t* a, int la, const uint8_t* b, int lb,
                int band, uint8_t* ops, int cap) {
    band = std::max(band, std::abs(la - lb) + 1);
    const int w = 2 * band + 1;
    const int INF = 1 << 28;
    std::vector<int> dp((size_t)(la + 1) * w, INF);
    std::vector<uint8_t> bt((size_t)(la + 1) * w, 255);
    auto idx = [&](int i, int j) { return (size_t)i * w + (j - i + band); };
    auto inb = [&](int i, int j) {
        return j >= 0 && j <= lb && (j - i + band) >= 0 && (j - i + band) < w;
    };
    dp[idx(0, 0)] = 0;
    for (int j = 1; j <= lb && inb(0, j); j++) {
        dp[idx(0, j)] = j; bt[idx(0, j)] = 2;
    }
    for (int i = 1; i <= la; i++) {
        const int jlo = std::max(0, i - band), jhi = std::min(lb, i + band);
        for (int j = jlo; j <= jhi; j++) {
            int best = INF; uint8_t op = 255;
            if (j > 0 && inb(i - 1, j - 1) && dp[idx(i - 1, j - 1)] < INF) {
                const int c = dp[idx(i - 1, j - 1)] +
                              ((a[i - 1] == b[j - 1]) ? 0 : 1);
                if (c < best) { best = c; op = 0; }
            }
            if (inb(i - 1, j) && dp[idx(i - 1, j)] < INF) {
                const int c = dp[idx(i - 1, j)] + 1;
                if (c < best) { best = c; op = 1; }
            }
            if (j > 0 && inb(i, j - 1) && dp[idx(i, j - 1)] < INF) {
                const int c = dp[idx(i, j - 1)] + 1;
                if (c < best) { best = c; op = 2; }
            }
            dp[idx(i, j)] = best; bt[idx(i, j)] = op;
        }
    }
    if (!inb(la, lb) || dp[idx(la, lb)] >= INF) return -1;
    // backtrack
    int i = la, j = lb, nops = 0;
    std::vector<uint8_t> rev;
    rev.reserve(la + lb);
    while (i > 0 || j > 0) {
        const uint8_t op = bt[idx(i, j)];
        if (op == 255) return -1;
        rev.push_back(op);
        if (op == 0) { i--; j--; }
        else if (op == 1) i--;
        else j--;
        nops++;
    }
    if (nops > cap) return -1;
    for (int k = 0; k < nops; k++) ops[k] = rev[nops - 1 - k];
    return nops;
}


// ---------------------------------------------------------------------------
// Bit-parallel NW path (edlib-style): full-matrix Myers forward pass
// storing per-column vertical (VP/VN, post-update) and horizontal
// (PH/MH, pre-shift) delta bits, then an O(la+lb) traceback walking
// score-consistent moves with the same tie-break order as orc_nw_path's
// forward DP (diag > consume-A > consume-B). ~3x faster than the banded
// DP + backtrack matrix for the consensus pileup loop. Returns op count
// or -1 (caller falls back to the banded path).
// ---------------------------------------------------------------------------
static int myers_nw_path(const uint8_t* a, int la, const uint8_t* b, int lb,
                         uint8_t* ops, int cap,
                         std::vector<uint64_t>& store) {
    if (la == 0 || lb == 0) {
        const int n = la + lb;
        if (n > cap) return -1;
        for (int k = 0; k < la; k++) ops[k] = 1;
        for (int k = 0; k < lb; k++) ops[k] = 2;
        return n;
    }
    const int W = (la + 63) / 64;
    // per column j: [VP x W][VN x W][PH x W][MH x W]
    store.resize((size_t)lb * W * 4);
    std::vector<uint64_t> Peq((size_t)W * 5, 0);
    for (int i = 0; i < la; i++)
        Peq[(size_t)(i / 64) * 5 + (a[i] < 5 ? a[i] : 4)] |= 1ull << (i % 64);
    std::vector<uint64_t> VP(W, ~0ull), VN(W, 0);
    int score = la;
    const int wm = (la - 1) / 64, rm = (la - 1) % 64;
    for (int j = 0; j < lb; j++) {
        int hin = 1;  // NW
        const uint8_t c = b[j] < 5 ? b[j] : 4;
        uint64_t* col = store.data() + (size_t)j * W * 4;
        for (int w = 0; w < W; w++) {
            uint64_t Eq = Peq[(size_t)w * 5 + c];
            const uint64_t hinNeg = hin < 0 ? 1ull : 0ull;
            const uint64_t hinPos = hin > 0 ? 1ull : 0ull;
            const uint64_t Pv = VP[w], Mv = VN[w];
            const uint64_t Xv = Eq | Mv;
            const uint64_t Eq_ = Eq | hinNeg;
            const uint64_t Xh = (((Eq_ & Pv) + Pv) ^ Pv) | Eq_;
            uint64_t Ph = Mv | ~(Xh | Pv);
            uint64_t Mh = Pv & Xh;
            col[2 * W + w] = Ph;  // pre-shift: bit (i-1) = hdelta at row i
            col[3 * W + w] = Mh;
            if (w == wm)
                score += (int)((Ph >> rm) & 1) - (int)((Mh >> rm) & 1);
            const int hout =
                (int)((Ph >> 63) & 1) - (int)((Mh >> 63) & 1);
            Ph = (Ph << 1) | hinPos;
            Mh = (Mh << 1) | hinNeg;
            VP[w] = Mh | ~(Xv | Ph);
            VN[w] = Ph & Xv;
            col[w] = VP[w];       // post-update: bit (i-1) = vdelta row i
            col[W + w] = VN[w];
            hin = hout;
        }
    }
    // traceback
    auto bit = [&](int j, int plane, int i) -> int {
        const uint64_t v =
            store[(size_t)j * W * 4 + (size_t)plane * W + (i - 1) / 64];
        return (int)((v >> ((i - 1) % 64)) & 1);
    };
    auto vdelta = [&](int j, int i) -> int {  // score(i,j) - score(i-1,j)
        if (j == 0) return 1;                  // column 0: score(i,0) = i
        return bit(j - 1, 0, i) - bit(j - 1, 1, i);
    };
    auto hdelta = [&](int j, int i) -> int {  // score(i,j) - score(i,j-1)
        return bit(j - 1, 2, i) - bit(j - 1, 3, i);
    };
    int i = la, jj = lb, s = score, nops = 0;
    std::vector<uint8_t> rev;
    rev.reserve(la + lb);
    while (i > 0 && jj > 0) {
        const int s_left = s - hdelta(jj, i);
        const int s_diag = s_left - vdelta(jj - 1, i);
        const int cost = (a[i - 1] == b[jj - 1]) ? 0 : 1;
        if (s_diag + cost == s) {
            rev.push_back(0); s = s_diag; i--; jj--;
        } else if (vdelta(jj, i) == 1) {   // score(i-1,j) == s-1
            rev.push_back(1); s = s - 1; i--;
        } else if (s_left + 1 == s) {
            rev.push_back(2); s = s_left; jj--;
        } else {
            return -1;  // inconsistent (should not happen)
        }
        nops++;
    }
    while (i > 0) { rev.push_back(1); i--; nops++; }
    while (jj > 0) { rev.push_back(2); jj--; nops++; }
    if (nops > cap) return -1;
    for (int k = 0; k < nops; k++) ops[k] = rev[nops - 1 - k];
    return nops;
}

// ---------------------------------------------------------------------------
// Batched star-alignment paths: align each read against ONE consensus
// draft (the consensus-builder hot loop; one ctypes crossing per group
// instead of per read). Bands derive per read from the exact Myers
// distance. ops_out is [nreads, stride] row-major; ops_len[r] = op count
// or -1 on band/cap overflow.
// ---------------------------------------------------------------------------
void orc_nw_path_batch(const uint8_t* seqs, const long* offs,
                       const int* lens, int nreads,
                       const uint8_t* cons, int lc,
                       uint8_t* ops_out, int stride, int* ops_len,
                       int nthreads) {
    parallel_for(nreads, orc_nthreads(nthreads), [&](int r) {
        static thread_local std::vector<uint64_t> store;
        const uint8_t* a = seqs + offs[r];
        const int la = lens[r];
        uint8_t* o = ops_out + (size_t)r * stride;
        int n = myers_nw_path(a, la, cons, lc, o, stride, store);
        if (n < 0) {  // fallback: banded DP (identical path semantics)
            const int d = orc_edit_distance(a, la, cons, lc, 0);
            n = orc_nw_path(a, la, cons, lc, d > 0 ? d : 1, o, stride);
        }
        ops_len[r] = n;
    });
}

// ---------------------------------------------------------------------------
// Fused star-alignment pileup: align every read against ONE consensus
// draft and accumulate per-column base counts in the exact column layout
// of cluster/consensus._align_rows (insertions at the same draft position
// share columns, right-aligned within the run; the draft itself votes as
// row 0 — reference create_consensus counts it, amplicon_sorter.py:372).
// counts is [capw, 5] int32 row-major. Returns the alignment width, or
// -1 if capw is too small (caller retries or falls back).
// ---------------------------------------------------------------------------
static long pileup_accumulate(const uint8_t* seqs, const long* offs,
                              int nreads, const uint8_t* cons, int lc,
                              const std::vector<uint8_t>& ops, int stride,
                              const std::vector<int>& nops,
                              int* counts, int capw);

long orc_pileup_batch(const uint8_t* seqs, const long* offs, const int* lens,
                      int nreads, const uint8_t* cons, int lc,
                      int* counts, int capw, int nthreads) {
    int maxlen = lc;
    for (int r = 0; r < nreads; r++) maxlen = std::max(maxlen, lens[r]);
    const int stride = maxlen + lc + 1;
    std::vector<uint8_t> ops((size_t)nreads * stride);
    std::vector<int> nops(nreads);
    parallel_for(nreads, orc_nthreads(nthreads), [&](int r) {
        static thread_local std::vector<uint64_t> store;
        const uint8_t* a = seqs + offs[r];
        const int la = lens[r];
        uint8_t* o = ops.data() + (size_t)r * stride;
        int n = myers_nw_path(a, la, cons, lc, o, stride, store);
        if (n < 0) {
            const int d = orc_edit_distance(a, la, cons, lc, 0);
            n = orc_nw_path(a, la, cons, lc, d > 0 ? d : 1, o, stride);
        }
        nops[r] = n;
    });
    for (int r = 0; r < nreads; r++)
        if (nops[r] < 0) return -1;
    return pileup_accumulate(seqs, offs, nreads, cons, lc, ops, stride,
                             nops, counts, capw);
}

static long pileup_accumulate(const uint8_t* seqs, const long* offs,
                              int nreads, const uint8_t* cons, int lc,
                              const std::vector<uint8_t>& ops, int stride,
                              const std::vector<int>& nops,
                              int* counts, int capw) {
    // pass 1: per-draft-position max insertion-run length across reads
    std::vector<int> ins_count(lc + 1, 0);
    for (int r = 0; r < nreads; r++) {
        const uint8_t* o = ops.data() + (size_t)r * stride;
        int ti = 0, run = 0;
        for (int k = 0; k < nops[r]; k++) {
            if (o[k] == 1) {
                run++;
            } else {
                if (run) {
                    ins_count[ti] = std::max(ins_count[ti], run);
                    run = 0;
                }
                ti++;
            }
        }
        if (run) ins_count[lc] = std::max(ins_count[lc], run);
    }
    // column layout: [ins before pos 0][pos 0][ins before 1][pos 1]...
    std::vector<long> col_of_t(lc), ins_base(lc + 1);
    long acc = 0;
    for (int p = 0; p < lc; p++) {
        ins_base[p] = acc;
        col_of_t[p] = acc + ins_count[p];
        acc = col_of_t[p] + 1;
    }
    ins_base[lc] = acc;
    const long width = acc + ins_count[lc];
    if (width > capw) return -1;
    std::memset(counts, 0, (size_t)width * 5 * sizeof(int));
    for (int p = 0; p < lc; p++)   // draft row votes
        if (cons[p] < 5) counts[col_of_t[p] * 5 + cons[p]]++;
    // pass 2: scatter matches and right-aligned insertions
    for (int r = 0; r < nreads; r++) {
        const uint8_t* o = ops.data() + (size_t)r * stride;
        const uint8_t* a = seqs + offs[r];
        int ti = 0, qi = 0, run = 0;
        for (int k = 0; k < nops[r]; k++) {
            const uint8_t op = o[k];
            if (op == 0) {
                if (a[qi] < 5) counts[col_of_t[ti] * 5 + a[qi]]++;
                ti++; qi++; run = 0;
            } else if (op == 1) {
                // rank within the run = `run`; right-aligned placement
                const long col = ins_base[ti] + ins_count[ti] - 1 - run;
                if (a[qi] < 5) counts[col * 5 + a[qi]]++;
                qi++; run++;
            } else {
                ti++; run = 0;
            }
        }
    }
    return width;
}

// ---------------------------------------------------------------------------
// Pileup from DEVICE-computed Myers bit-planes (the Pallas path-bits
// kernel, align/pallas_pileup.py). The kernel runs the forward DP with
// pattern = DRAFT and texts = reads, storing per READ position j the
// four delta planes over the draft words:
//   plane 0/1: VP/VN  (post-update; bit i-1 = score(i,j)-score(i-1,j))
//   plane 2/3: PH/MH  (pre-shift;  bit i-1 = score(i,j)-score(i,j-1))
// This traceback walks score-consistent moves with the preference
// diag > consume-READ > consume-DRAFT — the transposed image of
// myers_nw_path's (pattern=read) diag > consume-A > consume-B order, so
// the emitted op sequences are identical (both walk true full-matrix
// scores). planes layout per read: [ncols][4][W] uint32, ncols >= read
// length. Emits ops in the shared 0=diag 1=consume-read 2=consume-draft
// convention, then runs the same pileup accumulation as
// orc_pileup_batch. Returns width or -1.
// ---------------------------------------------------------------------------
static int traceback_from_bits(const uint32_t* planes, int W,
                               const uint8_t* read, int n,
                               const uint8_t* draft, int lc,
                               uint8_t* ops, int cap) {
    auto bit = [&](int j, int plane, int i) -> int {
        // column j is 1-based (state after read char j)
        const uint32_t v =
            planes[((size_t)(j - 1) * 4 + plane) * W + (i - 1) / 32];
        return (int)((v >> ((i - 1) % 32)) & 1);
    };
    auto vdelta = [&](int i, int j) -> int {
        if (j == 0) return 1;   // initial VP = all ones
        return bit(j, 0, i) - bit(j, 1, i);
    };
    auto hdelta = [&](int i, int j) -> int {
        return bit(j, 2, i) - bit(j, 3, i);
    };
    // starting score: lc + sum of top-row horizontal deltas
    int s = lc;
    for (int j = 1; j <= n; j++) s += hdelta(lc, j);
    int i = lc, j = n, nops_ = 0;
    std::vector<uint8_t> rev;
    rev.reserve(lc + n);
    while (i > 0 && j > 0) {
        const int s_left = s - hdelta(i, j);
        const int s_diag = s_left - vdelta(i, j - 1);
        const int cost = (draft[i - 1] == read[j - 1]) ? 0 : 1;
        if (s_diag + cost == s) {
            rev.push_back(0); s = s_diag; i--; j--;
        } else if (s_left + 1 == s) {
            rev.push_back(1); s = s_left; j--;       // consume read
        } else if (vdelta(i, j) == 1) {
            rev.push_back(2); s -= 1; i--;           // consume draft
        } else {
            return -1;
        }
        nops_++;
    }
    while (j > 0) { rev.push_back(1); j--; nops_++; }
    while (i > 0) { rev.push_back(2); i--; nops_++; }
    if (nops_ > cap) return -1;
    for (int k2 = 0; k2 < nops_; k2++) ops[k2] = rev[nops_ - 1 - k2];
    return nops_;
}

long orc_pileup_from_bits(const uint32_t* planes, long plane_stride,
                          int W, const uint8_t* seqs, const long* offs,
                          const int* lens, int nreads,
                          const uint8_t* cons, int lc,
                          int* counts, int capw, int nthreads) {
    int maxlen = lc;
    for (int r = 0; r < nreads; r++) maxlen = std::max(maxlen, lens[r]);
    const int stride = maxlen + lc + 1;
    std::vector<uint8_t> ops((size_t)nreads * stride);
    std::vector<int> nops(nreads);
    parallel_for(nreads, orc_nthreads(nthreads), [&](int r) {
        nops[r] = traceback_from_bits(
            planes + (size_t)r * plane_stride, W, seqs + offs[r],
            lens[r], cons, lc, ops.data() + (size_t)r * stride, stride);
    });
    for (int r = 0; r < nreads; r++)
        if (nops[r] < 0) return -1;
    return pileup_accumulate(seqs, offs, nreads, cons, lc, ops, stride,
                             nops, counts, capw);
}

// Batched one-vs-many NW distances (threaded): the finetune/converge
// scoring loops (amplicon_sorter.py:838-965 check_consensus) in one
// ctypes crossing.
void orc_nw_dist_batch(const uint8_t* q, int lq, const uint8_t* seqs,
                       const long* offs, const int* lens, int n,
                       int* d, int nthreads) {
    parallel_for(n, orc_nthreads(nthreads), [&](int i) {
        d[i] = orc_edit_distance(q, lq, seqs + offs[i], lens[i], 0);
    });
}

// Orientation distances for consensus_direction (amplicon_sorter.py:
// 1826-1838): NW distance of `first` vs each sequence forward and vs its
// reverse complement, one crossing per group.
void orc_orient_batch(const uint8_t* first, int l0, const uint8_t* seqs,
                      const long* offs, const int* lens, int nreads,
                      int* d_fwd, int* d_rc, int nthreads) {
    parallel_for(nreads, orc_nthreads(nthreads), [&](int r) {
        const uint8_t* a = seqs + offs[r];
        const int la = lens[r];
        d_fwd[r] = orc_edit_distance(first, l0, a, la, 0);
        std::vector<uint8_t> rc((size_t)la, 4);
        for (int k = 0; k < la; k++) {
            const uint8_t c = a[la - 1 - k];
            rc[k] = c < 4 ? (uint8_t)(3 - c) : c;
        }
        d_rc[r] = orc_edit_distance(first, l0, rc.data(), la, 0);
    });
}

// Batched consensus-pair HW distances: for each pair (pa[k], pb[k]) the
// HW distance of the shorter sequence within the longer, forward and vs
// the longer's reverse complement, threaded, ONE ctypes crossing for all
// G^2 merge-loop pairs (engine._hw_sim; reference iden_consensus
// amplicon_sorter.py:1140-1159 / compare_consensus :1840-1960).
void orc_hw_pairs(const uint8_t* seqs, const long* offs, const int* lens,
                  const int* pa, const int* pb, int npairs,
                  int* d_fwd, int* d_rc, int nthreads) {
    parallel_for(npairs, orc_nthreads(nthreads), [&](int k) {
        const int a = pa[k], b = pb[k];
        const uint8_t* A = seqs + offs[a];
        const uint8_t* B = seqs + offs[b];
        int la = lens[a], lb = lens[b];
        const uint8_t* S = A;
        const uint8_t* L = B;
        int ls = la, ll = lb;
        if (la > lb) { S = B; ls = lb; L = A; ll = la; }
        d_fwd[k] = orc_edit_distance(S, ls, L, ll, 2);
        std::vector<uint8_t> rc((size_t)ll, 4);
        for (int i = 0; i < ll; i++) {
            const uint8_t c = L[ll - 1 - i];
            rc[i] = c < 4 ? (uint8_t)(3 - c) : c;
        }
        d_rc[k] = orc_edit_distance(S, ls, rc.data(), ll, 2);
    });
}

}  // extern "C"
