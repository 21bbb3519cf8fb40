// The port's k-way merge of per-chunk suffix orders (out-of-core stage 1).
//
// A copy of native/extmerge.cpp for bfqzip_tpu_torch: the out-of-core path
// (bfqzip_tpu_torch/external.py) sorts each read chunk's suffixes on the
// card and merges the chunk orders here on the host, into the global BWT
// symbol, permuted quality, 1-byte LCP (255-capped), smoothing predecessor
// text[g-2] and suffix position.  The cursors, the word-wise comparators,
// both loser trees (plain, and LCP-augmented when the chunk LCPs are
// given), the sampled splitters and the checks on untrusted input are
// native/extmerge.cpp's, and the output bytes are too.  Three things
// differ, all for a consumer that smooths the merged prefix while the merge
// runs:
//
//  - Ordered ranges.  The output is cut into R ranges, more than the T
//    threads (8 per thread unless the caller names R), and the workers take
//    them from an atomic counter in output order.  The merged prefix then
//    trails the pool by about T ranges and grows at the pool's rate; with
//    one range per thread it grew at one thread's rate and jumped to the end.
//  - The seam handshake.  A range's first entry holds a provisional LCP of 0
//    until its predecessor's last suffix is known.  Each seam between
//    non-empty ranges counts two arrivals, "range r finished" and "the next
//    range wrote its first entry"; whichever comes second fixes the LCP and
//    then publishes r's end.  Nothing waits, at any T (a spin on the next
//    range would deadlock once ranges queue for threads).  No in-loop
//    publish reaches a range's end, so a consumer never reads a seam before
//    it is fixed.  The serial entry points keep a final boundary pass.
//  - The progress step is an argument (a power of two), and
//    ext_merge_prefix reads the cursors with acquire loads, which order the
//    consumer's reads on any host, aarch64 included.
//
// Built by bfqzip_tpu_torch/utils/cuda_build.py with the host compiler and
// no -march flag, so the library runs on any x86-64 or aarch64 host.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kTermCode = 0;   // alphabet.TERM
constexpr uint8_t kTermChar = '#'; // alphabet.TERM_CHAR

inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// 0x80 in every byte of v that is 0x00 (classic SWAR zero-byte detector)
inline uint64_t zero_bytes(uint64_t v) {
    return (v - 0x0101010101010101ull) & ~v & 0x8080808080808080ull;
}

// suffix comparator on the padded text; 0 stops a row (terminator/pad).
// Every row ends with at least one 0 inside the array (k = wp-1 is always
// pad), so the byte tail loop cannot run off the end; the word loop is
// additionally bounds-guarded for its 8-byte loads.
inline bool suffix_less(const uint8_t* text, int64_t n_pad, int64_t a, int64_t b) {
    if (a == b) return false;
    const uint8_t* pa = text + a;
    const uint8_t* pb = text + b;
    int64_t lim = n_pad - (a > b ? a : b);  // bytes both sides can load
    int64_t i = 0;
    while (i + 8 <= lim) {
        uint64_t va = load64(pa + i), vb = load64(pb + i);
        uint64_t diff = va ^ vb;
        uint64_t term = zero_bytes(va);
        if (!(diff | term)) { i += 8; continue; }
        // first interesting byte: a mismatch or a's terminator, whichever
        // comes first (little-endian: lowest set bit = earliest byte)
        int dj = diff ? __builtin_ctzll(diff) >> 3 : 8;
        int zj = term ? __builtin_ctzll(term) >> 3 : 8;
        int j = dj < zj ? dj : zj;
        uint8_t ca = pa[i + j], cb = pb[i + j];
        if (ca != cb) return ca < cb;
        // equal terminators: same in-read offset -> position order
        return a < b;
    }
    pa += i; pb += i;
    while (*pa != 0 && *pa == *pb) { pa++; pb++; }
    if (*pa != *pb) return *pa < *pb;
    return a < b;
}

inline uint8_t lcp255(const uint8_t* text, int64_t n_pad, int64_t a, int64_t b) {
    const uint8_t* pa = text + a;
    const uint8_t* pb = text + b;
    int64_t lim = n_pad - (a > b ? a : b);
    if (lim > 255 + 8) lim = 255 + 8;
    int64_t i = 0;
    while (i + 8 <= lim && i < 255) {
        uint64_t va = load64(pa + i), vb = load64(pb + i);
        uint64_t stop = (va ^ vb) | zero_bytes(va);
        if (!stop) { i += 8; continue; }
        i += __builtin_ctzll(stop) >> 3;
        return (uint8_t)(i < 255 ? i : 255);
    }
    while (i < 255 && pa[i] != 0 && pa[i] == pb[i]) i++;
    return (uint8_t)i;
}

// TIdx = int32_t for workloads under 2^31 positions, int64_t beyond (the
// reference's dataTypeNChar=ulong analog, parameters.h:60-106: 50M x 101bp
// reads already exceed int32 global positions).
template <typename TIdx>
struct Cursor {
    const TIdx* p;
    const TIdx* end;
    const uint8_t* lcp;  // intra-chunk LCP of *p vs its chunk predecessor
                         // (255-capped lower bound); null when unavailable
};

// Order + mutual LCP of suffixes a < b starting from a known common prefix
// `from` (a valid lower bound of lcp(a,b)).  Returns (a<b) and writes the
// 255-capped mutual lcp.
inline bool suffix_less_from(const uint8_t* text, int64_t n_pad, int64_t a,
                             int64_t b, int from, int* out_lcp) {
    if (a == b) { *out_lcp = 255; return false; }
    const uint8_t* pa = text + a + from;
    const uint8_t* pb = text + b + from;
    int64_t lim = n_pad - (a > b ? a : b) - from;
    int64_t i = 0;
    while (i + 8 <= lim) {
        uint64_t va = load64(pa + i), vb = load64(pb + i);
        uint64_t diff = va ^ vb;
        uint64_t term = zero_bytes(va);
        if (!(diff | term)) { i += 8; continue; }
        int dj = diff ? __builtin_ctzll(diff) >> 3 : 8;
        int zj = term ? __builtin_ctzll(term) >> 3 : 8;
        int j = dj < zj ? dj : zj;
        int64_t l = from + i + j;
        *out_lcp = l > 255 ? 255 : (int)l;
        uint8_t ca = pa[i + j], cb = pb[i + j];
        if (ca != cb) return ca < cb;
        return a < b;  // equal terminators: position order
    }
    // byte tail (in-bounds: every row ends in a 0 before the array end)
    while (pa[i] != 0 && pa[i] == pb[i]) i++;
    int64_t l = from + i;
    *out_lcp = l > 255 ? 255 : (int)l;
    if (pa[i] != pb[i]) return pa[i] < pb[i];
    return a < b;
}

int merge_threads() {
    if (const char* e = std::getenv("BFQ_EXT_THREADS")) {
        int v = std::atoi(e);
        if (v > 0) return v;
    }
    unsigned hc = std::thread::hardware_concurrency();
    return hc ? (int)hc : 2;
}

// Ranges shorter than this are not worth a loser tree of their own.
constexpr int64_t kMinRange = 512;
constexpr int64_t kRangesPerThread = 8;
// The serial merge's progress step: never reached, so the per-emit
// progress branch is never taken.
constexpr int64_t kNoStep = int64_t(1) << 62;

inline void publish(int64_t* slot, int64_t value) {
    __atomic_store_n(slot, value, __ATOMIC_RELEASE);
}

// Loser-tree merge of one output range; returns 0 or a negative error code.
// lcp_out[0] is left 0 for the seam fix-up.  on_first() runs once entry 0
// is written.  prog (nullable) receives the absolute cursor abs_base + i + 1
// after entry 0 and then every step emits (step_mask = step - 1), but never
// the range's end: the caller publishes that once the seam is fixed.
template <typename TIdx, typename OnFirst>
int merge_range(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                std::vector<Cursor<TIdx>>& cur, int64_t total,
                uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                uint8_t* pre_out, TIdx* sa_out,
                int64_t* prog, int64_t step_mask, int64_t abs_base,
                OnFirst&& on_first) {
    int32_t n_chunks = (int32_t)cur.size();
    // internal nodes hold the LOSER chunk id, `winner` the overall minimum.
    // k is small (<= a few hundred), so the tree lives in L1; each emit
    // costs ceil(log2 k) suffix comparisons.
    int k = 1;
    while (k < n_chunks) k <<= 1;
    std::vector<int32_t> node((size_t)k, -1);  // internal loser slots
    auto head_less = [&](int32_t a, int32_t b) {
        // exhausted cursors sort last
        bool ea = cur[a].p == cur[a].end, eb = cur[b].p == cur[b].end;
        if (ea || eb) return !ea;
        return suffix_less(text, n_pad, *cur[a].p, *cur[b].p);
    };
    // initial winner via pairwise tournament
    int32_t winner = -1;
    {
        std::vector<int32_t> level((size_t)k, -1);
        for (int32_t c = 0; c < n_chunks; c++) level[c] = c;
        int width = k;
        int base = k;  // node indices [1, k) as a heap; fill bottom-up
        while (width > 1) {
            width >>= 1;
            base -= width;
            for (int i = 0; i < width; i++) {
                int32_t a = level[2 * i], b = level[2 * i + 1];
                int32_t w, l;
                if (b < 0 || (a >= 0 && head_less(a, b))) { w = a; l = b; }
                else { w = b; l = a; }
                node[base + i] = l;
                level[i] = w;
            }
        }
        winner = level[0];
    }

    int64_t prev_g = -1;
    for (int64_t i = 0; i < total; i++) {
        if (winner < 0 || cur[winner].p == cur[winner].end) return -3;
        int64_t g = *cur[winner].p++;
        if (cur[winner].p != cur[winner].end) {
            // the advancing chunk's next suffix is a likely near-term emit:
            // warm its output text lines while the tree replay runs
            int64_t ng = *cur[winner].p;
            __builtin_prefetch(text + (ng ? ng - 1 : 0));
            __builtin_prefetch(qtext + (ng ? ng - 1 : 0));
        }
        if (g <= 0 || g >= n_pad) {
            // g == 0 would need text[-1]; the padded layout always starts a
            // read at 0 whose preceding slot wraps — handle explicitly
            if (g != 0) return -4;
        }
        int64_t gp = g == 0 ? n_pad - 1 : g - 1;
        int64_t gp2 = g <= 1 ? n_pad - (2 - g) : g - 2;
        uint8_t cprev = text[gp];
        bwt_out[i] = cprev == 0 ? kTermCode : (uint8_t)(cprev - 1);
        qs_out[i] = cprev == 0 ? kTermChar : qtext[gp];
        uint8_t c2 = text[gp2];
        pre_out[i] = c2 == 0 ? kTermCode : (uint8_t)(c2 - 1);
        lcp_out[i] = prev_g < 0 ? 0 : lcp255(text, n_pad, prev_g, g);
        sa_out[i] = (TIdx)g;
        prev_g = g;
        if (i == 0 || ((i + 1) & step_mask) == 0) {
            if (i == 0) on_first();
            if (prog && i + 1 < total) publish(prog, abs_base + i + 1);
        }

        // replay the loser tree along winner's leaf-to-root path
        int32_t w = winner;
        for (int idx = (k + w) >> 1; idx >= 1; idx >>= 1) {
            int32_t l = node[idx];
            if (l >= 0 && !head_less(w, l)) {
                node[idx] = w;
                w = l;
            }
        }
        winner = w;
    }
    return 0;
}

// LCP-augmented loser tree (the Ng/Kakehi string-merge scheme): each node
// stores (loser, 255-capped lcp(loser head, the winner that defeated it)).
// A replay walks only the emitted winner's root path, where every stored
// lcp is relative to that same winner, so ordering is decided by comparing
// two integers — the text is walked only on exact ties, starting at the
// tied offset.  The carried lcp of the element reaching the root IS the
// next output LCP, so the per-emit lcp255 walk disappears too.  Intra-chunk
// LCPs (cur[].lcp, from the device chunk sorts) seed the carry when a
// cursor advances past its just-emitted predecessor.  Progress as in
// merge_range.
template <typename TIdx, typename OnFirst>
int merge_range_lcp(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                    std::vector<Cursor<TIdx>>& cur, int64_t total,
                    uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                    uint8_t* pre_out, TIdx* sa_out,
                    int64_t* prog, int64_t step_mask, int64_t abs_base,
                    OnFirst&& on_first) {
    int32_t n_chunks = (int32_t)cur.size();
    int k = 1;
    while (k < n_chunks) k <<= 1;
    std::vector<int32_t> node((size_t)k, -1);
    std::vector<int> nlcp((size_t)k, 0);

    int32_t winner = -1;
    int wlcp = 0;
    {
        std::vector<int32_t> level((size_t)k, -1);
        for (int32_t c = 0; c < n_chunks; c++) level[c] = c;
        int width = k;
        int base = k;
        while (width > 1) {
            width >>= 1;
            base -= width;
            for (int i = 0; i < width; i++) {
                int32_t a = level[2 * i], b = level[2 * i + 1];
                int32_t w, l;
                int ml = 0;
                if (b < 0) { w = a; l = b; }
                else if (a < 0) { w = b; l = a; }
                else {
                    bool ea = cur[a].p == cur[a].end, eb = cur[b].p == cur[b].end;
                    bool aw;
                    if (ea || eb) aw = !ea;
                    else aw = suffix_less_from(text, n_pad, *cur[a].p,
                                               *cur[b].p, 0, &ml);
                    if (aw) { w = a; l = b; }
                    else { w = b; l = a; }
                }
                node[base + i] = l;
                nlcp[base + i] = ml;
                level[i] = w;
            }
        }
        winner = level[0];
    }

    for (int64_t i = 0; i < total; i++) {
        if (winner < 0 || cur[winner].p == cur[winner].end) return -3;
        int64_t g = *cur[winner].p++;
        cur[winner].lcp++;
        if (cur[winner].p != cur[winner].end) {
            // the advancing chunk's next suffix is a likely near-term emit:
            // warm its output text lines while the tree replay runs
            int64_t ng = *cur[winner].p;
            __builtin_prefetch(text + (ng ? ng - 1 : 0));
            __builtin_prefetch(qtext + (ng ? ng - 1 : 0));
        }
        if (g <= 0 || g >= n_pad) {
            if (g != 0) return -4;
        }
        int64_t gp = g == 0 ? n_pad - 1 : g - 1;
        int64_t gp2 = g <= 1 ? n_pad - (2 - g) : g - 2;
        uint8_t cprev = text[gp];
        bwt_out[i] = cprev == 0 ? kTermCode : (uint8_t)(cprev - 1);
        qs_out[i] = cprev == 0 ? kTermChar : qtext[gp];
        uint8_t c2 = text[gp2];
        pre_out[i] = c2 == 0 ? kTermCode : (uint8_t)(c2 - 1);
        lcp_out[i] = i == 0 ? 0 : (uint8_t)wlcp;
        sa_out[i] = (TIdx)g;
        if (i == 0 || ((i + 1) & step_mask) == 0) {
            if (i == 0) on_first();
            if (prog && i + 1 < total) publish(prog, abs_base + i + 1);
        }

        // replay: carried cl = lcp(new head, the suffix just emitted)
        int32_t w = winner;
        bool wex = cur[w].p == cur[w].end;
        int cl = wex ? 0 : (int)*cur[w].lcp;
        for (int idx = (k + w) >> 1; idx >= 1; idx >>= 1) {
            int32_t l = node[idx];
            if (l < 0) continue;
            bool lex = cur[l].p == cur[l].end;
            int ll = nlcp[idx];
            bool w_wins;
            int mutual;
            if (wex || lex) {
                w_wins = !wex;
                mutual = 0;
            } else if (cl != ll) {
                w_wins = cl > ll;
                mutual = cl < ll ? cl : ll;
            } else {
                w_wins = suffix_less_from(text, n_pad, *cur[w].p, *cur[l].p,
                                          cl, &mutual);
            }
            if (w_wins) {
                nlcp[idx] = mutual;  // lcp(l, w) — w is the winner here
            } else {
                node[idx] = w;
                nlcp[idx] = mutual;
                w = l;
                cl = ll;
                wex = lex;
            }
        }
        winner = w;
        wlcp = cl;
    }
    return 0;
}

// Returns the merged total, negative on error.  nthreads <= 0 picks one
// thread per core (BFQ_EXT_THREADS overrides), nranges <= 0 picks 8 ranges
// per thread; both shrink so that a range holds at least kMinRange
// positions.  lcp_all (nullable) holds each chunk's intra-chunk 255-capped
// LCP aligned with sa_all and selects the LCP loser tree.
// prog (nullable): live progress for a concurrent consumer, an int64 array
// of 1 + 3 * nranges slots (nranges explicit):
//   prog[0]          = R, the number of ranges used (0 until the partition
//                      is fixed: nothing is consumable before)
//   prog[1+3r .. ]   = {range start, range end, absolute cursor} per range
// Every position below a range's cursor is final; a range's cursor reaches
// its end only after the boundary LCP of the next non-empty range is fixed.
// ext_merge_prefix walks the ranges in order to the first cursor short of
// its end.
template <typename TIdx>
int64_t ext_merge_impl(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                       const TIdx* sa_all, const uint8_t* lcp_all,
                       const int64_t* offs, int32_t n_chunks,
                       uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                       uint8_t* pre_out, TIdx* sa_out, int nthreads, int nranges,
                       int64_t* prog, int64_t step) {
    if (n_chunks <= 0) return -1;
    for (int32_t c = 0; c < n_chunks; c++)
        if (offs[c + 1] < offs[c]) return -2;
    int64_t total = offs[n_chunks];
    // validate every suffix position once, up front (untrusted input must
    // fail cleanly, not index out of bounds inside the merge threads)
    for (int64_t i = 0; i < total; i++)
        if (sa_all[i] < 0 || sa_all[i] >= n_pad) return -4;

    if (nthreads <= 0) nthreads = merge_threads();
    int64_t R = nranges > 0 ? nranges : kRangesPerThread * nthreads;
    R = std::max<int64_t>(std::min<int64_t>(R, total / kMinRange), 1);
    int T = (int)std::min<int64_t>(nthreads, R);

    // ---- splitter selection: sampled quantiles of the merged order ----
    std::vector<int64_t> samples;
    if (R > 1) {
        for (int32_t c = 0; c < n_chunks; c++) {
            int64_t len = offs[c + 1] - offs[c];
            if (len == 0) continue;
            int64_t s = std::min<int64_t>(len, 32 * R);
            for (int64_t j = 0; j < s; j++)
                samples.push_back(sa_all[offs[c] + j * len / s]);
        }
        std::sort(samples.begin(), samples.end(), [&](int64_t a, int64_t b) {
            return suffix_less(text, n_pad, a, b);
        });
    }

    // bounds[r][c]: partition point of splitter r in chunk c (r=0 -> 0,
    // r=R -> chunk length); splitters ascend, so bounds are monotone per
    // chunk and the output ranges [out0[r], out0[r+1]) tile exactly.
    std::vector<std::vector<int64_t>> bounds((size_t)R + 1,
                                             std::vector<int64_t>((size_t)n_chunks));
    for (int32_t c = 0; c < n_chunks; c++) {
        bounds[0][c] = 0;
        bounds[R][c] = offs[c + 1] - offs[c];
    }
    for (int64_t r = 1; r < R; r++) {
        int64_t spl = samples[(size_t)r * samples.size() / R];
        for (int32_t c = 0; c < n_chunks; c++) {
            const TIdx* lo = sa_all + offs[c];
            const TIdx* hi = sa_all + offs[c + 1];
            const TIdx* it = std::partition_point(lo, hi, [&](TIdx g) {
                return suffix_less(text, n_pad, g, spl);
            });
            bounds[r][c] = it - lo;
        }
    }

    std::vector<int64_t> out0((size_t)R + 1, 0);
    for (int64_t r = 0; r <= R; r++)
        for (int32_t c = 0; c < n_chunks; c++) out0[r] += bounds[r][c];
    if (out0[R] != total) return -5;  // partition must tile exactly

    // the non-empty neighbours of each range (-1 / R where there is none)
    std::vector<int64_t> prev_ne((size_t)R), next_ne((size_t)R);
    for (int64_t r = 0, last = -1; r < R; r++) {
        prev_ne[r] = last;
        if (out0[r + 1] > out0[r]) last = r;
    }
    for (int64_t r = R - 1, last = R; r >= 0; r--) {
        next_ne[r] = last;
        if (out0[r + 1] > out0[r]) last = r;
    }
    std::unique_ptr<std::atomic<int>[]> seams(new std::atomic<int>[(size_t)R]);
    for (int64_t r = 0; r < R; r++) seams[r].store(0, std::memory_order_relaxed);
    if (prog) {
        // an empty range starts at its end: a consumer walks through it
        for (int64_t r = 0; r < R; r++) {
            prog[1 + 3 * r] = out0[r];
            prog[2 + 3 * r] = out0[r + 1];
            publish(&prog[3 + 3 * r], out0[r]);
        }
        publish(&prog[0], R);
    }
    // The seam after non-empty range r: the second of its two arrivals
    // fixes the next non-empty range's first LCP, then publishes r's end.
    // acq_rel orders the first arriver's writes before the fix.
    auto arrive = [&](int64_t r) {
        if (seams[r].fetch_add(1, std::memory_order_acq_rel) == 0) return;
        int64_t e = out0[r + 1];
        lcp_out[e] = lcp255(text, n_pad, sa_out[e - 1], sa_out[e]);
        publish(&prog[3 + 3 * r], e);
    };

    const int64_t step_mask = step - 1;
    std::vector<int> rcs((size_t)R, 0);
    std::atomic<int64_t> next_range{0};
    std::atomic<bool> any_err{false};
    auto worker = [&]() {
        std::vector<Cursor<TIdx>> cur((size_t)n_chunks);
        static const uint8_t kZeroLcp = 0;
        while (!any_err.load(std::memory_order_relaxed)) {
            int64_t r = next_range.fetch_add(1);
            if (r >= R) return;
            int64_t o = out0[r], len = out0[r + 1] - o;
            if (len == 0) continue;
            for (int32_t c = 0; c < n_chunks; c++) {
                int64_t s = bounds[r][c], e = bounds[r + 1][c];
                cur[c] = {sa_all + offs[c] + s, sa_all + offs[c] + e,
                          lcp_all ? lcp_all + offs[c] + s : &kZeroLcp};
            }
            int64_t* pr = prog ? &prog[3 + 3 * r] : nullptr;
            auto on_first = [&]() {
                if (prog && prev_ne[r] >= 0) arrive(prev_ne[r]);
            };
            int rc = lcp_all
                ? merge_range_lcp(text, qtext, n_pad, cur, len, bwt_out + o, qs_out + o,
                                  lcp_out + o, pre_out + o, sa_out + o, pr, step_mask, o,
                                  on_first)
                : merge_range(text, qtext, n_pad, cur, len, bwt_out + o, qs_out + o,
                              lcp_out + o, pre_out + o, sa_out + o, pr, step_mask, o,
                              on_first);
            if (rc < 0) {
                rcs[r] = rc;
                any_err.store(true);
                return;
            }
            if (!prog) continue;
            if (next_ne[r] < R) arrive(r);
            else publish(pr, out0[r + 1]);  // the last range: no seam
        }
    };
    if (T <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < T; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    for (int64_t r = 0; r < R; r++)
        if (rcs[r] < 0) return rcs[r];

    // boundary LCPs of the serial merge: each range's first entry vs the
    // previous merged suffix (the seams did this with progress)
    if (!prog) {
        for (int64_t r = 1; r < R; r++) {
            int64_t i = out0[r];
            if (i > 0 && i < total && out0[r + 1] > i)
                lcp_out[i] = lcp255(text, n_pad, sa_out[i - 1], sa_out[i]);
        }
    }
    return total;
}

}  // namespace

extern "C" {

// Serial merges (the caller waits): int32 positions, and int64 positions,
// required beyond 2^31 total positions (~21M reads of 101 bp).
int64_t ext_merge_mt2(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                      const int32_t* sa_all, const uint8_t* lcp_all,
                      const int64_t* offs, int32_t n_chunks,
                      uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                      uint8_t* pre_out, int32_t* sa_out, int nthreads, int nranges) {
    return ext_merge_impl<int32_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads, nranges, nullptr, kNoStep);
}

int64_t ext_merge_mt3(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                      const int64_t* sa_all, const uint8_t* lcp_all,
                      const int64_t* offs, int32_t n_chunks,
                      uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                      uint8_t* pre_out, int64_t* sa_out, int nthreads, int nranges) {
    return ext_merge_impl<int64_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads, nranges, nullptr, kNoStep);
}

// Live-progress merges: prog is a caller-owned int64 array of 1 + 3 *
// nranges slots (layout at ext_merge_impl) that a concurrent consumer reads
// through ext_merge_prefix; nthreads and nranges must be explicit (> 0) and
// step, the emits between in-loop publishes, a power of two.
int64_t ext_merge_mt2p(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                       const int32_t* sa_all, const uint8_t* lcp_all,
                       const int64_t* offs, int32_t n_chunks,
                       uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                       uint8_t* pre_out, int32_t* sa_out, int nthreads, int nranges,
                       int64_t* prog, int64_t step) {
    if (nthreads <= 0 || nranges <= 0 || !prog || step <= 0 || (step & (step - 1)))
        return -6;
    return ext_merge_impl<int32_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads, nranges, prog, step);
}

int64_t ext_merge_mt3p(const uint8_t* text, const uint8_t* qtext, int64_t n_pad,
                       const int64_t* sa_all, const uint8_t* lcp_all,
                       const int64_t* offs, int32_t n_chunks,
                       uint8_t* bwt_out, uint8_t* qs_out, uint8_t* lcp_out,
                       uint8_t* pre_out, int64_t* sa_out, int nthreads, int nranges,
                       int64_t* prog, int64_t step) {
    if (nthreads <= 0 || nranges <= 0 || !prog || step <= 0 || (step & (step - 1)))
        return -6;
    return ext_merge_impl<int64_t>(text, qtext, n_pad, sa_all, lcp_all, offs,
                                   n_chunks, bwt_out, qs_out, lcp_out, pre_out,
                                   sa_out, nthreads, nranges, prog, step);
}

// The merged prefix P of a live merge: every output position below P is
// final.  Walks the ranges in order and stops at the first cursor short of
// its range's end; the acquire loads make the outputs below each cursor
// visible to the caller.
int64_t ext_merge_prefix(const int64_t* prog) {
    int64_t R = __atomic_load_n(&prog[0], __ATOMIC_ACQUIRE);
    int64_t p = 0;
    for (int64_t r = 0; r < R; r++) {
        int64_t end = prog[2 + 3 * r];
        int64_t cursor = __atomic_load_n(&prog[3 + 3 * r], __ATOMIC_ACQUIRE);
        if (cursor < end) return cursor;
        p = end;
    }
    return p;
}

}  // extern "C"
