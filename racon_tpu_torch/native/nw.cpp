// Banded Needleman-Wunsch global aligner with traceback.
//
// Native (host) replacement for the reference's edlib dependency: racon
// calls edlibAlign(..., EDLIB_MODE_NW, EDLIB_TASK_PATH) once per PAF/MHAP
// overlap to recover a CIGAR (reference: src/overlap.cpp:198-213). Overlap
// spans reach tens of kilobases, so the full O(Lq*Lt) matrix is avoided
// with a diagonal band that doubles until the optimal path stays strictly
// inside it (the same adaptive-band idea edlib uses); a band covering the
// whole matrix is exact plain NW, so the loop always terminates with an
// optimal alignment.
//
// Semantics are kept identical to the JAX device kernel
// (racon_tpu/ops/align.py): linear gap, int32 scores, tie preference
// DIAG > UP > LEFT, op encoding 0=M (diag), 1=I (up, consumes query),
// 2=D (left, consumes target).
//
// Band coordinates: k = j - i, band k in [klo, khi], column b = k - klo.
// Moving to row i+1: diag neighbour keeps b, up neighbour is b+1 in the
// previous row, left neighbour is b-1 in the same row.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr int32_t kNegInf = INT32_MIN / 4;
enum Dir : uint8_t { kDiag = 0, kUp = 1, kLeft = 2 };

struct BandResult {
    int32_t n_ops = -1;
    int32_t score = kNegInf;
};

// One banded pass. ops_out is filled back-to-front and left in
// start->end order on return.
BandResult band_pass(const uint8_t* q, int32_t lq, const uint8_t* t,
                     int32_t lt, int32_t m, int32_t x, int32_t g,
                     int32_t klo, int32_t khi, uint8_t* ops_out) {
    BandResult res;
    const int32_t bandw = khi - klo + 1;

    std::vector<uint8_t> dirs(static_cast<size_t>(lq + 1) * bandw);
    std::vector<int32_t> prev(bandw + 1, kNegInf), cur(bandw + 1, kNegInf);
    // prev/cur have one sentinel slot at the end so the up-neighbour read
    // prev[b + 1] is always in range.

    // Row 0: H[0][j] = j*g for j in [max(0, klo), min(lt, khi)].
    {
        const int32_t jlo = std::max(0, klo), jhi = std::min(lt, khi);
        for (int32_t j = jlo; j <= jhi; ++j) {
            prev[j - klo] = j * g;
        }
    }

    for (int32_t i = 1; i <= lq; ++i) {
        const int32_t jlo = std::max(0, i + klo);
        const int32_t jhi = std::min(lt, i + khi);
        if (jlo > jhi) return res;  // band fell off the matrix
        const uint8_t qc = q[i - 1];
        uint8_t* drow = dirs.data() + static_cast<size_t>(i) * bandw;

        int32_t blo = jlo - i - klo;
        const int32_t bhi = jhi - i - klo;
        // j = 0 boundary handled outside the hot loops.
        if (jlo == 0) {
            cur[blo] = i * g;
            drow[blo] = kUp;
            ++blo;
        }
        // Branchless vectorizable phase: tmp = max(diag, up). For b in
        // [blo, bhi], j = i + klo + b >= 1, so t[j-1] = tj[b] is in range.
        const uint8_t* tj = t + (i + klo - 1);
        const int32_t* pv = prev.data();
        int32_t* cu = cur.data();
        for (int32_t b = blo; b <= bhi; ++b) {
            const int32_t sub = tj[b] == qc ? m : x;
            const int32_t diag = pv[b] + sub;
            const int32_t up = pv[b + 1] + g;
            cu[b] = diag > up ? diag : up;
        }
        // Serial phase: fold in the left-gap chain and label directions.
        int32_t left = (jlo == 0) ? cur[blo - 1] : kNegInf;
        for (int32_t b = blo; b <= bhi; ++b) {
            const int32_t diag = pv[b] + (tj[b] == qc ? m : x);
            int32_t h = cu[b];
            if (left + g > h) h = left + g;
            cu[b] = h;
            left = h;
            drow[b] = (h == diag) ? kDiag
                                  : (h == pv[b + 1] + g ? kUp : kLeft);
        }
        // Sentinels outside the valid window (the next row reads one slot
        // past each side; a full fill per row is wasted bandwidth).
        if (blo - 1 >= 0 && jlo != 0) cur[blo - 1] = kNegInf;
        if (blo - 2 >= 0) cur[blo - 2] = kNegInf;
        if (bhi + 1 < bandw + 1) cur[bhi + 1] = kNegInf;
        std::swap(prev, cur);
    }

    const int32_t bend = lt - lq - klo;
    if (bend < 0 || bend >= bandw) return res;
    res.score = prev[bend];
    if (res.score <= kNegInf / 2) return res;

    // Traceback from (lq, lt).
    int32_t i = lq, j = lt, pos = lq + lt;
    while (i > 0 || j > 0) {
        uint8_t d;
        if (i == 0) {
            d = kLeft;
        } else if (j == 0) {
            d = kUp;
        } else {
            const int32_t b = j - i - klo;
            if (b < 0 || b >= bandw) return res;  // should not happen
            d = dirs[static_cast<size_t>(i) * bandw + b];
        }
        ops_out[--pos] = d;
        if (d != kLeft) --i;
        if (d != kUp) --j;
    }
    res.n_ops = lq + lt - pos;
    if (pos > 0) {
        std::memmove(ops_out, ops_out + pos, res.n_ops);
    }
    return res;
}

}  // namespace

extern "C" {

// Globally align q vs t; writes ops (0=M,1=I,2=D) into ops_out (capacity
// lq + lt). Returns the op count, or -1 on failure. band0 <= 0 selects an
// automatic initial half-width. score_out (optional) receives the score.
int32_t racon_nw_align(const uint8_t* q, int32_t lq, const uint8_t* t,
                       int32_t lt, int32_t m, int32_t x, int32_t g,
                       int32_t band0, uint8_t* ops_out, int32_t* score_out) {
    if (lq < 0 || lt < 0) return -1;
    if (lq == 0) {
        std::memset(ops_out, kLeft, lt);
        if (score_out) *score_out = lt * g;
        return lt;
    }
    if (lt == 0) {
        std::memset(ops_out, kUp, lq);
        if (score_out) *score_out = lq * g;
        return lq;
    }

    int32_t w = band0 > 0 ? band0
                          : std::max<int32_t>(128, std::abs(lt - lq) + 64);
    // The escape bound below needs g < 0 (it divides by -g, and with
    // free gaps no banded score can ever prove exactness): g >= 0 runs
    // the full matrix directly.
    if (g >= 0) w = std::max(lq, lt);
    // Acceptance is a *provable* escape bound (Ukkonen banding
    // generalized to match-bonus scoring), not the untouched-edge
    // heuristic: a balanced long insertion+deletion can route the
    // optimal path outside the band while a sub-optimal in-band path
    // never touches the edge (ADVICE r2 #1; edlib is exact).
    //   Any path leaving the band [min(0,d)-w, max(0,d)+w] (d = lt-lq)
    //   needs >= |d| + 2(w+1) gap ops (reach the edge + return), and has
    //   at most min(lq,lt) matches, so it scores at most
    //     max(m,0)*min(lq,lt) + g*(|d| + 2w + 2).
    //   A banded score >= that bound therefore beats every escaping
    //   path, and the in-band DP is exact over in-band paths.
    // Typical polishing alignments accept on the first pass; the loop
    // terminates at the full matrix regardless.
    const int64_t dgap = std::abs(lt - lq);
    const int64_t mmax = static_cast<int64_t>(std::max(m, 0)) *
                         std::min(lq, lt);
    while (true) {
        const int32_t klo = std::max(std::min(0, lt - lq) - w, -lq);
        const int32_t khi = std::min(std::max(0, lt - lq) + w, lt);
        BandResult res = band_pass(q, lq, t, lt, m, x, g, klo, khi, ops_out);
        if (klo <= -lq && khi >= lt) {
            // Full matrix — exact.
            if (res.n_ops >= 0) {
                if (score_out) *score_out = res.score;
                return res.n_ops;
            }
            return -1;
        }
        if (res.n_ops >= 0) {
            const int64_t escape =
                mmax + static_cast<int64_t>(g) * (dgap + 2 * w + 2);
            if (static_cast<int64_t>(res.score) >= escape) {
                if (score_out) *score_out = res.score;
                return res.n_ops;
            }
            // Jump straight to a width whose escape bound the current
            // (lower-bound) score already beats: the banded score only
            // improves as the band widens, so the next pass is
            // guaranteed to accept. Two passes total instead of a
            // doubling ladder.
            const int64_t n_g = (mmax - res.score + (-g) - 1) / (-g);
            const int64_t w_need = (n_g - dgap) / 2 + 1;
            w = static_cast<int32_t>(
                std::min<int64_t>(std::max<int64_t>(2 * w, w_need),
                                  std::max(lq, lt)));
        } else {
            w *= 2;
        }
    }
}

// Batched form over flat buffers. ops_off[i] must leave q_len[i]+t_len[i]
// capacity per record; ops_len[i] receives each op count (-1 on failure).
// Records fan out over n_threads OS threads (<=0 selects the hardware
// concurrency), the host analogue of the reference's per-overlap thread
// pool (src/polisher.cpp:351-364). Returns 0 on success, first failing
// index + 1 otherwise.
int32_t racon_nw_align_batch(const uint8_t* q, const int64_t* q_off,
                             const int32_t* q_len, const uint8_t* t,
                             const int64_t* t_off, const int32_t* t_len,
                             int32_t n, int32_t m, int32_t x, int32_t g,
                             int32_t band0, int32_t n_threads,
                             uint8_t* ops_out,
                             const int64_t* ops_off, int32_t* ops_len) {
    if (n_threads <= 0) {
        n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 1;
    }
    n_threads = std::min(n_threads, n);
    std::atomic<int32_t> next(0), rc(0);
    auto worker = [&]() {
        while (true) {
            const int32_t i = next.fetch_add(1);
            if (i >= n) return;
            ops_len[i] = racon_nw_align(q + q_off[i], q_len[i],
                                        t + t_off[i], t_len[i], m, x, g,
                                        band0, ops_out + ops_off[i],
                                        nullptr);
            if (ops_len[i] < 0) {
                int32_t cur = rc.load();
                while ((cur == 0 || i + 1 < cur) &&
                       !rc.compare_exchange_weak(cur, i + 1)) {
                }
            }
        }
    };
    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(n_threads);
        for (int32_t k = 0; k < n_threads; ++k) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return rc.load();
}

}  // extern "C"
