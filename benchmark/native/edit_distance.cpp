// Exact unit-cost edit distance of two byte strings, for the benchmark's
// accuracy metric (polished output against the generator's truth).
//
// Ukkonen's band: with a band of half-width w around the diagonals
// between 0 and lb - la, a distance d <= w is exact, so the band doubles
// until the banded distance fits inside it. Only two rows are kept.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

int64_t banded(const uint8_t* a, int64_t la, const uint8_t* b, int64_t lb,
               int64_t w) {
  const int64_t big = INT64_MAX / 4;
  const int64_t klo = std::min<int64_t>(0, lb - la) - w;
  const int64_t khi = std::max<int64_t>(0, lb - la) + w;
  const int64_t bw = khi - klo + 1;
  // Row i holds columns j = i + klo + c for c in [0, bw).
  std::vector<int64_t> prev(bw + 1, big), cur(bw + 1, big);
  for (int64_t c = 0; c < bw; ++c) {
    const int64_t j = klo + c;
    if (j >= 0 && j <= lb) prev[c] = j;
  }
  for (int64_t i = 1; i <= la; ++i) {
    for (int64_t c = 0; c < bw; ++c) {
      const int64_t j = i + klo + c;
      int64_t v = big;
      if (j >= 0 && j <= lb) {
        if (j == 0) {
          v = i;
        } else {
          v = prev[c] + (a[i - 1] != b[j - 1]);        // diagonal
          v = std::min(v, prev[c + 1] + 1);            // from above
          if (c > 0) v = std::min(v, cur[c - 1] + 1);  // from the left
        }
      }
      cur[c] = v;
    }
    cur[bw] = big;
    std::swap(prev, cur);
  }
  const int64_t c_end = lb - la - klo;
  return prev[c_end];
}

}  // namespace

extern "C" int64_t portbench_edit_distance(const uint8_t* a, int64_t la,
                                           const uint8_t* b, int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  int64_t w = 64;
  while (true) {
    const int64_t d = banded(a, la, b, lb, w);
    if (d <= w || w >= std::max(la, lb)) return d;
    w = std::max(2 * w, d);
  }
}
