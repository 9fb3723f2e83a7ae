// Column-walk traceback over banded cell planes (Hopper, sm_90a).
//
// Replaces the JAX package's column walk, an XLA scan
// (racon_tpu/ops/colwalk.py::col_walk, not a Pallas kernel), and is held
// bitwise against its plain PyTorch version
// racon_tpu_torch/ops/colwalk.py::col_walk (layout "band").
//
// Design: one thread per lane runs the reversed loop over the anchor
// positions p = 4*ceil((LA+2)/4) - 1 .. 0, grouped exactly as the plain
// version groups them (four single reads at k=1, two dual reads at k=2,
// one quad read at k=4 per group of four positions), and writes the four
// channels (ins_len, qstart, op_c, qi_c) of each position p < LA+2 as one
// vector store into out[b, p, 0:4], plus the lane's sat flag. Band slots
// map to target columns through the lane's klo, or through the origin of
// tile r / tile_len (tile_klo[n_tiles, B]) on the tiled overlap route.
// Flat indices are 64-bit: a stitched plane reaches 1.93e9 cells.
//
// Bound: the walk reads one cell (and its nxt/nxt2 bytes) per dependent
// step and writes B*(LA+2)*4 channel values, a few MB at the overlap
// shapes — microseconds of HBM. What bounds it is the chain: chain_len =
// ceil((LA+2)/k) dependent loads per lane, each a device-memory round trip.
// The planes are far larger than L2, so the design shortens nothing but
// the launch overhead; the k=2/4 planes are what divide the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0;
constexpr int kLeft = 2;
constexpr int kPadOp = 3;
constexpr int kUSat = 11;
constexpr int kUnroll = 4;
constexpr int kThreads = 32;

struct WalkArgs {
  const uint8_t* cells;     // [Lq, B, W]
  const uint8_t* nxt;       // [Lq, B, W] (k >= 2)
  const uint16_t* nxt2;     // [Lq, B, W] (k == 4)
  const int32_t* lq;        // [B]
  const int32_t* lt;        // [B]
  const int32_t* klo;       // [B] (when tile_klo is null)
  const int32_t* t_off;     // [B]
  const int32_t* tile_klo;  // [n_tiles, B] or null
  uint8_t* sat;             // [B]
  int B, Lq, W, LA, n_tiles, tile_len;
};

template <typename E>
struct Vec4;
template <>
struct Vec4<int16_t> {
  static __device__ void put(int16_t* p, int a, int b, int c, int d) {
    *reinterpret_cast<short4*>(p) =
        make_short4((short)a, (short)b, (short)c, (short)d);
  }
};
template <>
struct Vec4<int32_t> {
  static __device__ void put(int32_t* p, int a, int b, int c, int d) {
    *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
  }
};

template <typename E>
struct Lane {
  const int32_t* tile_klo;
  int B, Lq, W, n_tiles, tile_len;
  int b, i, tof, ltb, kl, npos;
  bool sat;
  E* out;  // out + b * npos * 4

  __device__ Lane(const WalkArgs& a, E* o, int lane)
      : tile_klo(a.tile_klo), B(a.B), Lq(a.Lq), W(a.W),
        n_tiles(a.n_tiles), tile_len(a.tile_len), b(lane) {
    i = a.lq[b];
    tof = a.t_off[b];
    ltb = a.lt[b];
    kl = a.tile_klo == nullptr ? a.klo[b] : 0;
    npos = a.LA + 2;
    sat = false;
    out = o + (size_t)b * npos * 4;
  }

  // Flat index of cell (i, clip(p - t_off, 0, lt)). Row r is clamped to
  // the plane as well, which the plain version's gather would reject.
  __device__ size_t index(int p) const {
    const int j = p - tof;
    const int jc = min(max(j, 0), ltb);
    const int r = min(max(i - 1, 0), Lq - 1);
    int k = kl;
    if (tile_klo != nullptr) {
      const int tl = min(r / tile_len, n_tiles - 1);
      k = __ldg(tile_klo + (size_t)tl * B + b);
    }
    const int col = min(max(jc - i - k, 0), W - 1);
    return ((size_t)r * B + b) * W + col;
  }

  // Undo anchor position p from the (up_run, consumer_dir) pair of the
  // cell the walk stands on.
  __device__ void undo(int p, int u_raw, int cdir_raw) {
    const int j = p - tof;
    const bool active = j >= 0 && j <= ltb;
    const int jc = min(max(j, 0), ltb);
    const bool readable = active && i >= 1 && jc >= 1;
    const int u = readable ? u_raw : 0;
    const int cdir = readable ? cdir_raw : kLeft;
    const bool is_j0 = active && j == 0;
    sat = sat || (readable && u == kUSat) || (is_j0 && i > kUSat - 1);
    const int u_eff = is_j0 ? i : u;
    const int top = i - u_eff;
    int cons = top <= 0 ? kLeft : cdir;
    if (is_j0) cons = kPadOp;
    const int qi = top - (cons == kDiag ? 1 : 0);
    if (p < npos) Vec4<E>::put(out + (size_t)p * 4, u_eff, top, cons, qi);
    if (active) i = is_j0 ? 0 : qi;
  }
};

template <int K, typename E>
__global__ void col_walk_kernel(const __grid_constant__ WalkArgs a,
                                E* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  Lane<E> L(a, out, b);
  const int groups = (a.LA + 1 + kUnroll) / kUnroll;
  for (int t = groups - 1; t >= 0; --t) {
    const int p0 = kUnroll * t;
    if (K == 1) {
      for (int k = kUnroll - 1; k >= 0; --k) {
        const int pv = __ldg(a.cells + L.index(p0 + k));
        L.undo(p0 + k, pv >> 4, (pv >> 2) & 3);
      }
    } else if (K == 2) {
      for (int k = kUnroll - 1; k >= 1; k -= 2) {
        const int p_hi = p0 + k;
        const int j = p_hi - L.tof;
        const size_t idx = L.index(p_hi);
        const int pv = __ldg(a.cells + idx);
        const int nv = __ldg(a.nxt + idx);
        const bool active_hi = j >= 0 && j <= L.ltb;
        L.undo(p_hi, pv >> 4, (pv >> 2) & 3);
        // Entry edge: while the hi position is inactive the clipped read
        // already fetched the cell the lo position needs.
        L.undo(p_hi - 1, active_hi ? nv >> 2 : pv >> 4,
               active_hi ? nv & 3 : (pv >> 2) & 3);
      }
    } else {
      const int p_hi = p0 + kUnroll - 1;
      const int j = p_hi - L.tof;
      const size_t idx = L.index(p_hi);
      const int pv = __ldg(a.cells + idx);
      const int nv = __ldg(a.nxt + idx);
      const int n2v = __ldg(a.nxt2 + idx);
      const int hu[4] = {pv >> 4, nv >> 2, (n2v >> 2) & 0xF,
                         (n2v >> 10) & 0xF};
      const int hc[4] = {(pv >> 2) & 3, nv & 3, n2v & 3, (n2v >> 8) & 3};
      // First active position of the quad (entry edge): position m takes
      // hop m - first of the gathered cell's chain.
      const int first = min(max(j - L.ltb, 0), 3);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int hop = min(max(m - first, 0), 3);
        L.undo(p_hi - m, hu[hop], hc[hop]);
      }
    }
  }
  a.sat[b] = L.sat ? 1 : 0;
}

template <int K, typename E>
cudaError_t launch(const WalkArgs& a, void* out, cudaStream_t stream) {
  const int blocks = (a.B + kThreads - 1) / kThreads;
  col_walk_kernel<K, E><<<blocks, kThreads, 0, stream>>>(
      a, static_cast<E*>(out));
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_k(const WalkArgs& a, int k, void* out,
                     cudaStream_t stream) {
  return k == 4 ? launch<4, E>(a, out, stream)
                : (k == 2 ? launch<2, E>(a, out, stream)
                          : launch<1, E>(a, out, stream));
}

}  // namespace

// out: [B, LA+2, 4] of int16 (emit_bytes 2) or int32 (emit_bytes 4);
// sat: [B] bytes. tile_klo may be null (then klo is read), klo may be null
// when tile_klo is given. nxt_k is 1, 2 or 4.
extern "C" int racon_col_walk(const void* cells, const void* nxt,
                              const void* nxt2, const void* lq,
                              const void* lt, const void* klo,
                              const void* t_off, const void* tile_klo,
                              void* out, void* sat, int B, int Lq, int W,
                              int LA, int n_tiles, int tile_len, int nxt_k,
                              int emit_bytes, void* stream) {
  if (B <= 0 || Lq <= 0 || W <= 0 || LA < 0 ||
      (nxt_k != 1 && nxt_k != 2 && nxt_k != 4) ||
      (emit_bytes != 2 && emit_bytes != 4) ||
      (tile_klo != nullptr && (n_tiles <= 0 || tile_len <= 0)) ||
      (tile_klo == nullptr && klo == nullptr) ||
      (nxt_k >= 2 && nxt == nullptr) || (nxt_k == 4 && nxt2 == nullptr))
    return (int)cudaErrorInvalidValue;
  WalkArgs a;
  a.cells = static_cast<const uint8_t*>(cells);
  a.nxt = static_cast<const uint8_t*>(nxt);
  a.nxt2 = static_cast<const uint16_t*>(nxt2);
  a.lq = static_cast<const int32_t*>(lq);
  a.lt = static_cast<const int32_t*>(lt);
  a.klo = static_cast<const int32_t*>(klo);
  a.t_off = static_cast<const int32_t*>(t_off);
  a.tile_klo = static_cast<const int32_t*>(tile_klo);
  a.sat = static_cast<uint8_t*>(sat);
  a.B = B;
  a.Lq = Lq;
  a.W = W;
  a.LA = LA;
  a.n_tiles = n_tiles;
  a.tile_len = tile_len;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = emit_bytes == 2
                            ? launch_k<int16_t>(a, nxt_k, out, st)
                            : launch_k<int32_t>(a, nxt_k, out, st);
  return (int)e;
}
