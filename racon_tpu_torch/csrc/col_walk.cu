// Column-walk traceback over banded cell planes (Hopper, sm_90a).
//
// Replaces the JAX package's column walk, an XLA scan
// (racon_tpu/ops/colwalk.py:66 ``col_walk``, not a Pallas kernel), and is
// held bitwise against its plain PyTorch version
// racon_tpu_torch/ops/colwalk.py::col_walk, on both of its layouts.
//
// The walk: a lane runs the reversed loop over the anchor positions
// p = 4*ceil((LA+2)/4) - 1 .. 0, grouped exactly as the plain version
// groups them (four single reads at k=1, two dual reads at k=2, one quad
// read at k=4 per group of four positions), and emits the four channels
// (ins_len, qstart, op_c, qi_c) of each position p < LA+2 into
// out[b, p, 0:4], plus the lane's sat flag. A read stands on cell
// (r, col): r = clamp(i - 1, 0, Lq - 1), col = clamp(jc - i - klo, 0,
// W - 1) on the band layout, with klo the lane's origin or, on the tiled
// overlap route, the origin of tile r / tile_len (tile_klo[n_tiles, B]);
// on the "flat" layout (template flag FLAT: the full-width forward's
// [Lq, B, Lt] planes, W = Lt, no nxt planes, k = 1) col = clamp(jc - 1,
// 0, W - 1). Plane indices are 64-bit: a group's plane passes 2^31.
//
// What bounds it: a lane is a serial chain of chain_len = ceil((LA+2)/k)
// dependent steps (each read's row and slot come from the step before),
// then bytes (one pass over the path's cells, the outputs once). One
// device-memory round trip per step made the chain ~0.5-1.2 us a step;
// the planes (12.1 GB for a tiled group) are far larger than L2.
//
// Design: G threads walk one lane (a power of two up to 32; a block
// holds lanes_per_block lanes). The planes are [Lq, B, W], so a lane's
// slots of one row are contiguous, and a near-diagonal path keeps its
// slot on the band layout (col = jc - i - klo) while it climbs one row a
// position. The lane's G threads stage a window of the planes its k
// reads (cells; nxt at k >= 2; nxt2 at k = 4) in shared memory: the R
// stored rows ending at the current row (never across a tile boundary,
// where the slot mapping jumps) by S slots around the current slot (the
// flat layout's slot falls one a row, so its window leans left by half
// its rows), each row as 16-byte cp.async pieces, all in flight at once.
// The walk, uniform across the G threads, reads the window at
// shared-memory latency; a read outside it, or on a clamped row or slot,
// is a miss. While the lane walks a window, the next one (the R rows
// above, at the slot the path holds, shifted by the tile origins'
// difference at a tile boundary) is on its way into a second buffer; a
// window of fewer than k rows serves one read and prefetches nothing. A
// miss that lands in the prefetched window waits for it and swaps, any
// other miss loads the window around the cell and waits
// (random planes miss often: slower, still exact). Reads whose values
// no position uses (row 0, column 0) are not made. The lane's tile
// origins sit in shared memory from the start. Each thread holds the
// channels of the positions p = gl (mod G) and the lane writes them
// every G positions as G adjacent 8- or 16-byte stores.
//
// The cost of a window is a DRAM page for each of its rows and planes:
// tall windows open about k times the pages of the rows the walk reads.
// With few lanes an SM the walk is latency-bound and tall windows pay;
// with thousands of lanes the pages bound it and the plan
// (ops/kernels.py::walk_plan) takes one-row windows. An optional
// refills[B, 2] receives each lane's windows entered and misses. The
// planes' rows are 16-byte pieces: W % 16 == 0 and 16-byte aligned planes
// (the port's band and target widths are multiples of 128).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0;
constexpr int kLeft = 2;
constexpr int kPadOp = 3;
constexpr int kUSat = 11;
constexpr int kUnroll = 4;

struct WalkArgs {
  const uint8_t* cells;     // [Lq, B, W] (flat layout: W = Lt)
  const uint8_t* nxt;       // [Lq, B, W] (k >= 2)
  const uint16_t* nxt2;     // [Lq, B, W] (k == 4)
  const int32_t* lq;        // [B]
  const int32_t* lt;        // [B]
  const int32_t* klo;       // [B] (band layout, when tile_klo is null)
  const int32_t* t_off;     // [B]
  const int32_t* tile_klo;  // [n_tiles, B] or null
  uint8_t* sat;             // [B]
  int32_t* refills;         // [B, 2] or null
  void* out;                // [B, LA+2, 4] of E
  int B, Lq, W, LA, n_tiles, tile_len;
  int G, R, S, lanes_per_block, lane_bytes;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory bytes of one window slot: cells, + nxt, + u16 nxt2.
__host__ __device__ constexpr int slot_bytes(int k) {
  return 1 + (k >= 2) + 2 * (k >= 4);
}

// A window: stored rows [lo, lo + nr) by slots [c0, c0 + Seff) of the
// lane's planes, whose rows all map through origin kl; nr == 0: none.
struct Win {
  int lo, nr, c0, kl;
};

// The block's shared memory: lanes_per_block lanes of lane_bytes each.
extern __shared__ __align__(16) uint8_t walk_smem[];

template <int K, bool FLAT, typename E>
struct Walker {
  const WalkArgs a;  // a copy of the kernel's parameters (constant bank)
  // Offsets in walk_smem: the window the walk reads, the one on its way,
  // the lane's tile origins (tk < 0: none).
  int cur_base, nxt_base, tk;
  unsigned mask;  // the lane's threads within the warp
  int b, gl, Seff, plane, npos, i, tof, ltb, kl, o0, o1, o2, o3;
  int n_win, n_miss;
  // A window row is cpr 16-byte pieces a plane (two of nxt2); thread gl
  // starts at row ld_r, piece ld_c and steps ld_dr rows and ld_dc
  // pieces.
  int cpr, ld_r, ld_c, ld_dr, ld_dc;
  bool sat;
  Win cur, nxt;

  __device__ Walker(const WalkArgs& args, int lane_base, int lane, int g,
                    unsigned m)
      : a(args), mask(m), b(lane), gl(g) {
    const int buf = args.R * args.S * slot_bytes(K);
    cur_base = lane_base;
    nxt_base = lane_base + buf;
    plane = args.R * args.S;
    Seff = min(args.S, args.W);
    cpr = Seff >> 4;
    ld_r = gl / cpr;
    ld_c = gl % cpr;
    ld_dr = args.G / cpr;
    ld_dc = args.G % cpr;
    i = args.lq[b];
    tof = args.t_off[b];
    ltb = args.lt[b];
    kl = (FLAT || args.tile_klo != nullptr) ? 0 : args.klo[b];
    npos = args.LA + 2;
    sat = false;
    o0 = o1 = o2 = o3 = 0;
    n_win = n_miss = 0;
    cur = nxt = Win{0, 0, 0, 0};
    tk = -1;
    if (!FLAT && args.tile_klo != nullptr) {
      tk = lane_base + 2 * buf;
      int32_t* t = reinterpret_cast<int32_t*>(walk_smem + tk);
      for (int x = gl; x < args.n_tiles; x += args.G)
        t[x] = args.tile_klo[(size_t)x * args.B + b];
      __syncwarp(mask);
    }
  }

  // Origin of stored row r and the first row of its tile.
  __device__ int row_klo(int r, int* tlo) const {
    if (tk < 0) {
      *tlo = 0;
      return kl;
    }
    const int tl = min(r / a.tile_len, a.n_tiles - 1);
    *tlo = tl * a.tile_len;
    return reinterpret_cast<const int32_t*>(walk_smem + tk)[tl];
  }

  // Slot of target column jc on a row of origin k (the walk's row i).
  __device__ int col_of(int jc, int k) const {
    if constexpr (FLAT) return min(max(jc - 1, 0), a.W - 1);
    return min(max(jc - i - k, 0), a.W - 1);
  }

  // Slots of a window whose top row holds the path at slot c_top.
  __device__ int place(int c_top, int nr) const {
    const int start = c_top - Seff / 2 - (FLAT ? nr / 2 : 0);
    return min(max(start, 0), a.W - Seff) & ~15;
  }

  // Issue the copies of window w into the buffer at dst as one cp.async
  // group.
  __device__ void load(int dst, const Win& w) const {
    const size_t rs = (size_t)a.B * a.W;
    const size_t base = ((size_t)w.lo * a.B + b) * a.W + w.c0;
    uint8_t* d = walk_smem + dst;
    uint16_t* d2 = reinterpret_cast<uint16_t*>(d + 2 * plane);
    int rr = ld_r, cc = ld_c;
    while (rr < w.nr) {
      const size_t g = base + rr * rs + (cc << 4);
      const int s = rr * a.S + (cc << 4);
      cp_async16(d + s, a.cells + g);
      if (K >= 2) cp_async16(d + plane + s, a.nxt + g);
      if (K == 4) {
        cp_async16(d2 + s, a.nxt2 + g);
        cp_async16(d2 + s + 8, a.nxt2 + g + 8);
      }
      rr += ld_dr;
      cc += ld_dc;
      if (cc >= cpr) {
        cc -= cpr;
        ++rr;
      }
    }
    cp_async_commit();
  }

  // Start the window above the current one into the second buffer; (r,
  // col) is the cell the walk stands on. A window of fewer than K rows
  // serves one read, and the row of the next is not known: none.
  __device__ void prefetch(int r, int col) {
    nxt.nr = 0;
    if (cur.lo == 0 || a.R < K) return;
    const int top = cur.lo - 1;
    int tlo;
    const int k = row_klo(top, &tlo);
    const int lo = max(top - a.R + 1, tlo);
    const int c_top = FLAT ? col - (r - top) : col + cur.kl - k;
    nxt = Win{lo, top - lo + 1, place(c_top, top - lo + 1), k};
    load(nxt_base, nxt);
  }

  // The read at target column jc left the window, or stands on a clamped
  // row or slot: find cell (r, col) exactly as the plain walk indexes it
  // and make the window hold it (it may already: a clamped cell; else
  // the prefetched window, if it holds it; else the window around it,
  // loaded now). Returns the cell's offset in the window.
  __device__ int miss(int jc) {
    const int r = min(max(i - 1, 0), a.Lq - 1);
    int tlo;
    const int k = row_klo(r, &tlo);
    const int col = col_of(jc, k);
    if ((unsigned)(r - cur.lo) < (unsigned)cur.nr &&
        (unsigned)(col - cur.c0) < (unsigned)Seff)
      return (r - cur.lo) * a.S + (col - cur.c0);
    __syncwarp(mask);  // every thread of the lane is done with cur_base
    if (nxt.nr > 0 && (unsigned)(r - nxt.lo) < (unsigned)nxt.nr &&
        (unsigned)(col - nxt.c0) < (unsigned)Seff) {
      cp_async_wait_all();
      const int t = cur_base;
      cur_base = nxt_base;
      nxt_base = t;
      cur = nxt;
    } else {
      const int lo = max(r - a.R + 1, tlo);
      const int nr = r - lo + 1;
      int c0 = place(col, nr);
      if (col >= c0 + Seff) c0 = (col - Seff + 16) & ~15;
      cur = Win{lo, nr, c0, k};
      load(cur_base, cur);
      cp_async_wait_all();  // this window, and a prefetch still in flight
      ++n_miss;
    }
    __syncwarp(mask);  // the window's bytes are visible to the lane
    ++n_win;
    prefetch(r, col);
    return (r - cur.lo) * a.S + (col - cur.c0);
  }

  // The planes' bytes under the read at anchor position p. A read with
  // i < 1 or at target column 0 is never used (every position it serves
  // is unreadable), so none is made.
  __device__ __forceinline__ void read(int p, int* pv, int* nv, int* n2v) {
    const int jc = min(max(p - tof, 0), ltb);
    if (i < 1 || jc < 1) {
      *pv = *nv = *n2v = 0;
      return;
    }
    // Fast path: the unclamped row and slot lie in the window (so no
    // clamp applies); everything else is a miss.
    const int dr = i - 1 - cur.lo;
    const int dc = (FLAT ? jc - 1 : jc - i - cur.kl) - cur.c0;
    const int off = ((unsigned)dr < (unsigned)cur.nr &&
                     (unsigned)dc < (unsigned)Seff)
                        ? dr * a.S + dc
                        : miss(jc);
    const uint8_t* w = walk_smem + cur_base;
    *pv = w[off];
    if (K >= 2) *nv = w[plane + off];
    if (K == 4)
      *n2v = reinterpret_cast<const uint16_t*>(w + 2 * plane)[off];
  }

  // Undo anchor position p from the (up_run, consumer_dir) pair of the
  // cell the walk stands on. The next row i comes first, by the shortest
  // chain of steps on i (the rest of the walk waits on it): a readable
  // position drops the up run and, when it consumes diagonally, one row
  // more; position j == 0 ends the query; an inactive one keeps i.
  __device__ __forceinline__ void undo(int p, int u_raw, int cdir_raw) {
    const int j = p - tof;
    const bool active = j >= 0 && j <= ltb;
    const bool is_j0 = active && j == 0;
    const bool rd = active && j >= 1 && i >= 1;  // readable
    const bool diag = cdir_raw == kDiag && i > u_raw;
    const int i_next = is_j0 ? 0 : (rd ? i - u_raw - (diag ? 1 : 0) : i);
    // The channels, off that chain: u_eff, top = i - u_eff, the consumer
    // op (LEFT when unreadable or when the run reaches row 0) and qi.
    const int u_eff = is_j0 ? i : (rd ? u_raw : 0);
    const int top = i - u_eff;
    const int cons =
        is_j0 ? kPadOp : (rd && top > 0 ? cdir_raw : kLeft);
    sat = sat || (rd && u_raw == kUSat) || (is_j0 && i > kUSat - 1);
    const int gm = a.G - 1;
    if ((p & gm) == gl) {
      o0 = u_eff;
      o1 = top;
      o2 = cons;
      o3 = top - (cons == kDiag ? 1 : 0);
    }
    i = i_next;
    if ((p & gm) == 0) {
      // Positions p .. p+G-1 are done: thread gl writes p + gl.
      const int q = p + gl;
      if (q < npos)
        Vec4<E>::put(static_cast<E*>(a.out) + ((size_t)b * npos + q) * 4,
                     o0, o1, o2, o3);
    }
  }
};

template <int K, bool FLAT, typename E>
__global__ void col_walk_kernel(const WalkArgs a) {
  static_assert(!FLAT || K == 1, "the flat layout walks at k = 1");
  const int grp = threadIdx.x >> (__ffs(a.G) - 1);
  const int gl = threadIdx.x & (a.G - 1);
  const int b = blockIdx.x * a.lanes_per_block + grp;
  if (b >= a.B) return;
  const unsigned mask =
      a.G == 32 ? 0xffffffffu
                : ((1u << a.G) - 1u) << ((threadIdx.x & 31) & ~(a.G - 1));
  Walker<K, FLAT, E> L(a, grp * a.lane_bytes, b, gl, mask);
  const int groups = (a.LA + 1 + kUnroll) / kUnroll;
  for (int t = groups - 1; t >= 0; --t) {
    const int p0 = kUnroll * t;
    int pv, nv = 0, n2v = 0;
    if (K == 1) {
#pragma unroll
      for (int k = kUnroll - 1; k >= 0; --k) {
        L.read(p0 + k, &pv, &nv, &n2v);
        L.undo(p0 + k, pv >> 4, (pv >> 2) & 3);
      }
    } else if (K == 2) {
#pragma unroll
      for (int k = kUnroll - 1; k >= 1; k -= 2) {
        const int p_hi = p0 + k;
        const int j = p_hi - L.tof;
        L.read(p_hi, &pv, &nv, &n2v);
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
      L.read(p_hi, &pv, &nv, &n2v);
      const int hu0 = pv >> 4, hu1 = nv >> 2, hu2 = (n2v >> 2) & 0xF,
                hu3 = (n2v >> 10) & 0xF;
      const int hc0 = (pv >> 2) & 3, hc1 = nv & 3, hc2 = n2v & 3,
                hc3 = (n2v >> 8) & 3;
      // First active position of the quad (entry edge): position m takes
      // hop m - first of the gathered cell's chain.
      const int first = min(max(j - L.ltb, 0), 3);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int hop = min(max(m - first, 0), 3);
        L.undo(p_hi - m, hop == 0 ? hu0 : hop == 1 ? hu1 : hop == 2 ? hu2 : hu3,
               hop == 0 ? hc0 : hop == 1 ? hc1 : hop == 2 ? hc2 : hc3);
      }
    }
  }
  if (gl == 0) {
    a.sat[b] = L.sat ? 1 : 0;
    if (a.refills != nullptr) {
      a.refills[2 * b] = L.n_win;
      a.refills[2 * b + 1] = L.n_miss;
    }
  }
}

using WalkFn = void (*)(const WalkArgs);

WalkFn walk_fn(int k, bool flat, int emit_bytes) {
  if (emit_bytes == 2) {
    if (flat) return col_walk_kernel<1, true, int16_t>;
    return k == 4 ? col_walk_kernel<4, false, int16_t>
                  : (k == 2 ? col_walk_kernel<2, false, int16_t>
                            : col_walk_kernel<1, false, int16_t>);
  }
  if (flat) return col_walk_kernel<1, true, int32_t>;
  return k == 4 ? col_walk_kernel<4, false, int32_t>
                : (k == 2 ? col_walk_kernel<2, false, int32_t>
                          : col_walk_kernel<1, false, int32_t>);
}

// Shared memory of one lane: two windows and the tile origins.
int lane_smem_bytes(int k, int R, int S, int n_tiles) {
  return 2 * R * S * slot_bytes(k) + ((4 * n_tiles + 15) & ~15);
}

bool plan_ok(int G, int R, int S, int lanes_per_block) {
  return G >= 1 && G <= 32 && (G & (G - 1)) == 0 && R >= 1 && S >= 16 &&
         S % 16 == 0 && lanes_per_block >= 1 && lanes_per_block * G <= 1024;
}

}  // namespace

// out: [B, LA+2, 4] of int16 (emit_bytes 2) or int32 (emit_bytes 4);
// sat: [B] bytes; refills: [B, 2] int32 or null. Band layout (flat 0):
// tile_klo may be null (then klo is read), klo may be null when tile_klo
// is given; nxt_k is 1, 2 or 4. Flat layout (flat 1, W = Lt): klo,
// tile_klo, nxt and nxt2 are null and nxt_k is 1. W % 16 == 0 and the
// planes 16-byte aligned. The plan: G threads a lane (a power of two up
// to 32), windows of R rows by S slots (S a multiple of 16),
// lanes_per_block lanes a block.
extern "C" int racon_col_walk(const void* cells, const void* nxt,
                              const void* nxt2, const void* lq,
                              const void* lt, const void* klo,
                              const void* t_off, const void* tile_klo,
                              void* out, void* sat, void* refills, int B,
                              int Lq, int W, int LA, int n_tiles,
                              int tile_len, int nxt_k, int emit_bytes,
                              int flat, int G, int R, int S,
                              int lanes_per_block, void* stream) {
  if (B <= 0 || Lq <= 0 || W <= 0 || LA < 0 ||
      (nxt_k != 1 && nxt_k != 2 && nxt_k != 4) ||
      (emit_bytes != 2 && emit_bytes != 4) ||
      !plan_ok(G, R, S, lanes_per_block) || W % 16 != 0 ||
      (((uintptr_t)cells | (uintptr_t)nxt | (uintptr_t)nxt2) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (flat ? (nxt_k != 1 || nxt != nullptr || nxt2 != nullptr ||
              tile_klo != nullptr)
           : ((tile_klo != nullptr && (n_tiles <= 0 || tile_len <= 0)) ||
              (tile_klo == nullptr && klo == nullptr) ||
              (nxt_k >= 2 && nxt == nullptr) ||
              (nxt_k == 4 && nxt2 == nullptr)))
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
  a.refills = static_cast<int32_t*>(refills);
  a.out = out;
  a.B = B;
  a.Lq = Lq;
  a.W = W;
  a.LA = LA;
  a.n_tiles = tile_klo != nullptr ? n_tiles : 0;
  a.tile_len = tile_len;
  a.G = G;
  a.R = R;
  a.S = S;
  a.lanes_per_block = lanes_per_block;
  a.lane_bytes = lane_smem_bytes(nxt_k, R, S, a.n_tiles);
  const size_t smem = (size_t)lanes_per_block * a.lane_bytes;
  const WalkFn fn = walk_fn(nxt_k, flat != 0, emit_bytes);
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                       dim3((B + lanes_per_block - 1) / lanes_per_block),
                       dim3(lanes_per_block * G), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the walk instantiation for (nxt_k, flat, emit_bytes) gets on the
// current card at `threads` threads and `smem` bytes of dynamic shared
// memory a block: out[0] resident blocks an SM, out[1] registers a
// thread, out[2] local-memory (spill) bytes a thread, out[3] the
// instantiation's most threads a block.
extern "C" int racon_col_walk_occupancy(int nxt_k, int flat, int emit_bytes,
                                        int threads, int smem, int* out) {
  if ((nxt_k != 1 && nxt_k != 2 && nxt_k != 4) || (flat && nxt_k != 1) ||
      (emit_bytes != 2 && emit_bytes != 4) || threads <= 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const WalkFn fn = walk_fn(nxt_k, flat != 0, emit_bytes);
  const void* f = reinterpret_cast<const void*>(fn);
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads,
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = at.maxThreadsPerBlock;
  return 0;
}
