// Op-string traceback over NW direction codes (Hopper, sm_90a).
//
// Replaces the JAX package's traceback, an XLA scan
// (racon_tpu/ops/align.py::_traceback_flat, not a Pallas kernel), on the
// [Lq, B, Lt] layout its Pallas forward (and K4, nw_fwd.cu) writes; held
// bitwise against racon_tpu_torch/ops/align.py::traceback_plain followed
// by the reference's flip and op count.
//
// The walk: a lane steps from (lq, lt) (clamped onto the plane) back to
// (0, 0), one op a step for at most L steps: PAD_OP at (0, 0), LEFT on
// row 0, UP on column 0, else the code of cell (i, j), stored at
// dirs[(i-1)*B*Lt + b*Lt + (j-1)] (64-bit offsets: B*Lq*Lt passes 2^31).
// Step s writes ops[b, L-1-s], so the row comes out right-aligned behind
// PAD_OP in start-to-end order (the reference's flip), and n[b] counts
// the ops that are not PAD_OP.
//
// What bounds it: each step's cell comes from the step before, and a
// lane's rows lie B*Lt bytes apart in planes far larger than L2, so a
// walk that loads every step from device memory pays a round trip a row
// (the chain floor). The least the card must fetch is the 32-byte sectors
// the paths touch (the sector bound), about one a row of a path. On an
// NVIDIA H100 80GB HBM3 at 700 W, at the op-string route's 3072-4096
// lanes, the design below takes about half its chain floor and reaches
// about 12% of its sector bound: the 32 lanes on an SM hide one another's
// window loads (prefetching gains 1-4%), and what it waits on is device
// memory serving a 64-byte band from a new DRAM row for every window row.
//
// Design: one warp a lane, lanes_per_block lanes a block, no block
// barrier. The warp stages a window of the plane in shared memory and
// walks it there. A window anchored at (i0, j0) holds kR = 32 rows, i0
// down to i0 - kR + 1, and of row r a band of kC = 64 bytes that follows
// the diagonal: it starts at the 32-byte sector boundary at or below the
// byte of column j0 - 1 - r - kM (kM = 16, the margin, keeps the diagonal
// at least 16 bytes from either edge), so a row costs two sectors. The
// warp loads it as independent 16-byte cp.async pieces (bytes at the
// plane's ends), syncs the warp, and walks it, all 32 threads in step,
// until the path leaves it: through the top (kR rows walked), through a
// band edge (a miss, before kR rows), or onto row 0 or column 0. The
// next window is anchored at the exit cell. The window kR rows up the
// diagonal from the entry cell is prefetched into a second buffer while
// the lane walks; a top exit inside that window's first row enters it
// without waiting. Cells on row 0 or column 0 are never loaded: the LEFT
// or UP run to (0, 0) and the PAD_OP fill are stored by the warp in
// 16-byte pieces. Thread 0 writes each op into a 256-byte ring in shared
// memory indexed by its output byte's address, so that at a window's end
// the warp stores the window's run of ops (contiguous in the output row)
// in 16-byte pieces. Codes other than DIAG, UP and LEFT do not move the
// walk (as in the plain version): the ring's capacity ends a run, and the
// walk goes on in the same window. An optional refills[B, 2] receives
// each lane's windows entered and misses. Lanes a block come from
// ops/kernels.py::traceback_plan, whose TB_WINDOW and TB_LANE_BYTES
// mirror kR, kC, kM and kLaneBytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr int kPadOp = 3;
constexpr int kRing = 256;  // bytes of a lane's op ring (a power of two)
constexpr int kR = 32;      // rows of a window
constexpr int kC = 64;      // band bytes of a window row (whole sectors)
constexpr int kM = 16;      // margin: band bytes left of the diagonal
// A lane's shared memory: two windows of kR x kC bytes (the one walked
// and the one prefetched), each with its kR + 2 first columns (the walk
// reads one past the last row it can stand on), and the ring.
constexpr int kWinBytes = kR * kC;
constexpr int kLaneBytes =
    (2 * (kWinBytes + 4 * (kR + 2)) + kRing + 15) & ~15;
static_assert(kC % 32 == 0 && kM + 32 <= kC, "a band of whole sectors");

struct TbArgs {
  const uint8_t* dirs;  // [Lq, B, Lt]
  const int32_t* lq;    // [B]
  const int32_t* lt;    // [B]
  uint8_t* ops;         // [B, L]
  int32_t* n;           // [B]
  int32_t* refills;     // [B, 2] or null
  long long total;      // Lq * B * Lt
  int B, Lq, Lt, L;
  int lanes_per_block;
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

// Element offset of the first byte of row r's band in a window anchored
// at (i0, j0): the sector boundary at or below column j0 - 1 - r - M of
// plane row i0 - 1 - r; bm is the plane's address modulo 32.
__device__ __forceinline__ long long band_start(const TbArgs& a, int b,
                                                long long bm, int i0, int j0,
                                                int r, long long* g) {
  *g = ((long long)(i0 - 1 - r) * a.B + b) * a.Lt;
  return ((bm + *g + (j0 - 1 - r) - kM) & ~31LL) - bm;
}

// Issue the copies of the window anchored at (i0, j0), nr rows, into w,
// and its rows' first columns into lo, as one cp.async group.
__device__ void load_window(const TbArgs& a, int b, long long bm, uint8_t* w,
                            int* lo, int i0, int j0, int nr, int lane) {
  constexpr int pieces = kC / 16;
  for (int r = lane; r < nr; r += 32) {
    long long g;
    lo[r] = (int)(band_start(a, b, bm, i0, j0, r, &g) - g);
  }
  for (int x = lane; x < nr * pieces; x += 32) {
    const int r = x / pieces;
    const int k = x - r * pieces;
    long long g;
    const long long e = band_start(a, b, bm, i0, j0, r, &g) + 16 * k;
    uint8_t* d = w + r * kC + 16 * k;
    if (e >= 0 && e + 16 <= a.total) {
      cp_async16(d, a.dirs + e);
    } else {
      for (int q = 0; q < 16; ++q)
        if (e + q >= 0 && e + q < a.total) d[q] = a.dirs[e + q];
    }
  }
  cp_async_commit();
}

// The warp stores output positions [p_lo, p_hi) of row: from the ring
// (fill < 0; the ring holds the byte of address x at x % kRing) or the
// byte fill, in 16-byte pieces between a head and a tail of bytes.
__device__ void store_run(uint8_t* row, int p_lo, int p_hi,
                          const uint8_t* ring, int fill, int lane) {
  if (p_lo >= p_hi) return;
  const uintptr_t a0 = (uintptr_t)(row + p_lo);
  const uintptr_t a1 = (uintptr_t)(row + p_hi);
  uintptr_t f = (a0 + 15) & ~(uintptr_t)15;
  uintptr_t l = a1 & ~(uintptr_t)15;
  if (f >= l) f = l = a1;  // no whole piece: bytes only
  const unsigned v = (unsigned)(fill & 0xFF) * 0x01010101u;
  for (uintptr_t x = a0 + lane; x < f; x += 32)
    *reinterpret_cast<uint8_t*>(x) =
        fill < 0 ? ring[x & (kRing - 1)] : (uint8_t)fill;
  for (uintptr_t x = f + 16 * lane; x < l; x += 16 * 32)
    *reinterpret_cast<uint4*>(x) =
        fill < 0 ? *reinterpret_cast<const uint4*>(ring + (x & (kRing - 1)))
                 : make_uint4(v, v, v, v);
  for (uintptr_t x = l + lane; x < a1; x += 32)
    *reinterpret_cast<uint8_t*>(x) =
        fill < 0 ? ring[x & (kRing - 1)] : (uint8_t)fill;
}

// Why a window's walk stopped.
enum Exit { kFull, kEdge, kTop, kMiss };

// The block's shared memory: lanes_per_block lanes of kLaneBytes each.
extern __shared__ __align__(16) uint8_t tb_smem[];

// A block holds up to 32 lanes (an SM's share at the route's shapes), so
// the kernel must launch at 1024 threads: at most 64 registers a thread.
__global__ void __launch_bounds__(1024)
    nw_traceback_kernel(const __grid_constant__ TbArgs a) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * a.lanes_per_block + wid;
  if (b >= a.B) return;
  // A lane's shared memory: window c at base + c * kWinBytes, the ring,
  // and window c's first columns at lo0 + c * (kR + 2).
  uint8_t* base = tb_smem + wid * kLaneBytes;
  uint8_t* ring = base + 2 * kWinBytes;
  int* lo0 = reinterpret_cast<int*>(ring + kRing);
  const long long bm = (long long)((uintptr_t)a.dirs & 31);

  int i = min(max(a.lq[b], 0), a.Lq);
  int j = min(max(a.lt[b], 0), a.Lt);
  uint8_t* row = a.ops + (size_t)b * a.L;
  const unsigned ra = (unsigned)(uintptr_t)row;
  int s = 0, n = 0, n_win = 0, n_miss = 0;
  int cur = 0, i0 = 0, nr = 0;
  bool pf = false, enter = true;
  int pf_i0 = 0, pf_lo0 = 0;
  while (s < a.L && i > 0 && j > 0) {
    if (enter) {
      if (pf && i == pf_i0 && (unsigned)(j - 1 - pf_lo0) < (unsigned)kC) {
        cur ^= 1;
      } else {
        load_window(a, b, bm, base + cur * kWinBytes, lo0 + cur * (kR + 2),
                    i, j, min(kR, i), lane);
      }
      // This window's bytes, and a discarded prefetch's, have landed.
      cp_async_wait_all();
      __syncwarp();
      i0 = i;
      nr = min(kR, i);
      ++n_win;
      pf = nr == kR && i - kR >= 1 && j - kR >= 1;
      if (pf) {
        pf_i0 = i - kR;
        const int o = cur ^ 1;
        load_window(a, b, bm, base + o * kWinBytes, lo0 + o * (kR + 2),
                    pf_i0, j - kR, min(kR, pf_i0), lane);
        long long g;
        pf_lo0 = (int)(band_start(a, b, bm, pf_i0, j - kR, 0, &g) - g);
      }
    }
    const uint8_t* w = base + cur * kWinBytes;
    const int* wl = lo0 + cur * (kR + 2);
    int r = i0 - i;
    int rC = r * kC;
    int lo_c = wl[r], lo_n = wl[r + 1];
    const int cap = min(kRing, a.L - s);
    unsigned wi = ra + (unsigned)(a.L - 1 - s);
    int k = 0;
    Exit why;
    for (;;) {
      if (k == cap) {
        why = kFull;
        break;
      }
      if (i == 0 || j == 0) {
        why = kEdge;
        break;
      }
      if (r == nr) {
        why = kTop;
        break;
      }
      const int c = j - 1 - lo_c;
      if ((unsigned)c >= (unsigned)kC) {
        why = kMiss;
        break;
      }
      const int d = w[rC + c];
      if (lane == 0) ring[wi & (kRing - 1)] = (uint8_t)d;
      --wi;
      ++k;
      n += d != kPadOp;
      const bool di = d == kDiag || d == kUp;
      i -= di ? 1 : 0;
      j -= (d == kDiag || d == kLeft) ? 1 : 0;
      if (di) {
        ++r;
        rC += kC;
        lo_c = lo_n;
        lo_n = wl[r + 1];
      }
    }
    __syncwarp();  // thread 0's ring bytes are visible to the warp
    store_run(row, a.L - s - k, a.L - s, ring, -1, lane);
    __syncwarp();  // the ring is read before it is written again
    s += k;
    n_miss += why == kMiss;
    enter = why != kFull;
  }
  if (s < a.L && (i == 0) != (j == 0)) {
    // The LEFT run along row 0 or the UP run along column 0.
    const int k = min(i + j, a.L - s);
    store_run(row, a.L - s - k, a.L - s, nullptr, i == 0 ? kLeft : kUp,
              lane);
    s += k;
    n += k;
  }
  if (s < a.L) store_run(row, 0, a.L - s, nullptr, kPadOp, lane);
  cp_async_wait_all();  // a prefetch the walk did not enter
  if (lane == 0) {
    a.n[b] = n;
    if (a.refills != nullptr) {
      a.refills[2 * b] = n_win;
      a.refills[2 * b + 1] = n_miss;
    }
  }
}

}  // namespace

// dirs: u8 [Lq, B, Lt]; lq, lt: i32 [B]; ops: u8 [B, L]; n: i32 [B];
// refills: i32 [B, 2] or null; lanes_per_block warps a block (1 to 32).
extern "C" int racon_nw_traceback(const void* dirs, const void* lq,
                                  const void* lt, void* ops, void* n,
                                  void* refills, int B, int Lq, int Lt,
                                  int L, int lanes_per_block, void* stream) {
  if (B <= 0 || Lq <= 0 || Lt <= 0 || L < 0 || lanes_per_block < 1 ||
      lanes_per_block > 32)
    return (int)cudaErrorInvalidValue;
  TbArgs a;
  a.dirs = static_cast<const uint8_t*>(dirs);
  a.lq = static_cast<const int32_t*>(lq);
  a.lt = static_cast<const int32_t*>(lt);
  a.ops = static_cast<uint8_t*>(ops);
  a.n = static_cast<int32_t*>(n);
  a.refills = static_cast<int32_t*>(refills);
  a.total = (long long)Lq * B * Lt;
  a.B = B;
  a.Lq = Lq;
  a.Lt = Lt;
  a.L = L;
  a.lanes_per_block = lanes_per_block;
  const int smem = lanes_per_block * kLaneBytes;
  cudaError_t e = cudaFuncSetAttribute(
      nw_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  nw_traceback_kernel<<<blocks, 32 * lanes_per_block, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// What the kernel gets on this card at lanes_per_block warps a block:
// out = {blocks an SM, registers a thread, local (spill) bytes a thread,
// max threads a block, shared memory a block}.
extern "C" int racon_nw_traceback_occupancy(int lanes_per_block, int* out) {
  if (lanes_per_block < 1 || lanes_per_block > 32)
    return (int)cudaErrorInvalidValue;
  const int smem = lanes_per_block * kLaneBytes;
  const void* f = reinterpret_cast<const void*>(nw_traceback_kernel);
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, f, 32 * lanes_per_block, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = at.maxThreadsPerBlock;
  out[4] = smem;
  return 0;
}
