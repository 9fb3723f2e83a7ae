// Banded NW forward in per-lane diagonal coordinates (Hopper, sm_90a).
//
// Two entry points share one row body (band_rows, template flag TILED):
//
// - racon_band_fwd (K1) replaces the JAX package's Pallas kernel
//   racon_tpu/ops/pallas/band_kernel.py::_kernel (entry fw_dirs_band); it
//   is held bitwise against racon_tpu_torch/ops/band.py::fw_dirs_band_plain.
// - racon_band_tile_fwd (K3) replaces band_kernel.py::_kernel_tile (entry
//   fw_dirs_band_tile): one T-row query tile whose DP frontier (scores,
//   packed metadata and the hlast capture, int32[B, W] each) is loaded from
//   its inputs instead of the row-0 fill and written out at the end. Rows
//   are numbered from the global origin i0, and the tile writes rows
//   [i0, i0+T) of the caller's stitched [Lq, B, W] planes in place. Held
//   bitwise against ops/band.py::fw_dirs_band_tile_plain.
//
// Design: one block per lane (job); each thread owns SPT consecutive band
// slots x (4, or 2 for K1 at 1024 <= W <= 2048: band_spt below); the
// query rows run in a loop inside the block. The lane's
// pre-shifted target window tband[b, 0 : W+rows) and its query column are
// staged in shared memory once. Per row:
//   - diag neighbour = slot x of the previous row, up neighbour = slot
//     x+1 of the previous row (both in shared memory, sentinel at x = W);
//   - the left-gap chain is an inclusive prefix max over x of
//     tmp - j*gap (with the NEG floor of the reference's shift-max
//     ladder): a per-thread serial prefix, a warp shuffle scan, and the
//     warp totals read back lane-parallel and folded with one
//     __reduce_max_sync;
//   - the UP-chain metadata (U, C) and the k-step predecessor hops
//     (N, N2, N3) follow the reference's three-shift propagation; the
//     "LEFT" hop reads slot x-1 of this row, exchanged across threads
//     through shared memory.
// A row costs three block barriers at k = 2 and five at k = 4. Measured
// on an H100 (band_edits.py, PERF.md), the row is bound by the integer
// instructions it issues more than by its barriers, so the body is cut
// for instructions: the warp totals read lane-parallel, the diagonal sum
// in int32 (as the plain version forms it) and one in-band test a
// thread. Recomputing slot x-1 in each thread to save a barrier, and
// packing the stores with __byte_perm, made K3 slower and were not kept.
// Output layout is the plain twin's "band" layout [Lq, B, W]: a lane's
// row is W contiguous bytes, written as SPT-wide vector stores.
//
// Filling the card. An overlap chunk has the reference's lanes: 64 on
// the tiled route, 128 on the untiled one (ops/budget.py admission rules,
// ops/ovl_align.py TB), so one chunk is 64 or 128 blocks on 132 SMs, one
// block an SM. The admission cap sizes a chunk; the group planner in
// ops/ovl_align.py sizes a launch: it concatenates consecutive chunks of
// one bucket (they share Lq, W, k and, tiled, T) into one launch of as
// many lanes as fill one wave, blocks_per_SM x SMs, from
// racon_band_occupancy below, so each SM interleaves the row chains of
// several lanes. At W=1536 and k=2 the tiled body takes 56 registers a
// thread, so three 384-thread blocks share an SM (G = 6 tiled chunks a
// launch on an H100); the untiled body there runs 768 threads of two
// slots at 38 registers, two blocks an SM (G = 2 untiled chunks). The
// kernels carry no
// __launch_bounds__: a floor of 2 or 3 resident blocks on the body
// before the cuts made ptxas schedule it differently and K3 8-14% slower
// (band_edits.py). A group's planes pass 2^31 elements (3 untiled chunks
// at Lq=8192, W=1536: 4.8e9), so every plane offset is 64-bit.
//
// Bound. K1 at its main-path shape (B=4096, Lq=640, W=256, k=4): the
// planes write B*Lq*W*(1+1+2) bytes ~ 2.7 GB (~0.8 ms at 3.35 TB/s), and
// the integer work is ~40 operations per cell over 671 M cells; the two
// are of the same order. K3 at its group shape (B=384, T=2048, W=1536,
// k=2): 1.2e9 cells at 2 bytes a cell is 0.72 ms of HBM, 40 operations a
// cell 2.9 ms of int32 throughput, so it is bound by operations. The
// design keeps every score and metadata word in shared memory or
// registers so device memory sees only the planes; what it does not hide
// is the chain of dependent rows, one per block barrier pair.
//
// Arithmetic: scores are int32 with NEG = -2^30, and every score is at
// least NEG. P + sub can reach exactly 2*NEG = -2^31 (a masked cell below
// a masked cell), which int32 holds, as in the plain version; the clamp
// to NEG precedes the "- j*gap" exactly as in the reference.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr int kUSat = 11;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int uc_boundary(int k) {
  // (N3 << 18 | N2 << 12 | N << 6 | U << 2 | C) with every field LEFT/0.
  return k >= 4 ? ((((kLeft << 6) | kLeft) << 6 | kLeft) << 6) | kLeft
                : (kLeft << 6) | kLeft;
}

template <int SPT>
struct Vec;
template <>
struct Vec<1> {
  static __device__ void put8(uint8_t* p, const int* v) { p[0] = (uint8_t)v[0]; }
  static __device__ void put16(uint16_t* p, const int* v) { p[0] = (uint16_t)v[0]; }
};
template <>
struct Vec<2> {
  static __device__ void put8(uint8_t* p, const int* v) {
    *reinterpret_cast<uint16_t*>(p) =
        (uint16_t)((v[0] & 0xff) | ((v[1] & 0xff) << 8));
  }
  static __device__ void put16(uint16_t* p, const int* v) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t)(v[0] & 0xffff) | ((uint32_t)(v[1] & 0xffff) << 16);
  }
};
template <>
struct Vec<4> {
  static __device__ void put8(uint8_t* p, const int* v) {
    uint32_t w = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8) |
                 ((uint32_t)(v[2] & 0xff) << 16) | ((uint32_t)(v[3] & 0xff) << 24);
    *reinterpret_cast<uint32_t*>(p) = w;
  }
  static __device__ void put16(uint16_t* p, const int* v) {
    uint2 w;
    w.x = (uint32_t)(v[0] & 0xffff) | ((uint32_t)(v[1] & 0xffff) << 16);
    w.y = (uint32_t)(v[2] & 0xffff) | ((uint32_t)(v[3] & 0xffff) << 16);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

// Frontier of a tile launch (TILED): inputs after row i0, outputs after
// row i0 + rows; all int32[B, W].
struct Frontier {
  const int32_t* pin;
  const int32_t* ucin;
  const int32_t* hlin;
  int32_t* pout;
  int32_t* ucout;
};

// Computes rows i0+1 .. i0+Lq (Lq = this launch's row count) and writes
// them at rows [i0, i0+Lq) of planes laid out [*, B, W].
template <int SPT, int K, bool TILED>
__device__ __forceinline__ void band_rows(
    const uint8_t* __restrict__ tband, const uint8_t* __restrict__ qT,
    const int32_t* __restrict__ klo, const int32_t* __restrict__ lq,
    uint8_t* __restrict__ cells, uint8_t* __restrict__ nxt,
    uint16_t* __restrict__ nxt2, int32_t* __restrict__ hlast, Frontier fr,
    int B, int Lq, int i0, int W, int match, int mismatch, int gap) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int PW = W + Lq;
  int32_t* P = smem;                 // W + 1 scores of the previous row
  int32_t* UC = P + (W + 1);         // W + 1 packed metadata words
  int32_t* wmax = UC + (W + 1);      // 32 warp totals of the scan
  int32_t* edge = wmax + 32;         // 3 * nthr last-slot exchanges
  uint8_t* tb = reinterpret_cast<uint8_t*>(edge + 3 * nthr);  // PW
  uint8_t* qs = tb + PW;             // Lq

  const int BND = uc_boundary(K);
  const int kl = klo[b];
  const int lqb = lq[b];
  for (int y = tid; y < PW; y += nthr) tb[y] = tband[(size_t)b * PW + y];
  for (int r = tid; r < Lq; r += nthr) qs[r] = qT[(size_t)r * B + b];

  const int x0 = tid * SPT;
  const size_t fb = (size_t)b * W;
  int hl[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int x = x0 + s;
    if (TILED) {
      hl[s] = x < W ? fr.hlin[fb + x] : kNeg;
      if (x < W) {
        P[x] = fr.pin[fb + x];
        UC[x] = fr.ucin[fb + x];
      }
    } else {
      const int j0 = kl + x;
      hl[s] = j0 >= 0 ? j0 * gap : kNeg;
      if (x < W) {
        P[x] = hl[s];
        UC[x] = BND;
      }
    }
  }
  if (tid == 0) {
    P[W] = kNeg;
    UC[W] = BND;
  }
  __syncthreads();

  // SPT divides W, so a thread's slots are all in the band or all out.
  const bool active = x0 < W;
  for (int r = 1; r <= Lq; ++r) {
    const int i = i0 + r;  // global 1-based row
    const int qb = qs[r - 1];
    int dg[SPT];
    int upv[SPT], f[SPT], ucp[SPT], ucup[SPT], jc[SPT];
    int tot = kNeg;
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int x = x0 + s;
      jc[s] = i + kl + x;
      if (active) {
        int sub = (tb[r - 1 + x] == qb) ? match : mismatch;
        if (jc[s] < 1) sub = kNeg;
        dg[s] = P[x] + sub;  // >= 2*NEG = -2^31, no wrap
        upv[s] = P[x + 1] + gap;
        int t = dg[s] > upv[s] ? dg[s] : upv[s];
        if (jc[s] == 0) t = i * gap;
        if (t < kNeg) t = kNeg;
        const int fv = t - jc[s] * gap;
        tot = fv > tot ? fv : tot;
        ucp[s] = UC[x];
        ucup[s] = UC[x + 1];
      } else {
        dg[s] = 0;
        upv[s] = 0;
        ucp[s] = BND;
        ucup[s] = BND;
      }
      f[s] = tot;  // thread-local inclusive prefix max
    }
    // Block-wide exclusive prefix max of the per-thread totals.
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = v > incl ? v : incl;
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNeg;
    if (lane == 31) wmax[warp] = incl;
    __syncthreads();
    {
      const int m = __reduce_max_sync(kFull, lane < warp ? wmax[lane] : kNeg);
      excl = m > excl ? m : excl;
    }

    int h[SPT], d[SPT], U[SPT], C[SPT], un[SPT], N[SPT];
    bool isup[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int F = f[s] > excl ? f[s] : excl;
      const int hv = jc[s] >= 0 ? F + jc[s] * gap : kNeg;
      h[s] = hv;
      d[s] = hv == dg[s] ? kDiag : (hv == upv[s] ? kUp : kLeft);
      isup[s] = d[s] == kUp;
      const int uu = ((ucup[s] >> 2) & 0xF) + 1;
      U[s] = isup[s] ? (uu < kUSat ? uu : kUSat) : 0;
      C[s] = isup[s] ? (ucup[s] & 3) : d[s];
      un[s] = (U[s] << 2) + C[s];
      if (i == lqb) hl[s] = hv;
    }
    const size_t row = ((size_t)(i - 1) * B + b) * W + x0;
    {
      int pk[SPT];
#pragma unroll
      for (int s = 0; s < SPT; ++s) pk[s] = d[s] + (C[s] << 2) + (U[s] << 4);
      if (active) Vec<SPT>::put8(cells + row, pk);
    }
    int uc_new[SPT];
    if (K >= 2) {
      edge[tid] = un[SPT - 1];
      __syncthreads();
      int left = tid > 0 ? edge[tid - 1] : kLeft;
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        N[s] = isup[s] ? ((ucup[s] >> 6) & 0x3F)
                       : (d[s] == kDiag ? (ucp[s] & 0x3F) : left);
        left = un[s];
      }
      if (active) Vec<SPT>::put8(nxt + row, N);
#pragma unroll
      for (int s = 0; s < SPT; ++s) uc_new[s] = (N[s] << 6) + un[s];
    } else {
#pragma unroll
      for (int s = 0; s < SPT; ++s) uc_new[s] = un[s];
    }
    if (K >= 4) {
      int N2[SPT], N3[SPT];
      edge[nthr + tid] = N[SPT - 1];
      __syncthreads();
      int left = tid > 0 ? edge[nthr + tid - 1] : kLeft;
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        N2[s] = isup[s] ? ((ucup[s] >> 12) & 0x3F)
                        : (d[s] == kDiag ? ((ucp[s] >> 6) & 0x3F) : left);
        left = N[s];
      }
      edge[2 * nthr + tid] = N2[SPT - 1];
      __syncthreads();
      left = tid > 0 ? edge[2 * nthr + tid - 1] : kLeft;
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        N3[s] = isup[s] ? ((ucup[s] >> 18) & 0x3F)
                        : (d[s] == kDiag ? ((ucp[s] >> 12) & 0x3F) : left);
        left = N2[s];
      }
      int pk[SPT];
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        pk[s] = (N3[s] << 8) + N2[s];
        uc_new[s] += (N3[s] << 18) + (N2[s] << 12);
      }
      if (active) Vec<SPT>::put16(nxt2 + row, pk);
    }
    // Every read of P/UC for this row happened before the scan's sync.
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int x = x0 + s;
      if (active) {
        P[x] = h[s];
        UC[x] = uc_new[s];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int x = x0 + s;
    if (x < W) {
      hlast[fb + x] = hl[s];
      if (TILED) {
        fr.pout[fb + x] = P[x];
        fr.ucout[fb + x] = UC[x];
      }
    }
  }
}

#define RACON_BAND_PARAMS                                                    \
  const uint8_t *__restrict__ tband, const uint8_t *__restrict__ qT,         \
      const int32_t *__restrict__ klo, const int32_t *__restrict__ lq,       \
      uint8_t *__restrict__ cells, uint8_t *__restrict__ nxt,                \
      uint16_t *__restrict__ nxt2, int32_t *__restrict__ hlast, Frontier fr, \
      int B, int Lq, int i0, int W, int match, int mismatch, int gap
#define RACON_BAND_ARGS                                                     \
  tband, qT, klo, lq, cells, nxt, nxt2, hlast, fr, B, Lq, i0, W, match,     \
      mismatch, gap

// K1.
template <int SPT, int K>
__global__ void band_fwd_kernel(RACON_BAND_PARAMS) {
  band_rows<SPT, K, false>(RACON_BAND_ARGS);
}

// K3.
template <int SPT, int K>
__global__ void band_tile_kernel(RACON_BAND_PARAMS) {
  band_rows<SPT, K, true>(RACON_BAND_ARGS);
}

using BandKernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*,
                            const int32_t*, uint8_t*, uint8_t*, uint16_t*,
                            int32_t*, Frontier, int, int, int, int, int, int,
                            int);

// Slots a thread of the instantiation for (tiled, W): 4 when W % 4 == 0,
// else 1; K1 at 1024 <= W <= 2048 takes 2, twice the warps on each row's
// chain at half the blocks an SM. Measured on an H100 (band_edits.py,
// variant spt2): the untiled overlap chunks' K1 8% faster a lane over the
// main path's 3-chunk bucket and 19-29% faster on one chunk, K1 at the
// consensus shape (W=256, 4 slots) unchanged. K3 keeps four: its groups
// already hold three blocks an SM.
int band_spt(bool tiled, int W) {
  if (!tiled && W >= 1024 && W <= 2048 && W % 2 == 0) return 2;
  return (W % 4) == 0 ? 4 : 1;
}

// Threads a block: W / band_spt, in whole warps.
int band_threads(bool tiled, int W) {
  const int slots = W / band_spt(tiled, W);
  return ((slots + 31) / 32) * 32;
}

// Dynamic shared memory: P and UC rows, warp totals, last-slot
// exchanges, the target window and the query column.
size_t band_smem(int W, int rows, int nthr) {
  return sizeof(int32_t) * (2 * (W + 1) + 32 + 3 * nthr) +
         (size_t)(W + rows) + (size_t)rows;
}

// The untiled entry takes k in {1, 2, 4}, the tiled entry k in {2, 4}.
template <int SPT>
BandKernel band_kernel_spt(bool tiled, int k) {
  if (!tiled)
    return k >= 4 ? &band_fwd_kernel<SPT, 4>
                  : (k >= 2 ? &band_fwd_kernel<SPT, 2>
                            : &band_fwd_kernel<SPT, 1>);
  if (k != 2 && k != 4) return nullptr;
  return k == 4 ? &band_tile_kernel<SPT, 4> : &band_tile_kernel<SPT, 2>;
}

// The instantiation for (tiled, W, depth k), or nullptr where none
// exists (past 1024 threads a block, or no such k).
BandKernel band_kernel_for(bool tiled, int W, int k) {
  if (W <= 0 || band_threads(tiled, W) > 1024) return nullptr;
  switch (band_spt(tiled, W)) {
    case 4: return band_kernel_spt<4>(tiled, k);
    case 2: return band_kernel_spt<2>(tiled, k);
    default: return band_kernel_spt<1>(tiled, k);
  }
}

cudaError_t allow_smem(BandKernel kern, size_t shm) {
  if (shm <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shm);
}

cudaError_t launch(bool tiled, int nxt_k, const uint8_t* tband,
                   const uint8_t* qT, const int32_t* klo, const int32_t* lq,
                   uint8_t* cells, uint8_t* nxt, uint16_t* nxt2,
                   int32_t* hlast, Frontier fr, int B, int Lq, int i0, int W,
                   int match, int mismatch, int gap, cudaStream_t stream) {
  BandKernel kern = band_kernel_for(tiled, W, nxt_k);
  if (kern == nullptr) return cudaErrorInvalidValue;
  const int nthr = band_threads(tiled, W);
  const size_t shm = band_smem(W, Lq, nthr);
  cudaError_t e = allow_smem(kern, shm);
  if (e != cudaSuccess) return e;
  kern<<<B, nthr, shm, stream>>>(tband, qT, klo, lq, cells, nxt, nxt2, hlast,
                                 fr, B, Lq, i0, W, match, mismatch, gap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int racon_band_fwd(const void* tband, const void* qT,
                              const void* klo, const void* lq, void* cells,
                              void* nxt, void* nxt2, void* hlast, int B,
                              int Lq, int W, int match, int mismatch,
                              int gap, int nxt_k, void* stream) {
  if (B <= 0 || Lq <= 0) return (int)cudaErrorInvalidValue;
  const Frontier fr{nullptr, nullptr, nullptr, nullptr, nullptr};
  return (int)launch(
      false, nxt_k, static_cast<const uint8_t*>(tband),
      static_cast<const uint8_t*>(qT), static_cast<const int32_t*>(klo),
      static_cast<const int32_t*>(lq), static_cast<uint8_t*>(cells),
      static_cast<uint8_t*>(nxt), static_cast<uint16_t*>(nxt2),
      static_cast<int32_t*>(hlast), fr, B, Lq, 0, W, match, mismatch, gap,
      static_cast<cudaStream_t>(stream));
}

// One tile: rows i0+1 .. i0+T from the frontier (prev, uc, hlast_in),
// written at rows [i0, i0+T) of the stitched [Lq, B, W] planes whose row 0
// the plane pointers address. nxt_k is 2 or 4.
extern "C" int racon_band_tile_fwd(
    const void* tband, const void* qT, const void* klo, const void* lq,
    const void* prev, const void* uc, const void* hlast_in, void* cells,
    void* nxt, void* nxt2, void* hlast, void* prev_out, void* uc_out, int B,
    int T, int i0, int W, int match, int mismatch, int gap, int nxt_k,
    void* stream) {
  if (B <= 0 || T <= 0 || i0 < 0) return (int)cudaErrorInvalidValue;
  const Frontier fr{static_cast<const int32_t*>(prev),
                    static_cast<const int32_t*>(uc),
                    static_cast<const int32_t*>(hlast_in),
                    static_cast<int32_t*>(prev_out),
                    static_cast<int32_t*>(uc_out)};
  return (int)launch(
      true, nxt_k, static_cast<const uint8_t*>(tband),
      static_cast<const uint8_t*>(qT), static_cast<const int32_t*>(klo),
      static_cast<const int32_t*>(lq), static_cast<uint8_t*>(cells),
      static_cast<uint8_t*>(nxt), static_cast<uint16_t*>(nxt2),
      static_cast<int32_t*>(hlast), fr, B, T, i0, W, match, mismatch, gap,
      static_cast<cudaStream_t>(stream));
}

// What one instantiation gets on this card at (tiled, W, rows, nxt_k):
// out[0] resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// with the launch's threads and shared memory), out[1] registers a thread,
// out[2] local memory bytes a thread (where spills go), out[3] threads a
// block. The group planner (ops/ovl_align.py) sizes a launch from out[0].
extern "C" int racon_band_occupancy(int tiled, int W, int rows, int nxt_k,
                                    int* out) {
  BandKernel kern = band_kernel_for(tiled != 0, W, nxt_k);
  if (kern == nullptr || rows <= 0) return (int)cudaErrorInvalidValue;
  const int nthr = band_threads(tiled != 0, W);
  const size_t shm = band_smem(W, rows, nthr);
  cudaError_t e = allow_smem(kern, shm);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(kern), nthr, shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = nthr;
  return 0;
}
