// Batched NW forward: direction codes of every DP cell (Hopper, sm_90a).
//
// Replaces the JAX package's Pallas kernel
// racon_tpu/ops/pallas/nw_kernel.py::_kernel (entry nw_dirs_pallas), and
// is held bitwise against the plain PyTorch version
// racon_tpu_torch/ops/align.py::nw_dirs_plain.
//
// Cell (i, j) of lane b, 1 <= i <= Lq and 1 <= j <= Lt, lands at
// dirs[i-1, b, j-1] of a u8 [Lq, B, Lt] plane: DIAG 0, UP 1, LEFT 2 (ties
// in that order), from int32 scores with H[0, j] = j*gap, H[i, 0] = i*gap
// and the substitution q == t ? match : mismatch over the whole padded
// grid. The left-gap chain of a row is the prefix max of f = max(diag,
// up) - (j+1)*gap, floored at the boundary i*gap.
//
// Bound on an H100 at the op-string route's shapes (Lt = 512; B=4096 at
// Lq=512 and 640, B=3072 at Lq=640): the planes write B*Lq*Lt bytes
// (1.34 GB at B=4096, Lq=640: 0.40 ms at 3.35 TB/s) against the 14
// integer operations a cell that one pass needs (1.12 ms at the int32
// rate; chip_smoke.py's OPS_PER_CELL lists them): operations bound. K4 is
// integer DP along a serial chain of rows. It has no matrix product and
// no tile to reuse, so wgmma and TMA have nothing to do here: on this
// card the design is about registers, warp shuffles and occupancy.
//
// Two variants, both hand kernels; ops/kernels.py::nw_plan picks one by
// shape.
//
// The warp kernel (Lt <= 1024, every shape of the op-string route): one
// warp a lane, kWarpLanes lanes a block, no shared memory and no block
// barrier. Thread l owns C = ceil(Lt/32) (rounded up to a multiple of 4)
// consecutive columns j0 = l*C ... j0+C-1, and keeps the score row of
// those columns in registers, as f-space scores P[c] = H[i-1][j0+c+1] -
// (j0+c+1)*gap: then up - (j+1)*gap = P[c] + gap and diag - (j+1)*gap =
// P[c-1] + sub - gap, and the new row is P[c] = max(base, prefix max of
// f), with no per-column gap offset to add or take off. A row is one
// pass: an ascending sweep over the registers forms f and its running
// max (Hopper's DPX add-max, __viaddmax_s32), a 5-step shuffle scan
// gives the exclusive max of the earlier threads' totals, and a
// descending sweep forms the codes and overwrites P (descending, so that
// diag still reads the old P[c-1]). The left neighbour of a thread's
// first column comes from the thread before it by __shfl_up_sync. The
// lane's target codes sit in registers, 4 to a word; each thread loads
// the query base of one row of a 32-row stripe and __shfl_sync
// broadcasts the row's base; __vcmpeq4 compares 4 columns at once. The
// C codes are packed 4 to a word and stored as 16-byte pieces where the
// row allows (Lt % 16 == 0 and C % 16 == 0; at Lt = 512 a warp writes
// its 512-byte row as 32 such stores), else as words or bytes. Columns
// at or past Lt are computed but never stored.
//
// The wide kernel (any Lt whose row fits in shared memory): one block a
// lane; threads across the target columns, each owning G consecutive
// groups of four columns (G > 1 only when Lt / 4 exceeds the 1024-thread
// block). The Lq query rows run in a loop inside the block, with the
// lane's target and query staged in shared memory. The prefix max runs
// per thread over its columns, then as a warp-shuffle scan, then one
// shared-memory pass over the 32 warp totals (identity: the reference's
// NEG). Each row runs two passes over a thread's columns: the first
// reduces the thread's max of f, the second (after the scan) recomputes
// diag/up, emits the codes and overwrites the score row; two block
// barriers a row. It was the only variant before the warp kernel, which
// does the same work in one pass with no barrier.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    nw_fwd_wide(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                uint8_t* __restrict__ dirs, int B, int Lq, int Lt, int G,
                int match, int mismatch, int gap) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t* P = smem;                                    // Lt: H[i-1][j+1]
  int32_t* wmax = P + Lt;                               // 32 warp totals
  uint8_t* tb = reinterpret_cast<uint8_t*>(wmax + 32);  // Lt target codes
  uint8_t* qs = tb + Lt;                                // Lq query codes
  for (int y = tid; y < Lt; y += nthr) {
    tb[y] = t[(size_t)b * Lt + y];
    P[y] = (y + 1) * gap;
  }
  for (int r = tid; r < Lq; r += nthr) qs[r] = q[(size_t)b * Lq + r];
  __syncthreads();

  const int j0 = tid * 4 * G;
  const int j1 = min(j0 + 4 * G, Lt);
  for (int i = 1; i <= Lq; ++i) {
    const int qb = qs[i - 1];
    // H[i-1][j0]: the boundary, or the previous thread's last column.
    const int left0 = j0 == 0 ? (i - 1) * gap : (j0 < Lt ? P[j0 - 1] : 0);
    int tot = kNeg;
    int left = left0;
    for (int j = j0; j < j1; ++j) {
      const int pj = P[j];
      const int diag = left + (tb[j] == qb ? match : mismatch);
      const int up = pj + gap;
      tot = max(tot, max(diag, up) - (j + 1) * gap);
      left = pj;
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNeg;
    if (lane == 31) wmax[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = max(excl, wmax[w]);

    int run = max(excl, i * gap);
    left = left0;
    uint8_t* row = dirs + ((size_t)(i - 1) * B + b) * Lt;
    uint32_t word = 0;
    for (int j = j0; j < j1; ++j) {
      const int pj = P[j];
      const int diag = left + (tb[j] == qb ? match : mismatch);
      const int up = pj + gap;
      run = max(run, max(diag, up) - (j + 1) * gap);
      const int h = run + (j + 1) * gap;
      const int d = h == diag ? kDiag : (h == up ? kUp : kLeft);
      P[j] = h;
      left = pj;
      if (VEC) {
        word |= (uint32_t)d << (8 * (j & 3));
        if ((j & 3) == 3) {
          *reinterpret_cast<uint32_t*>(row + j - 3) = word;
          word = 0;
        }
      } else {
        row[j] = (uint8_t)d;
      }
    }
    // Every read of P for this row happened before the scan's barrier or
    // in this thread's own columns.
    __syncthreads();
  }
}

// The wide kernel's block: threads across the 4-column groups, and its
// shared memory (ops/kernels.py::nw_smem).
int wide_threads(int Lt) {
  const int groups = (Lt + 3) / 4;
  return min(kMaxThreads, ((groups + 31) / 32) * 32);
}

size_t wide_smem(int Lq, int Lt) {
  return sizeof(int32_t) * ((size_t)Lt + 32) + (size_t)Lt + (size_t)Lq;
}

using WideKernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, int,
                            int, int, int, int, int, int);

// The wide kernel for Lt, allowed the shared memory of (Lq, Lt).
cudaError_t wide_kernel(int Lq, int Lt, WideKernel* kern) {
  *kern = Lt % 4 == 0 ? nw_fwd_wide<true> : nw_fwd_wide<false>;
  const size_t shm = wide_smem(Lq, Lt);
  if (shm <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
}

constexpr int kWarpLanes = 4;

// max(a + b, c): one DPX instruction on Hopper.
__device__ __forceinline__ int add_max(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpLanes)
    nw_fwd_warp(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                uint8_t* __restrict__ dirs, int B, int Lq, int Lt, int match,
                int mismatch, int gap) {
  static_assert(C % 4 == 0 && C >= 4 && C <= 32, "C: 4, 8, ..., 32");
  constexpr int NW = C / 4;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpLanes + (threadIdx.x >> 5);
  if (b >= B) return;
  const int j0 = lane * C;

  uint32_t tw[NW];  // target codes, 4 to a word
  const uint8_t* tr = t + (size_t)b * Lt;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + 4 * w + k;
      if (j < Lt) word |= (uint32_t)tr[j] << (8 * k);
    }
    tw[w] = word;
  }
  int P[C];  // f-space row: H[i-1][j0+c+1] - (j0+c+1)*gap, 0 at i = 1
#pragma unroll
  for (int c = 0; c < C; ++c) P[c] = 0;
  int fpref[C];
  const int mg = match - gap;
  const int xg = mismatch - gap;
  const bool full = j0 + C <= Lt;
  const bool vec16 = C % 16 == 0 && Lt % 16 == 0;
  const bool vec4 = Lt % 4 == 0;
  const uint8_t* qr = q + (size_t)b * Lq;

  for (int i0 = 0; i0 < Lq; i0 += 32) {
    const uint32_t qs = i0 + lane < Lq ? qr[i0 + lane] : 0u;
    const int rows = min(32, Lq - i0);
    for (int r = 0; r < rows; ++r) {
      const int i = i0 + r + 1;
      const uint32_t qrep = __shfl_sync(kFull, qs, r) * 0x01010101u;
      uint32_t eq[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) eq[w] = __vcmpeq4(tw[w], qrep);
      int left = __shfl_up_sync(kFull, P[C - 1], 1);
      if (lane == 0) left = (i - 1) * gap;

      int run = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int sg = (eq[c >> 2] >> (8 * (c & 3))) & 1 ? mg : xg;
        run = add_max(P[c], gap, run);
        run = add_max(c == 0 ? left : P[c - 1], sg, run);
        fpref[c] = run;
      }
      int incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = kNeg;
      const int base = max(excl, i * gap);

      uint32_t code[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) code[w] = 0;
#pragma unroll
      for (int c = C - 1; c >= 0; --c) {
        const int sg = (eq[c >> 2] >> (8 * (c & 3))) & 1 ? mg : xg;
        const int diag = (c == 0 ? left : P[c - 1]) + sg;
        const int up = P[c] + gap;
        const int h = max(base, fpref[c]);
        const uint32_t d = h == diag ? kDiag : (h == up ? kUp : kLeft);
        code[c >> 2] |= d << (8 * (c & 3));
        P[c] = h;
      }

      uint8_t* row = dirs + ((size_t)(i - 1) * B + b) * Lt + j0;
      if (full && vec16) {
        if constexpr (C % 16 == 0) {
#pragma unroll
          for (int k = 0; k < C / 16; ++k)
            reinterpret_cast<uint4*>(row)[k] =
                make_uint4(code[4 * k], code[4 * k + 1], code[4 * k + 2],
                           code[4 * k + 3]);
        }
      } else if (full && vec4) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
          reinterpret_cast<uint32_t*>(row)[w] = code[w];
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (j0 + c < Lt)
            row[c] = (uint8_t)(code[c >> 2] >> (8 * (c & 3)));
      }
    }
  }
}

using WarpKernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, int,
                            int, int, int, int, int);

WarpKernel warp_kernel(int C) {
  switch (C) {
    case 4: return nw_fwd_warp<4>;
    case 8: return nw_fwd_warp<8>;
    case 12: return nw_fwd_warp<12>;
    case 16: return nw_fwd_warp<16>;
    case 20: return nw_fwd_warp<20>;
    case 24: return nw_fwd_warp<24>;
    case 28: return nw_fwd_warp<28>;
    case 32: return nw_fwd_warp<32>;
    default: return nullptr;
  }
}

}  // namespace

// q: u8 [B, Lq]; t: u8 [B, Lt]; dirs: u8 [Lq, B, Lt]. C = 0: the wide
// kernel; C in {4, 8, ..., 32} with 32*C >= Lt: the warp kernel with C
// columns a thread.
extern "C" int racon_nw_fwd(const void* q, const void* t, void* dirs, int B,
                            int Lq, int Lt, int match, int mismatch, int gap,
                            int C, void* stream) {
  if (B <= 0 || Lq <= 0 || Lt <= 0) return (int)cudaErrorInvalidValue;
  auto* qq = static_cast<const uint8_t*>(q);
  auto* tt = static_cast<const uint8_t*>(t);
  auto* d = static_cast<uint8_t*>(dirs);
  auto st = static_cast<cudaStream_t>(stream);
  if (C == 0) {
    WideKernel kern;
    const cudaError_t e = wide_kernel(Lq, Lt, &kern);
    if (e != cudaSuccess) return (int)e;
    const int nthr = wide_threads(Lt);
    const int G = ((Lt + 3) / 4 + nthr - 1) / nthr;
    kern<<<B, nthr, wide_smem(Lq, Lt), st>>>(qq, tt, d, B, Lq, Lt, G, match,
                                             mismatch, gap);
    return (int)cudaGetLastError();
  }
  const WarpKernel kern = warp_kernel(C);
  if (kern == nullptr || 32 * C < Lt) return (int)cudaErrorInvalidValue;
  kern<<<(B + kWarpLanes - 1) / kWarpLanes, 32 * kWarpLanes, 0, st>>>(
      qq, tt, d, B, Lq, Lt, match, mismatch, gap);
  return (int)cudaGetLastError();
}

// out: resident blocks an SM, registers a thread, local-memory bytes a
// thread, threads a block of the launch racon_nw_fwd makes for (Lq, Lt,
// C).
extern "C" int racon_nw_occupancy(int Lq, int Lt, int C, int* out) {
  if (Lq <= 0 || Lt <= 0) return (int)cudaErrorInvalidValue;
  const void* kern;
  int nthr;
  size_t shm = 0;
  if (C == 0) {
    WideKernel wk;
    const cudaError_t e = wide_kernel(Lq, Lt, &wk);
    if (e != cudaSuccess) return (int)e;
    kern = reinterpret_cast<const void*>(wk);
    nthr = wide_threads(Lt);
    shm = wide_smem(Lq, Lt);
  } else {
    const WarpKernel wk = warp_kernel(C);
    if (wk == nullptr || 32 * C < Lt) return (int)cudaErrorInvalidValue;
    kern = reinterpret_cast<const void*>(wk);
    nthr = 32 * kWarpLanes;
  }
  int blocks = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, nthr, shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = nthr;
  return 0;
}
