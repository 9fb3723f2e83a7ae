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
// grid.
//
// Design: one block per lane; threads across the target columns, each
// owning G consecutive groups of four columns (G > 1 only when Lt / 4
// exceeds the 1024-thread block). The Lq query rows run in a loop inside
// the block, with the lane's target and query staged in shared memory
// and the substitution formed from the u8 codes (the Pallas kernel's int8
// [Lq, B, Lt] substitution tensor is never built). The left-gap chain of
// a row is the prefix max of f = max(diag, up) - (j+1)*gap, floored at
// the boundary i*gap: per thread over its columns, then a warp-shuffle
// scan, then one shared-memory pass over the 32 warp totals (identity:
// the reference's NEG). Each row runs two passes over a thread's
// columns: the first reduces the thread's max of f, the second (after
// the scan) recomputes diag/up, emits the codes and overwrites the score
// row. A thread reads its first column's left neighbour before the
// scan's barrier and carries the previous row's value of each column it
// overwrites in a register, so one score row in shared memory suffices
// and the registers a thread needs do not grow with G.
//
// Bound at the op-string route's shape (B=4096, Lq=640, Lt=512): the
// plane writes B*Lq*Lt bytes (1.34 GB, 0.40 ms at 3.35 TB/s) against the
// 14 integer operations a cell that one pass needs (1.12 ms at the int32
// rate; chip_smoke.py's OPS_PER_CELL lists them): operations bound. The
// second pass above is this design's extra work and is not in the bound.

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
    nw_fwd_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
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

template <bool VEC>
cudaError_t launch(const uint8_t* q, const uint8_t* t, uint8_t* dirs, int B,
                   int Lq, int Lt, int match, int mismatch, int gap,
                   cudaStream_t stream) {
  const int groups = (Lt + 3) / 4;
  const int nthr = min(kMaxThreads, ((groups + 31) / 32) * 32);
  const int G = (groups + nthr - 1) / nthr;
  const size_t shm =
      sizeof(int32_t) * ((size_t)Lt + 32) + (size_t)Lt + (size_t)Lq;
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_fwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return e;
  }
  nw_fwd_kernel<VEC><<<B, nthr, shm, stream>>>(q, t, dirs, B, Lq, Lt, G,
                                               match, mismatch, gap);
  return cudaGetLastError();
}

}  // namespace

// q: u8 [B, Lq]; t: u8 [B, Lt]; dirs: u8 [Lq, B, Lt].
extern "C" int racon_nw_fwd(const void* q, const void* t, void* dirs, int B,
                            int Lq, int Lt, int match, int mismatch, int gap,
                            void* stream) {
  if (B <= 0 || Lq <= 0 || Lt <= 0) return (int)cudaErrorInvalidValue;
  auto* qq = static_cast<const uint8_t*>(q);
  auto* tt = static_cast<const uint8_t*>(t);
  auto* d = static_cast<uint8_t*>(dirs);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      (Lt % 4) == 0
          ? launch<true>(qq, tt, d, B, Lq, Lt, match, mismatch, gap, st)
          : launch<false>(qq, tt, d, B, Lq, Lt, match, mismatch, gap, st);
  return (int)e;
}
