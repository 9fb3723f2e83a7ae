// Full-width NW forward over absolute target columns (Hopper, sm_90a).
//
// Replaces the JAX package's Pallas kernel
// racon_tpu/ops/pallas/flat_kernel.py::_kernel (entry fw_dirs_pallas), and
// is held bitwise against the plain PyTorch version
// racon_tpu_torch/ops/flat.py::fw_dirs_flat_plain.
//
// Design: one block per lane; each thread owns SPT consecutive target
// columns j; the Lq query rows run in a loop inside the block with the
// lane's target and query staged in shared memory. The diag neighbour is
// column j-1 of the previous row (shared memory), the up neighbour column
// j of the previous row, and the left-gap chain a block-wide inclusive
// prefix max of tmp - (j+1)*gap with the H[i][0] = i*gap boundary
// injected at column 0 as (i+1)*gap. The UP-chain metadata (U, C) of a
// column stays in the owning thread's registers: in absolute coordinates
// the UP predecessor is the same column. Output u8 [Lq, B, Lt].
//
// Bound at the main-path shape (B=1024, Lq=640, Lt=640): the plane
// writes B*Lq*Lt bytes (~0.42 GB, ~0.13 ms at 3.35 TB/s) against ~30
// integer operations per cell over 419 M cells; scores and metadata
// never leave shared memory or registers.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr int kUSat = 11;
constexpr unsigned kFull = 0xffffffffu;

template <int SPT>
__device__ __forceinline__ void put8(uint8_t* p, const int* v);
template <>
__device__ __forceinline__ void put8<1>(uint8_t* p, const int* v) {
  p[0] = (uint8_t)v[0];
}
template <>
__device__ __forceinline__ void put8<4>(uint8_t* p, const int* v) {
  *reinterpret_cast<uint32_t*>(p) =
      (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8) |
      ((uint32_t)(v[2] & 0xff) << 16) | ((uint32_t)(v[3] & 0xff) << 24);
}

template <int SPT>
__global__ void flat_fwd_kernel(const uint8_t* __restrict__ tbuf,
                                const uint8_t* __restrict__ qT,
                                uint8_t* __restrict__ cells, int B, int Lq,
                                int Lt, int match, int mismatch, int gap) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t* P = smem;                 // Lt scores of the previous row
  int32_t* wmax = P + Lt;            // 32 warp totals of the scan
  uint8_t* tb = reinterpret_cast<uint8_t*>(wmax + 32);  // Lt
  uint8_t* qs = tb + Lt;             // Lq
  for (int y = tid; y < Lt; y += nthr) tb[y] = tbuf[(size_t)b * Lt + y];
  for (int r = tid; r < Lq; r += nthr) qs[r] = qT[(size_t)r * B + b];

  const int j0 = tid * SPT;
  int U[SPT], C[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = j0 + s;
    if (j < Lt) P[j] = (j + 1) * gap;  // H[0][j+1]
    U[s] = 0;
    C[s] = kLeft;
  }
  __syncthreads();

  for (int i = 1; i <= Lq; ++i) {
    const int qb = qs[i - 1];
    int diag[SPT], up[SPT], f[SPT];
    int tot = INT_MIN;
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int j = j0 + s;
      if (j < Lt) {
        const int sub = (tb[j] == qb) ? match : mismatch;
        const int pshift = j == 0 ? (i - 1) * gap : P[j - 1];
        diag[s] = pshift + sub;
        up[s] = P[j] + gap;
        int tmp = diag[s] > up[s] ? diag[s] : up[s];
        const int bnd = (i + 1) * gap + (j == 0 ? 0 : kNeg);
        tmp = tmp > bnd ? tmp : bnd;
        const int fv = tmp - (j + 1) * gap;
        tot = fv > tot ? fv : tot;
      } else {
        diag[s] = 0;
        up[s] = 0;
      }
      f[s] = tot;
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = v > incl ? v : incl;
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = INT_MIN;
    if (lane == 31) wmax[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = wmax[w] > excl ? wmax[w] : excl;

    int h[SPT], pk[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int F = f[s] > excl ? f[s] : excl;
      h[s] = F + (j0 + s + 1) * gap;
      const int d = h[s] == diag[s] ? kDiag : (h[s] == up[s] ? kUp : kLeft);
      const bool isup = d == kUp;
      U[s] = isup ? (U[s] + 1 < kUSat ? U[s] + 1 : kUSat) : 0;
      C[s] = isup ? C[s] : d;
      pk[s] = d + (C[s] << 2) + (U[s] << 4);
    }
    if (j0 < Lt) put8<SPT>(cells + ((size_t)(i - 1) * B + b) * Lt + j0, pk);
    // Every read of P for this row happened before the scan's sync.
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      if (j0 + s < Lt) P[j0 + s] = h[s];
    __syncthreads();
  }
}

template <int SPT>
cudaError_t launch(const uint8_t* tbuf, const uint8_t* qT, uint8_t* cells,
                   int B, int Lq, int Lt, int match, int mismatch, int gap,
                   cudaStream_t stream) {
  const int slots = (Lt + SPT - 1) / SPT;
  const int nthr = ((slots + 31) / 32) * 32;
  const size_t shm =
      sizeof(int32_t) * (Lt + 32) + (size_t)Lt + (size_t)Lq;
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flat_fwd_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return e;
  }
  flat_fwd_kernel<SPT><<<B, nthr, shm, stream>>>(tbuf, qT, cells, B, Lq, Lt,
                                                 match, mismatch, gap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int racon_flat_fwd(const void* tbuf, const void* qT, void* cells,
                              int B, int Lq, int Lt, int match,
                              int mismatch, int gap, void* stream) {
  auto* t = static_cast<const uint8_t*>(tbuf);
  auto* q = static_cast<const uint8_t*>(qT);
  auto* c = static_cast<uint8_t*>(cells);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (Lt % 4) == 0;
  if ((vec ? Lt / 4 : Lt) > 1024 || B <= 0 || Lq <= 0 || Lt <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = vec ? launch<4>(t, q, c, B, Lq, Lt, match, mismatch, gap, st)
                      : launch<1>(t, q, c, B, Lq, Lt, match, mismatch, gap, st);
  return (int)e;
}
