// Monotone count of the op-string vote extraction (Hopper, sm_90a):
//
//     F[b, p] = #{ s : X[b, s] < p }   for p in [0, P)
//
// Replaces the JAX package's Pallas kernel
// racon_tpu/ops/pallas/count_kernel.py::_kernel (entry
// monotone_count_pallas), and is held bitwise against the plain PyTorch
// version racon_tpu_torch/ops/device_merge.py::monotone_count_plain.
//
// Bound on an H100: X is read once and F written once, 4*B*(S + P)
// bytes (18.6 us at 3.35 TB/s at the op-string route's shape B=14965,
// S=532, P=510), against a handful of integer operations an element:
// bytes bound. At ~2 KB a lane in and out, what stands between a kernel
// and that bound is the fixed cost of each lane: start-up, barriers and
// the round trips of a serial scan.
//
// Design: one warp a lane, up to 8 lanes a block (fewer where 8
// histograms of P bins would pass the block's shared memory:
// ops/kernels.py::count_plan), and no block barrier anywhere. The launch
// bounds hold a thread to 32 registers, so that 8 such blocks (64 warps)
// fill an SM. Each warp owns its lane's histogram in shared memory and
// synchronises with __syncwarp only. The lane's S values go into the
// histogram over [0, P): a value v < P-1 adds one at max(v+1, 0) (every
// p > v counts it), a value v >= P-1 adds nothing; an inclusive scan over
// the P bins then gives F. That is #{s : X[b,s] < p} exactly for any X,
// sorted or not, at O(S + P) work a lane where the Pallas kernel makes
// S*P compares. The histogram takes shared-memory integer atomics, whose
// sums do not depend on their order, so F is the same from run to run.
//
// - X is read as 16-byte loads from the row's first 16-byte boundary;
//   the unaligned head and the tail (at most 3 + 3 values) are read one
//   value a thread. Every value is its own atomic: adding equal bins of
//   the warp by one atomic (__match_any_sync) ran 2.4x slower at the
//   route's shape on an H100 (PERF.md §6).
// - The scan: each thread sums a contiguous run of bins (an odd number
//   of them, so the 32 threads read 32 distinct banks), a 5-step
//   __shfl_up_sync scan gives its offset, and the scanned bins go back
//   into the histogram. F is written from there with consecutive threads
//   on consecutive p, as 16-byte stores where the output row is 16-byte
//   aligned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 8;
constexpr unsigned kFull = 0xffffffffu;

// Bins a lane's histogram takes: P rounded up to whole 16-byte pieces.
__host__ __device__ inline int hist_stride(int P) { return (P + 3) & ~3; }

// One value into the histogram h.
__device__ __forceinline__ void add_value(int32_t* h, int v, int P) {
  if (v < P - 1) atomicAdd(&h[max(v + 1, 0)], 1);
}

__global__ void __launch_bounds__(32 * kMaxLanes, 2048 / (32 * kMaxLanes))
    monotone_count_kernel(const int32_t* __restrict__ X,
                          int32_t* __restrict__ F, int B, int S, int P) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;
  const int np4 = hist_stride(P) >> 2;
  int4* h4 = smem4 + (size_t)w * np4;
  int32_t* h = reinterpret_cast<int32_t*>(h4);
  for (int k = lane; k < np4; k += 32) h4[k] = make_int4(0, 0, 0, 0);
  __syncwarp();

  const int32_t* x = X + (size_t)b * S;
  const int head = min(S, (int)((16 - (reinterpret_cast<uintptr_t>(x) & 15))
                                & 15) >> 2);
  const int n4 = (S - head) >> 2;
  const int tail = S - head - 4 * n4;
  const int4* body = reinterpret_cast<const int4*>(x + head);
  for (int k = lane; k < n4; k += 32) {
    const int4 v = body[k];
    add_value(h, v.x, P);
    add_value(h, v.y, P);
    add_value(h, v.z, P);
    add_value(h, v.w, P);
  }
  if (lane < head)
    add_value(h, x[lane], P);
  else if (lane - head < tail)
    add_value(h, x[head + 4 * n4 + (lane - head)], P);
  __syncwarp();

  const int per = ((P + 31) >> 5) | 1;
  const int c0 = min(lane * per, P);
  const int c1 = min(c0 + per, P);
  int sum = 0;
  for (int p = c0; p < c1; ++p) sum += h[p];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  int run = incl - sum;
  for (int p = c0; p < c1; ++p) {
    run += h[p];
    h[p] = run;
  }
  __syncwarp();

  int32_t* f = F + (size_t)b * P;
  int p0 = 0;
  if ((reinterpret_cast<uintptr_t>(f) & 15) == 0) {
    for (int k = lane; k < (P >> 2); k += 32)
      reinterpret_cast<int4*>(f)[k] = h4[k];
    p0 = P & ~3;
  }
  for (int p = p0 + lane; p < P; p += 32) f[p] = h[p];
}

size_t count_smem(int P, int lanes) {
  return sizeof(int32_t) * (size_t)hist_stride(P) * lanes;
}

cudaError_t allow_smem(size_t shm) {
  if (shm <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(monotone_count_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shm);
}

}  // namespace

// X: i32 [B, S]; F: i32 [B, P]; `lanes` warps a block, one a lane.
extern "C" int racon_monotone_count(const void* X, void* F, int B, int S,
                                    int P, int lanes, void* stream) {
  if (B <= 0 || S < 0 || P <= 0 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const size_t shm = count_smem(P, lanes);
  cudaError_t e = allow_smem(shm);
  if (e != cudaSuccess) return (int)e;
  monotone_count_kernel<<<(B + lanes - 1) / lanes, 32 * lanes, shm,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(X), static_cast<int32_t*>(F), B, S, P);
  return (int)cudaGetLastError();
}

// out: resident blocks an SM, registers a thread, local-memory bytes a
// thread, threads a block of the launch racon_monotone_count makes.
extern "C" int racon_monotone_count_occupancy(int P, int lanes, int* out) {
  if (P <= 0 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const size_t shm = count_smem(P, lanes);
  cudaError_t e = allow_smem(shm);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, monotone_count_kernel, 32 * lanes, shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, monotone_count_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = 32 * lanes;
  return 0;
}
