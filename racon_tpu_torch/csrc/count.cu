// Monotone count of the op-string vote extraction (Hopper, sm_90a):
//
//     F[b, p] = #{ s : X[b, s] < p }   for p in [0, P)
//
// Replaces the JAX package's Pallas kernel
// racon_tpu/ops/pallas/count_kernel.py::_kernel (entry
// monotone_count_pallas), and is held bitwise against the plain PyTorch
// version racon_tpu_torch/ops/device_merge.py::monotone_count_plain.
//
// Design: one block per lane. The lane's S values go into a shared-memory
// histogram over [0, P): a value v < P-1 adds one at max(v+1, 0) (every
// p > v counts it), a value v >= P-1 adds nothing; an inclusive block
// scan over the P bins then gives F. That is #{s : X[b,s] < p} exactly
// for any X, sorted or not, at O(S + P) work a lane where the Pallas
// kernel makes S*P compares. The histogram takes shared-memory integer
// atomics, whose sums do not depend on their order, so F is the same from
// run to run. The scan: each thread sums a contiguous run of bins, a
// warp-shuffle scan and one shared-memory pass over the warp totals give
// its offset, and the scanned bins go back to shared memory so the
// output rows are written with consecutive threads on consecutive p.
//
// Bound: X is read once and F written once, 4*B*(S + P) bytes, against a
// handful of integer operations an element: bytes bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    monotone_count_kernel(const int32_t* __restrict__ X,
                          int32_t* __restrict__ F, int S, int P) {
  extern __shared__ int32_t hist[];  // P bins, then 32 warp totals
  int32_t* wsum = hist + P;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int p = tid; p < P; p += kThreads) hist[p] = 0;
  __syncthreads();
  const int32_t* x = X + (size_t)b * S;
  for (int s = tid; s < S; s += kThreads) {
    const int v = x[s];
    if (v < P - 1) atomicAdd(&hist[v < 0 ? 0 : v + 1], 1);
  }
  __syncthreads();

  const int per = (P + kThreads - 1) / kThreads;
  const int c0 = min(tid * per, P);
  const int c1 = min(c0 + per, P);
  int sum = 0;
  for (int p = c0; p < c1; ++p) sum += hist[p];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int p = c0; p < c1; ++p) {
    run += hist[p];
    hist[p] = run;
  }
  __syncthreads();
  int32_t* f = F + (size_t)b * P;
  for (int p = tid; p < P; p += kThreads) f[p] = hist[p];
}

}  // namespace

// X: i32 [B, S]; F: i32 [B, P].
extern "C" int racon_monotone_count(const void* X, void* F, int B, int S,
                                    int P, void* stream) {
  if (B <= 0 || S < 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const size_t shm = sizeof(int32_t) * ((size_t)P + 32);
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        monotone_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  monotone_count_kernel<<<B, kThreads, shm,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(X), static_cast<int32_t*>(F), S, P);
  return (int)cudaGetLastError();
}
