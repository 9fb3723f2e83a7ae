// Dependent-load latency probe (Hopper, sm_90a).
//
// Not a port of a TPU kernel: it measures the floor of the column walk
// (col_walk.cu). A walk lane is a chain of chain_len dependent loads, each
// about k plane rows (k * B * W bytes) below the last, and the B lanes of
// a plane row lie W bytes apart. Here thread b follows the same chain
// through an int32 array whose entry i holds the index of the next load,
// starting lane_stride * b entries below ``start``, so the probe makes the
// walk's loads at the walk's addresses (and meets the same L2 and TLB)
// with none of its work.
//
// Shared mode: the block first copies the array (at most kSharedEntries
// int32) into shared memory and the threads follow their chains there:
// the floor of one dependent on-chip step, the unit of the windowed
// walk's serial chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kSharedEntries = 12288;  // 48 KB, static shared memory

__global__ void chase_kernel(const int32_t* __restrict__ next, int start,
                             int lane_stride, int lanes, int steps,
                             int32_t* __restrict__ end) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  int i = start - lane_stride * b;
  for (int s = 0; s < steps; ++s) i = __ldg(next + i);
  end[b] = i;
}

__global__ void chase_shared_kernel(const int32_t* __restrict__ next, int n,
                                    int start, int lane_stride, int lanes,
                                    int steps, int32_t* __restrict__ end) {
  __shared__ int32_t s[kSharedEntries];
  for (int x = threadIdx.x; x < n; x += blockDim.x) s[x] = next[x];
  __syncthreads();
  const int b = threadIdx.x;
  if (b >= lanes) return;
  int i = start - lane_stride * b;
  for (int k = 0; k < steps; ++k) i = s[i];
  end[b] = i;
}

}  // namespace

// next: int32[n] with every entry in [0, n), n = start + 1; thread b
// starts at entry start - lane_stride * b (>= 0). end: int32[lanes], the
// index each thread reaches after ``steps`` loads. shared: 1 to chase
// through shared memory (n <= kSharedEntries, lanes <= 1024, one block).
extern "C" int racon_chase(const void* next, int start, int lane_stride,
                           int lanes, int steps, int shared, void* end,
                           void* stream) {
  if (next == nullptr || end == nullptr || lanes <= 0 || steps < 0 ||
      lane_stride < 0 || start < 0 ||
      (int64_t)start - (int64_t)lane_stride * (lanes - 1) < 0)
    return (int)cudaErrorInvalidValue;
  if (shared) {
    if (start + 1 > kSharedEntries || lanes > 1024)
      return (int)cudaErrorInvalidValue;
    chase_shared_kernel<<<1, (lanes + 31) / 32 * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(next), start + 1, start, lane_stride,
        lanes, steps, static_cast<int32_t*>(end));
    return (int)cudaGetLastError();
  }
  chase_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), start, lane_stride, lanes, steps,
      static_cast<int32_t*>(end));
  return (int)cudaGetLastError();
}
