// Op-string traceback over NW direction codes (Hopper, sm_90a).
//
// Replaces the JAX package's traceback, an XLA scan
// (racon_tpu/ops/align.py::_traceback_flat, not a Pallas kernel), on the
// [Lq, B, Lt] layout its Pallas forward (and K4, nw_fwd.cu) writes; held
// bitwise against racon_tpu_torch/ops/align.py::traceback_plain followed
// by the reference's flip and op count.
//
// Design: one thread per lane walks from (lq, lt) back to (0, 0), one op
// a step for L = Lq + Lt steps (PAD_OP once it is home), reading cell
// (i, j) at dirs[(i-1)*B*Lt + b*Lt + (j-1)] in 64-bit indices (B = 4096
// at Lq = Lt = 768 already passes 2^31). Step s writes ops[b, L-1-s], so
// the row comes out right-aligned behind PAD_OP in start-to-end order
// (the reference's flip) with no second pass, and the lane's op count n.
//
// Bound: the walk reads one byte a step and writes L bytes a lane, a few
// MB at the route's shape (microseconds of HBM). What bounds it is the
// chain: up to lq + lt dependent loads a lane, each a device-memory round
// trip through a plane far larger than L2, as in the column walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr int kPadOp = 3;
constexpr int kThreads = 32;

__global__ void nw_traceback_kernel(const uint8_t* __restrict__ dirs,
                                    const int32_t* __restrict__ lq,
                                    const int32_t* __restrict__ lt,
                                    uint8_t* __restrict__ ops,
                                    int32_t* __restrict__ n_out, int B,
                                    int Lq, int Lt, int L) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // Starting points past the plane are clamped onto it (as the plain
  // version does).
  int i = min(max(lq[b], 0), Lq);
  int j = min(max(lt[b], 0), Lt);
  const size_t plane = (size_t)B * Lt;
  const uint8_t* lane = dirs + (size_t)b * Lt;
  uint8_t* row = ops + (size_t)b * L;
  int n = 0;
  for (int s = 0; s < L; ++s) {
    int d;
    if (i == 0 && j == 0) {
      d = kPadOp;
    } else if (i == 0) {
      d = kLeft;
    } else if (j == 0) {
      d = kUp;
    } else {
      d = __ldg(lane + (size_t)(i - 1) * plane + (j - 1));
    }
    row[L - 1 - s] = (uint8_t)d;
    n += d != kPadOp;
    i -= (d == kDiag || d == kUp) ? 1 : 0;
    j -= (d == kDiag || d == kLeft) ? 1 : 0;
  }
  n_out[b] = n;
}

}  // namespace

// dirs: u8 [Lq, B, Lt]; lq, lt: i32 [B]; ops: u8 [B, L]; n: i32 [B].
extern "C" int racon_nw_traceback(const void* dirs, const void* lq,
                                  const void* lt, void* ops, void* n, int B,
                                  int Lq, int Lt, int L, void* stream) {
  if (B <= 0 || Lq <= 0 || Lt <= 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  nw_traceback_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(lq),
      static_cast<const int32_t*>(lt), static_cast<uint8_t*>(ops),
      static_cast<int32_t*>(n), B, Lq, Lt, L);
  return (int)cudaGetLastError();
}
