// The window merge of a consensus round (Hopper, sm_90a): two kernels,
// M1 and M2, for the back half of a round after the column walk.
//
// They replace what the JAX package compiles with XLA into one round
// (racon_tpu/ops/device_poa.py:601-640): the vote extraction and the
// per-window sums of racon_tpu/ops/device_merge.py
// (extract_votes_cols:251, aggregate_votes:417, its membership matmul),
// then add_backbone, assemble, compact and coord_maps (:511, :534, :618,
// :651) and the state remap of device_poa.py:544. No Pallas kernel stands
// there; the port ran them as ~1,500 eager PyTorch ops a round. They are
// held bitwise against their plain versions,
// racon_tpu_torch/ops/device_merge.py::merge_votes_plain (M1) and
// ::merge_windows_plain (M2).
//
// Bound on an H100: bytes. M1 reads the walk's four int16 columns and the
// queries and writes the per-window sums (132 float32 channels a gap);
// M2 reads those sums and the anchors and writes the next round's state,
// a few operations a byte. What stands between the kernels and the bound
// is latency: each job's loads come after the last job's adds.
//
// Exactness. Every float32 operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), so that the compiler
// contracts nothing into a fused multiply-add: the bits are those of the
// plain version's separate PyTorch ops. M1 adds, for each gap and channel,
// the contributions of the window's jobs in job order, as the plain sum
// does one job at a time. Every contribution is >= 0 and every sum starts
// at +0.0, so a job whose contribution is zero may be skipped: adding +0.0
// would not change a bit. Only the nonzero ones are added. The channels
// whose sums are integers (counts, integer weights) are exact in any order.
//
// M1, racon_merge_votes: one block of kTile threads for each (tile of
// kTile gaps, window), one thread a gap p in [0, LA]. The thread keeps
// its gap's 132 sums in shared memory (column t of a [132][kTile] array:
// a warp touches 32 consecutive words whatever channel each thread adds
// to, so there are no bank conflicts) and walks its window's jobs in job
// order: the walk's entries at p and p+1 (8 bytes each), then only the
// query bytes that the job's contributions at p read. The window's
// membership (stable order, starts, counts) comes in as device tensors;
// each block loops over its own window's count. Block (0, w) also sums
// the window's escape flags in job order.
//
// M2, racon_merge_windows: one block of kWinThreads threads a window. The
// threads fold in the backbone and vote out each gap (a gap a thread,
// strided, reading the sums with consecutive threads on consecutive
// gaps), keeping each gap's emitted length, kept flag, column code and
// coverage and its insertion codes and counts in the window's slice of a
// device-memory scratch buffer (about 70 bytes a gap, so that any anchor
// width runs: the slices stay in L2 at the main path's widths); a block
// scan of the lengths gives each gap's start and the window's total; a
// scatter from each gap fills the compacted codes and coverage in place in
// the outputs (what compact's gather reads: positions >= total hold 0,
// positions >= LA are dropped); a suffix-min and a prefix-max scan of the
// kept columns' landing positions give the coordinate maps with
// coord_maps' fallbacks and clamps; then the threads remap begin/end of
// the window's jobs through them. The block of the last window also
// remaps the padded lanes (window id n_win, sorted after every real
// lane), which read that window's maps as the plain version's clamp does,
// and carries the dummy anchor row over.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Channels of one gap's sums, in the order of the plain version's dict
// (device_merge.VOTE_CHANNELS).
constexpr int kBaseW = 0;     // 6: five bases and the deletion
constexpr int kBaseC = 6;     // 5
constexpr int kDirect = 11;   // 1
constexpr int kIns1W = 12;    // 5
constexpr int kIns1C = 17;    // 5
constexpr int kIns1Stop = 22; // 1
constexpr int kPileW = 23;    // K_INS x 5
constexpr int kPileC = 73;    // K_INS x 5
constexpr int kLenw = 123;    // K_INS - 1
constexpr int kNch = 132;
constexpr int kKins = 10;
constexpr int kNbase = 5;
constexpr int kDiag = 0;
constexpr int kHi = 1 << 30;

constexpr int kTile = 128;        // M1: gaps (threads) a block
constexpr int kWinThreads = 256;  // M2: threads a block
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ M1

// Weight of query position i of a lane: the 7-bit field the reference
// packs (qw8 clipped at 127) less one, at least 0; positions past the
// query read its last byte, as the padded words do.
__device__ __forceinline__ float weight_at(const uint8_t* w, int i, int Lq) {
  const int raw = min((int)w[min(i, Lq - 1)], 127);
  return fmaxf(__fadd_rn((float)raw, -1.0f), 0.0f);
}

__device__ __forceinline__ int base_at(const uint8_t* q, int i, int Lq) {
  return q[min(i, Lq - 1)] & 7;
}

// Query index of a column's base: the gather word at s0 = clamp(qstart) - 1
// and its field 1 when the clamped qi lies one past s0 (field 0 else).
__device__ __forceinline__ int column_index(int qstart, int qi, int Lq) {
  const int qsc = min(max(qstart, 0), Lq - 1);
  const int s0 = max(qsc - 1, 0);
  const int qic = min(max(qi, 0), Lq - 1);
  return s0 + (qic - s0 == 1 ? 1 : 0);
}

__device__ __forceinline__ void add_to(float* a, int ch, float v) {
  a[ch * kTile] = __fadd_rn(a[ch * kTile], v);
}

__global__ void __launch_bounds__(kTile) merge_votes_kernel(
    const int16_t* __restrict__ walk, long long walk_row,
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ qw8,
    const float* __restrict__ w_read, const int32_t* __restrict__ lt,
    const int32_t* __restrict__ t_off, const float* __restrict__ esc_w,
    const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, float* __restrict__ votes,
    float* __restrict__ wesc, int Lq, int LA) {
  extern __shared__ float acc_s[];  // [kNch][kTile]
  const int t = threadIdx.x;
  const int w = blockIdx.y;
  const int p = blockIdx.x * kTile + t;
  float* a = acc_s + t;
  for (int ch = 0; ch < kNch; ++ch) a[ch * kTile] = 0.0f;
  const int n = counts[w];
  const int32_t* ord = order + starts[w];

  if (p <= LA) {
    for (int r = 0; r < n; ++r) {
      const int j = ord[r];
      const int16_t* wr = walk + (size_t)j * walk_row;
      const short4 g0 = *reinterpret_cast<const short4*>(wr + 4 * p);
      const short4 g1 = *reinterpret_cast<const short4*>(wr + 4 * (p + 1));
      const int c = p - t_off[j];
      const int L = lt[j];
      const bool in_gaps = c >= 0 && c <= L;
      const bool in_cols = c >= 0 && c < L;
      const uint8_t* qj = q + (size_t)j * Lq;
      const uint8_t* wj = qw8 + (size_t)j * Lq;
      const float wread = w_read[j];
      const int ins = in_gaps ? (int)g0.x : 0;

      // The column consuming anchor position p (entry p+1).
      const bool match = in_cols && g1.z == kDiag;
      float wq = wread;
      int code = kNbase;
      if (match) {
        const int idx = column_index(g1.y, g1.w, Lq);
        code = base_at(qj, idx, Lq);
        wq = weight_at(wj, idx, Lq);
      }
      if (p < LA && in_cols) {
        if (code <= kNbase) add_to(a, kBaseW + code, wq);
        if (match && code < kNbase) add_to(a, kBaseC + code, 1.0f);
      }
      // The crossing weight of gap p: the mean of the weights of the
      // columns on either side (entry p's column, or the read mean at p=0).
      if (c >= 1 && c <= L - 1 && ins == 0) {
        float wq_prev = wread;
        if (p >= 1 && c - 1 < L && g0.z == kDiag)
          wq_prev = weight_at(wj, column_index(g0.y, g0.w, Lq), Lq);
        add_to(a, kDirect, __fmul_rn(0.5f, __fadd_rn(wq_prev, wq)));
      }
      // The insertion run at gap p, from query position qs on.
      if (ins >= 1) {
        const int qs = min(max((int)g0.y, 0), Lq - 1);
        if (ins == 1) {
          const int b = base_at(qj, qs, Lq);
          const float w1 = weight_at(wj, qs, Lq);
          if (b < kNbase) {
            add_to(a, kIns1W + b, w1);
            add_to(a, kIns1C + b, 1.0f);
          }
          add_to(a, kIns1Stop, w1);
        } else {
          const int m = min(ins, kKins);
          float run = 0.0f;
          for (int k = 0; k < m; ++k) {
            const int b = base_at(qj, qs + k, Lq);
            const float wk = weight_at(wj, qs + k, Lq);
            if (b < kNbase) {
              add_to(a, kPileW + kNbase * k + b, wk);
              add_to(a, kPileC + kNbase * k + b, 1.0f);
            }
            run = __fadd_rn(run, wk);
          }
          add_to(a, kLenw + m - 2, __fdiv_rn(run, (float)ins));
        }
      }
    }
    float* out = votes + (size_t)w * kNch * (LA + 1) + p;
    for (int ch = 0; ch < kNch; ++ch)
      out[(size_t)ch * (LA + 1)] = a[ch * kTile];
  }
  if (blockIdx.x == 0 && t == 0) {
    float s = 0.0f;
    for (int r = 0; r < n; ++r) s = __fadd_rn(s, esc_w[ord[r]]);
    wesc[w] = s;
  }
}

size_t votes_smem() { return sizeof(float) * kNch * kTile; }

// ------------------------------------------------------------------ M2

// One window's slice of M2's scratch at anchor width LA: int arrays
// first, then bytes.
struct WinScratch {
  int* start;    // [LA+1] emitted length, then its exclusive scan
  int* col_cov;  // [LA]
  int* map_b;    // [LA]
  int* map_e;    // [LA]
  int* ins_cnt;  // [kKins][LA+1]
  uint8_t* e;         // [LA+1]
  uint8_t* kept;      // [LA+1]
  uint8_t* col_code;  // [LA]
  uint8_t* ins_code;  // [kKins][LA+1]
};

// Bytes of one window's slice, in whole 16-byte pieces.
__host__ __device__ inline size_t win_bytes(int LA) {
  const size_t ints = (size_t)(LA + 1) * (1 + kKins) + 3 * (size_t)LA;
  const size_t bytes = (size_t)(LA + 1) * (2 + kKins) + (size_t)LA;
  return (sizeof(int) * ints + bytes + 15) & ~(size_t)15;
}

__device__ WinScratch carve(uint8_t* base, int LA) {
  WinScratch s;
  int* ip = reinterpret_cast<int*>(base);
  s.start = ip;
  ip += LA + 1;
  s.col_cov = ip;
  ip += LA;
  s.map_b = ip;
  ip += LA;
  s.map_e = ip;
  ip += LA;
  s.ins_cnt = ip;
  ip += (LA + 1) * kKins;
  uint8_t* bp = reinterpret_cast<uint8_t*>(ip);
  s.e = bp;
  bp += LA + 1;
  s.kept = bp;
  bp += LA + 1;
  s.col_code = bp;
  bp += LA;
  s.ins_code = bp;
  return s;
}

struct OpSum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct OpMin {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct OpMax {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Block-wide scan of a[0, n) in place (the block's scratch slice): each thread scans
// a contiguous run of entries, a warp scan and a scan of the warp totals
// give its offset. ``reverse`` scans from the end (a suffix scan);
// ``exclusive`` stores the scan before each entry, else after it. Returns
// the reduction of all n entries. Every thread of the block calls it.
template <class Op>
__device__ int block_scan(int* a, int n, int identity, bool reverse,
                          bool exclusive, Op op, int* red) {
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  const int per = (n + T - 1) / T;
  const int i0 = min(t * per, n), i1 = min(i0 + per, n);
  int loc = identity;
  for (int i = i0; i < i1; ++i) loc = op(loc, a[reverse ? n - 1 - i : i]);
  int incl = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = op(v, incl);
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? red[lane] : identity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v = op(u, v);
    }
    red[lane] = v;
  }
  __syncthreads();
  const int prefix = warp > 0 ? red[warp - 1] : identity;
  const int up = __shfl_up_sync(kFull, incl, 1);
  int run = lane > 0 ? op(prefix, up) : prefix;
  for (int i = i0; i < i1; ++i) {
    int& x = a[reverse ? n - 1 - i : i];
    const int v = x;
    if (exclusive) {
      x = run;
      run = op(run, v);
    } else {
      run = op(run, v);
      x = run;
    }
  }
  const int total = red[nwarps - 1];
  __syncthreads();
  return total;
}

__device__ __forceinline__ int first_max5(const float* v) {
  int best = 0;
#pragma unroll
  for (int i = 1; i < kNbase; ++i)
    if (v[i] > v[best]) best = i;
  return best;
}

__global__ void __launch_bounds__(kWinThreads) merge_windows_kernel(
    const float* __restrict__ votes, const float* __restrict__ wesc,
    const uint8_t* __restrict__ bb, const float* __restrict__ bbw,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ begin,
    const int32_t* __restrict__ end, const int32_t* __restrict__ win,
    const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const uint8_t* __restrict__ ovf,
    uint8_t* __restrict__ new_bb, float* __restrict__ new_bbw,
    int32_t* __restrict__ new_alen, int32_t* __restrict__ nb,
    int32_t* __restrict__ ne, int32_t* __restrict__ cov_out,
    uint8_t* __restrict__ ovf_out, uint8_t* __restrict__ conv,
    uint8_t* __restrict__ scratch, int B, int n_win, int LA, float ins_scale,
    float eps, int detect) {
  __shared__ int red[32];  // scan scratch
  __shared__ int changed;  // the window's changed spans
  const int T = blockDim.x, t = threadIdx.x;
  const int w = blockIdx.x;
  const WinScratch s = carve(scratch + (size_t)w * win_bytes(LA), LA);
  const int LA1 = LA + 1;
  uint8_t* codes = new_bb + (size_t)w * LA;
  int32_t* cov = cov_out + (size_t)w * LA;
  const float* V = votes + (size_t)w * kNch * LA1;
  const uint8_t* bbr = bb + (size_t)w * LA;
  const float* bwr = bbw + (size_t)w * LA;
  const int al = alen[w];
  const float bwl = bwr[min(max(al - 1, 0), LA - 1)];
  if (t == 0) changed = 0;

  // Backbone fold and vote-out of each gap.
  for (int p = t; p <= LA; p += T) {
    const float* v = V + p;
    float dw = v[(size_t)kDirect * LA1];
    if (p <= al) {
      float left = p == 0 ? bwr[0] : bwr[p - 1];
      float right = p < LA ? bwr[p] : bwl;
      if (p == al) left = right = bwl;
      dw = __fadd_rn(dw, __fadd_rn(__fmul_rn(0.5f, __fadd_rn(left, right)),
                                   eps));
    }
    bool kept = false;
    if (p < LA) {
      float bw[kNbase + 1], bc[kNbase];
#pragma unroll
      for (int i = 0; i <= kNbase; ++i) bw[i] = v[(size_t)(kBaseW + i) * LA1];
#pragma unroll
      for (int i = 0; i < kNbase; ++i) bc[i] = v[(size_t)(kBaseC + i) * LA1];
      const bool vcol = p < al;
      const int code = bbr[p];
      if (vcol && code < kNbase) {
        bw[code] = __fadd_rn(bw[code], __fadd_rn(bwr[p], eps));
        bc[code] = __fadd_rn(bc[code], 1.0f);
      }
      const int best = first_max5(bw);
      kept = vcol && bw[kNbase] <= bw[best];
      s.col_code[p] = (uint8_t)best;
      s.col_cov[p] = (int)bc[best];
    }
    float stopped = __fmul_rn(dw, ins_scale);
    bool emit = p <= al;
    int e = 0;
    for (int k = 0; k < kKins && emit; ++k) {
      float cw[kNbase], cc[kNbase];
#pragma unroll
      for (int i = 0; i < kNbase; ++i) {
        cw[i] = v[(size_t)(kPileW + kNbase * k + i) * LA1];
        cc[i] = v[(size_t)(kPileC + kNbase * k + i) * LA1];
        if (k == 0) {
          cw[i] = __fadd_rn(cw[i], v[(size_t)(kIns1W + i) * LA1]);
          cc[i] = __fadd_rn(cc[i], v[(size_t)(kIns1C + i) * LA1]);
        }
      }
      float tot = cw[0];
#pragma unroll
      for (int i = 1; i < kNbase; ++i) tot = __fadd_rn(tot, cw[i]);
      emit = tot > stopped;
      const int bk = first_max5(cw);
      s.ins_code[k * LA1 + p] = (uint8_t)bk;
      s.ins_cnt[k * LA1 + p] = (int)cc[bk];
      e += emit;
      if (k == 0) stopped = __fadd_rn(stopped, v[(size_t)kIns1Stop * LA1]);
      if (k >= 1) stopped = __fadd_rn(stopped, v[(size_t)(kLenw + k - 1) * LA1]);
    }
    s.e[p] = (uint8_t)e;
    s.kept[p] = kept;
    s.start[p] = e + kept;
  }
  for (int i = t; i < LA; i += T) {
    codes[i] = 0;
    cov[i] = 0;
  }
  __syncthreads();
  const int total = block_scan(s.start, LA1, 0, false, true, OpSum(), red);

  // Compaction: a scatter from each gap, and each kept column's landing
  // position for the maps.
  for (int p = t; p <= LA; p += T) {
    const int st = s.start[p];
    const int e = s.e[p];
    for (int k = 0; k < e; ++k)
      if (st + k < LA) {
        codes[st + k] = s.ins_code[k * LA1 + p];
        cov[st + k] = s.ins_cnt[k * LA1 + p];
      }
    if (p < LA) {
      const bool kept = s.kept[p];
      if (kept && st + e < LA) {
        codes[st + e] = s.col_code[p];
        cov[st + e] = s.col_cov[p];
      }
      s.map_b[p] = kept ? st + e : kHi;
      s.map_e[p] = kept ? st + e : -kHi;
    }
  }
  __syncthreads();
  const int first_kept =
      block_scan(s.map_b, LA, INT_MAX, true, false, OpMin(), red);
  const int last_kept =
      block_scan(s.map_e, LA, INT_MIN, false, false, OpMax(), red);
  const bool any_kept = first_kept != kHi && LA > 0;
  const int hi = max(total - 1, 0);
  for (int p = t; p < LA; p += T) {
    int mb = s.map_b[p], me = s.map_e[p];
    if (mb == kHi) mb = last_kept;
    if (me == -kHi) me = first_kept;
    if (!any_kept) mb = me = 0;
    s.map_b[p] = min(max(mb, 0), hi);
    s.map_e[p] = min(max(me, 0), hi);
  }
  __syncthreads();

  // Remap the window's jobs; the last window's block also takes the
  // padded lanes sorted after every real one.
  const int tot_c = min(max(total, 1), LA);
  const int n_real = counts[w];
  const int n_lanes = w == n_win - 1 ? B - starts[w] : n_real;
  const int32_t* ord = order + starts[w];
  for (int r = t; r < n_lanes; r += T) {
    const int j = ord[r];
    const int L = alen[min(max(win[j], 0), n_win)];
    const int b = begin[j], en = end[j];
    const int nbv = b < L ? s.map_b[min(max(b, 0), LA - 1)] : 0;
    const int nev = en < L ? s.map_e[min(max(en, 0), LA - 1)] : tot_c - 1;
    nb[j] = nbv;
    ne[j] = nev;
    if (detect && r < n_real && (nbv != b || nev != en))
      atomicAdd(&changed, 1);
  }

  // The next round's anchor row, coverage and flags.
  int same = 1;
  for (int i = t; i < LA; i += T) {
    same &= codes[i] == bbr[i];
    new_bbw[(size_t)w * LA + i] = 0.0f;
  }
  same = __syncthreads_and(same);
  if (t == 0) {
    new_alen[w] = tot_c;
    ovf_out[w] = ovf[w] || total > LA || wesc[w] > 0.0f;
    conv[w] = detect && total == al && changed == 0 && same;
  }
  if (w == n_win - 1) {
    for (int i = t; i < LA; i += T) {
      new_bb[(size_t)n_win * LA + i] = bb[(size_t)n_win * LA + i];
      new_bbw[(size_t)n_win * LA + i] = 0.0f;
    }
    if (t == 0) new_alen[n_win] = alen[n_win];
  }
}

cudaError_t allow_smem(const void* fn, size_t shm) {
  if (shm <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shm);
}

}  // namespace

// M1. walk: int16 [B, walk_row / 4, 4] (ins_len, qstart, op_c, qi_c; at
// least LA+2 entries a lane, 8-byte aligned); q, qw8: u8 [B, Lq]; w_read,
// esc_w: f32 [B]; lt, t_off: i32 [B]; order: i32 [B] (window order, real
// lanes first); starts, counts: i32 [n_win]. votes: f32 [n_win, 132,
// LA+1]; wesc: f32 [n_win].
extern "C" int racon_merge_votes(const void* walk, long long walk_row,
                                 const void* q, const void* qw8,
                                 const void* w_read, const void* lt,
                                 const void* t_off, const void* esc_w,
                                 const void* order, const void* starts,
                                 const void* counts, void* votes, void* wesc,
                                 int n_win, int Lq, int LA, void* stream) {
  if (n_win <= 0 || Lq <= 0 || LA <= 0 || walk_row < 4 * (long long)(LA + 2))
    return (int)cudaErrorInvalidValue;
  const size_t shm = votes_smem();
  cudaError_t e = allow_smem((const void*)merge_votes_kernel, shm);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((LA + 1 + kTile - 1) / kTile, n_win);
  merge_votes_kernel<<<grid, kTile, shm, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(walk), walk_row,
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(qw8),
      static_cast<const float*>(w_read), static_cast<const int32_t*>(lt),
      static_cast<const int32_t*>(t_off), static_cast<const float*>(esc_w),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<float*>(votes),
      static_cast<float*>(wesc), Lq, LA);
  return (int)cudaGetLastError();
}

// Bytes of M2's scratch a window at anchor width LA.
extern "C" long long racon_merge_windows_scratch(int LA) {
  return LA > 0 ? (long long)win_bytes(LA) : -1;
}

// M2. votes, wesc: M1's outputs; bb u8 / bbw f32 [n_win+1, LA]; alen i32
// [n_win+1]; begin, end, win: i32 [B]; order, starts, counts as M1's; ovf
// u8 [n_win]. Outputs: new_bb u8 / new_bbw f32 [n_win+1, LA], new_alen
// i32 [n_win+1], nb, ne i32 [B], cov i32 [n_win, LA], ovf_out, conv u8
// [n_win]. scratch: n_win * racon_merge_windows_scratch(LA) bytes,
// 16-byte aligned, read only after this launch writes it.
extern "C" int racon_merge_windows(
    const void* votes, const void* wesc, const void* bb, const void* bbw,
    const void* alen, const void* begin, const void* end, const void* win,
    const void* order, const void* starts, const void* counts,
    const void* ovf, void* new_bb, void* new_bbw, void* new_alen, void* nb,
    void* ne, void* cov, void* ovf_out, void* conv, void* scratch, int B,
    int n_win, int LA, float ins_scale, float eps, int detect,
    void* stream) {
  if (B <= 0 || n_win <= 0 || LA <= 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  merge_windows_kernel<<<n_win, kWinThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(votes), static_cast<const float*>(wesc),
      static_cast<const uint8_t*>(bb), static_cast<const float*>(bbw),
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(begin),
      static_cast<const int32_t*>(end), static_cast<const int32_t*>(win),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<const uint8_t*>(ovf),
      static_cast<uint8_t*>(new_bb), static_cast<float*>(new_bbw),
      static_cast<int32_t*>(new_alen), static_cast<int32_t*>(nb),
      static_cast<int32_t*>(ne), static_cast<int32_t*>(cov),
      static_cast<uint8_t*>(ovf_out), static_cast<uint8_t*>(conv),
      static_cast<uint8_t*>(scratch), B, n_win, LA, ins_scale, eps, detect);
  return (int)cudaGetLastError();
}

// out: resident blocks an SM, registers a thread, local-memory bytes a
// thread, threads a block and shared memory a block of M1 (which = 0) or
// M2 (which = 1); neither depends on the anchor width.
extern "C" int racon_merge_occupancy(int which, int* out) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const void* fn = which == 0 ? (const void*)merge_votes_kernel
                              : (const void*)merge_windows_kernel;
  const int threads = which == 0 ? kTile : kWinThreads;
  const size_t shm = which == 0 ? votes_smem() : 0;
  cudaError_t e = allow_smem(fn, shm);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = threads;
  out[4] = (int)(shm + attr.sharedSizeBytes);
  return 0;
}
