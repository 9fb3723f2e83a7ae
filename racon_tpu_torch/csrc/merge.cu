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
// is latency: a job's query bytes come after its walk entries, which come
// after its row in the window's order.
//
// Exactness. Every float32 operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), so that the compiler
// contracts nothing into a fused multiply-add: the bits are those of the
// plain version's separate PyTorch ops. M1 adds, for each gap and channel,
// the contributions of the window's jobs in job order, as the plain sum
// does one job at a time. Every contribution is >= 0 and every sum starts
// at +0.0, so a job whose contribution is zero may be skipped: adding +0.0
// would not change a bit. Only the nonzero ones are added. Where a sum
// lives (a register, shared memory, the output) changes no bit either.
//
// M1, racon_merge_votes: one block for each (tile, window), one thread a
// gap p in [0, LA]. The tiles are even (kernels.merge_votes_plan: at most
// kTileMax gaps a tile, as many tiles as that takes, the gaps split evenly
// among them), and the register cap of kVotesBlocks blocks an SM lets the
// main path's grid (6 tiles x 160 windows) run in one wave on 132 SMs.
// - The block stages its window's jobs once (their walk and query rows,
//   slice offset, length, read weight, escape weight: kStage jobs a pass)
//   in shared memory, so the per-job loop reads them as broadcasts.
// - The thread keeps the 23 channels that nearly every job touches (the
//   column's base weights and counts, the crossing weight, the single
//   insertions and their stop weight) in registers; each data-dependent
//   channel index becomes an unrolled compare-and-add, so nothing is
//   indexed at run time. The 109 channels of insertion runs of 2 or more
//   live in the output (the thread owns its gap's column of it alone): a
//   channel's first contribution is stored and the next ones added, and
//   the channels the gap never adds to are zeroed kZeroStep a job, so that
//   those stores overlap the loop instead of preceding it. The dense
//   output goes out with streaming stores (evict first), so that it does
//   not push the walk and the queries out of L2.
// - A software pipeline keeps the loads of the next jobs in flight: each
//   thread copies job r+kAhead's walk entries at p and p+1 into its own
//   slots of a ring in shared memory (cp.async, no barrier), and issues
//   job r+kByteDepth's query-byte loads into a ring of registers, before
//   job r's contributions are added. The weight of the column left of gap
//   p is the previous thread's column weight (a warp shuffle).
// Block (0, w) also sums the window's escape flags in job order.
//
// M2, racon_merge_windows, in two variants (kernels.merge_windows_plan).
// The narrow one (LA + 1 <= kWinMaxThreads): one block a window, one
// thread a gap, the gap's state in registers (emitted length, kept flag,
// column code and coverage, insertion codes packed 3 bits a rank; the
// emitted ranks' counts are read from the sums again when scattered;
// 32-bit offsets. Its registers must stay low enough for at least two
// blocks of 672 threads an SM, so that the main path's 160 windows at
// LA = 640 are resident at once: test_merge_occupancy checks it).
// The threads fold in the backbone and vote out their gaps; a block scan
// of one value a thread (a warp shuffle scan, then a scan of the warp
// totals: one barrier) gives each gap's start and the window's total;
// each thread scatters its run into the compacted codes and coverage (what
// compact's gather reads: positions >= total hold 0, positions >= LA are
// dropped); a suffix-min and a prefix-max scan of the kept columns'
// landing positions give the coordinate maps with coord_maps' fallbacks
// and clamps, into shared memory (2 x LA ints); then the threads remap
// begin/end of the window's jobs through them. The wide variant (any LA):
// 256 threads a window, a gap a thread strided, the per-gap state in the
// window's slice of a device-memory scratch and block scans over it. In
// both, the block of the last window also remaps the padded lanes (window
// id n_win, sorted after every real lane), which read that window's maps
// as the plain version's clamp does, and carries the dummy anchor row
// over.
//
// M2's sched mode (both variants; the template parameter Sched) is the
// convergence scheduler's round merge, held bitwise against
// device_merge.merge_windows_sched_plain. It is the base mode's launch,
// and then, in a window that freezes (converged, flagged or the schedule's
// last round: a block-uniform test once the flags are known), a second
// pass: the same sums voted out again at the final insertion scale (only
// the insertion ranks depend on the scale; the kept columns, their codes
// and coverages are the first pass's), scanned and compacted into the
// window's row of the scheduler's output accumulators (SchedOut), with its
// clipped length and the flag of its freeze reason. A window that does not
// freeze, or whose row is the trash row, writes nothing there.

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

constexpr int kTileMax = 128;      // M1: most gaps (threads) a block
constexpr int kVotesBlocks = 8;    // M1: blocks an SM (its register cap)
constexpr int kStage = 256;        // M1: jobs staged a pass
constexpr int kAhead = 6;          // M1: jobs whose walk entries are in flight
constexpr int kSlots = 8;          // M1: the entries' ring, in jobs (> kAhead)
constexpr int kByteDepth = 2;      // M1: jobs whose query bytes are in flight
constexpr int kRunCh = kNch - kPileW;  // M1: channels of runs of 2 or more
constexpr int kZeroStep = 4;       // M1: run channels zeroed a job
constexpr int kWinMaxThreads = 1024;        // M2 narrow: most gaps a block
constexpr int kWinThreads = 256;            // M2 wide: threads a block
constexpr unsigned kFull = 0xffffffffu;

// M2's sched mode: where a freezing window's final-scale output goes.
struct SchedOut {
  const int32_t* orig_ids;  // [n_win] each window's output row
  uint8_t* codes;           // [n_keep + 1, LA]
  int32_t* cov;             // [n_keep + 1, LA]
  int32_t* total;           // [n_keep + 1]
  uint8_t* ovf;             // [n_keep + 1]
  int n_keep;               // rows below the trash row n_keep
  float scale;              // the final round's insertion scale
  int last;                 // the schedule's last round: every window freezes
};

// ------------------------------------------------------------------ M1

// Weight of a query byte: the 7-bit field the reference packs (qw8
// clipped at 127) less one, at least 0.
__device__ __forceinline__ float weight_of(int raw) {
  return fmaxf(__fadd_rn((float)min(raw, 127), -1.0f), 0.0f);
}

// Weight and base code of query position i of a lane; positions past the
// query read its last byte, as the padded words do.
__device__ __forceinline__ float weight_at(const uint8_t* w, int i, int Lq) {
  return weight_of(w[min(i, Lq - 1)]);
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

// Field f of a walk entry (ins_len, qstart, op_c, qi_c) held as one
// 64-bit word.
__device__ __forceinline__ int field(long long g, int f) {
  return (int)(short)(g >> (16 * f));
}

__device__ __forceinline__ void add_out(float* out, int ch, size_t LA1,
                                        float v) {
  float* a = out + ch * LA1;
  *a = __fadd_rn(*a, v);
}

// An 8-byte asynchronous copy from device to shared memory; where ``on``
// is false nothing is read and the 8 bytes are zeroed.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool on) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(on ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The window's staged jobs, the ring of walk entries and thread p's place
// in its tile. A job's row j, slice offset t_off, length and read weight
// are read from the stage where they are used (a broadcast).
struct VotesCtx {
  const long long* walk;
  const uint8_t* q;
  const uint8_t* qw8;
  const long long* s_wrow;  // a job's first walk entry (row j's offset)
  const long long* s_qrow;  // a job's first query byte
  const int* s_off;
  const int* s_len;
  long long* ring;  // [kSlots][2][kTileMax]: entries p and p+1 of a job
  int t, p, pe, pe1, lane, Lq;
  bool own;
};

__device__ __forceinline__ long long* ring_at(const VotesCtx& x, int i) {
  return x.ring + (i & (kSlots - 1)) * 2 * kTileMax + x.t;
}

// Copy staged job i's walk entries p (where its slice covers gap p, 0 <= c
// <= L, c = p - t_off) and p+1 (where column p lies in the slice) into
// thread p's slot of the ring; each thread reads only its own copies, so
// no barrier is needed.
__device__ __forceinline__ void fetch_walk(const VotesCtx& x, int i) {
  const long long* wr = x.walk + x.s_wrow[i];
  const int c = x.p - x.s_off[i], L = x.s_len[i];
  long long* dst = ring_at(x, i);
  cp_async8(dst, wr + x.pe, x.own && c >= 0 && c <= L);
  cp_async8(dst + kTileMax, wr + x.pe1, x.own && c >= 0 && c < L);
}

__device__ __forceinline__ int entry_ins(long long g0, int c, int L) {
  return c >= 0 && c <= L ? field(g0, 0) : 0;
}

// What one job's contributions at p read of its query, packed in a word:
// bits 0-2 the column's base and 3-10 its weight byte (where the column
// consuming anchor position p is a match), 11-13 the first inserted base
// and 14-21 its weight byte (where an insertion run starts at p), 22-29
// the weight byte of the column left of p (lane 0 only: the other lanes
// take that weight from the previous thread), bit 30 the match.
constexpr int kColW = 3, kInsB = 11, kInsW = 14, kLeftW = 22, kMatch = 30;

// Issue the query-byte loads of staged job i, whose entries are in.
__device__ __forceinline__ unsigned fetch_bytes(const VotesCtx& x, int i) {
  const long long* e = ring_at(x, i);
  const long long g0 = e[0], g1 = e[kTileMax];
  const long long base = x.s_qrow[i];
  const int c = x.p - x.s_off[i], L = x.s_len[i];
  const int ins = entry_ins(g0, c, L);
  unsigned word = 0;
  if (x.own && c >= 0 && c < L && field(g1, 2) == kDiag) {
    const int idx = column_index(field(g1, 1), field(g1, 3), x.Lq);
    word = (__ldg(x.q + base + idx) & 7u) |
           (unsigned)__ldg(x.qw8 + base + idx) << kColW | 1u << kMatch;
  }
  if (x.own && ins >= 1) {
    const int qs = min(max(field(g0, 1), 0), x.Lq - 1);
    word |= (__ldg(x.q + base + qs) & 7u) << kInsB |
            (unsigned)__ldg(x.qw8 + base + qs) << kInsW;
  }
  if (x.lane == 0 && x.own && x.p >= 1 && c >= 1 && c <= L - 1 &&
      ins == 0 && field(g0, 2) == kDiag)
    word |= (unsigned)__ldg(x.qw8 + base + column_index(
                field(g0, 1), field(g0, 3), x.Lq)) << kLeftW;
  return word;
}

// The run channels (insertion runs of 2 or more) that a thread has added
// to: bit ch of tb[ch / 32]. A run channel's first contribution is stored
// (0 + v is v), the next ones added; one the thread never adds to is
// zeroed, kZeroStep a job as the jobs go and the rest at the end.
struct Touched {
  unsigned tb[4];

  __device__ __forceinline__ bool has(int ch) const {
    const int q = ch >> 5;
    const unsigned w = q == 0 ? tb[0] : q == 1 ? tb[1] : q == 2 ? tb[2]
                                                                : tb[3];
    return (w >> (ch & 31)) & 1u;
  }

  __device__ __forceinline__ void add(float* out, size_t LA1, int ch,
                                      float v) {
    float* a = out + (kPileW + ch) * LA1;
    if (has(ch)) {
      *a = __fadd_rn(*a, v);
      return;
    }
    *a = v;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q == ch >> 5) tb[q] |= 1u << (ch & 31);
  }
};

// Thread p's 23 register channels.
struct RegSums {
  float bw[kNbase + 1], bc[kNbase], i1w[kNbase], i1c[kNbase];
  float dw, i1s;
};

// Add staged job i's contributions at gap p, its query bytes in ``word``.
// Every lane calls it (the left column's weight is a shuffle).
__device__ __forceinline__ void add_job(const VotesCtx& x, const float* s_wr,
                                        int i, unsigned word, int LA,
                                        float* out, RegSums& r, Touched& tc) {
  const long long g0 = ring_at(x, i)[0];
  const int c = x.p - x.s_off[i], L = x.s_len[i];
  const float wr = s_wr[i];
  const bool in_cols = c >= 0 && c < L;
  const int ins = entry_ins(g0, c, L);
  const bool match = (word >> kMatch) & 1;
  // The column consuming anchor position p (entry p+1).
  float wq = wr;
  int code = kNbase;
  if (match) {
    code = word & 7;
    wq = weight_of((word >> kColW) & 0xff);
  }
  // The crossing weight of gap p: the mean of the weights of the columns
  // on either side (entry p's column, the previous thread's column
  // weight, or the read mean at p=0).
  float wq_prev = __shfl_up_sync(kFull, wq, 1);
  if (x.lane == 0)
    wq_prev = x.p >= 1 && field(g0, 2) == kDiag
                  ? weight_of((word >> kLeftW) & 0xff)
                  : wr;
  if (!x.own) return;
  if (x.p < LA && in_cols) {
#pragma unroll
    for (int b = 0; b <= kNbase; ++b)
      if (code == b) r.bw[b] = __fadd_rn(r.bw[b], wq);
    if (match) {
#pragma unroll
      for (int b = 0; b < kNbase; ++b)
        if (code == b) r.bc[b] = __fadd_rn(r.bc[b], 1.0f);
    }
  }
  if (c >= 1 && c <= L - 1 && ins == 0)
    r.dw = __fadd_rn(r.dw, __fmul_rn(0.5f, __fadd_rn(wq_prev, wq)));
  // The insertion run at gap p, from query position qs on.
  if (ins == 1) {
    const int b1 = (word >> kInsB) & 7;
    const float w1 = weight_of((word >> kInsW) & 0xff);
#pragma unroll
    for (int b = 0; b < kNbase; ++b)
      if (b1 == b) {
        r.i1w[b] = __fadd_rn(r.i1w[b], w1);
        r.i1c[b] = __fadd_rn(r.i1c[b], 1.0f);
      }
    r.i1s = __fadd_rn(r.i1s, w1);
  } else if (ins >= 2) {
    const size_t LA1 = (size_t)LA + 1;
    const int qs = min(max(field(g0, 1), 0), x.Lq - 1);
    const uint8_t* qj = x.q + x.s_qrow[i];
    const uint8_t* wj = x.qw8 + x.s_qrow[i];
    const int mr = min(ins, kKins);
    float run = 0.0f;
    for (int k = 0; k < mr; ++k) {
      const int b = k == 0 ? (int)((word >> kInsB) & 7)
                           : base_at(qj, qs + k, x.Lq);
      const float wk = k == 0 ? weight_of((word >> kInsW) & 0xff)
                              : weight_at(wj, qs + k, x.Lq);
      if (b < kNbase) {
        tc.add(out, LA1, kNbase * k + b, wk);
        tc.add(out, LA1, kPileC - kPileW + kNbase * k + b, 1.0f);
      }
      run = __fadd_rn(run, wk);
    }
    tc.add(out, LA1, kLenw - kPileW + mr - 2, __fdiv_rn(run, (float)ins));
  }
}

__global__ void __launch_bounds__(kTileMax, kVotesBlocks) merge_votes_kernel(
    const int16_t* __restrict__ walk, long long walk_row,
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ qw8,
    const float* __restrict__ w_read, const int32_t* __restrict__ lt,
    const int32_t* __restrict__ t_off, const float* __restrict__ esc_w,
    const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, float* __restrict__ votes,
    float* __restrict__ wesc, int Lq, int LA, int gaps) {
  __shared__ long long s_wrow[kStage], s_qrow[kStage];
  __shared__ int s_off[kStage], s_len[kStage];
  __shared__ float s_wr[kStage], s_esc[kStage];
  __shared__ long long s_ring[kSlots * 2 * kTileMax];
  const int t = threadIdx.x;
  const int w = blockIdx.y;
  VotesCtx x;
  x.walk = reinterpret_cast<const long long*>(walk);
  x.q = q;
  x.qw8 = qw8;
  x.s_wrow = s_wrow;
  x.s_qrow = s_qrow;
  x.s_off = s_off;
  x.s_len = s_len;
  x.ring = s_ring;
  x.t = t;
  x.p = blockIdx.x * gaps + t;
  x.pe = min(x.p, LA + 1);
  x.pe1 = min(x.p + 1, LA + 1);
  x.lane = t & 31;
  x.Lq = Lq;
  x.own = t < gaps && x.p <= LA;  // thread p owns gap p's sums
  const size_t LA1 = (size_t)LA + 1;
  float* out = votes + (size_t)w * kNch * LA1 + x.p;
  RegSums r;
#pragma unroll
  for (int i = 0; i <= kNbase; ++i) r.bw[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNbase; ++i) r.bc[i] = r.i1w[i] = r.i1c[i] = 0.0f;
  r.dw = r.i1s = 0.0f;
  Touched tc;
#pragma unroll
  for (int k = 0; k < 4; ++k) tc.tb[k] = 0u;
  int zc = 0;  // the next run channel to zero
  float esc = 0.0f;
  const int n = counts[w];
  const int32_t* ord = order + starts[w];

  for (int r0 = 0; r0 < n; r0 += kStage) {
    const int m = min(kStage, n - r0);
    __syncthreads();
    for (int i = t; i < m; i += blockDim.x) {
      const int j = ord[r0 + i];
      s_wrow[i] = (long long)j * (walk_row / 4);
      s_qrow[i] = (long long)j * Lq;
      s_off[i] = t_off[j];
      s_len[i] = lt[j];
      s_wr[i] = w_read[j];
      s_esc[i] = esc_w[j];
    }
    __syncthreads();
    if (blockIdx.x == 0 && t == 0)
      for (int i = 0; i < m; ++i) esc = __fadd_rn(esc, s_esc[i]);

    // Pipeline: job i+kAhead's walk entries and job i+kByteDepth's query
    // bytes are issued before job i is added. The bytes' words form a
    // ring of registers that the unrolled loop indexes statically, so no
    // register move waits on a load.
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (a < m) fetch_walk(x, a);
      cp_async_commit();
    }
    cp_async_wait<kAhead - kByteDepth>();
    unsigned words[kByteDepth + 1];
#pragma unroll
    for (int d = 0; d <= kByteDepth; ++d)
      words[d] = d < kByteDepth && d < m ? fetch_bytes(x, d) : 0u;
    for (int i0 = 0; i0 < m; i0 += kByteDepth + 1) {
#pragma unroll
      for (int u = 0; u <= kByteDepth; ++u) {
        const int i = i0 + u;
        if (i < m) {
          if (i + kAhead < m) fetch_walk(x, i + kAhead);
          cp_async_commit();
          cp_async_wait<kAhead - kByteDepth>();
          if (i + kByteDepth < m)
            words[(u + kByteDepth) % (kByteDepth + 1)] =
                fetch_bytes(x, i + kByteDepth);
          add_job(x, s_wr, i, words[u], LA, out, r, tc);
          if (x.own) {
#pragma unroll
            for (int z = 0; z < kZeroStep; ++z)
              if (zc + z < kRunCh && !tc.has(zc + z))
                __stcs(out + (kPileW + zc + z) * LA1, 0.0f);
          }
          zc += kZeroStep;
        }
      }
    }
    cp_async_wait<0>();
  }
  if (x.own) {
    for (int ch = zc; ch < kRunCh; ++ch)
      if (!tc.has(ch)) __stcs(out + (kPileW + ch) * LA1, 0.0f);
#pragma unroll
    for (int b = 0; b <= kNbase; ++b)
      __stcs(out + (kBaseW + b) * LA1, r.bw[b]);
#pragma unroll
    for (int b = 0; b < kNbase; ++b) {
      __stcs(out + (kBaseC + b) * LA1, r.bc[b]);
      __stcs(out + (kIns1W + b) * LA1, r.i1w[b]);
      __stcs(out + (kIns1C + b) * LA1, r.i1c[b]);
    }
    __stcs(out + kDirect * LA1, r.dw);
    __stcs(out + kIns1Stop * LA1, r.i1s);
  }
  if (blockIdx.x == 0 && t == 0) wesc[w] = esc;
}

// ------------------------------------------------------------------ M2

struct OpSum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct OpMin {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct OpMax {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

template <bool Reverse, class Op>
__device__ __forceinline__ int warp_scan(int v, int lane, Op op) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = Reverse ? __shfl_down_sync(kFull, v, off)
                          : __shfl_up_sync(kFull, v, off);
    if (Reverse ? lane + off < 32 : lane >= off) v = op(v, u);
  }
  return v;
}

// Inclusive scan of one value a thread over the block, in thread order
// (``Reverse``: from the last thread, a suffix scan): a warp shuffle scan,
// the warp totals through ``buf`` (32 ints of shared memory that no other
// scan of the launch uses) and one barrier, then each warp scans the warp
// totals itself. Returns the scan at this thread; ``*total`` gets the
// block's reduction. Every thread of the block calls it. Always inlined
// (the sched mode calls the sum scan twice).
template <bool Reverse, class Op>
__device__ __forceinline__ int scan_block(int v, int identity, Op op,
                                          int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_scan<Reverse>(v, lane, op);
  if (lane == (Reverse ? 0 : 31)) buf[warp] = v;
  __syncthreads();
  int x = lane < nwarps ? buf[lane] : identity;
  x = warp_scan<Reverse>(x, lane, op);
  const int src = Reverse ? warp + 1 : warp - 1;
  int before = __shfl_sync(kFull, x, src & 31);
  if (src < 0 || src >= nwarps) before = identity;
  *total = __shfl_sync(kFull, x, Reverse ? 0 : nwarps - 1);
  return op(before, v);
}

// The insertion ranks of gap p (narrow M2) at ``scale``, from the folded
// crossing weight dw: (x) the ranks emitted (rank 0 folds in the single
// insertions; rank k is tested only while every rank before it emitted),
// (y) their codes, 3 bits a rank.
__device__ __forceinline__ uint2 ins_ranks(const float* __restrict__ votes,
                                           int vp, int LA1, float dw,
                                           float scale, bool emit) {
  int e = 0;
  unsigned icode = 0;
  float stopped = __fmul_rn(dw, scale);
#pragma unroll
  for (int k = 0; k < kKins && emit; ++k) {
    const int vk = vp + (kPileW + kNbase * k) * LA1;
    float cw[kNbase];
#pragma unroll
    for (int i = 0; i < kNbase; ++i) {
      cw[i] = votes[vk + i * LA1];
      if (k == 0) cw[i] = __fadd_rn(cw[i], votes[vp + (kIns1W + i) * LA1]);
    }
    float tot = cw[0];
#pragma unroll
    for (int i = 1; i < kNbase; ++i) tot = __fadd_rn(tot, cw[i]);
    emit = tot > stopped;
    int bk = 0;
    float top = cw[0];
#pragma unroll
    for (int i = 1; i < kNbase; ++i)
      if (cw[i] > top) {
        top = cw[i];
        bk = i;
      }
    if (emit) {
      icode |= (unsigned)bk << (3 * k);
      ++e;
      if (k + 1 < kKins)
        stopped = __fadd_rn(
            stopped, votes[vp + (k == 0 ? kIns1Stop : kLenw + k - 1) * LA1]);
    }
  }
  return make_uint2((unsigned)e, icode);
}

// Gap p's crossing weight with the backbone's folded in (narrow M2, 32-bit
// offsets: vp gap p's sums, ap the window's anchor row).
__device__ __forceinline__ float fold_direct_at(
    const float* __restrict__ votes, const float* __restrict__ bbw, int vp,
    int ap, int p, int al, int LA, int LA1, float eps) {
  float dw = votes[vp + kDirect * LA1];
  if (p <= al) {
    const float bwl = bbw[ap + min(max(al - 1, 0), LA - 1)];
    float left = p == 0 ? bbw[ap] : bbw[ap + p - 1];
    float right = p < LA ? bbw[ap + p] : bwl;
    if (p == al) left = right = bwl;
    dw = __fadd_rn(dw, __fadd_rn(__fmul_rn(0.5f, __fadd_rn(left, right)),
                                 eps));
  }
  return dw;
}

// The count of gap p's emitted rank k, code bk (narrow M2), read from the
// sums again.
__device__ __forceinline__ int ins_count(const float* __restrict__ votes,
                                         int vp, int LA1, int k, int bk) {
  float c = votes[vp + (kPileC + kNbase * k + bk) * LA1];
  if (k == 0) c = __fadd_rn(c, votes[vp + (kIns1C + bk) * LA1]);
  return (int)c;
}

template <bool Sched>
__global__ void __launch_bounds__(kWinMaxThreads) merge_windows_kernel(
    const float* __restrict__ votes, const float* __restrict__ wesc,
    const uint8_t* __restrict__ bb, const float* __restrict__ bbw,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ begin,
    const int32_t* __restrict__ end, const int32_t* __restrict__ win,
    const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, const uint8_t* __restrict__ ovf,
    uint8_t* __restrict__ new_bb, float* __restrict__ new_bbw,
    int32_t* __restrict__ new_alen, int32_t* __restrict__ nb,
    int32_t* __restrict__ ne, int32_t* __restrict__ cov_out,
    uint8_t* __restrict__ ovf_out, uint8_t* __restrict__ conv, int B,
    int n_win, int LA, float ins_scale, float eps, int detect, SchedOut so) {
  extern __shared__ int maps[];  // [2][LA]: map_b, then map_e
  __shared__ int red[3][32];     // warp totals of the three scans
  const int p = threadIdx.x;
  const int w = blockIdx.x;
  const int LA1 = LA + 1;
  // 32-bit element offsets from the parameters' base pointers (the
  // wrapper keeps every tensor under 2^31 elements), so that few 64-bit
  // addresses stay live. vp: gap p's sums, channel 0; ap: the window's
  // anchor row.
  const int vp = w * kNch * LA1 + p;
  const int ap = w * LA;
  const int al = alen[w];

  // Backbone fold and vote-out of gap p, into registers: e emitted
  // insertion ranks (codes 3 bits a rank in icode), the kept flag, the
  // column's code and coverage.
  int e = 0, best = 0, ccov = 0;
  unsigned icode = 0;
  bool kept = false;
  if (p <= LA) {
    const float dw = fold_direct_at(votes, bbw, vp, ap, p, al, LA, LA1, eps);
    if (p < LA) {
      float bw[kNbase + 1];
#pragma unroll
      for (int i = 0; i <= kNbase; ++i)
        bw[i] = votes[vp + (kBaseW + i) * LA1];
      const bool vcol = p < al;
      const int code = bb[ap + p];
      if (vcol && code < kNbase) {
        const float add = __fadd_rn(bbw[ap + p], eps);
#pragma unroll
        for (int i = 0; i < kNbase; ++i)
          if (code == i) bw[i] = __fadd_rn(bw[i], add);
      }
      float top = bw[0];
#pragma unroll
      for (int i = 1; i < kNbase; ++i)
        if (bw[i] > top) {
          top = bw[i];
          best = i;
        }
      kept = vcol && bw[kNbase] <= top;
      if (kept) {
        float c = votes[vp + (kBaseC + best) * LA1];
        if (code == best) c = __fadd_rn(c, 1.0f);
        ccov = (int)c;
      }
    }
    const uint2 r = ins_ranks(votes, vp, LA1, dw, ins_scale, p <= al);
    e = (int)r.x;
    icode = r.y;
  }

  // Each gap's start in the compacted row, and the window's total.
  int total;
  const int ulen = e + (int)kept;
  const int st = scan_block<false>(ulen, 0, OpSum(), red[0], &total) - ulen;

  // Compaction: each gap scatters its run; positions past the total hold
  // 0. Every position below LA is written once, so the detect test
  // compares it with the anchor as it is written.
  bool same = true;
  if (p < LA && p >= total) {
    new_bb[ap + p] = 0;
    cov_out[ap + p] = 0;
    if (detect) same = bb[ap + p] == 0;
  }
  for (int k = 0; k < e; ++k) {
    const int pos = st + k;
    if (pos < LA) {
      const int bk = (icode >> (3 * k)) & 7;
      new_bb[ap + pos] = (uint8_t)bk;
      cov_out[ap + pos] = ins_count(votes, vp, LA1, k, bk);
      if (detect) same = same && bb[ap + pos] == bk;
    }
  }
  const int pk = st + e;  // the kept column's landing position
  if (kept && pk < LA) {
    new_bb[ap + pk] = (uint8_t)best;
    cov_out[ap + pk] = ccov;
    if (detect) same = same && bb[ap + pk] == best;
  }

  // The coordinate maps: suffix-min and prefix-max of the kept columns'
  // positions, with coord_maps' fallbacks and clamps.
  int first_kept, last_kept;
  const int mb = scan_block<true>(kept ? pk : kHi, INT_MAX, OpMin(), red[1],
                                  &first_kept);
  const int me = scan_block<false>(kept ? pk : -kHi, INT_MIN, OpMax(),
                                   red[2], &last_kept);
  const bool any_kept = first_kept != kHi;
  const int hi = max(total - 1, 0);
  if (p < LA) {
    int b = mb, en = me;
    if (b == kHi) b = last_kept;
    if (en == -kHi) en = first_kept;
    if (!any_kept) b = en = 0;
    maps[p] = min(max(b, 0), hi);
    maps[LA + p] = min(max(en, 0), hi);
    new_bbw[ap + p] = 0.0f;
  }
  __syncthreads();

  // Remap the window's jobs; the last window's block also takes the
  // padded lanes sorted after every real one.
  const int tot_c = min(max(total, 1), LA);
  const int n_real = counts[w];
  const int n_lanes = w == n_win - 1 ? B - starts[w] : n_real;
  const int32_t* ord = order + starts[w];
  bool changed = false;
  for (int r = p; r < n_lanes; r += blockDim.x) {
    const int j = ord[r];
    const int L = alen[min(max(win[j], 0), n_win)];
    const int b = begin[j], en = end[j];
    const int nbv = b < L ? maps[min(max(b, 0), LA - 1)] : 0;
    const int nev = en < L ? maps[LA + min(max(en, 0), LA - 1)] : tot_c - 1;
    nb[j] = nbv;
    ne[j] = nev;
    changed = changed || (r < n_real && (nbv != b || nev != en));
  }
  const bool unchanged = __syncthreads_and(same && !changed);
  const bool ovf_pre = ovf[w] || wesc[w] > 0.0f;
  const bool cv = detect && total == al && unchanged;
  if (p == 0) {
    new_alen[w] = tot_c;
    ovf_out[w] = ovf_pre || total > LA;
    conv[w] = cv;
  }
  if (w == n_win - 1) {
    for (int i = p; i < LA; i += blockDim.x) {
      new_bb[(size_t)n_win * LA + i] = bb[(size_t)n_win * LA + i];
      new_bbw[(size_t)n_win * LA + i] = 0.0f;
    }
    if (p == 0) new_alen[n_win] = alen[n_win];
  }
  if constexpr (Sched) {
    // The dual assembly of a freezing window (the test is the same in
    // every thread of the block): the insertion ranks again at the final
    // scale, a scan and the scatter into the window's output row. The
    // folded crossing weight is computed again rather than kept: held
    // across the remap, it made the kernel spill at its 32 registers.
    const bool ovf_new = ovf_pre || total > LA;
    const int orow = so.orig_ids[w];
    if (!(cv || ovf_new || so.last) || orow < 0 || orow >= so.n_keep) return;
    const uint2 r_f =
        p <= LA ? ins_ranks(votes, vp, LA1,
                            fold_direct_at(votes, bbw, vp, ap, p, al, LA,
                                           LA1, eps),
                            so.scale, p <= al)
                : make_uint2(0u, 0u);
    const int e_f = (int)r_f.x;
    const unsigned icode_f = r_f.y;
    const int ulen_f = e_f + (int)kept;
    int total_f;
    const int st_f =
        scan_block<false>(ulen_f, 0, OpSum(), red[0], &total_f) - ulen_f;
    uint8_t* oc = so.codes + (size_t)orow * LA;
    int32_t* ov = so.cov + (size_t)orow * LA;
    if (p < LA && p >= total_f) {
      oc[p] = 0;
      ov[p] = 0;
    }
    for (int k = 0; k < e_f; ++k) {
      const int pos = st_f + k;
      if (pos < LA) {
        const int bk = (icode_f >> (3 * k)) & 7;
        oc[pos] = (uint8_t)bk;
        ov[pos] = ins_count(votes, vp, LA1, k, bk);
      }
    }
    const int pk_f = st_f + e_f;
    if (kept && pk_f < LA) {
      oc[pk_f] = (uint8_t)best;
      ov[pk_f] = ccov;
    }
    if (p == 0) {
      so.total[orow] = min(max(total_f, 1), LA);
      so.ovf[orow] = (so.last ? ovf_pre : ovf_new) || total_f > LA;
    }
  }
}

size_t windows_smem(int LA) { return 2 * sizeof(int) * (size_t)LA; }

// The wide M2 (any LA). One window's slice of its scratch at anchor
// width LA: int arrays first, then bytes.
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

// Gap p's crossing weight with the backbone's folded in (wide M2): v =
// the window's sums at gap p, bwr its anchor weights.
__device__ __forceinline__ float fold_direct(const float* v, const float* bwr,
                                            int p, int al, int LA, int LA1,
                                            float bwl, float eps) {
  float dw = v[(size_t)kDirect * LA1];
  if (p <= al) {
    float left = p == 0 ? bwr[0] : bwr[p - 1];
    float right = p < LA ? bwr[p] : bwl;
    if (p == al) left = right = bwl;
    dw = __fadd_rn(dw, __fadd_rn(__fmul_rn(0.5f, __fadd_rn(left, right)),
                                 eps));
  }
  return dw;
}

// Gap p's insertion ranks at ``scale`` (wide M2): each reached rank's code
// and count into the scratch; returns the ranks emitted.
__device__ __forceinline__ int wide_ins(const float* v, const WinScratch& s,
                                        int p, int LA1, float dw, float scale,
                                        bool emit) {
  float stopped = __fmul_rn(dw, scale);
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
  return e;
}

// Scatter each gap's run (wide M2) from the scanned starts in the scratch
// into a compacted row: codes and coverage at positions below LA.
__device__ __forceinline__ void wide_scatter(const WinScratch& s, int LA,
                                             uint8_t* codes, int32_t* cov) {
  const int LA1 = LA + 1;
  for (int p = threadIdx.x; p <= LA; p += blockDim.x) {
    const int st = s.start[p];
    const int e = s.e[p];
    for (int k = 0; k < e; ++k)
      if (st + k < LA) {
        codes[st + k] = s.ins_code[k * LA1 + p];
        cov[st + k] = s.ins_cnt[k * LA1 + p];
      }
    if (p < LA && s.kept[p] && st + e < LA) {
      codes[st + e] = s.col_code[p];
      cov[st + e] = s.col_cov[p];
    }
  }
}

template <bool Sched>
__global__ void __launch_bounds__(kWinThreads) merge_windows_wide_kernel(
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
    float eps, int detect, SchedOut so) {
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
    const float dw = fold_direct(v, bwr, p, al, LA, LA1, bwl, eps);
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
    const int e = wide_ins(v, s, p, LA1, dw, ins_scale, p <= al);
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
  wide_scatter(s, LA, codes, cov);
  for (int p = t; p < LA; p += T) {
    const int pk = s.start[p] + s.e[p];
    s.map_b[p] = s.kept[p] ? pk : kHi;
    s.map_e[p] = s.kept[p] ? pk : -kHi;
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
  const bool ovf_pre = ovf[w] || wesc[w] > 0.0f;
  const bool cv = detect && total == al && changed == 0 && same;
  if (t == 0) {
    new_alen[w] = tot_c;
    ovf_out[w] = ovf_pre || total > LA;
    conv[w] = cv;
  }
  if (w == n_win - 1) {
    for (int i = t; i < LA; i += T) {
      new_bb[(size_t)n_win * LA + i] = bb[(size_t)n_win * LA + i];
      new_bbw[(size_t)n_win * LA + i] = 0.0f;
    }
    if (t == 0) new_alen[n_win] = alen[n_win];
  }
  if constexpr (Sched) {
    // The dual assembly of a freezing window (the same test in every
    // thread): the insertion ranks again at the final scale into the
    // scratch (the first pass is done with it), a scan and the scatter
    // into the window's output row.
    const bool ovf_new = ovf_pre || total > LA;
    const int orow = so.orig_ids[w];
    if (!(cv || ovf_new || so.last) || orow < 0 || orow >= so.n_keep) return;
    uint8_t* oc = so.codes + (size_t)orow * LA;
    int32_t* ov = so.cov + (size_t)orow * LA;
    for (int p = t; p <= LA; p += T) {
      const float dw = fold_direct(V + p, bwr, p, al, LA, LA1, bwl, eps);
      const int e = wide_ins(V + p, s, p, LA1, dw, so.scale, p <= al);
      s.e[p] = (uint8_t)e;
      s.start[p] = e + s.kept[p];
    }
    for (int i = t; i < LA; i += T) {
      oc[i] = 0;
      ov[i] = 0;
    }
    __syncthreads();
    const int total_f = block_scan(s.start, LA1, 0, false, true, OpSum(), red);
    wide_scatter(s, LA, oc, ov);
    if (t == 0) {
      so.total[orow] = min(max(total_f, 1), LA);
      so.ovf[orow] = (so.last ? ovf_pre : ovf_new) || total_f > LA;
    }
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
// LA+1]; wesc: f32 [n_win]. ``gaps`` a tile (block) of ``threads``
// threads, a multiple of 32 up to kTileMax with gaps <= threads
// (kernels.merge_votes_plan).
extern "C" int racon_merge_votes(const void* walk, long long walk_row,
                                 const void* q, const void* qw8,
                                 const void* w_read, const void* lt,
                                 const void* t_off, const void* esc_w,
                                 const void* order, const void* starts,
                                 const void* counts, void* votes, void* wesc,
                                 int n_win, int Lq, int LA, int gaps,
                                 int threads, void* stream) {
  if (n_win <= 0 || Lq <= 0 || LA <= 0 || walk_row % 4 != 0 ||
      walk_row < 4 * (long long)(LA + 2) || threads < 32 ||
      threads > kTileMax || threads % 32 != 0 || gaps < 1 || gaps > threads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((LA + gaps) / gaps, n_win);
  merge_votes_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(walk), walk_row,
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(qw8),
      static_cast<const float*>(w_read), static_cast<const int32_t*>(lt),
      static_cast<const int32_t*>(t_off), static_cast<const float*>(esc_w),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<float*>(votes),
      static_cast<float*>(wesc), Lq, LA, gaps);
  return (int)cudaGetLastError();
}

// Bytes of the wide M2's scratch a window at anchor width LA.
extern "C" long long racon_merge_windows_scratch(int LA) {
  return LA > 0 ? (long long)win_bytes(LA) : -1;
}

// M2. votes, wesc: M1's outputs; bb u8 / bbw f32 [n_win+1, LA]; alen i32
// [n_win+1]; begin, end, win: i32 [B]; order, starts, counts as M1's; ovf
// u8 [n_win]. Outputs: new_bb u8 / new_bbw f32 [n_win+1, LA], new_alen
// i32 [n_win+1], nb, ne i32 [B], cov i32 [n_win, LA], ovf_out, conv u8
// [n_win]. ``wide`` 0: the narrow kernel, ``threads`` a multiple of 32
// from LA+1 to kWinMaxThreads, scratch unused; 1: the wide kernel,
// kWinThreads threads, scratch n_win * racon_merge_windows_scratch(LA)
// bytes, 16-byte aligned, read only after this launch writes it.
// ``sched`` 1: the sched mode, which also writes each freezing window's
// final-scale output (at ``scale_final``; every window freezes when
// ``last``) into row orig_ids[w] (i32 [n_win]) of out_codes u8 / out_cov
// i32 [n_keep+1, LA], out_total i32 and out_ovf u8 [n_keep+1], unless
// that row is n_keep or more; 0: those are not read.
extern "C" int racon_merge_windows(
    const void* votes, const void* wesc, const void* bb, const void* bbw,
    const void* alen, const void* begin, const void* end, const void* win,
    const void* order, const void* starts, const void* counts,
    const void* ovf, void* new_bb, void* new_bbw, void* new_alen, void* nb,
    void* ne, void* cov, void* ovf_out, void* conv, void* scratch, int B,
    int n_win, int LA, float ins_scale, float eps, int detect, int wide,
    int threads, const void* orig_ids, void* out_codes, void* out_cov,
    void* out_total, void* out_ovf, int n_keep, float scale_final, int last,
    int sched, void* stream) {
  if (B <= 0 || n_win <= 0 || LA <= 0) return (int)cudaErrorInvalidValue;
  if (sched && (orig_ids == nullptr || out_codes == nullptr ||
                out_cov == nullptr || out_total == nullptr ||
                out_ovf == nullptr || n_keep < 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(votes);
  const float* we = static_cast<const float*>(wesc);
  const uint8_t* b8 = static_cast<const uint8_t*>(bb);
  const float* bw = static_cast<const float*>(bbw);
  const int32_t* al = static_cast<const int32_t*>(alen);
  const int32_t* be = static_cast<const int32_t*>(begin);
  const int32_t* en = static_cast<const int32_t*>(end);
  const int32_t* wi = static_cast<const int32_t*>(win);
  const int32_t* od = static_cast<const int32_t*>(order);
  const int32_t* sa = static_cast<const int32_t*>(starts);
  const int32_t* co = static_cast<const int32_t*>(counts);
  const uint8_t* ov = static_cast<const uint8_t*>(ovf);
  uint8_t* nbb = static_cast<uint8_t*>(new_bb);
  float* nbw = static_cast<float*>(new_bbw);
  int32_t* nal = static_cast<int32_t*>(new_alen);
  int32_t* nb_ = static_cast<int32_t*>(nb);
  int32_t* ne_ = static_cast<int32_t*>(ne);
  int32_t* cv = static_cast<int32_t*>(cov);
  uint8_t* oo = static_cast<uint8_t*>(ovf_out);
  uint8_t* cf = static_cast<uint8_t*>(conv);
  const SchedOut so{static_cast<const int32_t*>(orig_ids),
                    static_cast<uint8_t*>(out_codes),
                    static_cast<int32_t*>(out_cov),
                    static_cast<int32_t*>(out_total),
                    static_cast<uint8_t*>(out_ovf), n_keep, scale_final,
                    last};
  if (wide) {
    if (threads != kWinThreads || scratch == nullptr ||
        reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    uint8_t* sc = static_cast<uint8_t*>(scratch);
    if (sched)
      merge_windows_wide_kernel<true><<<n_win, kWinThreads, 0, st>>>(
          v, we, b8, bw, al, be, en, wi, od, sa, co, ov, nbb, nbw, nal, nb_,
          ne_, cv, oo, cf, sc, B, n_win, LA, ins_scale, eps, detect, so);
    else
      merge_windows_wide_kernel<false><<<n_win, kWinThreads, 0, st>>>(
          v, we, b8, bw, al, be, en, wi, od, sa, co, ov, nbb, nbw, nal, nb_,
          ne_, cv, oo, cf, sc, B, n_win, LA, ins_scale, eps, detect, so);
  } else {
    if (threads % 32 != 0 || threads < LA + 1 || threads > kWinMaxThreads)
      return (int)cudaErrorInvalidValue;
    const size_t shm = windows_smem(LA);
    if (sched)
      merge_windows_kernel<true><<<n_win, threads, shm, st>>>(
          v, we, b8, bw, al, be, en, wi, od, sa, co, ov, nbb, nbw, nal, nb_,
          ne_, cv, oo, cf, B, n_win, LA, ins_scale, eps, detect, so);
    else
      merge_windows_kernel<false><<<n_win, threads, shm, st>>>(
          v, we, b8, bw, al, be, en, wi, od, sa, co, ov, nbb, nbw, nal, nb_,
          ne_, cv, oo, cf, B, n_win, LA, ins_scale, eps, detect, so);
  }
  return (int)cudaGetLastError();
}

// out: resident blocks an SM, registers a thread, local-memory bytes a
// thread, threads a block and shared memory a block of M1 (which = 0),
// the narrow M2 (1) or the wide M2 (2), or M2's sched mode, narrow (3) or
// wide (4), launched with ``threads`` threads and ``smem`` bytes of
// dynamic shared memory.
extern "C" int racon_merge_occupancy(int which, int threads, int smem,
                                     int* out) {
  if (which < 0 || which > 4 || threads < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const void* fns[] = {(const void*)merge_votes_kernel,
                       (const void*)merge_windows_kernel<false>,
                       (const void*)merge_windows_wide_kernel<false>,
                       (const void*)merge_windows_kernel<true>,
                       (const void*)merge_windows_wide_kernel<true>};
  const void* fn = fns[which];
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = threads;
  out[4] = (int)(smem + attr.sharedSizeBytes);
  return 0;
}
