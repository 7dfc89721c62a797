// GraphSAGE masked neighbour mean, forward and backward, on Hopper.
//
// Replaces: src/repro/kernels/sage_aggregate.py:30, `_sage_aggregate_kernel`
// (the Pallas body behind `sage_aggregate`), and, for the backward, the
// gradient XLA derives from the jnp mean (`src/repro/core/mfg.py`
// `mean_aggregate`): `repro` has no backward kernel.
//
// What bounds the forward on this card: bytes.  Each destination row reads
// F edge ids and up to F source rows of D floats, and writes D floats; it
// does one add per gathered float (about 0.25 flop per byte), far below
// the ridge.  The TPU kernel built one-hot count matrices per (dst tile,
// src tile) pair for the MXU, which touches every source tile for every
// destination tile; here it is a direct gather-reduce that reads only the
// rows the edges name.
//
// What held the first design (one warp per destination row, a runtime
// loop over f) below half of its bound, and what this one does instead:
//   1. Every lane read all F ids to count them, then again for each of
//      its float4 columns.  Now a block stages the ids of its tile of R
//      rows in shared memory with one coalesced load, and each row's
//      source-table base once (the 64-bit b * N * D offset).
//   2. A lane waited for row f before it issued row f + 1: the 16-byte load
//      sat behind a data-dependent branch in a loop of unknown trip count,
//      so a row cost F memory latencies.  Now the kernel is specialised
//      for the fanouts of the main path (F = 15, 10, 5), and each thread
//      issues all F of its predicated loads before its first add (any other
//      F goes through a generic path, 8 loads in flight at a time).
//   3. At D = 100 a warp per row left 7 of 32 lanes idle (25 float4
//      columns).  Now thread work is the tile's (row, float4 column)
//      pairs, and R is picked so that they fill whole warps: at D = 100
//      (F = 5), 64 rows on 800 threads, two pairs a thread and no idle
//      lane; at D = 256, 4 rows on 256 threads, 64 threads per row.  At
//      F <= 5 one pair holds too few loads to pay for a block's staging
//      and barrier: two pairs a thread took 0.033 ms against 0.040 for
//      one at the serving bottom layer (tools/forward_plan_sweep.py).
//   4. A padding row (only -1 ids; about three rows in four when serving
//      pads a worker's seeds to the bucket) still occupied a warp that
//      re-read its ids.  Now its loads are predicated off, so it reads
//      nothing past the staged ids and streams its +0.0 row (__stcs).
// Each thread counts its row's valid ids itself, from the F ids it reads
// out of shared memory anyway to form its addresses and predicates: a
// separate count pass would cost one more barrier and shared-memory round
// trip per block and save only F integer adds per thread.
//
// The bits do not depend on the launch shape, so a seed's aggregate does
// not depend on its bucket (served == direct predict): each output column
// is the sum over f = 0..F-1, in that order and starting from +0.0, of
// h[e[f]][c] for a valid id and +0.0 for an invalid one, divided (IEEE
// division) by the count of valid ids; a row with none is +0.0.  Adding
// +0.0 gives the bits of skipping the slot, since a sum that starts at
// +0.0 is never -0.0 (Inf and NaN included).  A duplicate edge counts by
// multiplicity.  The float4 path (D a multiple of 4, both pointers
// 16-byte aligned) and the scalar path (anything else) add in the same
// order.  The launch shape (R, threads) is picked from D and F only
// (`forward_plan` in kernels/sage_aggregate.py), with R * F at most
// kMaxStagedIds so the staged ids fit in 32 KB of shared memory.
//
// Wide rows (F > kMaxStagedIds: exact inference pads every row to the
// graph's max in-degree, 11 361 on the H100 check's graph) take another
// kernel in the same launch: one block per destination row (R = 1), which
// stages the row's ids kMaxStagedIds at a time and keeps each column's sum
// and the valid count in registers across the chunks.  It adds in the same
// f order from the same +0.0, so its bits are those the narrow kernel
// would give.  A simple path: each thread reads every staged id of the row
// (most are -1 padding in exact inference), kChunk loads in flight.
//
// Layout: edges (B, S, F) int32, valid iff in [0, N); h (B, N, D) float32;
// out (B, S, D) float32.  B is the worker axis.
//
// Backward: grad_h[n] = sum over valid (i, f) with edges[i, f] == n of
// grad_out[i] / max(count_i, 1); duplicates count by multiplicity and a
// row no edge names gets 0.  It replaces the gradient XLA derives from the
// jnp mean (src/repro/core/mfg.py:59); `repro` has no backward kernel.
// Also bound by bytes: it reads each named grad_out row and writes every
// grad_h row, zero rows included (most of a capacity-padded layer).  A
// float atomicAdd scatter would give other bits on every run, so the
// kernel gathers over a transpose built on the card first
// (sage_backward_index.cu: each source row's slots in ascending (i, f)
// order, a row pointer, each destination row's max(count, 1)), and every
// output row is written once: the same bits on every run.
//
// Backward design: each warp walks 8 consecutive source rows.  Most rows
// of a capacity-padded layer hold zero or one slot, so a warp per row
// would pay a chain of dependent loads (rowptr -> slot -> denom ->
// grad_out) for each row with little in flight.  The 8 rows' slots are
// one contiguous run of `slots`: lane k reads
// the end of row k once, then, 32 slots at a time, lane k loads slot
// k0 + k, its destination row and its denom, and the warp broadcasts them
// with __shfl_sync.  For D = 256 each lane covers a row in one pass with
// two float4 columns, two slots at a time (four independent 16-byte loads
// in flight per lane before the adds, which still run in ascending slot
// order with g / d per term); the warp writes a row when the walk passes
// its end.  A row with no slot (capacity padding) gets zeros with
// streaming stores.  Writing grad_h (every row, zero rows included) is
// most of the bytes, so a zero fill of the output is this kernel's floor
// in practice.
//
// Backward layout: rowptr (B * N + 1) int32 and slots (nnz) int32, the
// flattened (b, i, f) slot ids sorted by source row b * N + n; grad_out
// (B, S, D) float32; denom (B * S) float32; grad_h (B, N, D) float32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // backward
constexpr int kRowsPerWarp = 8;    // backward: source rows one warp walks
constexpr int kMaxStagedIds = 8192;  // forward: ids a block stages (32 KB)
constexpr int kChunk = 8;  // forward, generic F: loads in flight per batch
constexpr int kWideMaxThreads = 512;  // forward, F > kMaxStagedIds

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void add_div(float& acc, float g, float d) {
  acc += g / d;
}
__device__ __forceinline__ void add_div(float4& acc, const float4& g,
                                        float d) {
  acc.x += g.x / d;
  acc.y += g.y / d;
  acc.z += g.z / d;
  acc.w += g.w / d;
}

__device__ __forceinline__ void add(float& acc, float x) { acc += x; }
__device__ __forceinline__ void add(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// The most threads a forward block may have: a thread of the F = 5 kernel
// holds 5 loads in flight and fits 64 registers, the others hold up to 15
// (60 registers of loads alone at float4).  `forward_plan` keeps to it.
template <int kF>
constexpr int kForwardMaxThreads = kF == 5 ? 1024 : 512;

template <typename T>
__device__ __forceinline__ T load(const T* p) {
  return __ldg(p);
}

__device__ __forceinline__ float div(float a, float d) { return a / d; }
__device__ __forceinline__ float4 div(const float4& a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

// T = float4 (D % 4 == 0, 16-byte aligned) or float; Dv = D in units of T.
// kF = the fanout the kernel is specialised for, 0 for any F.  A block
// takes R consecutive destination rows; thread work is the tile's R * Dv
// (row, column) pairs, walked with a stride of the block's size.
template <typename T, int kF>
__global__ void __launch_bounds__(kForwardMaxThreads<kF>)
    sage_aggregate_kernel(const int* __restrict__ edges,
                          const T* __restrict__ h, long long rows, int S,
                          int F, int N, int Dv, int R,
                          T* __restrict__ out) {
  constexpr int kLoads = kF ? kF : kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  const T** s_h = reinterpret_cast<const T**>(smem);
  int* s_ids = reinterpret_cast<int*>(smem + R * sizeof(const T*));
  const int Fr = kF ? kF : F;
  const long long row0 = (long long)blockIdx.x * R;
  const int nr = (int)min((long long)R, rows - row0);
  const int* e = edges + row0 * Fr;
  for (int i = threadIdx.x; i < nr * Fr; i += blockDim.x)
    s_ids[i] = __ldg(e + i);
  for (int i = threadIdx.x; i < nr; i += blockDim.x)
    s_h[i] = h + (row0 + i) / S * (long long)N * Dv;
  __syncthreads();
  T* o = out + row0 * Dv;
  for (int p = threadIdx.x; p < nr * Dv; p += blockDim.x) {
    const int r = p / Dv;
    const int* ids = s_ids + r * Fr;
    const T* hc = s_h[r] + (p - r * Dv);
    T acc = zero<T>();
    int count = 0;
    for (int f0 = 0; f0 < Fr; f0 += kLoads) {  // one trip when kF != 0
      T x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = (kF || f0 + u < Fr) ? ids[f0 + u] : -1;
        const bool ok = (unsigned)j < (unsigned)N;
        count += ok;
        x[u] = ok ? load(hc + (long long)j * Dv) : zero<T>();
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) add(acc, x[u]);
    }
    if (count == 0) {
      __stcs(o + p, zero<T>());
    } else {
      o[p] = div(acc, (float)count);
    }
  }
}

// Wide rows: T and Dv as above, F > kMaxStagedIds, one block per
// destination row.  Columns are walked a block's width at a time (one pass
// when Dv <= blockDim.x); for each, the row's ids are staged in chunks of
// kMaxStagedIds, and the sum and count carry over from chunk to chunk.
template <typename T>
__global__ void __launch_bounds__(kWideMaxThreads)
    sage_aggregate_wide_kernel(const int* __restrict__ edges,
                               const T* __restrict__ h, int S, int F, int N,
                               int Dv, T* __restrict__ out) {
  __shared__ int s_ids[kMaxStagedIds];
  const long long row = blockIdx.x;
  const int* e = edges + row * F;
  const T* hb = h + row / S * (long long)N * Dv;
  T* o = out + row * Dv;
  for (int c0 = 0; c0 < Dv; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool live = c < Dv;
    T acc = zero<T>();
    int count = 0;
    for (int f0 = 0; f0 < F; f0 += kMaxStagedIds) {
      const int n = min(kMaxStagedIds, F - f0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        s_ids[i] = __ldg(e + f0 + i);
      __syncthreads();
      if (!live) continue;
      for (int u0 = 0; u0 < n; u0 += kChunk) {
        T x[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int j = u0 + u < n ? s_ids[u0 + u] : -1;
          const bool ok = (unsigned)j < (unsigned)N;
          count += ok;
          x[u] = ok ? load(hb + (long long)j * Dv + c) : zero<T>();
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) add(acc, x[u]);
      }
    }
    if (!live) continue;
    if (count == 0) {
      __stcs(o + c, zero<T>());
    } else {
      o[c] = div(acc, (float)count);
    }
  }
}

// T = float4 (D % 4 == 0, 16-byte aligned) or float; Dv = D in units of T.
// One warp walks kRowsPerWarp consecutive source rows, whose slots are one
// contiguous run of `slots`; each pass covers 64 T columns (lane and
// lane + 32) of every row.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sage_aggregate_backward_kernel(const int* __restrict__ rowptr,
                                   const int* __restrict__ slots,
                                   const T* __restrict__ grad_out,
                                   const float* __restrict__ denom,
                                   long long rows, int F, int Dv,
                                   T* __restrict__ grad_h) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kUnroll = 2;
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (r0 >= rows) return;
  const int nr = (int)min((long long)kRowsPerWarp, rows - r0);
  const int k_beg = rowptr[r0];
  // lane k < nr holds the end of row r0 + k
  const int row_end = lane < nr ? rowptr[r0 + lane + 1] : 0;
  const int k_end = __shfl_sync(kFull, row_end, nr - 1);
  T* out = grad_h + r0 * Dv;
  for (int c0 = 0; c0 < Dv; c0 += 64) {
    const int ca = c0 + lane;
    const int cb = c0 + 32 + lane;
    const bool has_a = ca < Dv;
    const bool has_b = cb < Dv;
    T acc_a = zero<T>();
    T acc_b = zero<T>();
    int cur = 0;  // the row being summed: r0 + cur
    int cur_beg = k_beg;
    int cur_end = __shfl_sync(kFull, row_end, 0);
    // write row r0 + cur (zeros, streamed, when it has no slot) and move on
    auto finish_row = [&]() {
      T* o = out + (long long)cur * Dv;
      if (cur_beg == cur_end) {
        if (has_a) __stcs(o + ca, zero<T>());
        if (has_b) __stcs(o + cb, zero<T>());
      } else {
        if (has_a) o[ca] = acc_a;
        if (has_b) o[cb] = acc_b;
      }
      acc_a = zero<T>();
      acc_b = zero<T>();
      cur_beg = cur_end;
      ++cur;
      if (cur < nr) cur_end = __shfl_sync(kFull, row_end, cur);
    };
    for (int k0 = k_beg; k0 < k_end; k0 += 32) {
      const int n = min(32, k_end - k0);
      int dst = 0;
      float den = 1.f;
      if (lane < n) {
        dst = slots[k0 + lane] / F;
        den = denom[dst];
      }
      for (int j = 0; j < n; j += kUnroll) {
        T xa[kUnroll];
        T xb[kUnroll];
        float d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int src = __shfl_sync(kFull, dst, (j + u) & 31);
          d[u] = __shfl_sync(kFull, den, (j + u) & 31);
          const T* g = grad_out + (long long)src * Dv;
          const bool live = j + u < n;
          xa[u] = live && has_a ? g[ca] : zero<T>();
          xb[u] = live && has_b ? g[cb] : zero<T>();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < n) {
            while (k0 + j + u >= cur_end) finish_row();
            add_div(acc_a, xa[u], d[u]);
            add_div(acc_b, xb[u], d[u]);
          }
        }
      }
    }
    while (cur < nr) finish_row();
  }
}

}  // namespace

namespace {

template <typename T, int kF>
cudaError_t launch_forward(const int* edges, const float* h, long long rows,
                           int S, int F, int N, int Dv, int R, int threads,
                           float* out, cudaStream_t stream) {
  const long long blocks = (rows + R - 1) / R;
  if (threads > kForwardMaxThreads<kF> || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const size_t smem =
      (size_t)R * sizeof(const T*) + (size_t)R * F * sizeof(int);
  sage_aggregate_kernel<T, kF>
      <<<(unsigned int)blocks, threads, smem, stream>>>(
          edges, reinterpret_cast<const T*>(h), rows, S, F, N, Dv, R,
          reinterpret_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_forward_wide(const int* edges, const float* h,
                                long long rows, int S, int F, int N, int Dv,
                                int threads, float* out,
                                cudaStream_t stream) {
  if (threads > kWideMaxThreads || rows > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  sage_aggregate_wide_kernel<T><<<(unsigned int)rows, threads, 0, stream>>>(
      edges, reinterpret_cast<const T*>(h), S, F, N, Dv,
      reinterpret_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_forward_f(const int* edges, const float* h, long long rows,
                             int S, int F, int N, int Dv, int R, int threads,
                             float* out, cudaStream_t stream) {
  if (F > kMaxStagedIds)
    return launch_forward_wide<T>(edges, h, rows, S, F, N, Dv, threads, out,
                                  stream);
  switch (F) {
    case 5:
      return launch_forward<T, 5>(edges, h, rows, S, F, N, Dv, R, threads,
                                  out, stream);
    case 10:
      return launch_forward<T, 10>(edges, h, rows, S, F, N, Dv, R, threads,
                                   out, stream);
    case 15:
      return launch_forward<T, 15>(edges, h, rows, S, F, N, Dv, R, threads,
                                   out, stream);
    default:
      return launch_forward<T, 0>(edges, h, rows, S, F, N, Dv, R, threads,
                                  out, stream);
  }
}

}  // namespace

// R rows per block and `threads` threads per block, from `forward_plan`
// (R = 1 for F > kMaxStagedIds: the wide-row kernel).
extern "C" int sage_aggregate_launch(const int* edges, const float* h, int B,
                                     int S, int F, int N, int D, int vec,
                                     int R, int threads, float* out,
                                     cudaStream_t stream) {
  const long long rows = (long long)B * S;
  if (rows == 0) return (int)cudaSuccess;
  if (R < 1 || (F <= kMaxStagedIds && (long long)R * F > kMaxStagedIds) ||
      (F > kMaxStagedIds && R != 1))
    return (int)cudaErrorInvalidValue;
  if (vec)
    return (int)launch_forward_f<float4>(edges, h, rows, S, F, N, D >> 2, R,
                                         threads, out, stream);
  return (int)launch_forward_f<float>(edges, h, rows, S, F, N, D, R, threads,
                                      out, stream);
}

extern "C" int sage_aggregate_backward_launch(
    const int* rowptr, const int* slots, const float* grad_out,
    const float* denom, int B, int N, int F, int D, int vec, float* grad_h,
    cudaStream_t stream) {
  const long long rows = (long long)B * N;
  if (rows == 0) return (int)cudaSuccess;
  constexpr int kRowsPerBlock = kWarpsPerBlock * kRowsPerWarp;
  const unsigned int blocks =
      (unsigned int)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (vec) {
    sage_aggregate_backward_kernel<float4>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            rowptr, slots, reinterpret_cast<const float4*>(grad_out), denom,
            rows, F, D >> 2, reinterpret_cast<float4*>(grad_h));
  } else {
    sage_aggregate_backward_kernel<float>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            rowptr, slots, grad_out, denom, rows, F, D, grad_h);
  }
  return (int)cudaGetLastError();
}
