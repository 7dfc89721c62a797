// GraphSAGE masked neighbour mean, forward and backward, on Hopper.
//
// Replaces: src/repro/kernels/sage_aggregate.py:30, `_sage_aggregate_kernel`
// (the Pallas body behind `sage_aggregate`), and, for the backward, the
// gradient XLA derives from the jnp mean (`src/repro/core/mfg.py`
// `mean_aggregate`): `repro` has no backward kernel.
//
// What bounds it on this card: bytes.  Each destination row reads F edge
// ids and up to F source rows of D floats, and writes D floats; it does one
// add per gathered float (about 0.25 flop per byte), far below the ridge.
// The TPU kernel built one-hot count matrices per (dst tile, src tile) pair
// for the MXU, which touches every source tile for every destination tile;
// here it is a direct gather-reduce that reads only the rows the edges name.
//
// Design: one warp per destination row.  Lanes split the D columns, with
// 16-byte float4 loads and stores when D is a multiple of 4 and both
// pointers are 16-byte aligned (else a scalar path), so each gathered source
// row is read by one coalesced warp-wide request.  The edge ids of the row
// are read by every lane from the same address (one broadcast transaction).
// The sum runs in f = 0..F-1 order over valid edges, the count of valid
// edges stays in a register, and the result is sum / max(count, 1): a row
// with no valid edge gives 0 and a duplicate edge counts by multiplicity.
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

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerWarp = 8;  // backward: source rows one warp walks

template <bool kVec>
__global__ void sage_aggregate_kernel(const int* __restrict__ edges,
                                      const float* __restrict__ h,
                                      long long rows, int S, int F, int N,
                                      int D, float* __restrict__ out) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long b = row / S;
  const int* e = edges + row * F;
  const float* hb = h + b * (long long)N * D;
  float* o = out + row * (long long)D;

  int count = 0;
  for (int f = 0; f < F; ++f) {
    const int j = e[f];
    count += (j >= 0 && j < N) ? 1 : 0;
  }
  const float denom = (float)max(count, 1);

  if (kVec) {
    const int D4 = D >> 2;
    for (int c = lane; c < D4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int f = 0; f < F; ++f) {
        const int j = e[f];
        if (j >= 0 && j < N) {
          const float4 x =
              reinterpret_cast<const float4*>(hb + (long long)j * D)[c];
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
      }
      acc.x /= denom;
      acc.y /= denom;
      acc.z /= denom;
      acc.w /= denom;
      reinterpret_cast<float4*>(o)[c] = acc;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
      for (int f = 0; f < F; ++f) {
        const int j = e[f];
        if (j >= 0 && j < N) acc += hb[(long long)j * D + c];
      }
      o[c] = acc / denom;
    }
  }
}

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

extern "C" int sage_aggregate_launch(const int* edges, const float* h, int B,
                                     int S, int F, int N, int D, int vec,
                                     float* out, cudaStream_t stream) {
  const long long rows = (long long)B * S;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned int blocks =
      (unsigned int)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec) {
    sage_aggregate_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        edges, h, rows, S, F, N, D, out);
  } else {
    sage_aggregate_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        edges, h, rows, S, F, N, D, out);
  }
  return (int)cudaGetLastError();
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
