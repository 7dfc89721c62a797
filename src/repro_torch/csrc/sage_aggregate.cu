// GraphSAGE masked neighbour mean, forward and backward, on Hopper.
//
// Replaces: src/repro/kernels/sage_aggregate.py, `_sage_aggregate_kernel`
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
// row no edge names gets 0.  Also bound by bytes.  A float atomicAdd
// scatter would give other bits on every run, so the kernel gathers
// instead: the wrapper prepares the transpose once per call (a stable
// sort of the flattened edge slots by source row, `rowptr` over the
// sorted slots, and each destination row's max(count, 1)), and one warp
// per source row sums its slots in ascending (i, f) order.  Every output
// row is written once, so the result is the same bits on every run.
//
// Backward layout: rowptr (B * N + 1) int32 and slots (nnz) int32, the
// flattened (b, i, f) slot ids sorted by source row b * N + n; grad_out
// (B, S, D) float32; denom (B * S) float32; grad_h (B, N, D) float32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <bool kVec>
__global__ void sage_aggregate_backward_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ slots,
    const float* __restrict__ grad_out, const float* __restrict__ denom,
    long long rows, int F, int D, float* __restrict__ grad_h) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int beg = rowptr[row];
  const int end = rowptr[row + 1];
  float* o = grad_h + row * (long long)D;

  if (kVec) {
    const int D4 = D >> 2;
    for (int c = lane; c < D4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = beg; k < end; ++k) {
        const int dst = slots[k] / F;
        const float d = denom[dst];
        const float4 g =
            reinterpret_cast<const float4*>(grad_out + (long long)dst * D)[c];
        acc.x += g.x / d;
        acc.y += g.y / d;
        acc.z += g.z / d;
        acc.w += g.w / d;
      }
      reinterpret_cast<float4*>(o)[c] = acc;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
      for (int k = beg; k < end; ++k) {
        const int dst = slots[k] / F;
        acc += grad_out[(long long)dst * D + c] / denom[dst];
      }
      o[c] = acc;
    }
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
  const unsigned int blocks =
      (unsigned int)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec) {
    sage_aggregate_backward_kernel<true>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            rowptr, slots, grad_out, denom, rows, F, D, grad_h);
  } else {
    sage_aggregate_backward_kernel<false>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            rowptr, slots, grad_out, denom, rows, F, D, grad_h);
  }
  return (int)cudaGetLastError();
}
