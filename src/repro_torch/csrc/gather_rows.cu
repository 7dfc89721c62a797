// Pinned hot-row gather for the `pinned_hot` feature store, on Hopper.
//
// Replaces: src/repro/kernels/gather.py, `_gather_kernel` (the Pallas body
// behind `gather_rows`).
//
// What bounds it on this card: bytes.  It is a pure copy: read one id per
// output row and, for a valid id, one table row of D floats; write the
// row.  Most ids on the training path are -1 (frontier slots the cache
// misses), which write +0.0 rows and read no table row.  The TPU kernel
// ran a 2-slot VMEM DMA ring per row so that one row's HBM fetch hid
// behind the previous row's VMEM write; on Hopper each warp issues its
// row's loads directly and the many warps in flight hide the latency.
//
// Design: one warp per output row, lanes over the D columns with 16-byte
// float4 loads and stores when D is a multiple of 4 and both pointers are
// 16-byte aligned (else a scalar path).  Ids outside [0, K) write +0.0
// rows.
//
// Layout: ids (B, N) int32; table (B, K, D) float32, one pinned table per
// worker; out (B, N, D) float32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void gather_rows_kernel(const int* __restrict__ ids,
                                   const float* __restrict__ table,
                                   long long rows, int N, int K, int D,
                                   float* __restrict__ out) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long b = row / N;
  const int j = ids[row];
  const bool ok = j >= 0 && j < K;
  float* o = out + row * (long long)D;

  if (kVec) {
    const int D4 = D >> 2;
    float4* o4 = reinterpret_cast<float4*>(o);
    if (ok) {
      const float4* src = reinterpret_cast<const float4*>(
          table + (b * K + j) * (long long)D);
      for (int c = lane; c < D4; c += 32) o4[c] = src[c];
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = lane; c < D4; c += 32) o4[c] = zero;
    }
  } else {
    const float* src = table + (b * K + (ok ? j : 0)) * (long long)D;
    for (int c = lane; c < D; c += 32) o[c] = ok ? src[c] : 0.f;
  }
}

}  // namespace

extern "C" int gather_rows_launch(const int* ids, const float* table, int B,
                                  int N, int K, int D, int vec, float* out,
                                  cudaStream_t stream) {
  const long long rows = (long long)B * N;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned int blocks =
      (unsigned int)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec) {
    gather_rows_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        ids, table, rows, N, K, D, out);
  } else {
    gather_rows_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        ids, table, rows, N, K, D, out);
  }
  return (int)cudaGetLastError();
}
