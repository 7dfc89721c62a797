// Feature-row gather for the hybrid feature fetch, on Hopper.
//
// Replaces: src/repro/kernels/feature_gather.py, `_gather_kernel` (the
// Pallas body behind `feature_gather`).
//
// What bounds it on this card: bytes.  It is a pure copy: read one id and
// one table row of D floats per output row, write the row.  The TPU kernel
// contracted a one-hot matrix with every table tile on the MXU, which reads
// the whole table for every block of ids; here each output row reads only
// the one table row its id names.
//
// Design: one warp per output row, lanes over the D columns with 16-byte
// float4 loads and stores when D is a multiple of 4 and both pointers are
// 16-byte aligned (else a scalar path).  Ids outside [0, M) write +0.0 rows.
//
// Layout: ids (B, Q) int32; table (B, M, D) float32, one table per worker;
// out (B, Q, D) float32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void feature_gather_kernel(const int* __restrict__ ids,
                                      const float* __restrict__ table,
                                      long long rows, int Q, int M, int D,
                                      float* __restrict__ out) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long b = row / Q;
  const int j = ids[row];
  const bool ok = j >= 0 && j < M;
  const float* src = table + (b * M + (ok ? j : 0)) * (long long)D;
  float* o = out + row * (long long)D;

  if (kVec) {
    const int D4 = D >> 2;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = lane; c < D4; c += 32) {
      reinterpret_cast<float4*>(o)[c] =
          ok ? reinterpret_cast<const float4*>(src)[c] : zero;
    }
  } else {
    for (int c = lane; c < D; c += 32) o[c] = ok ? src[c] : 0.f;
  }
}

}  // namespace

extern "C" int feature_gather_launch(const int* ids, const float* table,
                                     int B, int Q, int M, int D, int vec,
                                     float* out, cudaStream_t stream) {
  const long long rows = (long long)B * Q;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned int blocks =
      (unsigned int)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec) {
    feature_gather_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        ids, table, rows, Q, M, D, out);
  } else {
    feature_gather_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        ids, table, rows, Q, M, D, out);
  }
  return (int)cudaGetLastError();
}
