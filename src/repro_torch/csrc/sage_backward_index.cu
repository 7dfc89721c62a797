// The transpose that the sage_aggregate backward gathers over, built on
// the card once per backward call.
//
// Replaces: the index preparation of the gradient XLA derives from
// `repro`'s jnp mean (src/repro/core/mfg.py:59; the Pallas forward is
// src/repro/kernels/sage_aggregate.py:30): XLA scatters, the port gathers
// over this transpose so its gradient has the same bits on every run.
//
// What bounds it on this card: bytes.  It reads the B*S*F edge ids once
// and writes one int32 key and slot id per edge slot, a row pointer over
// the B*N source rows and one float per destination row; the sort moves
// each key and slot a few times more.  No floating-point work.
//
// Design, three steps on the caller's stream:
//  1. backward_prep_kernel, one thread per edge slot s = (b, i, f): writes
//     the int32 key b*N + e for a valid slot (e = edges[s] in [0, N)) and
//     B*N otherwise, the slot id s itself (the sort's value), each
//     destination row's max(count, 1), and the per-source-row histogram of
//     valid slots with integer atomics (counts do not depend on order).
//  2. rowptr_scan_kernel: an exclusive scan of the histogram into rowptr
//     with decoupled look-back (scan.cuh), one launch.
//  3. a stable radix sort (CUB, from the CUDA toolkit) of the 32-bit keys
//     with 32-bit slot values over the key's significant bits only, so each
//     source row's slots end in ascending (i, f) order; 32-bit keys over
//     ceil(log2(B*N + 1)) bits need fewer radix passes than 64-bit ones.
//
// Layout: edges (B, S, F) int32; keys, vals, keys_sorted, slots (B*S*F)
// int32; denom (B*S) float32; hist (B*N + 1) int32 and the scan scratch,
// zeroed by the caller; rowptr (B*N + 1) int32.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = scan::kThreads * kScanItems;  // kernels/scan.py

__global__ void __launch_bounds__(kThreads) backward_prep_kernel(
    const int* __restrict__ edges, int nnz, int SF, int F, int N, int BN,
    unsigned int* __restrict__ keys, int* __restrict__ vals,
    float* __restrict__ denom, int* __restrict__ hist) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= nnz) return;
  const int b = s / SF;
  const int e = edges[s];
  const bool valid = e >= 0 && e < N;
  keys[s] = (unsigned int)(valid ? b * N + e : BN);
  vals[s] = s;
  if (valid) atomicAdd(hist + b * N + e, 1);
  if (s % F == 0) {
    int count = 0;
    for (int f = 0; f < F; ++f) {
      const int x = edges[s + f];
      count += (x >= 0 && x < N) ? 1 : 0;
    }
    denom[s / F] = (float)max(count, 1);
  }
}

// A tile is scan::kThreads * kScanItems histogram rows; thread t owns rows
// t * kScanItems ... t * kScanItems + kScanItems - 1 of it.
__global__ void __launch_bounds__(scan::kThreads) rowptr_scan_kernel(
    const int* __restrict__ hist, int n, int* __restrict__ rowptr,
    uint64_t* status, int* counter) {
  __shared__ int s_prefix;
  const int tile = scan::next_tile(counter);
  const long long i0 =
      (long long)tile * kScanTile + threadIdx.x * kScanItems;
  int x[kScanItems];
  int thread_sum = 0;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    x[m] = i0 + m < n ? hist[i0 + m] : 0;
    thread_sum += x[m];
  }
  int total;
  const int incl = scan::block_inclusive_scan(thread_sum, &total);
  if (threadIdx.x < 32) {
    const int exclusive = scan::warp_lookback(status, tile, 0, total);
    if (threadIdx.x == 0) s_prefix = exclusive;
  }
  __syncthreads();
  int running = s_prefix + incl - thread_sum;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    if (i0 + m < n) rowptr[i0 + m] = running;
    running += x[m];
  }
}

}  // namespace

// Bytes of scratch the sort needs for `nnz` pairs over `end_bit` bits.
extern "C" size_t sage_backward_index_temp_bytes(int nnz, int end_bit) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, (unsigned int*)nullptr,
                                  (unsigned int*)nullptr, (int*)nullptr,
                                  (int*)nullptr, nnz, 0, end_bit);
  return bytes;
}

extern "C" int sage_backward_index_launch(
    const int* edges, int B, int S, int F, int N, int end_bit,
    int scan_tiles, unsigned int* keys, int* vals, unsigned int* keys_sorted,
    int* slots, float* denom, int* rowptr, int* hist, uint64_t* scratch,
    void* temp, size_t temp_bytes, cudaStream_t stream) {
  const int nnz = B * S * F;
  const int n = B * N + 1;  // rows of the histogram, its last one empty
  if (scan_tiles != (n + kScanTile - 1) / kScanTile) {
    return (int)cudaErrorInvalidValue;
  }
  if (nnz > 0) {
    backward_prep_kernel<<<(nnz + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(edges, nnz, S * F, F, N, B * N, keys,
                                     vals, denom, hist);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rowptr_scan_kernel<<<scan_tiles, scan::kThreads, 0, stream>>>(
      hist, n, rowptr, scratch, reinterpret_cast<int*>(scratch + scan_tiles));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nnz == 0) return (int)err;
  err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, keys_sorted,
                                        vals, slots, nnz, 0, end_bit, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
