// Fused neighbour sampling for one level (Algorithm 1) on Hopper.
//
// Replaces: src/repro/kernels/fused_sample.py, `_fused_sample_kernel` (the
// Pallas body behind `fused_sample`).
//
// What bounds it on this card: bytes, and their latency.  Per seed it reads
// two row pointers and up to `fanout` neighbour ids at data-dependent places
// in `indices`, and writes `fanout` samples and one row pointer; the hash is
// a handful of 32-bit integer operations per slot.  The TPU kernel copied a
// `window`-long slice of each neighbour list into VMEM because VMEM forced
// it to; here each lane reads `indices[start + col]` straight from global
// memory (only the drawn columns are touched), so the sentinel-padded copy
// of `indices` the TPU wrapper made is gone.  The `window` argument keeps its
// exact semantics (draws modulo min(deg, window), seeds with deg > window
// counted) so results match the reference bit for bit.
//
// Design: one warp per seed, lanes over slots (a loop when fanout > 32), so
// the random reads of one seed are issued together.  Lane 0 writes the
// seed's valid count into R[b, i + 1]; the second kernel of this file turns
// each row of R into its running total (a block-wide scan with a carry
// across chunks), because blocks of the first kernel run in no order.  The
// overflow count is one integer atomicAdd per overflowing seed.
//
// Layout: seeds (B, S) int32 (-1 = padding), one row per worker;
// samples (B, S, fanout) int32 (-1 = invalid); R (B, S + 1) int32;
// overflow (B,) int32, zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t salt) {
  // SplitMix32 finalizer; uint32 arithmetic wraps exactly as jnp.uint32 does
  x = x + salt * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void fused_sample_kernel(const int* __restrict__ indptr,
                                    const int* __restrict__ indices,
                                    const int* __restrict__ seeds,
                                    long long rows, int S, int fanout,
                                    int window, uint32_t salt,
                                    int* __restrict__ samples,
                                    int* __restrict__ R,
                                    int* __restrict__ overflow) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long b = row / S;
  const int i = (int)(row % S);

  const int s = seeds[row];
  const bool ok = s >= 0;
  const int v = ok ? s : 0;
  const int start = indptr[v];
  const int deg = ok ? indptr[v + 1] - start : 0;
  const int eff = min(deg, window);
  const bool take_all = eff <= fanout;
  const int n_valid = min(eff, fanout);
  const uint32_t base = (uint32_t)v * 2654435761u;
  const uint32_t modulus = (uint32_t)max(eff, 1);

  int* out = samples + row * fanout;
  for (int slot = lane; slot < fanout; slot += 32) {
    int val = -1;
    if (slot < n_valid) {
      const int col = take_all
          ? slot
          : (int)(hash_u32(base + (uint32_t)slot, salt) % modulus);
      val = indices[start + col];
    }
    out[slot] = val;
  }
  if (lane == 0) {
    R[b * (S + 1) + i + 1] = n_valid;
    if (ok && deg > window) atomicAdd(overflow + b, 1);
  }
}

// In-place running total of R[b, 1:] for one row b per block; R[b, 0] = 0.
__global__ void row_scan_kernel(int* __restrict__ R, int S) {
  __shared__ int warp_sums[32];
  __shared__ int carry_s;
  int* r = R + (long long)blockIdx.x * (S + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    r[0] = 0;
    carry_s = 0;
  }
  __syncthreads();
  for (int base = 0; base < S; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    int x = idx < S ? r[idx + 1] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_sums[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int carry = carry_s;
    if (idx < S) r[idx + 1] = x + carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    __syncthreads();
    if (threadIdx.x == 0) carry_s = carry + warp_sums[nwarps - 1];
    __syncthreads();
  }
}

}  // namespace

extern "C" int fused_sample_launch(const int* indptr, const int* indices,
                                   const int* seeds, int B, int S,
                                   int fanout, int window, unsigned int salt,
                                   int* samples, int* R, int* overflow,
                                   cudaStream_t stream) {
  const long long rows = (long long)B * S;
  if (rows > 0) {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    fused_sample_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, 0,
                          stream>>>(indptr, indices, seeds, rows, S, fanout,
                                    window, salt, samples, R, overflow);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0) {
    row_scan_kernel<<<B, kScanThreads, 0, stream>>>(R, S);
  }
  return (int)cudaGetLastError();
}
