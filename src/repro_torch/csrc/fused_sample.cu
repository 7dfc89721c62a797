// Fused neighbour sampling for one level (Algorithm 1) on Hopper: the
// samples and the CSC row pointer R in one launch.
//
// Replaces: src/repro/kernels/fused_sample.py:41, `_fused_sample_kernel`
// (the Pallas body behind `fused_sample`), whose sequential grid carried
// R's running total in SMEM (:79-87).
//
// What bounds it on this card: bytes, and the latency of its dependent
// reads.  Per seed it reads the seed, two row pointers, then up to
// `fanout` neighbour ids at data-dependent places in `indices` (a chain of
// three dependent loads), and writes `fanout` samples and one row pointer;
// the hash is a handful of 32-bit integer operations per slot.  The TPU
// kernel copied a `window`-long slice of each neighbour list into VMEM;
// here only the drawn columns are read, straight from global memory.  The
// `window` argument keeps its exact semantics (draws modulo
// max(min(deg, window), 1), seeds with deg > window counted) so results
// match the reference bit for bit.
//
// Design:
//  - One block per tile of one worker row: 256 seeds (one per thread) for
//    small levels, 1024 (four per thread) past 2**17 seeds, where 4x fewer
//    tiles shorten the look-back (the wrapper picks; results are the same).
//    Tile ids come from an atomic counter (scan.cuh).  Each thread reads
//    its seeds and their row pointers; the per-seed count n_valid =
//    min(min(deg, window), fanout) needs `indptr` alone, so the block scans
//    its counts before any neighbour id is read.
//  - One warp then looks back over the row's earlier tiles (decoupled
//    look-back, scan.cuh) while the other warps draw: R is written in this
//    launch, with no grid that runs in order and no second pass over R.
//  - Lanes go over (seed, slot) pairs of the tile, not one warp per seed,
//    so no lane idles at small fanouts; the tile's samples are one
//    contiguous span, written with 16-byte stores in its aligned middle,
//    and each thread has four independent neighbour reads in flight.  A
//    padding seed (-1) gets its -1 row with no reads.
//  - Overflow (deg > window) is counted per block and added with one
//    integer atomicAdd per block; integer sums do not depend on order.
//
// Layout: seeds (B, S) int32 (-1 = padding), one row per worker;
// samples (B, S, fanout) int32 (-1 = invalid), 16-byte aligned; R (B, S + 1)
// int32; overflow (B,) int32 and the scan scratch, zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t salt) {
  // SplitMix32 finalizer; uint32 arithmetic wraps exactly as jnp.uint32 does
  x = x + salt * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// A tile is scan::kThreads * kItems seeds of one row; thread t owns seeds
// t * kItems ... t * kItems + kItems - 1 of it.
template <int kItems>
__global__ void __launch_bounds__(scan::kThreads) fused_sample_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const int* __restrict__ seeds, int S, int tiles_per_row, int fanout,
    int window, uint32_t salt, int* __restrict__ samples,
    int* __restrict__ R, int* __restrict__ overflow, uint64_t* status,
    int* counter) {
  constexpr int kTile = scan::kThreads * kItems;
  __shared__ int s_start[kTile];
  __shared__ int s_valid[kTile];
  __shared__ int s_eff[kTile];
  __shared__ uint32_t s_base[kTile];
  __shared__ int s_prefix;

  const int tile = scan::next_tile(counter);
  const int b = tile / tiles_per_row;
  const int first = b * tiles_per_row;
  const int i0 = (tile - first) * kTile;  // the tile's first seed in row b
  const int n = max(0, min(kTile, S - i0));
  const long long row0 = (long long)b * S + i0;
  const int j0 = threadIdx.x * kItems;

  int valid[kItems];
  bool over[kItems];
  int thread_sum = 0;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = j0 + m;
    int start = 0;
    int deg = 0;
    int v = 0;
    bool ok = false;
    if (j < n) {
      const int s = seeds[row0 + j];
      ok = s >= 0;
      if (ok) {
        v = s;
        start = indptr[s];
        deg = indptr[s + 1] - start;
      }
    }
    const int eff = min(deg, window);
    valid[m] = min(eff, fanout);
    over[m] = ok && deg > window;
    thread_sum += valid[m];
    s_start[j] = start;
    s_valid[j] = valid[m];
    s_eff[j] = eff;
    s_base[j] = (uint32_t)v * 2654435761u;
  }
  int total;
  const int incl = scan::block_inclusive_scan(thread_sum, &total);
  int n_over = 0;
#pragma unroll
  for (int m = 0; m < kItems; ++m) n_over += __syncthreads_count(over[m]);

  if (threadIdx.x < 32) {
    const int exclusive = scan::warp_lookback(status, tile, first, total);
    if (threadIdx.x == 0) {
      s_prefix = exclusive;
      if (n_over > 0) atomicAdd(overflow + b, n_over);
    }
  }

  // draw pair p = (seed p / fanout, slot p % fanout) of the tile
  auto draw = [&](int p) -> int {
    const int q = p / fanout;
    const int slot = p - q * fanout;
    if (slot >= s_valid[q]) return -1;
    const int e = s_eff[q];
    const bool take_all = e <= fanout;
    const int col =
        take_all ? slot
                 : (int)(hash_u32(s_base[q] + (uint32_t)slot, salt) %
                         (uint32_t)max(e, 1));
    return indices[s_start[q] + col];
  };
  const long long g0 = row0 * fanout;  // the tile's first sample
  const int count = n * fanout;
  int* out = samples + g0;
  const int head = min(count, (int)((4 - (g0 & 3)) & 3));
  const int quads = (count - head) >> 2;
  for (int p = threadIdx.x; p < head; p += scan::kThreads) out[p] = draw(p);
  for (int k = threadIdx.x; k < quads; k += scan::kThreads) {
    const int p = head + 4 * k;
    int4 q;
    q.x = draw(p);
    q.y = draw(p + 1);
    q.z = draw(p + 2);
    q.w = draw(p + 3);
    *reinterpret_cast<int4*>(out + p) = q;
  }
  for (int p = head + 4 * quads + threadIdx.x; p < count;
       p += scan::kThreads) {
    out[p] = draw(p);
  }

  __syncthreads();  // s_prefix
  int* r = R + (long long)b * (S + 1);
  if (i0 == 0 && threadIdx.x == 0) r[0] = 0;
  int running = s_prefix + incl - thread_sum;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    running += valid[m];
    if (j0 + m < n) r[i0 + j0 + m + 1] = running;
  }
}

}  // namespace

extern "C" int fused_sample_launch(const int* indptr, const int* indices,
                                   const int* seeds, int B, int S, int tile,
                                   int tiles_per_row, int fanout, int window,
                                   unsigned int salt, int* samples, int* R,
                                   int* overflow, uint64_t* scratch,
                                   cudaStream_t stream) {
  if ((tile != scan::kThreads && tile != 4 * scan::kThreads) ||
      tiles_per_row != (S > 0 ? (S + tile - 1) / tile : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  const long long tiles = (long long)B * tiles_per_row;
  int* counter = reinterpret_cast<int*>(scratch + tiles);
  if (tile == scan::kThreads) {
    fused_sample_kernel<1><<<(unsigned int)tiles, scan::kThreads, 0,
                             stream>>>(indptr, indices, seeds, S,
                                       tiles_per_row, fanout, window, salt,
                                       samples, R, overflow, scratch,
                                       counter);
  } else {
    fused_sample_kernel<4><<<(unsigned int)tiles, scan::kThreads, 0,
                             stream>>>(indptr, indices, seeds, S,
                                       tiles_per_row, fanout, window, salt,
                                       samples, R, overflow, scratch,
                                       counter);
  }
  return (int)cudaGetLastError();
}
