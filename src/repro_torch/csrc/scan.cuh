// Single-pass device-wide exclusive scan with decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), shared by fused_sample.cu (the row pointer R of
// Algorithm 1, written in the same launch as the samples) and
// sage_backward_index.cu (the row pointer of the backward's transpose).
//
// The TPU kernel carried its running total in SMEM from one grid step to
// the next, because its grid runs in order.  Hopper runs blocks in no
// order, so here:
//
//  - each block takes its tile id from an atomic counter, not from
//    blockIdx: every earlier tile then belongs to a block that has already
//    started and publishes without waiting on a later one, so the
//    look-back cannot deadlock;
//  - the block scans its tile, publishes the tile's aggregate, walks back
//    over the earlier tiles of its row (summing aggregates) until it meets
//    a published inclusive prefix, and publishes its own;
//  - flag and value share one 64-bit status word, stored with release and
//    loaded with acquire semantics, so a reader never sees a flag without
//    its value;
//  - tiles never span two rows, and the look-back stops at the row's first
//    tile, whose prefix is 0.
//
// Scratch, allocated and zeroed by the caller on every call
// (repro_torch/kernels/scan.py): one 64-bit status word per tile, then one
// word whose low half is the tile counter.  Values are int32; the wrappers
// keep every row's total below 2**31.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kThreads = 256;  // threads per block; a tile is kThreads
                               // threads times a few items each
constexpr uint64_t kFlagAggregate = 1ull << 32;
constexpr uint64_t kFlagPrefix = 2ull << 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The calling block's tile id, in the order the blocks started.  Called
// once by every thread of the block.
__device__ __forceinline__ int next_tile(int* counter) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(counter, 1);
  __syncthreads();
  return tile;
}

// Inclusive scan of one int per thread (the sum of the thread's items)
// over a block of kThreads threads; `*total` gets the block's sum.  Called
// once per block (it ends past a __syncthreads, so shared memory written
// before the call is visible to every thread after it).
__device__ __forceinline__ int block_inclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return x + before;
}

// Run by the 32 lanes of one warp.  Publishes tile `tile`'s aggregate,
// walks back 32 tiles at a time to the nearest published prefix (tiles
// before `first`, the row's first tile, count as a prefix of 0), publishes
// the tile's inclusive prefix and returns its exclusive prefix to every
// lane.
__device__ __forceinline__ int warp_lookback(uint64_t* status, int tile,
                                             int first, int aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == first) {
    if (lane == 0) {
      store_release(status + tile, kFlagPrefix | (uint32_t)aggregate);
    }
    return 0;
  }
  if (lane == 0) {
    store_release(status + tile, kFlagAggregate | (uint32_t)aggregate);
  }
  int exclusive = 0;
  for (int last = tile - 1;; last -= 32) {
    const int t = last - lane;  // lane 0 holds the nearest tile
    uint64_t w;
    do {
      w = t >= first ? load_acquire(status + t) : kFlagPrefix;
    } while (!__all_sync(kFullMask, (w >> 32) != 0));
    const unsigned prefixes = __ballot_sync(kFullMask, w >= kFlagPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int v = lane <= stop ? (int)(uint32_t)w : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
    exclusive += v;
    if (prefixes) break;
  }
  if (lane == 0) {
    store_release(status + tile,
                  kFlagPrefix | (uint32_t)(exclusive + aggregate));
  }
  return exclusive;
}

}  // namespace scan
