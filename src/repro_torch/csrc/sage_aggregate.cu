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
// graph's max in-degree, 11 361 on the H100 check's graph, and 99.8 % of
// those slots are -1) take another kernel in the same launch: one block of
// kWideThreads per destination row, whatever D is.  Its bytes are the
// row's F ids (45 KB at 11 361) far more than the few source rows most
// rows name, and one hub row names 11 361.  So, per chunk of kWideChunk
// ids:
//   1. The ids are read once, at bandwidth: each thread loads kWideVecs
//      16-byte vectors (coalesced across the block, streamed past L2).  An
//      odd F leaves a row's ids only 4-byte aligned, so the vectors are
//      those of the 16-byte boundary at or below the row's start, and the
//      one or two that straddle its ends are read one id at a time.
//   2. The valid ids are compacted in f order into shared memory: each
//      thread counts its vectors' valid ids, a warp scans the counts
//      (packed 8 bits a vector, one shuffle scan for four vectors), warp
//      0 scans the (vector, warp) totals, and each thread writes its valid
//      ids at its offset.  The -1 padding costs its read and nothing else.
//   3. The listed rows are gathered through a ring of kWideStages stages
//      in kWideRingBytes of shared memory, with one warp per 32 columns
//      adding and every other warp copying: the copiers fill a stage with
//      16-byte cp.async copies (4-byte ones on the scalar path) as soon as
//      the adders have emptied it, and signal its full mbarrier when the
//      copies land (cp.async.mbarrier.arrive); the adders take the stages
//      in list order and signal its empty mbarrier.  No block-wide barrier
//      stands between stages, so a hub row keeps the whole ring in flight.
// Each column's sum and the valid count carry over from chunk to chunk,
// so the sum is the f-ordered one from +0.0 over the valid ids only; with
// invalid terms being +0.0, those are the bits the narrow kernel gives.
// The chunk's list (48 KB), the scan's totals, the mbarriers and the ring
// (64 KB) are dynamic shared memory, opted in above 48 KB by the launcher:
// two blocks an SM.  Columns past kWideCols take another pass over the row.
// The ring's shape was chosen by timing variants on an H100: the hub row
// is bound by issuing its copies, not by bytes in flight; three large
// stages beat deeper rings of smaller ones, whose per-stage hand-off
// costs more, and a single copying warp (or TMA bulk copies, one a row)
// is slower again.
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

#include <atomic>

namespace {

constexpr int kWarpsPerBlock = 8;  // backward
constexpr int kRowsPerWarp = 8;    // backward: source rows one warp walks
constexpr int kMaxStagedIds = 8192;  // forward: ids a block stages (32 KB)
constexpr int kChunk = 8;  // forward, generic F: loads in flight per batch
// forward, F > kMaxStagedIds (the wide-row kernel): a block of kWideThreads
// takes kWideVecs int4 of ids a thread per chunk, kWideChunk ids; its
// gather ring is kWideStages stages in kWideRingBytes (kWideSmem in all,
// 112.4 KB: two blocks an SM).
constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideVecs = 6;
constexpr int kWideChunk = kWideThreads * kWideVecs * 4;  // 12 288 ids
constexpr int kWideScan = kWideVecs * kWideWarps;  // per (vector, warp)
constexpr int kWideStages = 3;
constexpr int kWideRingBytes = 64 << 10;
// columns (in T) a gather pass adds: at most half the block's threads, so
// that at least half of its warps produce
constexpr int kWideCols = kWideThreads / 2;
// a ring stage holds at least one source row's kWideCols columns, float4
// (and so float) ones
static_assert(kWideRingBytes / kWideStages / 16 >= kWideCols,
              "a ring stage must hold one row of a column pass");
// shared memory: the chunk's list, the scan's totals, its count (padded
// to 8 bytes), a full and an empty mbarrier a ring stage, the ring
constexpr int kWideBarOffset = (kWideChunk + kWideScan + 2) * 4;
constexpr int kWideRingOffset =
    (kWideBarOffset + 2 * kWideStages * 8 + 15) / 16 * 16;
constexpr int kWideSmem = kWideRingOffset + kWideRingBytes;
// blocks an SM can hold (228 KB of shared memory, 1 KB of it reserved per
// block)
constexpr int kWideBlocksPerSM = 228 * 1024 / (kWideSmem + 1024);
static_assert(kWideBlocksPerSM >= 1, "the wide kernel's shared memory");
static_assert(kWideBarOffset % 8 == 0, "mbarriers are 8-byte aligned");
static_assert(kWideScan % 32 == 0, "warp 0 scans kWideScan / 32 a lane");

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

// cp.async copies into shared memory, 16 bytes (float4, L2 only) or 4
// (float): the wide kernel's gather ring.
__device__ __forceinline__ void cp_async(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// mbarriers in shared memory (by their shared-window address): the
// wide kernel's producer/consumer hand-off
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(unsigned bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Wide rows: T and Dv as above, F > kMaxStagedIds, one block of
// kWideThreads per destination row.  Per chunk of kWideChunk ids: read the
// ids (16-byte loads, the row's unaligned head and tail one id at a time),
// compact the valid ones in f order into s_list (per-thread counts, a warp
// scan of them packed 8 bits per vector, warp 0 scanning the warps'
// totals), then gather their source rows through the kWideStages-deep
// ring, copying warps ahead of adding warps, and add them in list order.
// Columns past kWideCols take another pass over the row.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, kWideBlocksPerSM)
    sage_aggregate_wide_kernel(const int* __restrict__ edges,
                               const T* __restrict__ h, int S, int F, int N,
                               int Dv, T* __restrict__ out) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kVecsPerChunk = kWideThreads * kWideVecs;
  constexpr int kStageElems = kWideRingBytes / kWideStages / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_list = reinterpret_cast<int*>(smem);      // kWideChunk ids
  int* s_scan = s_list + kWideChunk;               // kWideScan totals
  int* s_n = s_scan + kWideScan;                   // the chunk's count
  T* ring = reinterpret_cast<T*>(smem + kWideRingOffset);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const int* e = edges + row * F;
  // the row as int4 vectors from the 16-byte boundary at or below e: id f
  // is component (f + head) % 4 of vector (f + head) / 4
  const int head = (int)((reinterpret_cast<unsigned long long>(e) >> 2) & 3);
  const int4* ev = reinterpret_cast<const int4*>(e - head);
  const long long Q = ((long long)head + F + 3) >> 2;
  const T* hb = h + row / S * (long long)N * Dv;
  T* o = out + row * Dv;
  const unsigned bars =
      (unsigned)__cvta_generic_to_shared(smem + kWideBarOffset);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWideStages + s); };
  for (int c0 = 0; c0 < Dv; c0 += kWideCols) {
    const int Cp = min(Dv - c0, kWideCols);
    // warps [0, nc) add (thread c < Cp owns column c0 + c), the other np
    // threads copy
    const int nc = (Cp + 31) / 32;
    const int np = kWideThreads - 32 * nc;
    const bool live = tid < Cp;
    const int G = max(1, kStageElems / Cp);  // source rows a ring stage
    // a producer's first (row, column) of a stage's G * Cp copies, and the
    // step of np copies in rows and columns
    const int pt = tid - 32 * nc;
    const int g_first = pt / Cp, c_first = pt - g_first * Cp;
    const int g_step = np / Cp;
    const int c_step = np - g_step * Cp;
    if (tid == 0) {
      for (int s = 0; s < kWideStages; ++s) {
        mbar_init(full(s), np);
        mbar_init(empty(s), 32 * nc);
      }
    }
    T acc = zero<T>();
    int count = 0;
    int k0 = 0;  // ring stages used by earlier chunks of this pass
    for (long long q0 = 0; q0 < Q; q0 += kVecsPerChunk) {
      // ids: vector q0 + u * kWideThreads + tid, -1 outside the row
      int x[kWideVecs][4];
      unsigned packed[(kWideVecs + 3) / 4] = {};
#pragma unroll
      for (int u = 0; u < kWideVecs; ++u) {
        const long long q = q0 + u * kWideThreads + tid;
        const long long f = 4 * q - head;
        int4 v = make_int4(-1, -1, -1, -1);
        if (f >= 0 && f + 4 <= F) {
          v = __ldcs(ev + q);
        } else if (q < Q) {
          if (f >= 0) v.x = __ldcs(e + f);
          if (f + 1 >= 0 && f + 1 < F) v.y = __ldcs(e + f + 1);
          if (f + 2 >= 0 && f + 2 < F) v.z = __ldcs(e + f + 2);
          if (f + 3 < F) v.w = __ldcs(e + f + 3);
        }
        x[u][0] = v.x;
        x[u][1] = v.y;
        x[u][2] = v.z;
        x[u][3] = v.w;
        unsigned c = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) c += (unsigned)x[u][k] < (unsigned)N;
        packed[u / 4] += c << (8 * (u % 4));
      }
      // inclusive warp scan, each 8-bit field one vector's counts (a warp
      // holds at most 128 valid ids of one vector)
      unsigned incl[(kWideVecs + 3) / 4];
#pragma unroll
      for (int p = 0; p < (kWideVecs + 3) / 4; ++p) {
        unsigned v = packed[p];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(kFull, v, d);
          if (lane >= d) v += y;
        }
        incl[p] = v;
      }
      if (lane == 31) {
#pragma unroll
        for (int u = 0; u < kWideVecs; ++u)
          s_scan[u * kWideWarps + warp] =
              (incl[u / 4] >> (8 * (u % 4))) & 255;
      }
      __syncthreads();
      if (warp == 0) {
        // exclusive scan of the kWideScan warp totals in f order (vector
        // index major, warp minor), kPer a lane
        constexpr int kPer = kWideScan / 32;
        int t[kPer];
        int sum = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          t[j] = s_scan[lane * kPer + j];
          sum += t[j];
        }
        int run = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, run, d);
          if (lane >= d) run += y;
        }
        if (lane == 31) *s_n = run;
        run -= sum;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s_scan[lane * kPer + j] = run;
          run += t[j];
        }
      }
      __syncthreads();
      const int n = *s_n;
#pragma unroll
      for (int u = 0; u < kWideVecs; ++u) {
        const int sh = 8 * (u % 4);
        int off = s_scan[u * kWideWarps + warp] +
                  (int)(((incl[u / 4] - packed[u / 4]) >> sh) & 255);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if ((unsigned)x[u][k] < (unsigned)N) s_list[off++] = x[u][k];
      }
      count += n;
      __syncthreads();
      // gather-add s_list[0, n): stage k of the chunk holds list rows kG ..
      // kG + G - 1 in ring slot (k0 + k) % kWideStages.  The producers fill
      // a slot once the adders have emptied it, up to the whole ring ahead;
      // the adders take the stages in order as they land.
      const int stages = (n + G - 1) / G;
      if (tid >= 32 * nc) {
        for (int k = 0; k < stages; ++k) {
          const int kr = k0 + k;
          const int s = kr % kWideStages;
          if (kr >= kWideStages)
            mbar_wait(empty(s), (kr / kWideStages - 1) & 1);
          const int r0 = k * G;
          const int nr = min(G, n - r0);
          T* dst = ring + s * G * Cp;
          for (int g = g_first, c = c_first; g < nr;) {
            cp_async(dst + g * Cp + c,
                     hb + (long long)s_list[r0 + g] * Dv + c0 + c);
            g += g_step;
            c += c_step;
            if (c >= Cp) {
              c -= Cp;
              ++g;
            }
          }
          cp_async_arrive(full(s));
        }
      } else {
        for (int k = 0; k < stages; ++k) {
          const int kr = k0 + k;
          const int s = kr % kWideStages;
          mbar_wait(full(s), (kr / kWideStages) & 1);
          if (live) {
            const T* src = ring + s * G * Cp + tid;
            const int nr = min(G, n - k * G);
#pragma unroll 4
            for (int g = 0; g < nr; ++g) add(acc, src[g * Cp]);
          }
          mbar_arrive(empty(s));
        }
      }
      k0 += stages;
      __syncthreads();  // s_list, s_scan and the ring are free again
    }
    if (tid == 0) {
      for (int s = 0; s < kWideStages; ++s) {
        mbar_inval(full(s));
        mbar_inval(empty(s));
      }
    }
    if (!live) continue;
    if (count == 0) {
      __stcs(o + c0 + tid, zero<T>());
    } else {
      o[c0 + tid] = div(acc, (float)count);
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
  if (threads != kWideThreads || rows > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  // above 48 KB of dynamic shared memory only by opting in; the largest
  // carveout lets two blocks share an SM.  Function attributes belong to
  // a device's context, so they are set once a device (host API calls an
  // exact pass would otherwise make twice for each of its 2931 launches;
  // two threads setting them at once is harmless).
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(sage_aggregate_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWideSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          sage_aggregate_wide_kernel<T>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  sage_aggregate_wide_kernel<T>
      <<<(unsigned int)rows, kWideThreads, kWideSmem, stream>>>(
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
