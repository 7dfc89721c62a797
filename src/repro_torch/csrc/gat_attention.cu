// GAT's attention over a destination's sampled edges and itself (the
// original, static attention of Velickovic et al., arXiv:1710.10903),
// forward and backward, on Hopper.
//
// Replaces: no TPU kernel.  `repro` has no such layer: its `gat` attends
// over the sampled edges only, in jnp (src/repro/models/gnn.py), and the
// port's plain attention (`_gat_aggregate`) builds several (S, F, H, C)
// temporaries.  This port-only pair is the attention of the port's
// `gatv1` conv (src/repro_torch/models/gnn.py), a row's whole softmax and
// weighted sum in one pass each way.
//
// Math, per destination row i and head h (C wide): the slots are i itself
// (slot 0, z_i) and its F sampled edges (slot f + 1, z_j for the edge's
// source j), a slot kept where `keep` says so (the self slot always).
// Every z is a row of one projected table z (N rows a worker), named by
// id: i's own row `dst[i]`, an edge's source `edges[i, f]`.  s_k = z_k .
// a_src, t = z_i . a_dst, e_k = LeakyReLU(s_k + t), alpha = softmax over
// the kept slots, out = sum_k alpha_k z_k.  The backward, from the
// upstream g: da_k = g . z_k, go = sum_k alpha_k da_k, dpre_k = alpha_k
// (da_k - go) times LeakyReLU's slope at s_k + t; slot k's gradient is
// alpha_k g + dpre_k a_src (the self slot's adds (sum_k dpre_k) a_dst),
// and a table row's gradient is the sum of the gradients of the kept slots
// that name it; a_src's gradient sums dpre_k z_k and a_dst's (sum_k
// dpre_k) z_i over the rows.
//
// What bounds it on this card: bytes.  Each slot's C-wide row is read for
// one dot product and one multiply-add an element (forward), or two dots
// and a few multiply-adds (backward), against 4 bytes an element.
//
// Design: the forward and the backward's per-destination pass run a block
// of H warps, one warp a head.  A lane holds a float4 of the head's row
// where C is a multiple of 4 and every pointer 16-byte aligned (a float
// else), so at C = 128 a warp reads one slot's head in one 512-byte
// access.  Dot products are a lane's partial in element order, then an xor
// butterfly (every lane ends with the same bits); the kept edges' go two at
// a time, so two gathered rows' loads are in flight.  The scores go to shared
// memory; every lane forms the max and the sum in slot order; the weighted
// sum walks the slots in slot order for each element.  A row's second read
// of its slots (the weighted sum, the backward's partials) finds them in
// L1/L2: the slots of the rows in flight are a few MB.  Bits depend on F, H
// and C alone, never on the row count or on which rows share the table.
//
// The backward, three launches of one kernel template, no atomics:
//  0. per destination: dpre (rows, F + 1, H) and sum_k dpre_k (rows, H),
//     and the attention vectors' gradients as per-block partials: a block
//     walks `rows_per_block` consecutive rows in order, each thread adding
//     its own elements, and writes one row of `part_src` and `part_dst`,
//     which the wrapper sums.  `rows_per_block` depends on the row count.
//  1. per source, the long slot lists: over the transpose (`rowptr` and
//     `slots` from sage_backward_index.cu, over the (rows, F + 1) ids of
//     every slot, the self slot's first: each table row's slots in
//     ascending (i, k) order), a source's slots split into chunks of
//     kChunk; a warp sums each chunk after a row's first into the row of
//     `part` named by the chunk's start over kChunk (unique: a later
//     chunk follows kChunk slots of its own row), in slot order.
//  2. per source, every row: a warp sums the row's first chunk in slot
//     order, then adds the later chunks' partials in chunk order, and
//     writes the row (zeros where no kept slot names it).  A hub's serial
//     chain is kChunk slots and one add a chunk; the bits depend on the
//     data alone.
//
// Layout: z (B * N, H*C), worker b's rows from b * N; edges (rows, F)
// int32 and keep (rows, F) bytes, rows = B * S, worker b's from b * S;
// dst (rows) int32; ids are rows of their worker's table, in [0, N) where
// kept; a_src, a_dst (H, C); out (rows, H, C); alpha (rows, F + 1, H).
// Backward: g (rows, H, C); dz as z; dpre (rows, F + 1, H); sdp (rows, H);
// part_src, part_dst (blocks, H*C); part (windows, H*C), windows =
// ceil(rows * (F + 1) / kChunk).  float32 throughout.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRowsPerBlock = 32;
constexpr long long kTargetBlocks = 132 * 8;  // SMs x blocks each
// slots a chunk of the per-source passes (CHUNK in kernels/gat_attention.py)
constexpr int kChunk = kWarp;
constexpr int kSourceWarps = 4;  // warps a block of the per-source passes

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, long long v,
                                     float* x) {
  using T = typename Vec<V>::T;
  *reinterpret_cast<T*>(x) = reinterpret_cast<const T*>(p)[v];
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, long long v,
                                      const float* x) {
  using T = typename Vec<V>::T;
  reinterpret_cast<T*>(p)[v] = *reinterpret_cast<const T*>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : x * slope;
}

// x . a over one head's row, every lane the same bits
template <int V>
__device__ __forceinline__ float dot1(const float* __restrict__ x,
                                      const float* __restrict__ a, int lane,
                                      int CV) {
  float p = 0.f;
  for (int v = lane; v < CV; v += kWarp) {
    float xv[V], av[V];
    load<V>(x, v, xv);
    load<V>(a, v, av);
#pragma unroll
    for (int j = 0; j < V; ++j) p = fmaf(xv[j], av[j], p);
  }
  return warp_sum(p);
}

// (x . a, x . b) over one head's row, each as dot1 gives it
template <int V>
__device__ __forceinline__ void dot2(const float* __restrict__ x,
                                     const float* __restrict__ a,
                                     const float* __restrict__ b, int lane,
                                     int CV, float* xa, float* xb) {
  float pa = 0.f, pb = 0.f;
  for (int v = lane; v < CV; v += kWarp) {
    float xv[V], av[V], bv[V];
    load<V>(x, v, xv);
    load<V>(a, v, av);
    load<V>(b, v, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pa = fmaf(xv[j], av[j], pa);
      pb = fmaf(xv[j], bv[j], pb);
    }
  }
  *xa = warp_sum(pa);
  *xb = warp_sum(pb);
}

// dot1 of two rows at once (each the bits dot1 gives it): two slots'
// loads in flight together
template <int V>
__device__ __forceinline__ void dot1x2(const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       const float* __restrict__ a, int lane,
                                       int CV, float* xa, float* ya) {
  float px = 0.f, py = 0.f;
  for (int v = lane; v < CV; v += kWarp) {
    float xv[V], yv[V], av[V];
    load<V>(x, v, xv);
    load<V>(y, v, yv);
    load<V>(a, v, av);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      px = fmaf(xv[j], av[j], px);
      py = fmaf(yv[j], av[j], py);
    }
  }
  *xa = warp_sum(px);
  *ya = warp_sum(py);
}

// dot2 of two rows at once, each as dot2 gives it
template <int V>
__device__ __forceinline__ void dot2x2(const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       const float* __restrict__ a,
                                       const float* __restrict__ b, int lane,
                                       int CV, float* xa, float* xb,
                                       float* ya, float* yb) {
  float pxa = 0.f, pxb = 0.f, pya = 0.f, pyb = 0.f;
  for (int v = lane; v < CV; v += kWarp) {
    float xv[V], yv[V], av[V], bv[V];
    load<V>(x, v, xv);
    load<V>(y, v, yv);
    load<V>(a, v, av);
    load<V>(b, v, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pxa = fmaf(xv[j], av[j], pxa);
      pxb = fmaf(xv[j], bv[j], pxb);
      pya = fmaf(yv[j], av[j], pya);
      pyb = fmaf(yv[j], bv[j], pyb);
    }
  }
  *xa = warp_sum(pxa);
  *xb = warp_sum(pxb);
  *ya = warp_sum(pya);
  *yb = warp_sum(pyb);
}

// The first kept edge slot at or after f (F where none is)
__device__ __forceinline__ int next_kept(const unsigned char* __restrict__ ki,
                                         int f, int F) {
  while (f < F && !ki[f]) ++f;
  return f;
}

template <int V>
__global__ void gat_attention_kernel(
    const float* __restrict__ z, const int* __restrict__ edges,
    const int* __restrict__ dst, const unsigned char* __restrict__ keep,
    const float* __restrict__ a_src, const float* __restrict__ a_dst,
    long long rows, long long S, long long N, int F, int H, int C,
    float slope, float* __restrict__ out, float* __restrict__ alpha) {
  extern __shared__ float smem[];
  const int h = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int HC = H * C, CV = C / V, K = F + 1;
  float* e = smem + h * K;        // this head's scores, then its weights
  const float* as = a_src + h * C;
  const float* ad = a_dst + h * C;
  for (long long i = blockIdx.x; i < rows; i += gridDim.x) {
    const float* zb = z + (i / S) * N * HC + h * C;  // the worker's table
    const float* zi = zb + (long long)dst[i] * HC;
    const int* ei = edges + i * F;
    const unsigned char* ki = keep + i * F;
    float s0, t;
    dot2<V>(zi, as, ad, lane, CV, &s0, &t);
    if (lane == 0) e[0] = leaky(s0 + t, slope);
    // the kept edges two at a time
    for (int f = next_kept(ki, 0, F); f < F;) {
      const int f2 = next_kept(ki, f + 1, F);
      if (f2 < F) {
        float sf, sf2;
        dot1x2<V>(zb + (long long)ei[f] * HC, zb + (long long)ei[f2] * HC,
                  as, lane, CV, &sf, &sf2);
        if (lane == 0) {
          e[f + 1] = leaky(sf + t, slope);
          e[f2 + 1] = leaky(sf2 + t, slope);
        }
        f = next_kept(ki, f2 + 1, F);
      } else {
        const float sf = dot1<V>(zb + (long long)ei[f] * HC, as, lane, CV);
        if (lane == 0) e[f + 1] = leaky(sf + t, slope);
        f = F;
      }
    }
    __syncwarp();
    float m = e[0];
    for (int f = 0; f < F; ++f)
      if (ki[f]) m = fmaxf(m, e[f + 1]);
    float l = expf(e[0] - m);
    for (int f = 0; f < F; ++f)
      if (ki[f]) l += expf(e[f + 1] - m);
    __syncwarp();                 // every lane has read the scores
    for (int k = lane; k < K; k += kWarp) {
      const float a = (k == 0 || ki[k - 1]) ? expf(e[k] - m) / l : 0.f;
      alpha[(i * K + k) * H + h] = a;
      e[k] = a;
    }
    __syncwarp();
    float* oi = out + i * HC + h * C;
    for (int v = lane; v < CV; v += kWarp) {
      float acc[V], zv[V];
      load<V>(zi, v, zv);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = e[0] * zv[j];
      for (int f = 0; f < F; ++f) {
        if (!ki[f]) continue;
        load<V>(zb + (long long)ei[f] * HC, v, zv);
        const float a = e[f + 1];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(a, zv[j], acc[j]);
      }
      store<V>(oi, v, acc);
    }
    __syncwarp();                 // before the next row rewrites e
  }
}

struct BackwardArgs {
  const float* g;
  const float* z;
  const int* edges;
  const int* dst;
  const unsigned char* keep;
  const float* a_src;
  const float* a_dst;
  const float* alpha;
  const int* rowptr;
  const int* slots;
  long long rows, S, N, table_rows;
  int F, H, C;
  float slope;
  int rows_per_block;
  float* dpre;
  float* sdp;
  float* part_src;
  float* part_dst;
  float* part;
  float* dz;
};

// Pass 0: dpre, sum_k dpre_k, and the attention vectors' block partials
template <int V>
__device__ void per_destination(const BackwardArgs& a) {
  extern __shared__ float smem[];
  const int h = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int F = a.F, H = a.H, C = a.C;
  const int HC = H * C, CV = C / V, K = F + 1;
  float* da = smem + h * 3 * K;   // g . z_k, then dpre_k
  float* pre = da + K;            // s_k + t
  float* al = pre + K;            // alpha_k
  float* acc_s = smem + 3 * H * K + h * C;   // this head's partial sums
  float* acc_d = acc_s + HC;
  const float* as = a.a_src + h * C;
  const float* ad = a.a_dst + h * C;
  for (int v = lane; v < CV; v += kWarp)
#pragma unroll
    for (int j = 0; j < V; ++j) acc_s[v * V + j] = acc_d[v * V + j] = 0.f;
  const long long r0 = (long long)blockIdx.x * a.rows_per_block;
  const long long r1 = r0 + a.rows_per_block < a.rows
                           ? r0 + a.rows_per_block : a.rows;
  for (long long i = r0; i < r1; ++i) {
    const float* zb = a.z + (i / a.S) * a.N * HC + h * C;
    const float* zi = zb + (long long)a.dst[i] * HC;
    const float* gi = a.g + i * HC + h * C;
    const int* ei = a.edges + i * F;
    const unsigned char* ki = a.keep + i * F;
    float s0, t;
    dot2<V>(zi, as, ad, lane, CV, &s0, &t);
    const float d0 = dot1<V>(zi, gi, lane, CV);
    if (lane == 0) {
      da[0] = d0;
      pre[0] = s0 + t;
    }
    // the kept edges two at a time
    for (int f = next_kept(ki, 0, F); f < F;) {
      const int f2 = next_kept(ki, f + 1, F);
      if (f2 < F) {
        float sf, df, sf2, df2;
        dot2x2<V>(zb + (long long)ei[f] * HC, zb + (long long)ei[f2] * HC,
                  as, gi, lane, CV, &sf, &df, &sf2, &df2);
        if (lane == 0) {
          da[f + 1] = df;
          pre[f + 1] = sf + t;
          da[f2 + 1] = df2;
          pre[f2 + 1] = sf2 + t;
        }
        f = next_kept(ki, f2 + 1, F);
      } else {
        float sf, df;
        dot2<V>(zb + (long long)ei[f] * HC, as, gi, lane, CV, &sf, &df);
        if (lane == 0) {
          da[f + 1] = df;
          pre[f + 1] = sf + t;
        }
        f = F;
      }
    }
    for (int k = lane; k < K; k += kWarp)
      al[k] = a.alpha[(i * K + k) * H + h];
    __syncwarp();
    float go = al[0] * da[0];
    for (int f = 0; f < F; ++f)
      if (ki[f]) go = fmaf(al[f + 1], da[f + 1], go);
    __syncwarp();                 // every lane has read da
    for (int k = lane; k < K; k += kWarp) {
      const bool kept = k == 0 || ki[k - 1];
      da[k] = kept ? al[k] * (da[k] - go) * (pre[k] > 0.f ? 1.f : a.slope)
                   : 0.f;
      a.dpre[(i * K + k) * H + h] = da[k];
    }
    __syncwarp();
    float sum_dp = da[0];
    for (int f = 0; f < F; ++f) sum_dp += da[f + 1];
    if (lane == 0) a.sdp[i * H + h] = sum_dp;
    for (int v = lane; v < CV; v += kWarp) {
      float zv[V], rs[V];
      load<V>(zi, v, zv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        rs[j] = da[0] * zv[j];
        acc_d[v * V + j] = fmaf(sum_dp, zv[j], acc_d[v * V + j]);
      }
      for (int f = 0; f < F; ++f) {
        if (!ki[f]) continue;
        float nv[V];
        load<V>(zb + (long long)ei[f] * HC, v, nv);
        const float d = da[f + 1];
#pragma unroll
        for (int j = 0; j < V; ++j) rs[j] = fmaf(d, nv[j], rs[j]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc_s[v * V + j] += rs[j];
    }
    __syncwarp();                 // before the next row rewrites da, al
  }
  float* ps = a.part_src + (long long)blockIdx.x * HC + h * C;
  float* pd = a.part_dst + (long long)blockIdx.x * HC + h * C;
  for (int v = lane; v < CV; v += kWarp)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ps[v * V + j] = acc_s[v * V + j];
      pd[v * V + j] = acc_d[v * V + j];
    }
}

// The kept slots among positions [p, p + n) of the transpose (n <=
// kChunk), staged in order as (destination row, slot) into this warp's
// `si`, `sk`; returns their count
__device__ __forceinline__ int stage_chunk(const BackwardArgs& a,
                                           long long p, int n, int lane,
                                           int* si, int* sk) {
  const int K = a.F + 1;
  int i = 0, k = 0;
  bool on = false;
  if (lane < n) {
    const int s = a.slots[p + lane];
    i = s / K;
    k = s - i * K;
    on = k == 0 || a.keep[(long long)i * a.F + k - 1];
  }
  const unsigned kept = __ballot_sync(0xffffffffu, on);
  if (on) {
    const int q = __popc(kept & ((1u << lane) - 1u));
    si[q] = i;
    sk[q] = k;
  }
  __syncwarp();
  return __popc(kept);
}

// acc += the staged slots' gradients at the table row's element block v,
// in slot order; each slot's term alpha_k g + dpre_k a_src + c a_dst, c
// sum_k dpre_k in a self slot and 0 in an edge's (branch-free, so the
// unrolled slots' loads are in flight together)
template <int V>
__device__ __forceinline__ void add_staged(const BackwardArgs& a, int count,
                                           const int* si, const int* sk,
                                           int v, float* acc) {
  const int H = a.H, HC = H * a.C, K = a.F + 1;
  const int h = v * V / a.C;
  float av[V], bv[V];
  load<V>(a.a_src, v, av);
  load<V>(a.a_dst, v, bv);
#pragma unroll 4
  for (int q = 0; q < count; ++q) {
    const long long i = si[q];
    const int k = sk[q];
    const long long ik = (i * K + k) * H + h;
    const float al = a.alpha[ik], dp = a.dpre[ik];
    const float e = k == 0 ? a.sdp[i * H + h] : 0.f;
    float gv[V];
    load<V>(a.g + i * HC, v, gv);
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] += fmaf(e, bv[j], fmaf(dp, av[j], al * gv[j]));
  }
}

// Pass 1: the chunks after a row's first, one a warp (window j holds at
// most one such chunk's start)
template <int V>
__device__ void later_chunks(const BackwardArgs& a) {
  __shared__ int s_i[kSourceWarps][kChunk], s_k[kSourceWarps][kChunk];
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long j = (long long)blockIdx.x * kSourceWarps + w;
  const long long p0 = j * kChunk;
  if (p0 >= a.rowptr[a.table_rows]) return;   // past the valid slots
  const int K = a.F + 1;
  const int s0 = a.slots[p0];
  const int i0 = s0 / K, k0 = s0 - i0 * K;
  const int id = k0 == 0 ? a.dst[i0] : a.edges[(long long)i0 * a.F + k0 - 1];
  const long long r = (i0 / a.S) * a.N + id;
  const long long rp = a.rowptr[r], rq = a.rowptr[r + 1];
  if (rp == p0) return;                       // a first chunk: pass 2's
  const long long p = rp + (p0 - rp + kChunk - 1) / kChunk * kChunk;
  if (p >= rq) return;
  const int n = (int)(rq - p < kChunk ? rq - p : kChunk);
  const int count = stage_chunk(a, p, n, lane, s_i[w], s_k[w]);
  const int HC = a.H * a.C, HCV = HC / V;
  float* out = a.part + j * HC;
  for (int v = lane; v < HCV; v += kWarp) {
    float acc[V] = {};
    add_staged<V>(a, count, s_i[w], s_k[w], v, acc);
    store<V>(out, v, acc);
  }
}

// Pass 2: every table row, one a warp: its first chunk, then the later
// chunks' partials in chunk order
template <int V>
__device__ void table_rows(const BackwardArgs& a) {
  __shared__ int s_i[kSourceWarps][kChunk], s_k[kSourceWarps][kChunk];
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long r = (long long)blockIdx.x * kSourceWarps + w;
  if (r >= a.table_rows) return;
  const long long rp = a.rowptr[r], rq = a.rowptr[r + 1];
  const int n = (int)(rq - rp < kChunk ? rq - rp : kChunk);
  const int count = stage_chunk(a, rp, n, lane, s_i[w], s_k[w]);
  const int HC = a.H * a.C, HCV = HC / V;
  float* out = a.dz + r * HC;
  for (int v = lane; v < HCV; v += kWarp) {
    float acc[V] = {};
    add_staged<V>(a, count, s_i[w], s_k[w], v, acc);
    for (long long p = rp + kChunk; p < rq; p += kChunk) {
      float pv[V];
      load<V>(a.part + p / kChunk * HC, v, pv);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += pv[j];
    }
    store<V>(out, v, acc);
  }
}

template <int V, int Pass>
__global__ void gat_attention_backward_kernel(const BackwardArgs a) {
  if constexpr (Pass == 0) {
    per_destination<V>(a);
  } else if constexpr (Pass == 1) {
    later_chunks<V>(a);
  } else {
    table_rows<V>(a);
  }
}

int rows_per_block_of(long long rows) {
  long long r = rows / kTargetBlocks;
  return (int)(r < 1 ? 1 : r > kMaxRowsPerBlock ? kMaxRowsPerBlock : r);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int V>
cudaError_t backward(const BackwardArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = ((size_t)3 * a.H * (a.F + 1) + 2 * (size_t)a.H * a.C)
                      * sizeof(float);
  const int threads = kSourceWarps * kWarp;
  cudaError_t err = allow_smem(
      (const void*)gat_attention_backward_kernel<V, 0>, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0) {
    gat_attention_backward_kernel<V, 0><<<blocks, a.H * kWarp, smem,
                                          stream>>>(a);
    const long long slots = a.rows * (a.F + 1);
    const long long windows = (slots + kChunk - 1) / kChunk;
    gat_attention_backward_kernel<V, 1><<<
        (unsigned int)((windows + kSourceWarps - 1) / kSourceWarps), threads,
        0, stream>>>(a);
  }
  if (a.table_rows > 0) {
    gat_attention_backward_kernel<V, 2><<<
        (unsigned int)((a.table_rows + kSourceWarps - 1) / kSourceWarps),
        threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gat_attention_launch(const float* z, const int* edges,
                                    const int* dst,
                                    const unsigned char* keep,
                                    const float* a_src, const float* a_dst,
                                    long long rows, long long S, long long N,
                                    int F, int H, int C, int vec, float slope,
                                    float* out, float* alpha,
                                    cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  const unsigned int grid =
      (unsigned int)(rows < (1LL << 30) ? rows : (1LL << 30));
  const size_t smem = (size_t)H * (F + 1) * sizeof(float);
  const void* kernel = vec ? (const void*)gat_attention_kernel<4>
                           : (const void*)gat_attention_kernel<1>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (vec) {
    gat_attention_kernel<4><<<grid, H * kWarp, smem, stream>>>(
        z, edges, dst, keep, a_src, a_dst, rows, S, N, F, H, C, slope, out,
        alpha);
  } else {
    gat_attention_kernel<1><<<grid, H * kWarp, smem, stream>>>(
        z, edges, dst, keep, a_src, a_dst, rows, S, N, F, H, C, slope, out,
        alpha);
  }
  return (int)cudaGetLastError();
}

// Rows of part_src and part_dst: the per-destination pass's blocks
extern "C" int gat_attention_backward_blocks(long long rows) {
  const int r = rows_per_block_of(rows);
  return (int)((rows + r - 1) / r);
}

extern "C" int gat_attention_backward_launch(
    const float* g, const float* z, const int* edges, const int* dst,
    const unsigned char* keep, const float* a_src, const float* a_dst,
    const float* alpha, const int* rowptr, const int* slots, long long rows,
    long long S, long long N, long long table_rows, int F, int H, int C,
    int vec, float slope, float* dpre, float* sdp, float* part_src,
    float* part_dst, float* part, float* dz, cudaStream_t stream) {
  BackwardArgs a{g, z, edges, dst, keep, a_src, a_dst, alpha, rowptr,
                 slots, rows, S, N, table_rows, F, H, C, slope,
                 rows_per_block_of(rows), dpre, sdp, part_src, part_dst,
                 part, dz};
  const int blocks = gat_attention_backward_blocks(rows);
  return (int)(vec ? backward<4>(a, blocks, stream)
                   : backward<1>(a, blocks, stream));
}
