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
// (slot 0, z_i) and its F sampled edges (slot f + 1, z_nb[i, f]), a slot
// kept where `keep` says so (the self slot always).  s_k = z_k . a_src,
// t = z_i . a_dst, e_k = LeakyReLU(s_k + t), alpha = softmax over the kept
// slots, out = sum_k alpha_k z_k.  The backward, from the upstream g:
// da_k = g . z_k, go = sum_k alpha_k da_k, dpre_k = alpha_k (da_k - go)
// times LeakyReLU's slope at s_k + t; dz_k = alpha_k g + dpre_k a_src
// (zero in a slot not kept), and the self slot's dz_i adds (sum_k dpre_k)
// a_dst; a_src's gradient sums dpre_k z_k and a_dst's (sum_k dpre_k) z_i
// over the rows.
//
// What bounds it on this card: bytes.  Each slot's C-wide row is read for
// one dot product and one multiply-add an element (forward), or two dots
// and a few multiply-adds (backward), against 4 bytes an element.
//
// Design: a block of H warps, one warp a head.  A lane holds a float4 of
// the head's row where C is a multiple of 4 and every pointer 16-byte
// aligned (a float else), so at C = 128 a warp reads one slot's head in
// one 512-byte access.  Dot products are a lane's partial in element
// order, then an xor butterfly (every lane ends with the same bits).  The
// scores go to shared memory; every lane forms the max and the sum in slot
// order; the weighted sum walks the slots in slot order for each element.
// A row's second read of its slots (the weighted sum, the backward's
// gradient pass) finds them in L1/L2: the slots of the rows in flight are a
// few MB.  Bits depend on F, H and C alone, never on the row count.
// The backward writes every slot of dz_nb (zeros where not kept) and the
// attention vectors' gradients as per-block partials without atomics: a
// block walks `rows_per_block` consecutive rows in order, each thread adding
// its own elements, and writes one row of `part_src` and `part_dst`, which
// the wrapper sums.  `rows_per_block` depends on the row count alone.
//
// Layout: z_nb (rows, F, H*C); z_dst (rows, H*C); keep (rows, F) bytes;
// a_src, a_dst (H, C); out (rows, H, C); alpha (rows, F + 1, H).
// Backward: g (rows, H, C); dz_nb, dz_dst as z_nb, z_dst; part_src,
// part_dst (blocks, H*C).  float32 throughout.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRowsPerBlock = 32;
constexpr long long kTargetBlocks = 132 * 8;  // SMs x blocks each

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, int v,
                                     float* x) {
  using T = typename Vec<V>::T;
  *reinterpret_cast<T*>(x) = reinterpret_cast<const T*>(p)[v];
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, int v,
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

template <int V>
__global__ void gat_attention_kernel(
    const float* __restrict__ z_nb, const float* __restrict__ z_dst,
    const unsigned char* __restrict__ keep, const float* __restrict__ a_src,
    const float* __restrict__ a_dst, long long rows, int F, int H, int C,
    float slope, float* __restrict__ out, float* __restrict__ alpha) {
  extern __shared__ float smem[];
  const int h = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int HC = H * C, CV = C / V, K = F + 1;
  float* e = smem + h * K;        // this head's scores, then its weights
  const float* as = a_src + h * C;
  const float* ad = a_dst + h * C;
  for (long long i = blockIdx.x; i < rows; i += gridDim.x) {
    const float* zi = z_dst + i * HC + h * C;
    const float* zn = z_nb + i * F * HC + h * C;
    const unsigned char* ki = keep + i * F;
    float s0, t;
    dot2<V>(zi, as, ad, lane, CV, &s0, &t);
    if (lane == 0) e[0] = leaky(s0 + t, slope);
    for (int f = 0; f < F; ++f) {
      if (!ki[f]) continue;
      const float sf = dot1<V>(zn + (long long)f * HC, as, lane, CV);
      if (lane == 0) e[f + 1] = leaky(sf + t, slope);
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
        load<V>(zn + (long long)f * HC, v, zv);
        const float a = e[f + 1];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(a, zv[j], acc[j]);
      }
      store<V>(oi, v, acc);
    }
    __syncwarp();                 // before the next row rewrites e
  }
}

template <int V>
__global__ void gat_attention_backward_kernel(
    const float* __restrict__ g, const float* __restrict__ z_nb,
    const float* __restrict__ z_dst, const unsigned char* __restrict__ keep,
    const float* __restrict__ a_src, const float* __restrict__ a_dst,
    const float* __restrict__ alpha, long long rows, int F, int H, int C,
    float slope, int rows_per_block, float* __restrict__ dz_nb,
    float* __restrict__ dz_dst, float* __restrict__ part_src,
    float* __restrict__ part_dst) {
  extern __shared__ float smem[];
  const int h = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int HC = H * C, CV = C / V, K = F + 1;
  float* da = smem + h * 3 * K;   // g . z_k, then dpre_k
  float* pre = da + K;            // s_k + t
  float* al = pre + K;            // alpha_k
  float* acc_s = smem + 3 * H * K + h * C;   // this head's partial sums
  float* acc_d = acc_s + HC;
  const float* as = a_src + h * C;
  const float* ad = a_dst + h * C;
  for (int v = lane; v < CV; v += kWarp)
#pragma unroll
    for (int j = 0; j < V; ++j) acc_s[v * V + j] = acc_d[v * V + j] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block
                                                  : rows;
  for (long long i = r0; i < r1; ++i) {
    const float* zi = z_dst + i * HC + h * C;
    const float* zn = z_nb + i * F * HC + h * C;
    const float* gi = g + i * HC + h * C;
    const unsigned char* ki = keep + i * F;
    float s0, t;
    dot2<V>(zi, as, ad, lane, CV, &s0, &t);
    const float d0 = dot1<V>(zi, gi, lane, CV);
    if (lane == 0) {
      da[0] = d0;
      pre[0] = s0 + t;
    }
    for (int f = 0; f < F; ++f) {
      if (!ki[f]) continue;
      float sf, df;
      dot2<V>(zn + (long long)f * HC, as, gi, lane, CV, &sf, &df);
      if (lane == 0) {
        da[f + 1] = df;
        pre[f + 1] = sf + t;
      }
    }
    for (int k = lane; k < K; k += kWarp) al[k] = alpha[(i * K + k) * H + h];
    __syncwarp();
    float go = al[0] * da[0];
    for (int f = 0; f < F; ++f)
      if (ki[f]) go = fmaf(al[f + 1], da[f + 1], go);
    __syncwarp();                 // every lane has read da
    for (int k = lane; k < K; k += kWarp) {
      const bool kept = k == 0 || ki[k - 1];
      da[k] = kept ? al[k] * (da[k] - go) * (pre[k] > 0.f ? 1.f : slope)
                   : 0.f;
    }
    __syncwarp();
    float sum_dp = da[0];
    for (int f = 0; f < F; ++f) sum_dp += da[f + 1];
    float* gzi = dz_dst + i * HC + h * C;
    float* gzn = dz_nb + i * F * HC + h * C;
    for (int v = lane; v < CV; v += kWarp) {
      float gv[V], zv[V], av[V], bv[V], out[V], rs[V];
      load<V>(gi, v, gv);
      load<V>(zi, v, zv);
      load<V>(as, v, av);
      load<V>(ad, v, bv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        out[j] = fmaf(sum_dp, bv[j], fmaf(da[0], av[j], al[0] * gv[j]));
        rs[j] = da[0] * zv[j];
        acc_d[v * V + j] = fmaf(sum_dp, zv[j], acc_d[v * V + j]);
      }
      store<V>(gzi, v, out);
      for (int f = 0; f < F; ++f) {
        if (ki[f]) {
          float nv[V];
          load<V>(zn + (long long)f * HC, v, nv);
          const float a = al[f + 1], d = da[f + 1];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            out[j] = fmaf(d, av[j], a * gv[j]);
            rs[j] = fmaf(d, nv[j], rs[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) out[j] = 0.f;
        }
        store<V>(gzn + (long long)f * HC, v, out);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc_s[v * V + j] += rs[j];
    }
    __syncwarp();                 // before the next row rewrites da, al
  }
  float* ps = part_src + (long long)blockIdx.x * HC + h * C;
  float* pd = part_dst + (long long)blockIdx.x * HC + h * C;
  for (int v = lane; v < CV; v += kWarp)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ps[v * V + j] = acc_s[v * V + j];
      pd[v * V + j] = acc_d[v * V + j];
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

}  // namespace

extern "C" int gat_attention_launch(const float* z_nb, const float* z_dst,
                                    const unsigned char* keep,
                                    const float* a_src, const float* a_dst,
                                    long long rows, int F, int H, int C,
                                    int vec, float slope, float* out,
                                    float* alpha, cudaStream_t stream) {
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
        z_nb, z_dst, keep, a_src, a_dst, rows, F, H, C, slope, out, alpha);
  } else {
    gat_attention_kernel<1><<<grid, H * kWarp, smem, stream>>>(
        z_nb, z_dst, keep, a_src, a_dst, rows, F, H, C, slope, out, alpha);
  }
  return (int)cudaGetLastError();
}

extern "C" int gat_attention_backward_blocks(long long rows) {
  const int r = rows_per_block_of(rows);
  return (int)((rows + r - 1) / r);
}

extern "C" int gat_attention_backward_launch(
    const float* g, const float* z_nb, const float* z_dst,
    const unsigned char* keep, const float* a_src, const float* a_dst,
    const float* alpha, long long rows, int F, int H, int C, int vec,
    float slope, float* dz_nb, float* dz_dst, float* part_src,
    float* part_dst, cudaStream_t stream) {
  const int blocks = gat_attention_backward_blocks(rows);
  if (blocks == 0) return (int)cudaSuccess;
  const int rpb = rows_per_block_of(rows);
  const size_t smem = ((size_t)3 * H * (F + 1) + 2 * (size_t)H * C)
                      * sizeof(float);
  const void* kernel = vec ? (const void*)gat_attention_backward_kernel<4>
                           : (const void*)gat_attention_backward_kernel<1>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (vec) {
    gat_attention_backward_kernel<4><<<blocks, H * kWarp, smem, stream>>>(
        g, z_nb, z_dst, keep, a_src, a_dst, alpha, rows, F, H, C, slope,
        rpb, dz_nb, dz_dst, part_src, part_dst);
  } else {
    gat_attention_backward_kernel<1><<<blocks, H * kWarp, smem, stream>>>(
        g, z_nb, z_dst, keep, a_src, a_dst, alpha, rows, F, H, C, slope,
        rpb, dz_nb, dz_dst, part_src, part_dst);
  }
  return (int)cudaGetLastError();
}
