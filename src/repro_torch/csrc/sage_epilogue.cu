// The dense tail of a GraphSAGE hidden layer, forward and backward, on
// Hopper.
//
// Replaces: no TPU kernel.  `repro` leaves the tail
// (`relu(h_dst @ w_self + agg @ w_neigh + b)` and dropout, in
// src/repro/models/gnn.py) to XLA, which fuses it into the products'
// epilogue; eager PyTorch ran it as a chain of generic elementwise kernels
// (a cat of the row-chunked products, two adds, relu, the dropout compare,
// multiply and divide, and their gradients), each a pass over the layer's
// (rows, H) activations.  This port-only kernel pair is that chain.
//
// What bounds it on this card: bytes.  A handful of float operations an
// element against 16 bytes (forward: the two products and a uniform read,
// the output written) or 12 bytes (backward: the upstream gradient and the
// saved output read, the pre-activation gradient written).
//
// Bits: each element goes through the chain's own fp32 operations in the
// chain's order, rounded to nearest with no contraction (`__fadd_rn`,
// `__fmul_rn`): x = (s + n) + b; y = relu(x) as PyTorch's clamp_min (NaN
// passes); with dropout, keep = u >= p and out = (y * keep) * scale, where
// scale is PyTorch's own reciprocal of (1 - p) in fp32 (a division of a
// CUDA tensor by a host scalar multiplies by it).  The backward recovers
// relu's and the mask's gradient from the saved output alone: out <= 0
// where y <= 0 or the element was dropped (scale >= 1 keeps a kept
// positive y positive), so dx = out <= 0 ? 0 : g * scale, the chain's
// threshold_backward((g * scale) * keep, y, 0) but for the sign of a
// dropped element's zero.
//
// Design: the forward is one flat pass, a float4 a thread where H is a
// multiple of 4 and every pointer 16-byte aligned (a scalar path else).
// The backward also produces the bias gradient without atomics: a block
// walks kTilesPerBlock tiles of rows, writes each tile's dx to device
// memory and to shared memory, and each thread adds its columns of the
// tile to a running column sum in row order; the block writes its column
// sums as one row of `partial` (one row a block), which the wrapper sums.
// The tile's rows depend on H alone, so the bias gradient's order of
// additions depends on the row count and H, never on the card.  Rows past
// `rows` (up to `rows_pad`, the products' zero-padded last row chunk) get
// dx = 0, so the weight gradients' padded chunk products see zeros.
//
// Layout: s, n (rows, H) rows of the products (row stride H); b (H);
// u (rows, H) or null; out (rows, H).  Backward: g, out (rows, H); dx
// (rows_pad, H); partial (blocks, H).  float32 throughout.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;   // a backward tile: its rows * H floats
constexpr int kTilesPerBlock = 4;

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float relu(float v) {
  // PyTorch's clamp_min(v, 0) on the card
  return isnan(v) ? v : fmaxf(v, 0.f);
}

template <int V, bool kDrop>
__global__ void sage_epilogue_kernel(const float* __restrict__ s,
                                     const float* __restrict__ n,
                                     const float* __restrict__ b,
                                     const float* __restrict__ u,
                                     long long total, int HV, float p,
                                     float scale, float* __restrict__ out) {
  using T = typename Vec<V>::T;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % HV);
  float sv[V], nv[V], bv[V], uv[V], ov[V];
  *reinterpret_cast<T*>(sv) = reinterpret_cast<const T*>(s)[i];
  *reinterpret_cast<T*>(nv) = reinterpret_cast<const T*>(n)[i];
  *reinterpret_cast<T*>(bv) = reinterpret_cast<const T*>(b)[c];
  if (kDrop) *reinterpret_cast<T*>(uv) = reinterpret_cast<const T*>(u)[i];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float y = relu(__fadd_rn(__fadd_rn(sv[j], nv[j]), bv[j]));
    if (kDrop) {
      const float keep = uv[j] >= p ? 1.f : 0.f;
      y = __fmul_rn(__fmul_rn(y, keep), scale);
    }
    ov[j] = y;
  }
  reinterpret_cast<T*>(out)[i] = *reinterpret_cast<T*>(ov);
}

template <int V>
__global__ void sage_epilogue_backward_kernel(
    const float* __restrict__ g, const float* __restrict__ out,
    long long rows, long long rows_pad, int H, int tile_rows, float scale,
    float* __restrict__ dx, float* __restrict__ partial) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                          // tile_rows x H
  float* acc = smem + (long long)tile_rows * H;  // H running column sums
  const int HV = H / V;
  for (int c = threadIdx.x; c < H; c += kThreads) acc[c] = 0.f;
  const long long row0 =
      (long long)blockIdx.x * tile_rows * kTilesPerBlock;
  for (int t = 0; t < kTilesPerBlock; ++t) {
    const long long r0 = row0 + (long long)t * tile_rows;
    if (r0 >= rows_pad) break;
    const int nrows =
        rows_pad - r0 < tile_rows ? (int)(rows_pad - r0) : tile_rows;
    for (int k = threadIdx.x; k < nrows * HV; k += kThreads) {
      const int r = k / HV, cv = k % HV;
      const long long e = (r0 + r) * HV + cv;
      float gv[V], ov[V], dv[V];
      if (r0 + r < rows) {
        *reinterpret_cast<T*>(gv) = reinterpret_cast<const T*>(g)[e];
        *reinterpret_cast<T*>(ov) = reinterpret_cast<const T*>(out)[e];
#pragma unroll
        for (int j = 0; j < V; ++j)
          dv[j] = ov[j] <= 0.f ? 0.f : __fmul_rn(gv[j], scale);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dv[j] = 0.f;
      }
      reinterpret_cast<T*>(dx)[e] = *reinterpret_cast<T*>(dv);
      *reinterpret_cast<T*>(tile + r * H + cv * V) =
          *reinterpret_cast<T*>(dv);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < H; c += kThreads) {
      float a = acc[c];
      for (int r = 0; r < nrows; ++r) a = __fadd_rn(a, tile[r * H + c]);
      acc[c] = a;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < H; c += kThreads)
    partial[(long long)blockIdx.x * H + c] = acc[c];
}

int tile_rows_of(int H) { return H >= kTileFloats ? 1 : kTileFloats / H; }

}  // namespace

extern "C" int sage_epilogue_launch(const float* s, const float* n,
                                    const float* b, const float* u,
                                    long long rows, int H, int vec, float p,
                                    float scale, float* out,
                                    cudaStream_t stream) {
  const int V = vec ? 4 : 1;
  const long long total = rows * (H / V);
  if (total == 0) return (int)cudaSuccess;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  const int HV = H / V;
  if (vec && u) {
    sage_epilogue_kernel<4, true><<<blocks, kThreads, 0, stream>>>(
        s, n, b, u, total, HV, p, scale, out);
  } else if (vec) {
    sage_epilogue_kernel<4, false><<<blocks, kThreads, 0, stream>>>(
        s, n, b, u, total, HV, p, scale, out);
  } else if (u) {
    sage_epilogue_kernel<1, true><<<blocks, kThreads, 0, stream>>>(
        s, n, b, u, total, HV, p, scale, out);
  } else {
    sage_epilogue_kernel<1, false><<<blocks, kThreads, 0, stream>>>(
        s, n, b, u, total, HV, p, scale, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int sage_epilogue_backward_blocks(long long rows_pad, int H) {
  const long long per_block = (long long)tile_rows_of(H) * kTilesPerBlock;
  return (int)((rows_pad + per_block - 1) / per_block);
}

extern "C" int sage_epilogue_backward_launch(const float* g, const float* out,
                                             long long rows,
                                             long long rows_pad, int H,
                                             int vec, float scale, float* dx,
                                             float* partial,
                                             cudaStream_t stream) {
  const int blocks = sage_epilogue_backward_blocks(rows_pad, H);
  if (blocks == 0) return (int)cudaSuccess;
  const int tile_rows = tile_rows_of(H);
  const size_t smem = ((size_t)tile_rows * H + H) * sizeof(float);
  auto kernel = vec ? sage_epilogue_backward_kernel<4>
                    : sage_epilogue_backward_kernel<1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(g, out, rows, rows_pad, H,
                                             tile_rows, scale, dx, partial);
  return (int)cudaGetLastError();
}
