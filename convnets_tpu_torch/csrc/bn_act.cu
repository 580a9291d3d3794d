// Batch-stat BN -> [ReLU] after the statistics conv, forward and backward,
// over the conv output y of a train-mode conv -> BN -> [ReLU] site, seen as
// (M, C) rows (NHWC). Replaces the part of
// convnets_tpu/ops/pallas/fused.py:conv_bn_relu_train that XLA fuses
// around the conv2d_stats kernel there (_fused_fwd_impl :49-60 and
// _fused_bwd :70-103): the statistics, the normalize and ReLU, and the BN
// VJP. The conv with its sums (conv2d_stats, rows 5/5g) and the conv's
// backward (cuDNN) stay as they are.
//
//  * bn_act_forward_kernel: each block first finishes the statistics of
//    its tile of channels in shared memory from the conv kernel's (2, C)
//    row of sums: mean = Σy·(1/n), var = max(Σy²·(1/n) − mean², 0), inv =
//    rsqrt(var + eps); then the fold of ops/norm.py:_apply_norm. The blocks
//    of row-block 0 write mean, var and inv (C,) for the running update
//    and the backward. Then it reads y once and writes out = relu(z) once.
//  * bn_act_sums_kernel: reads g and y, recomputes z (the ReLU mask) and
//    x̂ through the same __device__ functions as the forward, and writes one
//    fp32 (2, C) row of partial sums per block: Σdz, Σdz·x̂. conv_fused.cu's
//    stats_reduce_kernel adds the rows in a fixed order (no atomics, so a
//    replayed step is bit for bit the same).
//  * bn_act_apply_kernel: reads g and y again and writes
//    dy = γ·inv · ((dz − Σdz/n) − x̂·(Σdz·x̂/n)).
//
// Rounding: the plain version's sequence on the card, one op at a time,
// each an _rn intrinsic so that nothing is contracted into an FMA. A
// division by the count is a product with its fp32 reciprocal, as
// PyTorch's CUDA division by a host scalar computes it. bf16:
// z = bf16(bf16(y·bf16(w)) + bf16(shift)), x̂ = bf16(bf16(y − bf16(mean))
// · bf16(inv)), dy = bf16(bf16(γ·inv) · bf16(bf16(dz − a) − bf16(x̂·b)))
// with a, b the two sums over n rounded to bf16; fp32: z = ((y − mean)·w)
// + bias and the same dy in fp32. The sums are fp32 of the rounded values.
//
// What bounds it on the H100: memory. For a y of T bytes the forward must
// read y and write out (2T), the backward read g and y and write dy (3T);
// reading g and y a second time, as the apply kernel does, makes it 5T.
// Nothing but y, mean and inv is kept from the forward: z and x̂ are
// recomputed from y instead of being stored and read back.
//
// Layout: a block has 256 threads, TX channel units wide (a unit is 8
// channels on the "vector" route, in 16-byte loads, 1 on the "loop" route)
// and 256 / TX rows tall; grid (row blocks, ceil(units / TX)), each block
// striding over the rows. Every thread keeps its channels for the whole
// kernel. ops/kernels/bn_act.py:bn_act_plan picks TX and the row blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;  // channels of a block's tile: TX · V <= 256

__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x rounded to the compute dtype T, as a float
template <typename T> __device__ __forceinline__ float rd(float v);
template <> __device__ __forceinline__ float rd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rd<__nv_bfloat16>(float v) { return round_bf(v); }

// V consecutive channels as fp32 (V = 8: 16-byte loads; V = 1: one value)
template <int V> __device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V> __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(q[i] << 16);
      v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V> __device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    p[0] = v[0];
  }
}

template <int V> __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
      q[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// fp32 1/n, as PyTorch's CUDA division by a host integer computes it
__device__ __forceinline__ float recip(int n) { return __fdiv_rn(1.0f, __int2float_rn(n)); }

// clamp_min(v, 0): NaN stays NaN
__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// mean, biased var and rsqrt(var + eps) from Σy, Σy² (fused.py:43-45)
__device__ __forceinline__ void finish_stats(float s1, float s2, float rn, float eps,
                                             float& mean, float& var, float& inv) {
  mean = __fmul_rn(s1, rn);
  var = clamp0(__fsub_rn(__fmul_rn(s2, rn), __fmul_rn(mean, mean)));
  inv = rsqrtf(__fadd_rn(var, eps));
}

// The per-channel constants of z = _apply_norm(y, mean, inv, scale, bias)
// in T: fp32 keeps (mean, w, bias) for ((y − mean)·w) + bias; bf16 keeps
// (·, bf16(w), bf16(shift)) with w = scale·inv, shift = (−mean)·w + bias.
template <typename T>
__device__ __forceinline__ void fold(float mean, float inv, float scale, float bias, float& k0,
                                     float& k1, float& k2) {
  const float w = __fmul_rn(scale, inv);
  k0 = mean;
  if constexpr (sizeof(T) == 4) {
    k1 = w;
    k2 = bias;
  } else {
    k1 = round_bf(w);
    k2 = round_bf(__fadd_rn(__fmul_rn(-mean, w), bias));
  }
}

// z in T (as a float) from the constants of fold<T>
template <typename T>
__device__ __forceinline__ float normalize(float y, float k0, float k1, float k2) {
  if constexpr (sizeof(T) == 4) {
    return __fadd_rn(__fmul_rn(__fsub_rn(y, k0), k1), k2);
  } else {
    return round_bf(__fadd_rn(round_bf(__fmul_rn(y, k1)), k2));
  }
}

// x̂ = (y − T(mean))·T(inv) in T, from mean and inv already rounded to T
template <typename T> __device__ __forceinline__ float xhat(float y, float mean, float inv) {
  return rd<T>(__fmul_rn(rd<T>(__fsub_rn(y, mean)), inv));
}

// the thread's place: its channel unit (blockIdx.y·TX + tx) and its first
// row; `active` is false for the threads beyond 256 / TX rows and for the
// units past C (the loop route's ragged tile)
struct Place {
  int tx, ty, rows, first_ch;
  bool active;
};

template <int V> __device__ __forceinline__ Place place(int tx_n, int c) {
  Place p;
  p.tx = threadIdx.x % tx_n;
  p.ty = threadIdx.x / tx_n;
  p.rows = THREADS / tx_n;
  p.first_ch = (blockIdx.y * tx_n + p.tx) * V;
  p.active = p.ty < p.rows && p.first_ch < c;
  return p;
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS, 4)
bn_act_forward_kernel(const T* __restrict__ y, const float* __restrict__ sums,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      T* __restrict__ out, float* __restrict__ mean_out,
                      float* __restrict__ var_out, float* __restrict__ inv_out, int m, int c,
                      int n, float eps, int tx_n) {
  __shared__ float k[3][TILE];
  const int tile0 = blockIdx.y * tx_n * V;
  const int t = threadIdx.x;
  if (t < tx_n * V && tile0 + t < c) {
    const int ch = tile0 + t;
    float mean, var, inv;
    finish_stats(sums[ch], sums[c + ch], recip(n), eps, mean, var, inv);
    if (blockIdx.x == 0) {
      mean_out[ch] = mean;
      var_out[ch] = var;
      inv_out[ch] = inv;
    }
    fold<T>(mean, inv, scale[ch], bias[ch], k[0][t], k[1][t], k[2][t]);
  }
  __syncthreads();
  const Place p = place<V>(tx_n, c);
  if (!p.active) return;
  float k0[V], k1[V], k2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    k0[e] = k[0][p.tx * V + e];
    k1[e] = k[1][p.tx * V + e];
    k2[e] = k[2][p.tx * V + e];
  }
  for (int r = blockIdx.x * p.rows + p.ty; r < m; r += gridDim.x * p.rows) {
    const size_t off = static_cast<size_t>(r) * c + p.first_ch;
    float v[V];
    load<V>(y + off, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = normalize<T>(v[e], k0[e], k1[e], k2[e]);
      v[e] = RELU ? clamp0(z) : z;
    }
    store<V>(out + off, v);
  }
}

// The backward's per-channel constants for x̂ and the mask: T(mean),
// T(inv) and fold<T>'s three, into shared memory for the block's tile.
template <typename T>
__device__ __forceinline__ void backward_consts(const float* mean, const float* inv,
                                                const float* scale, const float* bias, int ch,
                                                float (&k)[5][TILE], int t) {
  k[0][t] = rd<T>(mean[ch]);
  k[1][t] = rd<T>(inv[ch]);
  fold<T>(mean[ch], inv[ch], scale[ch], bias[ch], k[2][t], k[3][t], k[4][t]);
}

// dz = g where z > 0 (else 0) with RELU; g itself without
template <typename T, bool RELU>
__device__ __forceinline__ float masked(float g, float y, float k0, float k1, float k2) {
  if constexpr (RELU) {
    return normalize<T>(y, k0, k1, k2) > 0.0f ? g : 0.0f;
  } else {
    return g;
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS, 4)
bn_act_sums_kernel(const T* __restrict__ g, const T* __restrict__ y,
                   const float* __restrict__ mean, const float* __restrict__ inv,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ partial, int m, int c, int tx_n) {
  __shared__ float k[5][TILE];
  __shared__ float red[2][THREADS * V];
  const int tile = tx_n * V;
  const int tile0 = blockIdx.y * tile;
  const int t = threadIdx.x;
  if (t < tile && tile0 + t < c) backward_consts<T>(mean, inv, scale, bias, tile0 + t, k, t);
  __syncthreads();
  const Place p = place<V>(tx_n, c);
  float s0[V], s1[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s0[e] = s1[e] = 0.0f;
  if (p.active) {
    for (int r = blockIdx.x * p.rows + p.ty; r < m; r += gridDim.x * p.rows) {
      const size_t off = static_cast<size_t>(r) * c + p.first_ch;
      float gv[V], yv[V];
      load<V>(g + off, gv);
      load<V>(y + off, yv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = p.tx * V + e;
        const float dz = masked<T, RELU>(gv[e], yv[e], k[2][i], k[3][i], k[4][i]);
        s0[e] = __fadd_rn(s0[e], dz);
        s1[e] = __fadd_rn(s1[e], __fmul_rn(dz, xhat<T>(yv[e], k[0][i], k[1][i])));
      }
    }
  }
  if (p.ty < p.rows) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[0][p.ty * tile + p.tx * V + e] = s0[e];
      red[1][p.ty * tile + p.tx * V + e] = s1[e];
    }
  }
  __syncthreads();
  // the block's rows added in a fixed order, one (2, tile) row per block
  for (int j = t; j < 2 * tile; j += THREADS) {
    const int st = j / tile;
    const int cl = j % tile;
    if (tile0 + cl >= c) continue;
    float sum = 0.0f;
    for (int row = 0; row < THREADS / tx_n; ++row) sum = __fadd_rn(sum, red[st][row * tile + cl]);
    partial[(static_cast<size_t>(blockIdx.x) * 2 + st) * c + tile0 + cl] = sum;
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS, 4)
bn_act_apply_kernel(const T* __restrict__ g, const T* __restrict__ y,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ sums, T* __restrict__ dy, int m, int c, int n,
                    int tx_n) {
  __shared__ float k[5][TILE];
  __shared__ float ka[3][TILE];  // T(Σdz/n), T(Σdz·x̂/n), T(scale·inv)
  const int tile0 = blockIdx.y * tx_n * V;
  const int t = threadIdx.x;
  if (t < tx_n * V && tile0 + t < c) {
    const int ch = tile0 + t;
    const float rn = recip(n);
    backward_consts<T>(mean, inv, scale, bias, ch, k, t);
    ka[0][t] = rd<T>(__fmul_rn(sums[ch], rn));
    ka[1][t] = rd<T>(__fmul_rn(sums[c + ch], rn));
    ka[2][t] = rd<T>(__fmul_rn(scale[ch], inv[ch]));
  }
  __syncthreads();
  const Place p = place<V>(tx_n, c);
  if (!p.active) return;
  for (int r = blockIdx.x * p.rows + p.ty; r < m; r += gridDim.x * p.rows) {
    const size_t off = static_cast<size_t>(r) * c + p.first_ch;
    float gv[V], yv[V];
    load<V>(g + off, gv);
    load<V>(y + off, yv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = p.tx * V + e;
      const float dz = masked<T, RELU>(gv[e], yv[e], k[2][i], k[3][i], k[4][i]);
      const float xh = xhat<T>(yv[e], k[0][i], k[1][i]);
      const float d = rd<T>(__fsub_rn(rd<T>(__fsub_rn(dz, ka[0][i])),
                                      rd<T>(__fmul_rn(xh, ka[1][i]))));
      gv[e] = __fmul_rn(ka[2][i], d);
    }
    store<V>(dy + off, gv);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// grid (row blocks, channel tiles), or a zero grid for a plan that is not built
dim3 grid_of(int route, int c, int tx_n, int rowblocks) {
  const int v = route == 1 ? 8 : 1;
  if ((route != 0 && route != 1) || c <= 0 || (route == 1 && c % 8 != 0) || tx_n < 1 ||
      tx_n > 32 || tx_n * v > TILE || rowblocks < 1) {
    return dim3(0, 0, 1);
  }
  const int units = c / v;
  return dim3(rowblocks, (units + tx_n - 1) / tx_n, 1);
}

template <typename T, int V>
void forward_run(dim3 grid, cudaStream_t st, int relu, const void* y, const void* sums,
                 const void* scale, const void* bias, void* out, void* mean, void* var,
                 void* inv, int m, int c, int n, float eps, int tx_n) {
  const T* yp = static_cast<const T*>(y);
  const float* sp = static_cast<const float*>(sums);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  float* mp = static_cast<float*>(mean);
  float* vp = static_cast<float*>(var);
  float* ip = static_cast<float*>(inv);
  if (relu) {
    bn_act_forward_kernel<T, V, true><<<grid, THREADS, 0, st>>>(yp, sp, sc, bi, op, mp, vp, ip,
                                                                 m, c, n, eps, tx_n);
  } else {
    bn_act_forward_kernel<T, V, false><<<grid, THREADS, 0, st>>>(yp, sp, sc, bi, op, mp, vp, ip,
                                                                  m, c, n, eps, tx_n);
  }
}

template <typename T, int V>
void sums_run(dim3 grid, cudaStream_t st, int relu, const void* g, const void* y,
              const void* mean, const void* inv, const void* scale, const void* bias,
              void* partial, int m, int c, int tx_n) {
  const T* gp = static_cast<const T*>(g);
  const T* yp = static_cast<const T*>(y);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(partial);
  if (relu) {
    bn_act_sums_kernel<T, V, true><<<grid, THREADS, 0, st>>>(gp, yp, mp, ip, sc, bi, pp, m, c,
                                                              tx_n);
  } else {
    bn_act_sums_kernel<T, V, false><<<grid, THREADS, 0, st>>>(gp, yp, mp, ip, sc, bi, pp, m, c,
                                                               tx_n);
  }
}

template <typename T, int V>
void apply_run(dim3 grid, cudaStream_t st, int relu, const void* g, const void* y,
               const void* mean, const void* inv, const void* scale, const void* bias,
               const void* sums, void* dy, int m, int c, int n, int tx_n) {
  const T* gp = static_cast<const T*>(g);
  const T* yp = static_cast<const T*>(y);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* sp = static_cast<const float*>(sums);
  T* dp = static_cast<T*>(dy);
  if (relu) {
    bn_act_apply_kernel<T, V, true><<<grid, THREADS, 0, st>>>(gp, yp, mp, ip, sc, bi, sp, dp, m,
                                                               c, n, tx_n);
  } else {
    bn_act_apply_kernel<T, V, false><<<grid, THREADS, 0, st>>>(gp, yp, mp, ip, sc, bi, sp, dp,
                                                                m, c, n, tx_n);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. y, out (M, C) in dtype; sums (2, C)
// fp32 [Σy; Σy²] over the n values of each channel (n: the global count
// under a data-parallel mesh, M this rank's rows); scale, bias (C,) fp32;
// mean, var, inv (C,) fp32 out: the mean, the biased var and rsqrt(var +
// eps). route: 0 = loop, 1 =
// vector (C % 8 == 0, y and out 16-byte aligned); tx, rowblocks: the plan
// of bn_act_plan. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan that is not built.
extern "C" int bn_act_forward_launch(int dtype, const void* y, const void* sums,
                                     const void* scale, const void* bias, void* out,
                                     void* mean, void* var, void* inv, int m, int c, int n,
                                     float eps, int relu, int route, int tx, int rowblocks,
                                     void* stream) {
  const dim3 grid = grid_of(route, c, tx, rowblocks);
  if (grid.x == 0 || (route == 1 && !(aligned16(y) && aligned16(out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && route == 1) {
    forward_run<float, 8>(grid, st, relu, y, sums, scale, bias, out, mean, var, inv, m, c, n,
                          eps, tx);
  } else if (dtype == 0) {
    forward_run<float, 1>(grid, st, relu, y, sums, scale, bias, out, mean, var, inv, m, c, n,
                          eps, tx);
  } else if (dtype == 1 && route == 1) {
    forward_run<__nv_bfloat16, 8>(grid, st, relu, y, sums, scale, bias, out, mean, var, inv, m,
                                  c, n, eps, tx);
  } else if (dtype == 1) {
    forward_run<__nv_bfloat16, 1>(grid, st, relu, y, sums, scale, bias, out, mean, var, inv, m,
                                  c, n, eps, tx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g, y (M, C) in dtype; mean, inv (C,) fp32 as the forward wrote them;
// partial (rowblocks, 2, C) fp32 out: per block Σdz, Σdz·x̂, which
// stats_reduce_launch then adds. Returns as bn_act_forward_launch.
extern "C" int bn_act_sums_launch(int dtype, const void* g, const void* y, const void* mean,
                                  const void* inv, const void* scale, const void* bias,
                                  void* partial, int m, int c, int relu, int route, int tx,
                                  int rowblocks, void* stream) {
  const dim3 grid = grid_of(route, c, tx, rowblocks);
  if (grid.x == 0 || (route == 1 && !(aligned16(g) && aligned16(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && route == 1) {
    sums_run<float, 8>(grid, st, relu, g, y, mean, inv, scale, bias, partial, m, c, tx);
  } else if (dtype == 0) {
    sums_run<float, 1>(grid, st, relu, g, y, mean, inv, scale, bias, partial, m, c, tx);
  } else if (dtype == 1 && route == 1) {
    sums_run<__nv_bfloat16, 8>(grid, st, relu, g, y, mean, inv, scale, bias, partial, m, c, tx);
  } else if (dtype == 1) {
    sums_run<__nv_bfloat16, 1>(grid, st, relu, g, y, mean, inv, scale, bias, partial, m, c, tx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// sums (2, C) fp32 [Σdz; Σdz·x̂] over the n values of each channel (the
// global ones under a mesh); dy (M, C) out in dtype. Returns as
// bn_act_forward_launch.
extern "C" int bn_act_apply_launch(int dtype, const void* g, const void* y, const void* mean,
                                   const void* inv, const void* scale, const void* bias,
                                   const void* sums, void* dy, int m, int c, int n, int relu,
                                   int route, int tx, int rowblocks, void* stream) {
  const dim3 grid = grid_of(route, c, tx, rowblocks);
  if (grid.x == 0 || (route == 1 && !(aligned16(g) && aligned16(y) && aligned16(dy)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && route == 1) {
    apply_run<float, 8>(grid, st, relu, g, y, mean, inv, scale, bias, sums, dy, m, c, n, tx);
  } else if (dtype == 0) {
    apply_run<float, 1>(grid, st, relu, g, y, mean, inv, scale, bias, sums, dy, m, c, n, tx);
  } else if (dtype == 1 && route == 1) {
    apply_run<__nv_bfloat16, 8>(grid, st, relu, g, y, mean, inv, scale, bias, sums, dy, m, c, n,
                                tx);
  } else if (dtype == 1) {
    apply_run<__nv_bfloat16, 1>(grid, st, relu, g, y, mean, inv, scale, bias, sums, dy, m, c, n,
                                tx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
