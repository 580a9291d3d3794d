// Winograd F(2,3) / F(4,3) tile transforms for the dense 3x3 stride-1
// conv, NHWC. Replaces no Pallas kernel: convnets_tpu/ops/winograd.py is
// an einsum composition that XLA fuses, and these are its two transform
// stages (the a² batched product between them is a cuBLAS call, as the
// JAX package leaves its einsum to XLA). a = m + 2; P = N·th·tw tiles.
//
//  * winograd_input_kernel: x (N, H, W, C) in T → V (a², P, C) in T,
//    V[r, s] = Σ_ij Bᵀ[r,i] d[i,j] Bᵀ[s,j] in fp32, one rounding. d is the
//    tile of the padded input at rows ty·m − ph + i, columns tx·m − pw + j;
//    the conv padding and the bottom/right tile-rounding pad are predicated
//    zero loads, never a padded copy. Grid (ceil(P·C/VEC / 256), a): a
//    block computes one row r of the a×a transform (blockIdx.y, uniform, so
//    the row's coefficients are compile-time constants and the input rows
//    it does not need are never loaded), a thread one tile × VEC channels:
//    s[j] = Σ_i Bᵀ[r,i] d[i,j], then V[r, s] = Σ_j Bᵀ[s,j] s[j]. VEC =
//    16 bytes of T (8 bf16, 4 fp32) where C allows it, else 1.
//  * winograd_output_kernel: M (a², P, O) fp32 → y (N, OH, OW, O) in T,
//    y = Aᵀ M A in fp32 for the m×m outputs of a tile, only the valid ones
//    written, with one of three epilogues, then one rounding:
//      EPI_BIAS   + bias (fp32; none if null): the bare Conv2d;
//      EPI_AFFINE ·scale + shift, then ReLU if asked: the eval ConvBNReLU
//                 site (conv_fused.cu's epilogue);
//      EPI_STATS  y stored, and per block one (2, O) row of partial sums
//                 Σy, Σy² of the STORED (rounded) y, added over the block
//                 in a fixed order in shared memory; conv_fused.cu's
//                 stats_reduce_kernel then adds the rows in a fixed order
//                 (no atomics): the (y, sums) of a train-mode BN site.
//    Block (TX, TY), TX·TY ≤ 256: TX channel units of VEC = 4 channels
//    (16-byte loads of M) or 1, TY tiles; grid (ceil(P / TY), ceil(O/VEC /
//    TX)). A thread keeps the m×m×VEC outputs of its tile in registers and
//    reads each of its a² rows of M once.
//
// What bounds them on the H100: memory. The input kernel writes V, a²/m²
// times x's values (4× at m = 2, 2.25× at m = 4); the output kernel reads
// the fp32 M, 2·a²/m² times y's bytes in bf16. Each moves its bytes once
// through device memory (the rows a thread reads again come from L1/L2);
// V and M themselves are the cost of the unfused design: a fused kernel
// would keep them on chip (PERF.md §6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int EPI_BIAS = 0, EPI_AFFINE = 1, EPI_STATS = 2;

// Lavin & Gray's Bᵀ and Aᵀ (ops/winograd.py); indices are compile-time
// constants after unrolling, so the tables fold into the code
template <int M> __device__ __forceinline__ float bt(int r, int c);
template <> __device__ __forceinline__ float bt<2>(int r, int c) {
  const float t[4][4] = {{1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
  return t[r][c];
}
template <> __device__ __forceinline__ float bt<4>(int r, int c) {
  const float t[6][6] = {{4, 0, -5, 0, 1, 0},   {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
                         {0, -2, -1, 2, 1, 0},  {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
  return t[r][c];
}
template <int M> __device__ __forceinline__ float at(int r, int c);
template <> __device__ __forceinline__ float at<2>(int r, int c) {
  const float t[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
  return t[r][c];
}
template <> __device__ __forceinline__ float at<4>(int r, int c) {
  const float t[4][6] = {{1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 0}, {0, 1, 1, 4, 4, 0},
                         {0, 1, -1, 8, -8, 1}};
  return t[r][c];
}

// VEC values of T at p as floats (zeros if !ok); VEC·sizeof(T) is 16 or VEC is 1
template <typename T, int VEC> __device__ __forceinline__ void load(float* d, const T* p,
                                                                    bool ok);
template <> __device__ __forceinline__ void load<float, 1>(float* d, const float* p, bool ok) {
  d[0] = ok ? *p : 0.f;
}
template <> __device__ __forceinline__ void load<float, 4>(float* d, const float* p, bool ok) {
  const float4 v = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
template <> __device__ __forceinline__ void load<__nv_bfloat16, 1>(float* d,
                                                                  const __nv_bfloat16* p,
                                                                  bool ok) {
  d[0] = ok ? __bfloat162float(*p) : 0.f;
}
template <> __device__ __forceinline__ void load<__nv_bfloat16, 8>(float* d,
                                                                  const __nv_bfloat16* p,
                                                                  bool ok) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (ok) v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    d[2 * k] = f.x;
    d[2 * k + 1] = f.y;
  }
}

// VEC floats rounded to T and stored at p (VEC·sizeof(T) of 4, 8 or 16 bytes, or VEC 1)
template <typename T, int VEC> __device__ __forceinline__ void store(T* p, const float* v);
template <> __device__ __forceinline__ void store<float, 1>(float* p, const float* v) {
  *p = v[0];
}
template <> __device__ __forceinline__ void store<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                                   const float* v) {
  *p = __float2bfloat16_rn(v[0]);
}
template <> __device__ __forceinline__ void store<__nv_bfloat16, 4>(__nv_bfloat16* p,
                                                                   const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}
template <> __device__ __forceinline__ void store<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                                   const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// the value T stores for v, as a float
template <typename T> __device__ __forceinline__ float stored(float v);
template <> __device__ __forceinline__ float stored<float>(float v) { return v; }
template <> __device__ __forceinline__ float stored<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct InShape {
  int n, h, w, c, th, tw, ph, pw;
};

// row R of the a×a input transform for one tile and VEC channels
template <typename T, int M, int VEC, int R>
__device__ __forceinline__ void input_row(const T* __restrict__ x, T* __restrict__ v,
                                          const InShape& s, int p, int c0, int tiles) {
  constexpr int A = M + 2;
  const int tx = p % s.tw;
  const int ty = (p / s.tw) % s.th;
  const int n = p / (s.tw * s.th);
  const int y0 = ty * M - s.ph, x0 = tx * M - s.pw;
  float acc[A][VEC];
#pragma unroll
  for (int j = 0; j < A; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[j][k] = 0.f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const float b = bt<M>(R, i);
    if (b == 0.f) continue;
    const int yy = y0 + i;
    const bool row_ok = yy >= 0 && yy < s.h;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const int xx = x0 + j;
      const bool ok = row_ok && xx >= 0 && xx < s.w;
      float d[VEC];
      load<T, VEC>(d, ok ? x + ((n * s.h + yy) * s.w + xx) * s.c + c0 : x, ok);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[j][k] += b * d[k];
    }
  }
#pragma unroll
  for (int q = 0; q < A; ++q) {
    float out[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = 0.f;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const float b = bt<M>(q, j);
      if (b == 0.f) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] += b * acc[j][k];
    }
    store<T, VEC>(v + (static_cast<int64_t>(R * A + q) * tiles + p) * s.c + c0, out);
  }
}

template <typename T, int M, int VEC>
__global__ void __launch_bounds__(THREADS)
winograd_input_kernel(const T* __restrict__ x, T* __restrict__ v, InShape s) {
  const int tiles = s.n * s.th * s.tw;
  const int units = s.c / VEC;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= tiles * units) return;
  const int p = t / units, c0 = (t % units) * VEC;
  switch (blockIdx.y) {
    case 0: input_row<T, M, VEC, 0>(x, v, s, p, c0, tiles); break;
    case 1: input_row<T, M, VEC, 1>(x, v, s, p, c0, tiles); break;
    case 2: input_row<T, M, VEC, 2>(x, v, s, p, c0, tiles); break;
    case 3: input_row<T, M, VEC, 3>(x, v, s, p, c0, tiles); break;
    case 4: if constexpr (M == 4) input_row<T, M, VEC, 4>(x, v, s, p, c0, tiles); break;
    case 5: if constexpr (M == 4) input_row<T, M, VEC, 5>(x, v, s, p, c0, tiles); break;
  }
}

struct OutShape {
  int n, oh, ow, o, th, tw;
};

template <typename T, int M, int VEC, int EPI>
__global__ void __launch_bounds__(THREADS)
winograd_output_kernel(const float* __restrict__ mm, T* __restrict__ y,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       float* __restrict__ partial, OutShape s, int relu) {
  constexpr int A = M + 2;
  extern __shared__ float red[];  // EPI_STATS: [2][TY][TX·VEC]
  const int tiles = s.n * s.th * s.tw;
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const bool live = p < tiles && c0 < s.o;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  if (live) {
    float acc[M][M][VEC];
#pragma unroll
    for (int u = 0; u < M; ++u)
#pragma unroll
      for (int q = 0; q < M; ++q)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[u][q][k] = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float row[A][VEC];
#pragma unroll
      for (int b = 0; b < A; ++b)
        load<float, VEC>(row[b], mm + (static_cast<int64_t>(a * A + b) * tiles + p) * s.o + c0,
                         true);
      // Mᵀ-side: t[q] = Σ_b Aᵀ[q,b]·M[a,b], then acc[u][q] += Aᵀ[u,a]·t[q]
#pragma unroll
      for (int q = 0; q < M; ++q) {
        float t[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] = 0.f;
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const float c = at<M>(q, b);
          if (c == 0.f) continue;
#pragma unroll
          for (int k = 0; k < VEC; ++k) t[k] += c * row[b][k];
        }
#pragma unroll
        for (int u = 0; u < M; ++u) {
          const float c = at<M>(u, a);
          if (c == 0.f) continue;
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[u][q][k] += c * t[k];
        }
      }
    }
    const int tx = p % s.tw;
    const int ty = (p / s.tw) % s.th;
    const int n = p / (s.tw * s.th);
    // EPI_BIAS: e0 the bias (0 without one); EPI_AFFINE: e0 scale, e1 shift
    float e0[VEC], e1[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      e0[k] = EPI != EPI_STATS && scale != nullptr ? scale[c0 + k] : 0.f;
      e1[k] = EPI == EPI_AFFINE ? shift[c0 + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int oy = ty * M + u;
      if (oy >= s.oh) break;
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const int ox = tx * M + q;
        if (ox >= s.ow) break;
        float out[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float val = acc[u][q][k];
          if (EPI == EPI_BIAS) val = val + e0[k];
          if (EPI == EPI_AFFINE) {
            val = val * e0[k] + e1[k];
            if (relu) val = fmaxf(val, 0.f);
          }
          out[k] = val;
        }
        store<T, VEC>(y + ((static_cast<int64_t>(n) * s.oh + oy) * s.ow + ox) * s.o + c0, out);
        if (EPI == EPI_STATS) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float r = stored<T>(out[k]);
            s1[k] += r;
            s2[k] += r * r;
          }
        }
      }
    }
  }
  if (EPI != EPI_STATS) return;
  // the block's partial row: its TY tiles added in order, per channel
  const int width = blockDim.x * VEC;
  float* r1 = red;
  float* r2 = red + blockDim.y * width;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    r1[threadIdx.y * width + threadIdx.x * VEC + k] = s1[k];
    r2[threadIdx.y * width + threadIdx.x * VEC + k] = s2[k];
  }
  __syncthreads();
  for (int idx = threadIdx.y * blockDim.x + threadIdx.x; idx < width;
       idx += blockDim.x * blockDim.y) {
    const int c = blockIdx.y * width + idx;
    if (c >= s.o) continue;
    float t1 = 0.f, t2 = 0.f;
    for (int yy = 0; yy < static_cast<int>(blockDim.y); ++yy) {
      t1 += r1[yy * width + idx];
      t2 += r2[yy * width + idx];
    }
    partial[(static_cast<int64_t>(blockIdx.x) * 2) * s.o + c] = t1;
    partial[(static_cast<int64_t>(blockIdx.x) * 2 + 1) * s.o + c] = t2;
  }
}

template <typename T, int M>
int launch_input(const void* x, void* v, const InShape& s, int vec, cudaStream_t stream) {
  const int units = vec ? s.c / static_cast<int>(16 / sizeof(T)) : s.c;
  const int64_t threads = static_cast<int64_t>(s.n) * s.th * s.tw * units;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS), M + 2);
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(v);
  if (vec)
    winograd_input_kernel<T, M, static_cast<int>(16 / sizeof(T))>
        <<<grid, THREADS, 0, stream>>>(xt, vt, s);
  else
    winograd_input_kernel<T, M, 1><<<grid, THREADS, 0, stream>>>(xt, vt, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M, int VEC>
int launch_output_vec(const void* mm, void* y, const void* scale, const void* shift,
                      void* partial, const OutShape& s, int epi, int relu, int tx, int ty,
                      cudaStream_t stream) {
  const int tiles = s.n * s.th * s.tw;
  const int units = (s.o + VEC - 1) / VEC;
  const dim3 grid((tiles + ty - 1) / ty, (units + tx - 1) / tx);
  const dim3 block(tx, ty);
  const float* m = static_cast<const float*>(mm);
  T* yt = static_cast<T*>(y);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* pa = static_cast<float*>(partial);
  if (epi == EPI_BIAS)
    winograd_output_kernel<T, M, VEC, EPI_BIAS><<<grid, block, 0, stream>>>(m, yt, sc, nullptr,
                                                                           nullptr, s, 0);
  else if (epi == EPI_AFFINE)
    winograd_output_kernel<T, M, VEC, EPI_AFFINE><<<grid, block, 0, stream>>>(m, yt, sc, sh,
                                                                             nullptr, s, relu);
  else
    winograd_output_kernel<T, M, VEC, EPI_STATS>
        <<<grid, block, 2 * tx * ty * VEC * sizeof(float), stream>>>(m, yt, nullptr, nullptr, pa,
                                                                     s, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
int launch_output(const void* mm, void* y, const void* scale, const void* shift, void* partial,
                  const OutShape& s, int vec, int epi, int relu, int tx, int ty,
                  cudaStream_t stream) {
  return vec ? launch_output_vec<T, M, 4>(mm, y, scale, shift, partial, s, epi, relu, tx, ty,
                                          stream)
             : launch_output_vec<T, M, 1>(mm, y, scale, shift, partial, s, epi, relu, tx, ty,
                                          stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; m 2 or 4; vec 1: 16-byte units along C
// (C a multiple of 16 / sizeof(T), x and v 16-byte aligned), 0: one value.
// v: (a², n·th·tw, c). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments no kernel is built for.
extern "C" int winograd_input_launch(int dtype, const void* x, void* v, int n, int h, int w,
                                     int c, int th, int tw, int ph, int pw, int m, int vec,
                                     void* stream) {
  const InShape s{n, h, w, c, th, tw, ph, pw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && m == 2) return launch_input<float, 2>(x, v, s, vec, st);
  if (dtype == 0 && m == 4) return launch_input<float, 4>(x, v, s, vec, st);
  if (dtype == 1 && m == 2) return launch_input<__nv_bfloat16, 2>(x, v, s, vec, st);
  if (dtype == 1 && m == 4) return launch_input<__nv_bfloat16, 4>(x, v, s, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// mm: (a², n·th·tw, o) fp32 → y (n, oh, ow, o) in dtype. epi 0: + scale as
// the bias (null: none); 1: ·scale + shift, ReLU if relu; 2: partial
// (ceil(n·th·tw / ty), 2, o) fp32 rows of Σy, Σy² of the stored y. vec 1:
// 4 channels a thread (o % 4 == 0, mm and y aligned), 0: one. Block (tx,
// ty), tx·ty <= 256. Returns as winograd_input_launch.
extern "C" int winograd_output_launch(int dtype, const void* mm, void* y, const void* scale,
                                      const void* shift, void* partial, int n, int oh, int ow,
                                      int o, int th, int tw, int m, int vec, int epi, int relu,
                                      int tx, int ty, void* stream) {
  const OutShape s{n, oh, ow, o, th, tw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tx < 1 || ty < 1 || tx * ty > THREADS || epi < EPI_BIAS || epi > EPI_STATS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && m == 2)
    return launch_output<float, 2>(mm, y, scale, shift, partial, s, vec, epi, relu, tx, ty, st);
  if (dtype == 0 && m == 4)
    return launch_output<float, 4>(mm, y, scale, shift, partial, s, vec, epi, relu, tx, ty, st);
  if (dtype == 1 && m == 2)
    return launch_output<__nv_bfloat16, 2>(mm, y, scale, shift, partial, s, vec, epi, relu, tx,
                                           ty, st);
  if (dtype == 1 && m == 4)
    return launch_output<__nv_bfloat16, 4>(mm, y, scale, shift, partial, s, vec, epi, relu, tx,
                                           ty, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
