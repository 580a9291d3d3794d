// Implicit-GEMM 2-D convolution with a fused per-channel scale/shift
// (inference BatchNorm folded in) and optional ReLU epilogue.
//
// Replaces convnets_tpu/ops/pallas/conv.py:conv2d_fused (_conv_kernel and
// the slab-tiled _conv_tiled_kernel). Same contract: x NHWC, w HWIO
// flattened to (kh*kw*Cin, Cout), fp32 accumulation, y = acc*scale + shift
// in fp32, optional ReLU, ONE rounding to the output dtype. Strides and
// padding are addressed directly: there is no space-to-depth rewrite, no
// 1x1 decimation and no padded copy of the input.
//
// GEMM view: rows M = N*OH*OW output pixels, columns Cout, depth
// K = kh*kw*Cin. A block owns a BM x BN output tile and walks K in BK
// steps; each step gathers the input window (A, zero outside the image)
// and a weight tile (B) into shared memory as fp32, and every thread
// accumulates a TM x TN micro-tile in registers. The next step's global
// loads are issued before the current step's FMAs (register prefetch).
//
// What bounds it on the H100: the FMAs run on the CUDA cores (fp32 SIMT),
// so at RN50 widths it is compute-bound at a fraction of the tensor-core
// rate. Left for later: wgmma on bf16 tiles fed by TMA through a
// multi-stage shared-memory ring, and a persistent tile scheduler.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction depth per step
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_ROWS = BM / (THREADS / BK);     // 8 pixels gathered per thread
constexpr int APAD = BM + 4;
constexpr int BPAD = BN + 4;

static_assert(THREADS == 256, "loader mapping assumes 256 threads");
static_assert(BK * BN == THREADS * 4, "B loader moves 4 values per thread");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct ConvShape {
  int n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_fused_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ y,
                  ConvShape s, int relu) {
  __shared__ __align__(16) float As[BK][APAD];
  __shared__ __align__(16) float Bs[BK][BPAD];

  const int tid = threadIdx.x;
  const int M = s.n * s.oh * s.ow;
  const int K = s.kh * s.kw * s.cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A gather: thread reads depth a_k of pixels a_m + 16*r. Neighbouring
  // threads read neighbouring channels of one pixel (coalesced in NHWC).
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_base[A_ROWS], a_ih[A_ROWS], a_iw[A_ROWS];
#pragma unroll
  for (int r = 0; r < A_ROWS; ++r) {
    const int m = m0 + a_m + r * (THREADS / BK);
    if (m < M) {
      const int ox = m % s.ow;
      const int t = m / s.ow;
      const int oy = t % s.oh;
      const int ni = t / s.oh;
      a_base[r] = ni * s.h * s.w * s.cin;
      a_ih[r] = oy * s.sh - s.ph;
      a_iw[r] = ox * s.sw - s.pw;
    } else {
      a_base[r] = 0;
      a_ih[r] = -(1 << 28);  // never inside the image
      a_iw[r] = 0;
    }
  }
  // B load: 4 consecutive output channels of one depth row.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  float a_reg[A_ROWS];
  float b_reg[4];

  auto gather = [&](int k0) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / s.cin : 0;
    const int ci = k - tap * s.cin;
    const int ky = tap / s.kw;
    const int kx = tap - ky * s.kw;
#pragma unroll
    for (int r = 0; r < A_ROWS; ++r) {
      const int ih = a_ih[r] + ky;
      const int iw = a_iw[r] + kx;
      float v = 0.f;
      if (k_ok && (unsigned)ih < (unsigned)s.h && (unsigned)iw < (unsigned)s.w)
        v = to_f(x[a_base[r] + (ih * s.w + iw) * s.cin + ci]);
      a_reg[r] = v;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + b_n + j;
      b_reg[j] = (kb < K && c < s.cout) ? to_f(wt[kb * s.cout + c]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  gather(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < A_ROWS; ++r) As[a_k][a_m + r * (THREADS / BK)] = a_reg[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[b_k][b_n + j] = b_reg[j];
    __syncthreads();
    if (k0 + BK < K) gather(k0 + BK);  // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: fp32 scale/shift, ReLU, one rounding to T
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = n0 + tx * TN + j;
    if (c >= s.cout) continue;
    const float sc = scale ? scale[c] : 1.f;
    const float sf = shift ? shift[c] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
      float v = acc[i][j];
      if (scale) v = v * sc + sf;
      if (relu) v = fmaxf(v, 0.f);
      y[m * s.cout + c] = from_f<T>(v);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale/shift: both null (no epilogue)
// or both (Cout,) fp32. Returns cudaGetLastError() after the launch.
extern "C" int conv_fused_launch(int dtype, const void* x, const void* w,
                                 const void* scale, const void* shift, void* y,
                                 int n, int h, int wd, int cin, int oh, int ow,
                                 int cout, int kh, int kw, int sh, int sw,
                                 int ph, int pw, int relu, void* stream) {
  const ConvShape s{n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw};
  const int M = n * oh * ow;
  const dim3 grid((M + BM - 1) / BM, (cout + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  if (dtype == 0) {
    conv_fused_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, sf,
        static_cast<float*>(y), s, relu);
  } else if (dtype == 1) {
    conv_fused_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), sc, sf,
        static_cast<__nv_bfloat16*>(y), s, relu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
