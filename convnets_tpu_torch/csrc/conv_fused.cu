// The dense 2-D convolution (implicit GEMM): its entry points, its fp32
// main loop and the fixed-order reduction of the statistics. Two
// epilogues, chosen by a template parameter over each main loop:
//
//  * conv_fused (STATS = false): per-channel scale/shift (inference
//    BatchNorm folded in) and optional ReLU. Replaces
//    convnets_tpu/ops/pallas/conv.py:conv2d_fused (_conv_kernel and the
//    slab-tiled _conv_tiled_kernel). Contract: x NHWC, w HWIO flattened to
//    (kh*kw*Cin, Cout), fp32 accumulation, y = acc*scale + shift in fp32,
//    optional ReLU, ONE rounding to the output dtype.
//  * conv_stats (STATS = true): y rounded once to the output dtype and
//    stored, plus the per-channel sum and sum of squares of the STORED
//    (rounded) values over N*OH*OW -- the train-mode BatchNorm statistics
//    pass fused into the conv. Replaces convnets_tpu/ops/pallas/conv.py:
//    conv2d_stats (_conv_stats_kernel, _conv_tiled_stats_kernel). The TPU
//    grid ran in order and carried the sums in a resident block; Hopper
//    blocks run in no order, so each block writes its own (2, Cout)
//    partial sums and stats_reduce_kernel adds the partials in a fixed
//    order. No atomics: a step is bit-reproducible on one card.
//
// The entry points take the plan that ops/kernels/conv.py:conv_plan
// chooses: route 1 (bf16) runs the tensor-core main loop of
// csrc/conv_wgmma.cu; route 0 (fp32) runs the CUDA-core loop below, which
// serves the fp32 paths (the kernel-vs-plain checks in fp32): tensor-core
// TF32 would not hold their bars. No bf16 call reaches the CUDA-core loop.
//
// Strides, dilation and padding are addressed directly: the tap (ky, kx)
// of output pixel (oy, ox) reads input row oy*sh - ph + ky*dh and column
// ox*sw - pw + kx*dw. There is no space-to-depth rewrite, no 1x1
// decimation and no padded copy of the input.
//
// The fp32 loop, GEMM view: rows M = N*OH*OW output pixels, columns Cout,
// depth K = kh*kw*Cin. A block owns a BM x BN output tile and walks K in
// BK steps; each step gathers the input window (A, zero outside the
// image) and a weight tile (B) into shared memory, and every thread
// accumulates a TM x TN micro-tile in registers. The next step's global
// loads are issued before the current step's FMAs (register prefetch).
// It is compute-bound on the CUDA cores (67 TFLOP/s fp32 on the H100);
// only checks run it, so it is kept simple.

#include <cuda_runtime.h>

// csrc/conv_wgmma.cu
int conv_wgmma_run(int stats, int bn, int vec_a, const void* x, const void* w,
                   const void* scale, const void* shift, void* y, void* partial,
                   const int* geo, int relu, void* stream);

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

struct ConvShape {
  int n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw;
};

// STATS = false: scale/shift/relu epilogue, `partial` unused.
// STATS = true: no scale/shift/relu; partial[blockIdx.x][0|1][c] receives
// this block's sum and sum of squares of the stored y of channel c.
template <bool STATS>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
            const float* __restrict__ scale, const float* __restrict__ shift,
            float* __restrict__ y, float* __restrict__ partial, ConvShape s,
            int relu) {
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
      const int ih = a_ih[r] + ky * s.dh;
      const int iw = a_iw[r] + kx * s.dw;
      float v = 0.f;
      if (k_ok && (unsigned)ih < (unsigned)s.h && (unsigned)iw < (unsigned)s.w)
        v = x[a_base[r] + (ih * s.w + iw) * s.cin + ci];
      a_reg[r] = v;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + b_n + j;
      b_reg[j] = (kb < K && c < s.cout) ? wt[kb * s.cout + c] : 0.f;
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

  if constexpr (!STATS) {
    // epilogue: fp32 scale/shift, ReLU
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
        y[m * s.cout + c] = v;
      }
    }
  } else {
    // epilogue: store y, then the sums of the stored values.
    // Rows past M and columns past Cout contribute nothing. Each thread
    // sums its TM rows, then thread c of the block adds the BM/TM row
    // groups of column c in order.
    __shared__ float red[2][BM / TM][BN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      float s1 = 0.f, s2 = 0.f;
      if (c < s.cout) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = m0 + ty * TM + i;
          if (m >= M) continue;
          const float r = acc[i][j];
          y[m * s.cout + c] = r;
          s1 += r;
          s2 = fmaf(r, r, s2);
        }
      }
      red[0][ty][tx * TN + j] = s1;
      red[1][ty][tx * TN + j] = s2;
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int st = tid / BN;
      const int cl = tid % BN;
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < BM / TM; ++r) t += red[st][r][cl];
      if (n0 + cl < s.cout)
        partial[(static_cast<size_t>(blockIdx.x) * 2 + st) * s.cout + n0 + cl] = t;
    }
  }
}

// (blocks, 2, Cout) partial sums -> (2, Cout), in a fixed order: thread
// (cx, ry) adds rows ry, ry + RY, ... of channel blockIdx.x*RC + cx, then
// the RY lanes are added as a fixed tree. Grid (ceil(Cout/RC), 2).
constexpr int RC = 32;
constexpr int RY = 32;

__global__ void __launch_bounds__(RC * RY)
stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int blocks, int cout) {
  __shared__ float buf[RY][RC + 1];
  const int cx = threadIdx.x;
  const int ry = threadIdx.y;
  const int c = blockIdx.x * RC + cx;
  const int st = blockIdx.y;
  float t = 0.f;
  if (c < cout) {
#pragma unroll 8
    for (int b = ry; b < blocks; b += RY)
      t += partial[(static_cast<size_t>(b) * 2 + st) * cout + c];
  }
  buf[ry][cx] = t;
  __syncthreads();
#pragma unroll
  for (int h = RY / 2; h > 0; h >>= 1) {
    if (ry < h) buf[ry][cx] += buf[ry + h][cx];
    __syncthreads();
  }
  if (ry == 0 && c < cout) out[st * cout + c] = buf[0][cx];
}

template <bool STATS>
int launch_simt(const void* x, const void* w, const void* scale, const void* shift, void* y,
                void* partial, const ConvShape& s, int relu, void* stream) {
  const int M = s.n * s.oh * s.ow;
  const dim3 grid((M + BM - 1) / BM, (s.cout + BN - 1) / BN);
  conv_kernel<STATS><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), static_cast<float*>(partial), s, relu);
  return static_cast<int>(cudaGetLastError());
}

// route 0: the fp32 CUDA-core loop (BM 128, BN 64, scalar gather); route 1:
// the bf16 tensor-core loop (BM 128, BN 32/64/128, gather 0 scalar or 1
// vector). Anything else is refused.
int run_plan(bool stats, int dtype, int route, int bm, int bn, int gather, const void* x,
             const void* w, const void* scale, const void* shift, void* y, void* partial,
             const int* geo, int relu, void* stream) {
  if (route == 0 && dtype == 0 && bm == BM && bn == BN && gather == 0) {
    const ConvShape s{geo[0], geo[1], geo[2],  geo[3],  geo[4],  geo[5],  geo[6], geo[7],
                      geo[8], geo[9], geo[10], geo[11], geo[12], geo[13], geo[14]};
    return stats ? launch_simt<true>(x, w, nullptr, nullptr, y, partial, s, 0, stream)
                 : launch_simt<false>(x, w, scale, shift, y, nullptr, s, relu, stream);
  }
  if (route == 1 && dtype == 1 && bm == 128 && (gather == 0 || gather == 1))
    return conv_wgmma_run(stats, bn, gather, x, w, scale, shift, y, partial, geo, relu, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Any stride and dilation >= 1.
// scale/shift: both null (no epilogue) or both (Cout,) fp32. route, bm, bn, gather: the plan of
// ops/kernels/conv.py:conv_plan. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan that is not built.
extern "C" int conv_fused_launch(int dtype, const void* x, const void* w,
                                 const void* scale, const void* shift, void* y,
                                 int n, int h, int wd, int cin, int oh, int ow,
                                 int cout, int kh, int kw, int sh, int sw,
                                 int ph, int pw, int dh, int dw, int route, int bm,
                                 int bn, int gather, int relu, void* stream) {
  const int geo[15] = {n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw};
  return run_plan(false, dtype, route, bm, bn, gather, x, w, scale, shift, y, nullptr, geo,
                  relu, stream);
}

// y = conv(x, w) in x's dtype, and partial (ceil(M / bm), 2, Cout) fp32
// per-block sums of y and y*y. Returns as conv_fused_launch.
extern "C" int conv_stats_launch(int dtype, const void* x, const void* w,
                                 void* y, void* partial, int n, int h, int wd,
                                 int cin, int oh, int ow, int cout, int kh,
                                 int kw, int sh, int sw, int ph, int pw, int dh,
                                 int dw, int route, int bm, int bn, int gather,
                                 void* stream) {
  const int geo[15] = {n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw};
  return run_plan(true, dtype, route, bm, bn, gather, x, w, nullptr, nullptr, y, partial, geo,
                  0, stream);
}

// out (2, Cout) fp32 = the `blocks` partial rows of conv_stats_launch
// added in a fixed order. Returns cudaGetLastError().
extern "C" int stats_reduce_launch(const void* partial, void* out, int blocks,
                                   int cout, void* stream) {
  const dim3 grid((cout + RC - 1) / RC, 2);
  const dim3 block(RC, RY);
  stats_reduce_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks, cout);
  return static_cast<int>(cudaGetLastError());
}
