// Depthwise 2-D convolution over NHWC, channel multiplier 1.
//
// Replaces convnets_tpu/ops/pallas/conv.py:depthwise_conv2d (_dw_kernel and
// the slab-tiled _dw_tiled_kernel). Contract: x (N, H, W, C), weights
// (kh*kw, C) in x's dtype (the JAX kernel casts w to x.dtype, conv.py:779),
// y (N, OH, OW, C) in x's dtype; for each output element the fp32 products
// x*w of its kh*kw taps are accumulated in row-major (i, j) order and the
// sum is rounded once to the output dtype. Taps that fall in the padding
// add nothing (the JAX kernel adds 0*w there). Strides and padding are
// addressed in place: no padded copy of x, no slabs.
//
// One thread per output element with the channel innermost, so a warp
// reads consecutive channels of one input pixel and of one weight row and
// writes consecutive channels of one output pixel (coalesced). Offsets are
// 32-bit: the wrapper refuses tensors of 2^31 elements or more.
//
// What bounds it on the H100: memory. A tap is one multiply-add per
// element read, so the kernel is far below the card's FLOP/byte balance;
// the input is read about (3/s)^2 times per 3x3 window, and those re-reads
// hit L1/L2, so device-memory traffic is close to one read of x and one
// write of y. Left for later: 16-byte vector loads (8 bf16 channels per
// thread), halo tiles in shared memory, and the BatchNorm + ReLU epilogue
// that would let a depthwise ConvBNReLU run as one kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void depthwise_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                                 T* __restrict__ y, int n, int h, int w, int c,
                                 int oh, int ow, int kh, int kw, int sh, int sw,
                                 int ph, int pw) {
  const unsigned total = static_cast<unsigned>(n) * oh * ow * c;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ci = static_cast<int>(i % c);
    unsigned t = i / c;
    const int ox = static_cast<int>(t % ow);
    t /= ow;
    const int oy = static_cast<int>(t % oh);
    const int ni = static_cast<int>(t / oh);
    const T* xn = x + static_cast<unsigned>(ni) * h * w * c + ci;
    const T* wc = wt + ci;
    float acc = 0.0f;
    for (int ky = 0; ky < kh; ++ky) {
      const int iy = oy * sh - ph + ky;
      if (iy < 0 || iy >= h) continue;
      for (int kx = 0; kx < kw; ++kx) {
        const int ix = ox * sw - pw + kx;
        if (ix < 0 || ix >= w) continue;
        acc += to_f(xn[(iy * w + ix) * c]) * to_f(wc[(ky * kw + kx) * c]);
      }
    }
    y[i] = from_f<T>(acc);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int depthwise_launch(int dtype, const void* x, const void* w, void* y,
                                int n, int h, int wd, int c, int oh, int ow,
                                int kh, int kw, int sh, int sw, int ph, int pw,
                                void* stream) {
  const long long total = static_cast<long long>(n) * oh * ow * c;
  const long long in_total = static_cast<long long>(n) * h * wd * c;
  if (total >= (1LL << 31) || in_total >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    depthwise_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), n, h, wd, c, oh, ow, kh, kw, sh, sw, ph, pw);
  } else if (dtype == 1) {
    depthwise_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), n, h, wd, c, oh, ow, kh, kw, sh, sw, ph, pw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
