// K x K window max pool over NHWC with -inf padding (torch MaxPool2d).
//
// Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d (_pool_kernel via
// _pool). One thread per output element with the channel innermost, so a
// warp reads and writes consecutive channels of one pixel (coalesced).
// Padding taps are skipped, which is the same as reading -inf. The max is
// taken in fp32; for bf16 that is exact, since every operand is a bf16.
//
// What bounds it on the H100: memory. Each input element is read by about
// (k/s)^2 windows (2.25 for the ResNet stem's 3x3/2); those re-reads hit
// L1/L2, so the traffic is close to one read of x and one write of y.
// Left for later: 16-byte vector loads (8 bf16 channels per thread) and
// fusing the pool into the stem conv's epilogue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void max_pool_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int n, int h, int w, int c, int oh, int ow,
                                int kh, int kw, int sh, int sw, int ph, int pw) {
  const long long total = static_cast<long long>(n) * oh * ow * c;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ci = static_cast<int>(i % c);
    long long t = i / c;
    const int ox = static_cast<int>(t % ow);
    t /= ow;
    const int oy = static_cast<int>(t % oh);
    const int ni = static_cast<int>(t / oh);
    const T* xn = x + static_cast<long long>(ni) * h * w * c + ci;
    float m = -CUDART_INF_F;
    for (int ky = 0; ky < kh; ++ky) {
      const int iy = oy * sh - ph + ky;
      if (iy < 0 || iy >= h) continue;
      for (int kx = 0; kx < kw; ++kx) {
        const int ix = ox * sw - pw + kx;
        if (ix < 0 || ix >= w) continue;
        m = fmaxf(m, to_f(xn[(static_cast<long long>(iy) * w + ix) * c]));
      }
    }
    y[i] = from_f<T>(m);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int max_pool_launch(int dtype, const void* x, void* y, int n, int h,
                               int w, int c, int oh, int ow, int kh, int kw,
                               int sh, int sw, int ph, int pw, void* stream) {
  const long long total = static_cast<long long>(n) * oh * ow * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    max_pool_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, h, w, c, oh,
        ow, kh, kw, sh, sw, ph, pw);
  } else if (dtype == 1) {
    max_pool_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n,
        h, w, c, oh, ow, kh, kw, sh, sw, ph, pw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
