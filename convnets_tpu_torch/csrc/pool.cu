// K x K window pooling over NHWC, one kernel templated over the mode:
//
//  * max (torch MaxPool2d): padding taps are skipped, which is the same as
//    reading -inf. Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d.
//    The max is taken in fp32; for bf16 that is exact, since every operand
//    is a bf16.
//  * avg (torch AvgPool2d, count_include_pad): the taps are summed in fp32
//    in row-major (ky, kx) order, padding taps adding nothing, and the sum
//    is MULTIPLIED by the fp32 reciprocal of kh*kw (the divisor counts the
//    padding taps) and rounded once to the output dtype, as
//    convnets_tpu/ops/pool.py:41-52. Replaces
//    convnets_tpu/ops/pallas/pool.py:avg_pool2d (_pool_kernel in "avg"
//    mode).
//
// One thread per output element with the channel innermost, so a warp
// reads and writes consecutive channels of one pixel (coalesced). Both
// modes run through the same loop, so the max kernel kept its code and
// numbers when the avg mode was added.
//
// What bounds it on the H100: memory. Each input element is read by about
// (k/s)^2 windows (2.25 for the ResNet stem's 3x3/2, exactly 1 for
// DenseNet's 2x2/2 transitions); re-reads hit L1/L2, so the traffic is
// close to one read of x and one write of y. Left for later: 16-byte
// vector loads (8 bf16 channels per thread) and fusing the pool into the
// neighbouring conv's epilogue or prologue.

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

template <typename T, bool AVG>
__global__ void pool_kernel(const T* __restrict__ x, T* __restrict__ y,
                            int n, int h, int w, int c, int oh, int ow,
                            int kh, int kw, int sh, int sw, int ph, int pw,
                            float inv_area) {
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
    float acc = AVG ? 0.0f : -CUDART_INF_F;
    for (int ky = 0; ky < kh; ++ky) {
      const int iy = oy * sh - ph + ky;
      if (iy < 0 || iy >= h) continue;
      for (int kx = 0; kx < kw; ++kx) {
        const int ix = ox * sw - pw + kx;
        if (ix < 0 || ix >= w) continue;
        const float v = to_f(xn[(static_cast<long long>(iy) * w + ix) * c]);
        acc = AVG ? acc + v : fmaxf(acc, v);
      }
    }
    y[i] = from_f<T>(AVG ? acc * inv_area : acc);
  }
}

template <bool AVG>
int pool_launch(int dtype, const void* x, void* y, int n, int h, int w, int c,
                int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw,
                void* stream) {
  const long long total = static_cast<long long>(n) * oh * ow * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  // the reciprocal rounded to fp32 once, as np.float32(1 / (kh * kw))
  const float inv_area = static_cast<float>(1.0 / (static_cast<double>(kh) * kw));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    pool_kernel<float, AVG><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, h, w, c, oh,
        ow, kh, kw, sh, sw, ph, pw, inv_area);
  } else if (dtype == 1) {
    pool_kernel<__nv_bfloat16, AVG><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n,
        h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, inv_area);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// the launch.
extern "C" int max_pool_launch(int dtype, const void* x, void* y, int n, int h,
                               int w, int c, int oh, int ow, int kh, int kw,
                               int sh, int sw, int ph, int pw, void* stream) {
  return pool_launch<false>(dtype, x, y, n, h, w, c, oh, ow, kh, kw, sh, sw, ph,
                            pw, stream);
}

extern "C" int avg_pool_launch(int dtype, const void* x, void* y, int n, int h,
                               int w, int c, int oh, int ow, int kh, int kw,
                               int sh, int sw, int ph, int pw, void* stream) {
  return pool_launch<true>(dtype, x, y, n, h, w, c, oh, ow, kh, kw, sh, sw, ph,
                           pw, stream);
}
