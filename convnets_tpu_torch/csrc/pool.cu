// K x K window pooling over NHWC, forward and backward, templated over the
// mode:
//
//  * max (torch MaxPool2d): padding taps are skipped, which is the same as
//    reading -inf, and the window's first maximum in row-major (ky, kx)
//    order wins. Replaces convnets_tpu/ops/pallas/pool.py:max_pool2d. The
//    max is taken in fp32; for bf16 that is exact, since every operand is a
//    bf16. In train mode the forward also writes, per output element, the
//    uint8 row-major tap of that first maximum (ky*kw + kx): the routing of
//    XLA's select-and-scatter, which the backward follows.
//  * avg (torch AvgPool2d, count_include_pad): the taps are summed in fp32
//    in row-major (ky, kx) order, padding taps adding nothing, and the sum
//    is MULTIPLIED by the fp32 reciprocal of kh*kw (the divisor counts the
//    padding taps) and rounded once to the output dtype, as
//    convnets_tpu/ops/pool.py:41-52. Replaces
//    convnets_tpu/ops/pallas/pool.py:avg_pool2d (_pool_kernel in "avg"
//    mode).
//  * backward (the VJP of convnets_tpu/ops/pallas/pool.py:pool2d_train,
//    :111-116): dx in gather form. A thread owns 8 channels of one input
//    pixel and visits the windows that cover it (at most ceil(k/s)^2) in
//    tap order (ky, kx ascending). Max adds g where the window's saved tap
//    points at the pixel; avg adds g * fp32 1/(kh*kw), the product rounded
//    before the sum as in the VJP of avg_pool2d. The sum is fp32, rounded
//    once to x's dtype; every dx element is written once, with no atomics
//    and no memset, and nothing of the forward is recomputed.
//
// What bounds it on the H100: memory. Each input element is read by about
// (k/s)^2 windows (2.25 for the ResNet stem's 3x3/2, exactly 1 for
// DenseNet's 2x2/2 transitions); re-reads hit L1/L2, so the least time is
// one read of x and one write of y (backward: g and the taps read, dx
// written). Two routes, chosen by shape in ops/kernels/pool.py:pool_plan:
//
//  * "vector" (C % 8 == 0): 8 channels per thread in 16-byte loads and
//    stores (two in fp32), 32-bit index arithmetic once per thread; in the
//    forward a thread computes a strip of R outputs along W, so where
//    windows overlap (the stem's 3x3/2, R = 2) a loaded column feeds every
//    window of the strip that holds it.
//  * "loop" (C % 8 != 0): one thread per output (backward: input) element
//    with the channel innermost, the same arithmetic in the same order, so
//    the two routes agree bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// V uint8 taps: 8 bytes in one load / store, or one
template <int V> __device__ __forceinline__ void load_taps(const uint8_t* p, uint8_t (&t)[V]) {
  if constexpr (V == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = static_cast<uint8_t>(u.x >> (8 * i));
      t[4 + i] = static_cast<uint8_t>(u.y >> (8 * i));
    }
  } else {
    t[0] = __ldg(p);
  }
}

template <int V> __device__ __forceinline__ void store_taps(uint8_t* p, const int (&t)[V]) {
  if constexpr (V == 8) {
    uint2 u = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u.x |= static_cast<uint32_t>(t[i] & 0xff) << (8 * i);
      u.y |= static_cast<uint32_t>(t[4 + i] & 0xff) << (8 * i);
    }
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    p[0] = static_cast<uint8_t>(t[0]);
  }
}

// one window's running value: an fp32 sum (avg), or the max and the tap of
// its first occurrence (a later tap replaces it only if strictly greater)
template <bool AVG, int V> struct Window {
  float acc[V];
  int tap[V];
  __device__ __forceinline__ Window() {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc[e] = AVG ? 0.0f : -CUDART_INF_F;
      tap[e] = -1;
    }
  }
  __device__ __forceinline__ void add(const float (&v)[V], int t) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (AVG) {
        acc[e] = __fadd_rn(acc[e], v[e]);
      } else if (tap[e] < 0 || v[e] > acc[e]) {
        acc[e] = v[e];
        tap[e] = t;
      }
    }
  }
  __device__ __forceinline__ void finish(float inv_area) {
    if (AVG) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(acc[e], inv_area);
    }
  }
};

// Forward. A thread owns V channels of a strip of R outputs along W.
// V = 8, R >= 1: the vector route; V = 1, R = 1: the loop.
template <typename T, bool AVG, bool TAPS, int V, int R>
__global__ void __launch_bounds__(256)
    pool_vec_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ taps,
                    int n, int h, int w, int c, int oh, int ow, int kh, int kw, int sh, int sw,
                    int ph, int pw, float inv_area) {
  const int vc = c / V, strips = (ow + R - 1) / R;
  const unsigned total = static_cast<unsigned>(n) * oh * strips * vc;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ci = static_cast<int>(i % vc) * V;
    unsigned t = i / vc;
    const int ox0 = static_cast<int>(t % strips) * R;
    t /= strips;
    const int oy = static_cast<int>(t % oh);
    const int ni = static_cast<int>(t / oh);
    const T* xn = x + ni * h * w * c + ci;
    Window<AVG, V> win[R];
    const int cols = (R - 1) * sw + kw;
    for (int ky = 0; ky < kh; ++ky) {
      const int iy = oy * sh - ph + ky;
      if (iy < 0 || iy >= h) continue;
      for (int j = 0; j < cols; ++j) {
        const int ix = ox0 * sw - pw + j;
        if (ix < 0 || ix >= w) continue;
        float v[V];
        load<V>(xn + (iy * w + ix) * c, v);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int kx = j - r * sw;  // output ox0 + r takes column j at tap kx
          if (kx >= 0 && kx < kw) win[r].add(v, ky * kw + kx);
        }
      }
    }
    const int out = ((ni * oh + oy) * ow + ox0) * c + ci;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (ox0 + r >= ow) break;
      win[r].finish(inv_area);
      store<V>(y + out + r * c, win[r].acc);
      if (TAPS) store_taps<V>(taps + out + r * c, win[r].tap);
    }
  }
}

// Backward, gather form. A thread owns V channels of one input pixel.
template <typename T, bool AVG, int V>
__global__ void __launch_bounds__(256)
    pool_bwd_kernel(const T* __restrict__ g, const uint8_t* __restrict__ taps,
                    T* __restrict__ dx, int n, int h, int w, int c, int oh, int ow, int kh,
                    int kw, int sh, int sw, int ph, int pw, float inv_area) {
  const int vc = c / V;
  const unsigned total = static_cast<unsigned>(n) * h * w * vc;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ci = static_cast<int>(i % vc) * V;
    unsigned t = i / vc;
    const int ix = static_cast<int>(t % w);
    t /= w;
    const int iy = static_cast<int>(t % h);
    const int ni = static_cast<int>(t / h);
    // the windows that cover (iy, ix): oy*sh - ph <= iy <= oy*sh - ph + kh - 1
    const int ay = iy + ph - kh + 1, ax = ix + pw - kw + 1;
    const int oy_lo = ay <= 0 ? 0 : (ay + sh - 1) / sh;
    const int ox_lo = ax <= 0 ? 0 : (ax + sw - 1) / sw;
    const int oy_hi = min(oh - 1, (iy + ph) / sh);
    const int ox_hi = min(ow - 1, (ix + pw) / sw);
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    // oy and ox descending: the taps ky, kx ascending, the order of the
    // plain version's per-tap sums
    for (int oy = oy_hi; oy >= oy_lo; --oy) {
      const int ky = iy + ph - oy * sh;
      for (int ox = ox_hi; ox >= ox_lo; --ox) {
        const int tap = ky * kw + ix + pw - ox * sw;
        const int o = ((ni * oh + oy) * ow + ox) * c + ci;
        float gv[V];
        load<V>(g + o, gv);
        if (AVG) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(gv[e], inv_area));
        } else {
          uint8_t tv[V];
          load_taps<V>(taps + o, tv);
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (tv[e] == tap) acc[e] = __fadd_rn(acc[e], gv[e]);
        }
      }
    }
    store<V>(dx + ((ni * h + iy) * w + ix) * c + ci, acc);
  }
}

int grid_for(long long threads_total) {
  long long blocks = (threads_total + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool AVG, bool TAPS>
int forward(int route, int r, const void* x, void* y, void* taps, int n, int h, int w, int c,
            int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw, float inv_area,
            cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  uint8_t* tp = static_cast<uint8_t*>(taps);
  if (route == 0 && r == 1) {
    pool_vec_kernel<T, AVG, TAPS, 1, 1><<<grid_for(static_cast<long long>(n) * oh * ow * c), 256,
                                          0, st>>>(xp, yp, tp, n, h, w, c, oh, ow, kh, kw, sh,
                                                   sw, ph, pw, inv_area);
  } else if (route == 1 && c % 8 == 0 && aligned16(x) && aligned16(y) &&
             (!TAPS || reinterpret_cast<uintptr_t>(taps) % 8 == 0) && (r == 1 || r == 2)) {
    const long long total = static_cast<long long>(n) * oh * ((ow + r - 1) / r) * (c / 8);
    if (r == 1) {
      pool_vec_kernel<T, AVG, TAPS, 8, 1><<<grid_for(total), 256, 0, st>>>(
          xp, yp, tp, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, inv_area);
    } else {
      pool_vec_kernel<T, AVG, TAPS, 8, 2><<<grid_for(total), 256, 0, st>>>(
          xp, yp, tp, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, inv_area);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool AVG, bool TAPS>
int forward_dtype(int dtype, int route, int r, const void* x, void* y, void* taps, int n, int h,
                  int w, int c, int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw,
                  void* stream) {
  const long long in_total = static_cast<long long>(n) * h * w * c;
  if (in_total >= (1LL << 31) || static_cast<long long>(n) * oh * ow * c >= (1LL << 31) ||
      kh * kw > 255) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the reciprocal rounded to fp32 once, as np.float32(1 / (kh * kw))
  const float inv_area = static_cast<float>(1.0 / (static_cast<double>(kh) * kw));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return forward<float, AVG, TAPS>(route, r, x, y, taps, n, h, w, c, oh, ow, kh, kw, sh, sw,
                                     ph, pw, inv_area, st);
  }
  if (dtype == 1) {
    return forward<__nv_bfloat16, AVG, TAPS>(route, r, x, y, taps, n, h, w, c, oh, ow, kh, kw,
                                             sh, sw, ph, pw, inv_area, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool AVG>
int backward(int route, const void* g, const void* taps, void* dx, int n, int h, int w, int c,
             int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw, float inv_area,
             cudaStream_t st) {
  const T* gp = static_cast<const T*>(g);
  const uint8_t* tp = static_cast<const uint8_t*>(taps);
  T* dp = static_cast<T*>(dx);
  if (route == 0) {
    pool_bwd_kernel<T, AVG, 1><<<grid_for(static_cast<long long>(n) * h * w * c), 256, 0, st>>>(
        gp, tp, dp, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, inv_area);
  } else if (route == 1 && c % 8 == 0 && aligned16(g) && aligned16(dx) &&
             (AVG || reinterpret_cast<uintptr_t>(taps) % 8 == 0)) {
    pool_bwd_kernel<T, AVG, 8><<<grid_for(static_cast<long long>(n) * h * w * (c / 8)), 256, 0,
                                 st>>>(gp, tp, dp, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw,
                                       inv_area);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 = loop, 1 = vector with r
// outputs per thread along W (pool_plan). max_pool_launch writes the uint8
// taps of the first maxima to `taps` unless it is null. Each returns
// cudaGetLastError() after the launch.
extern "C" int max_pool_launch(int dtype, const void* x, void* y, void* taps, int n, int h,
                               int w, int c, int oh, int ow, int kh, int kw, int sh, int sw,
                               int ph, int pw, int route, int r, void* stream) {
  if (taps == nullptr) {
    return forward_dtype<false, false>(dtype, route, r, x, y, taps, n, h, w, c, oh, ow, kh, kw,
                                       sh, sw, ph, pw, stream);
  }
  return forward_dtype<false, true>(dtype, route, r, x, y, taps, n, h, w, c, oh, ow, kh, kw, sh,
                                    sw, ph, pw, stream);
}

extern "C" int avg_pool_launch(int dtype, const void* x, void* y, int n, int h, int w, int c,
                               int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw,
                               int route, int r, void* stream) {
  return forward_dtype<true, false>(dtype, route, r, x, y, nullptr, n, h, w, c, oh, ow, kh, kw,
                                    sh, sw, ph, pw, stream);
}

// mode: 0 = max (taps from max_pool_launch), 1 = avg (taps unused). g
// (N, OH, OW, C) in dx's dtype, dx (N, H, W, C).
extern "C" int pool_backward_launch(int dtype, int mode, const void* g, const void* taps,
                                    void* dx, int n, int h, int w, int c, int oh, int ow, int kh,
                                    int kw, int sh, int sw, int ph, int pw, int route,
                                    void* stream) {
  if (static_cast<long long>(n) * h * w * c >= (1LL << 31) ||
      static_cast<long long>(n) * oh * ow * c >= (1LL << 31) || kh * kw > 255 ||
      (mode == 0 && taps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float inv_area = static_cast<float>(1.0 / (static_cast<double>(kh) * kw));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && mode == 0) {
    return backward<float, false>(route, g, taps, dx, n, h, w, c, oh, ow, kh, kw, sh, sw, ph,
                                  pw, inv_area, st);
  }
  if (dtype == 0 && mode == 1) {
    return backward<float, true>(route, g, taps, dx, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw,
                                 inv_area, st);
  }
  if (dtype == 1 && mode == 0) {
    return backward<__nv_bfloat16, false>(route, g, taps, dx, n, h, w, c, oh, ow, kh, kw, sh, sw,
                                          ph, pw, inv_area, st);
  }
  if (dtype == 1 && mode == 1) {
    return backward<__nv_bfloat16, true>(route, g, taps, dx, n, h, w, c, oh, ow, kh, kw, sh, sw,
                                         ph, pw, inv_area, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
