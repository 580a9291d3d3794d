// Depthwise 2-D convolution over NHWC, any channel multiplier, stride and
// dilation.
//
// Replaces convnets_tpu/ops/pallas/conv.py:depthwise_conv2d (_dw_kernel and
// the slab-tiled _dw_tiled_kernel), widened to the depthwise convs that the
// JAX package runs on lax (a channel multiplier m > 1, dilation). Contract:
// x (N, H, W, C), weights (kh*kw, m*C) in x's dtype (the JAX kernel casts w
// to x.dtype, conv.py:779), y (N, OH, OW, m*C) in x's dtype; output channel
// o reads input channel o / m (lax's feature_group_count order), and tap
// (ky, kx) of output (oy, ox) reads row oy*sh - ph + ky*dh, column
// ox*sw - pw + kx*dw. For each output element the fp32 products x*w of its
// kh*kw taps are accumulated with one fmaf each in row-major (ky, kx) order
// and the sum is rounded once to the output dtype. Strides, dilation and
// padding are addressed in place: no padded copy of x.
//
// What bounds it on the H100: memory. A tap is one multiply-add per input
// element it reads, far below the card's FLOP/byte balance, so the least
// time is one read of x and one write of y at 3.35 TB/s. The stride-2
// layers come near it; a stride-1 layer does 2.5x the multiply-adds and
// bf16 unpacking per byte, and the weights and accumulators in registers
// (~190 per thread) leave one 224-thread CTA per SM, so there the
// instruction throughput of that CTA and the halo's latency show. Two routes,
// chosen by shape in ops/kernels/depthwise.py:depthwise_plan:
//
//  * "vector" (m = 1, C % 8 == 0, 3x3, stride 1 or 2, dilation d of 1 or
//    2, each the same along H and W, any padding): the output is cut
//    into tiles of TH rows x TW columns x CB channels. For each tile a CTA
//    copies the input halo, ((TH-1)*s+2d+1) x ((TW-1)*s+2d+1) x CB, into
//    shared memory with 16-byte cp.async once, zeros in place of the
//    padding taps (which then add 0*w, as the JAX kernel's zero padding
//    does), so each input element crosses device memory about once. A
//    thread computes 8 channels (one 16-byte vector in bf16, two in fp32)
//    of a block of RY x R outputs, 2 x 4 at stride 1 and 1 x 2 at stride 2:
//    it keeps its 9x8 weights in fp32 registers and streams the block's
//    input rows and columns from shared memory, so a loaded 8-channel
//    vector feeds every tap of the block that reads it (at stride 1 24
//    loads for 8 outputs, where one output alone needs 9; dilated, the
//    block's taps are d apart and the rows and columns no tap reads are not
//    loaded: 48 loads for 8 outputs at d = 2). The grid is
//    persistent (as many CTAs as stay resident) and each CTA double-buffers
//    the halo: the next tile's copy is in flight while it computes this
//    one, which keeps device memory busy (one buffer per CTA left the copies
//    idle while the CTAs of an SM computed). Index arithmetic is 32-bit and
//    done once per tile and per thread, not per element.
//  * "loop" (every other shape: C % 8 != 0, a multiplier, other windows,
//    strides or dilations): one thread per output element with the output
//    channel innermost, the same fmaf chain with padding taps skipped. The vector route equals it bit for bit (a
//    padding tap adds +-0); chip_smoke.py checks that with torch.equal.
//
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <atomic>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One thread per output element: output channel co of cout = m*c reads
// input channel co / m.
template <typename T>
__global__ void depthwise_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                                 T* __restrict__ y, int n, int h, int w, int c, int cout,
                                 int oh, int ow, int kh, int kw, int sh, int sw,
                                 int ph, int pw, int dh, int dw) {
  const unsigned total = static_cast<unsigned>(n) * oh * ow * cout;
  const int m = cout / c;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int co = static_cast<int>(i % cout);
    unsigned t = i / cout;
    const int ox = static_cast<int>(t % ow);
    t /= ow;
    const int oy = static_cast<int>(t % oh);
    const int ni = static_cast<int>(t / oh);
    const T* xn = x + static_cast<unsigned>(ni) * h * w * c + co / m;
    const T* wc = wt + co;
    float acc = 0.0f;
    for (int ky = 0; ky < kh; ++ky) {
      const int iy = oy * sh - ph + ky * dh;
      if (iy < 0 || iy >= h) continue;
      for (int kx = 0; kx < kw; ++kx) {
        const int ix = ox * sw - pw + kx * dw;
        if (ix < 0 || ix >= w) continue;
        acc = fmaf(to_f(xn[(iy * w + ix) * c]), to_f(wc[(ky * kw + kx) * cout]), acc);
      }
    }
    y[i] = from_f<T>(acc);
  }
}

// 8 consecutive channels as fp32: one 16-byte load in bf16, two in fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(q[i] << 16);
    v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    q[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// The vector route's geometry: input and output extents, padding, and the
// tile (cb channels x th rows x tw columns) with the tile grid over the
// output.
struct Tiling {
  int h, w, c, oh, ow, ph, pw, cb, th, tw, tiles_h, tiles_w;
  __device__ __forceinline__ int spatial() const { return tiles_h * tiles_w; }
};

// One CTA's copy of tile t's input halo into shared memory, 16 bytes at a
// time, zeros where the halo leaves the input (the padding taps), as one
// cp.async group. KD: the window's extent, (K-1)*D+1 for a dilated K x K. Tiles are numbered channel block outermost, then image,
// tile row, tile column, so the tiles a grid works on at once are
// neighbours that share halo rows in L2.
template <typename T, int KD, int S>
__device__ __forceinline__ void copy_halo(const T* __restrict__ x, T* halo, const Tiling& g,
                                          int n_img, int t, int v, int p0, int pstep) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  const int hw = (g.tw - 1) * S + KD;
  const int npix = ((g.th - 1) * S + KD) * hw;
  const int per_c = n_img * g.spatial();
  const int cblk = t / per_c;
  int rest = t - cblk * per_c;
  const int ni = rest / g.spatial();
  rest -= ni * g.spatial();
  const int ty = rest / g.tiles_w, tx = rest - ty * g.tiles_w;
  const int iy0 = ty * g.th * S - g.ph, ix0 = tx * g.tw * S - g.pw;
  const T* xn = x + ni * g.h * g.w * g.c + cblk * g.cb + v * 8;
  int r = p0 / hw, col = p0 - r * hw;
  for (int p = p0; p < npix; p += pstep) {
    const int iy = iy0 + r, ix = ix0 + col;
    const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
                    static_cast<unsigned>(ix) < static_cast<unsigned>(g.w);
    const T* src = in ? xn + (iy * g.w + ix) * g.c : x;
    T* dst = halo + p * g.cb + v * 8;
#pragma unroll
    for (int q = 0; q < 8 / EPC; ++q) cp_async16(dst + q * EPC, src + q * EPC, in);
    col += pstep;
    while (col >= hw) {
      col -= hw;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Persistent: the grid holds as many CTAs as the SMs keep resident, and
// each walks the tiles t = blockIdx.x, + gridDim.x, ... with two halo
// buffers, copying the next tile's halo while it computes this one. A
// thread computes RY x R outputs (rows x columns) of 8 channels; the taps
// are D apart.
template <typename T, int K, int S, int D, int R, int RY>
__global__ void __launch_bounds__(256)
    depthwise_vec_kernel(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ y,
                         int n_img, Tiling g) {
  constexpr int KD = (K - 1) * D + 1;  // the window's extent
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int vb = g.cb / 8;  // 8-channel vectors per pixel of the tile
  const int ns = g.tw / R;  // strips per tile row
  const int hw = (g.tw - 1) * S + KD;
  T* const halo = reinterpret_cast<T*>(smem_raw);  // two buffers of `hsize`
  const int hsize = ((g.th - 1) * S + KD) * hw * g.cb;
  const int total = n_img * g.spatial() * (g.c / g.cb);
  // the thread's 8 channels, its place in the halo copy and in the tile,
  // once
  const int v = threadIdx.x % vb;
  const int p0 = threadIdx.x / vb;
  const int pstep = blockDim.x / vb;
  const int row = p0 / ns, sx = p0 - row * ns;

  int t = blockIdx.x;
  if (t >= total) return;
  copy_halo<T, KD, S>(x, halo, g, n_img, t, v, p0, pstep);
  int cblk_w = -1;
  float wr[K * K][8];
  for (int i = 0; t < total; ++i, t += gridDim.x) {
    if (t + static_cast<int>(gridDim.x) < total) {
      copy_halo<T, KD, S>(x, halo + ((i + 1) & 1) * hsize, g, n_img, t + gridDim.x, v, p0,
                         pstep);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int per_c = n_img * g.spatial();
    const int cblk = t / per_c;
    int rest = t - cblk * per_c;
    const int ni = rest / g.spatial();
    rest -= ni * g.spatial();
    const int ty = rest / g.tiles_w, tx = rest - ty * g.tiles_w;
    const int c0 = cblk * g.cb;
    if (cblk != cblk_w) {  // the weights, once per channel block
#pragma unroll
      for (int k = 0; k < K * K; ++k) load8(wt + k * g.c + c0 + v * 8, wr[k]);
      cblk_w = cblk;
    }
    const int oy = ty * g.th + row * RY, ox = tx * g.tw + sx * R;
    if (oy < g.oh && ox < g.ow) {
      float acc[RY][R][8];
#pragma unroll
      for (int q = 0; q < RY; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[q][r][e] = 0.0f;
      const T* base = halo + (i & 1) * hsize + (row * RY * S * hw + sx * R * S) * g.cb + v * 8;
      // output (q, r) takes halo row jy at tap ky = (jy - q*S) / D and
      // column j at kx = (j - r*S) / D where those divide: for each output
      // the taps arrive in (ky, kx) order. A row or column no tap reads is
      // not loaded (the unrolled load has no use)
#pragma unroll
      for (int jy = 0; jy < (RY - 1) * S + KD; ++jy) {
#pragma unroll
        for (int j = 0; j < (R - 1) * S + KD; ++j) {
          float xv[8];
          load8(base + (jy * hw + j) * g.cb, xv);
#pragma unroll
          for (int q = 0; q < RY; ++q) {
            const int dy = jy - q * S;
            if (dy < 0 || dy % D != 0 || dy / D >= K) continue;
            const int ky = dy / D;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int dx = j - r * S;
              const int kx = dx / D;
              if (dx >= 0 && dx % D == 0 && kx < K) {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  acc[q][r][e] = fmaf(xv[e], wr[ky * K + kx][e], acc[q][r][e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RY; ++q) {
        if (oy + q >= g.oh) break;
        T* yo = y + ((ni * g.oh + oy + q) * g.ow + ox) * g.c + c0 + v * 8;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (ox + r < g.ow) store8(yo + r * g.c, acc[q][r]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
}

constexpr int MAX_HALO = 48 * 1024;  // bytes of one halo buffer (depthwise_plan)

template <typename T, int S, int D, int R, int RY>
int launch_vec(const void* x, const void* w, void* y, int n, Tiling g, cudaStream_t st) {
  constexpr int K = 3;
  constexpr int KD = (K - 1) * D + 1;
  auto kernel = depthwise_vec_kernel<T, K, S, D, R, RY>;
  if (g.cb % 8 != 0 || g.c % g.cb != 0 || g.tw % R != 0 || g.th < 1 ||
      g.th % RY != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = static_cast<long long>(g.cb / 8) * (g.th / RY) * (g.tw / R);
  const long long halo =
      static_cast<long long>((g.th - 1) * S + KD) * ((g.tw - 1) * S + KD) * g.cb * sizeof(T);
  if (threads < 1 || threads > 256 || halo > MAX_HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the shared-memory opt-in for two buffers, once per instantiation and
  // device: one bit per device that has it
  static std::atomic<unsigned long long> sized{0};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  if (!(sized.load() & (1ull << dev))) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * MAX_HALO);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.fetch_or(1ull << dev);
  }
  const size_t smem = static_cast<size_t>(2 * halo);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      static_cast<int>(threads), smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.tiles_h = (g.oh + g.th - 1) / g.th;
  g.tiles_w = (g.ow + g.tw - 1) / g.tw;
  const long long tiles = static_cast<long long>(n) * g.tiles_h * g.tiles_w * (g.c / g.cb);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const long long grid = tiles < static_cast<long long>(sms) * per_sm
                             ? tiles : static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), n, g);
  return static_cast<int>(cudaGetLastError());
}

// the vector route at stride S (2 x 4 outputs per thread at 1, 1 x 2 at 2)
// and dilation d in {1, 2}
template <typename T, int S, int R, int RY>
int launch_vec_d(int d, const void* x, const void* w, void* y, int n, const Tiling& g,
                 cudaStream_t st) {
  switch (d) {
    case 1: return launch_vec<T, S, 1, R, RY>(x, w, y, n, g, st);
    case 2: return launch_vec<T, S, 2, R, RY>(x, w, y, n, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int route, const void* x, const void* w, void* y, int n, int h, int wd, int c,
           int cout, int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
           int dw, int cb, int th, int tw, int r, int ry, cudaStream_t st) {
  if (route == 1) {  // vector: multiplier 1, 3x3, stride 1 or 2, dilation 1 or 2
    if (cout != c || kh != 3 || kw != 3 || sh != sw || dh != dw ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const Tiling g{h, wd, c, oh, ow, ph, pw, cb, th, tw, 0, 0};
    if (sh == 1 && r == 4 && ry == 2) return launch_vec_d<T, 1, 4, 2>(dh, x, w, y, n, g, st);
    if (sh == 2 && r == 2 && ry == 1) return launch_vec_d<T, 2, 2, 1>(dh, x, w, y, n, g, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 0 || c < 1 || cout % c != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * oh * ow * cout;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  depthwise_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), n, h, wd, c, cout,
      oh, ow, kh, kw, sh, sw, ph, pw, dh, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cout: m*c for the channel multiplier
// m. route: 0 = loop, 1 = vector with the tile cb x th x tw and ry x r
// outputs per thread (depthwise_plan). Returns cudaGetLastError() after the
// launch.
extern "C" int depthwise_launch(int dtype, const void* x, const void* w, void* y,
                                int n, int h, int wd, int c, int oh, int ow, int cout,
                                int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                                int route, int cb, int th, int tw, int r, int ry,
                                void* stream) {
  const long long total = static_cast<long long>(n) * oh * ow * cout;
  const long long in_total = static_cast<long long>(n) * h * wd * c;
  if (total >= (1LL << 31) || in_total >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(route, x, w, y, n, h, wd, c, cout, oh, ow, kh, kw, sh, sw, ph, pw, dh,
                         dw, cb, th, tw, r, ry, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(route, x, w, y, n, h, wd, c, cout, oh, ow, kh, kw, sh, sw, ph,
                                 pw, dh, dw, cb, th, tw, r, ry, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
