// The CUDA-core grouped implicit-GEMM 2-D convolution: route "simt" of
// ops/kernels/conv.py:grouped_plan, and the entry points of every grouped
// route. Its loop serves fp32 (the fp32 checks, which tensor-core TF32
// would not hold) and can be asked for on any bf16 shape of the envelope,
// so the routes can be timed on the same inputs. The bf16 plan runs on the
// tensor cores: route "wgmma", the grouped mode of csrc/conv_wgmma.cu, at
// Cin/G = Cout/G in {4, 8, 16, 32} with Cin % 64 == 0 and aligned operands
// (every grouped layer of the ported ResNeXt kinds, SENet and SKNet); route
// "wgmma_wide", csrc/grouped_wgmma.cu, at every other bf16 shape but Cin/G
// = 2 (every grouped 1x1 of ShuffleNet-v1 g2-g8, Cin/G 12-400 and Cout/G
// 12-400; the rest of the envelope, any alignment). Two epilogues, chosen
// by a template parameter over one main loop, with the contracts of
// conv_fused.cu:
//
//  * grouped_fused (STATS = false): fp32 scale/shift (inference BatchNorm
//    folded in), optional ReLU, ONE rounding to the output dtype.
//  * grouped_stats (STATS = true): y rounded once and stored, plus per-block
//    partial sums of the stored y and y*y per channel, in the
//    (blocks, 2, Cout) layout that conv_fused.cu's stats_reduce_kernel adds
//    in a fixed order (no atomics).
//
// Replaces convnets_tpu/ops/pallas/conv.py:grouped_conv2d_train (:647) and
// the grouped ConvBNReLU paths of the JAX package, which run the dense
// Pallas kernels (conv2d_fused :391, conv2d_stats :543) on a block-diagonal
// weight (block_diag_weight :628). Here every FMA runs on a CUDA core, so
// each output channel sums only its own group's K_g = kh*kw*Cin/G products
// and no block-diagonal weight exists: 2*M*K_g*Cout FLOPs. The values
// equal the JAX package's up to the order of the sums.
//
// Contract: x NHWC (N, H, W, Cin), w HWIO (kh, kw, Cin/G, Cout) read as
// stored, i.e. (kh*kw*cgi, Cout) with row tap*cgi + ci; output channel c
// belongs to group c / cgo and reads input channels g*cgi .. g*cgi+cgi-1
// (cgi = Cin/G, cgo = Cout/G). fp32 accumulation in (tap, ci) order.
// Strides, dilation and padding are addressed in place: tap (ky, kx) of
// output pixel (oy, ox) reads input row oy*sh - ph + ky*dh and column
// ox*sw - pw + kx*dw.
//
// Tiling: a block owns BM output pixels and BN column slots. The slots hold
// gpb whole groups of cw = min(cgo, BN) columns each (gpb = BN / max(cgo,
// cgi), at least 1; a group wider than BN is split over nq = ceil(cgo/BN)
// blocks), so the input channels the block reads are one contiguous slab of
// gpb*cgi channels. For each tap (ky, kx) the block walks that depth in
// chunks: one chunk of the whole slab where cgi <= MAX_CGI (then gpb*cgi <=
// SLAB), else (the wide groups, where gpb = 1) chunks of MAX_CGI channels
// of the one group and a partial last chunk (68 = 32 + 32 + 4). Per chunk
// the block gathers its channels of its BM pixels (A, zero outside the
// image) and the chunk's weight rows of its columns (B) into shared memory;
// each thread then accumulates a TM x TN micro-tile over the chunk's depth
// of its columns' group. A wide group's Cout/G may leave slots of its block
// unused (cw < BN) or take several blocks (nq > 1).
//
// What bounds it on the H100: per chunk a thread makes 32 shared-memory
// stores of A and 8 of B against kc*TM*TN FMAs (kc: the chunk's depth),
// one chunk per pair of barriers with no prefetch, so at cgi = 4 it is
// bound by the gather (load instructions), not by FMAs or device memory;
// at cgi = 32 by the CUDA-core FMA rate (67 TFLOP/s fp32), which alone
// keeps ResNeXt-50's 16 grouped layers at b256 above their 1.005 ms byte
// bound, and ShuffleNet's wide 1x1s at 224^2 b256 ran 18.7x their bound
// here (13.702 ms against 0.7344). That is why the bf16 plan runs on the
// tensor cores; this loop is kept simple.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// csrc/conv_wgmma.cu
int conv_wgmma_grouped_run(int stats, int groups, const void* x, const void* w,
                           const void* scale, const void* shift, void* y, void* partial,
                           const int* geo, int relu, void* stream);
// csrc/grouped_wgmma.cu
int grouped_wide_run(int stats, int groups, const void* x, const void* w, const void* scale,
                     const void* shift, void* y, void* partial, const int* geo, int relu,
                     void* stream);

namespace {

constexpr int BM = 128;   // output pixels per block
constexpr int BN = 64;    // column slots per block
constexpr int SLAB = 64;     // input channels gathered per pixel and chunk, at most
constexpr int MAX_CGI = 32;  // depth of one chunk of B
constexpr int TM = 8;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_PITCH = SLAB + 1;               // pixel-major A rows
constexpr int B_PITCH = BN + 4;                 // float4-aligned B rows
constexpr int A_FLOATS = BM * A_PITCH;
constexpr int B_FLOATS = MAX_CGI * B_PITCH;

static_assert(THREADS == 256, "loader mapping assumes 256 threads");
static_assert(THREADS % SLAB == 0 && THREADS % BN == 0, "loader strides");
static_assert(2 * (BM / TM) * BN <= A_FLOATS, "stats buffer reuses the A tile");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct GroupedShape {
  int n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw, groups;
  int cgi, cgo;  // channels per group, in and out
  int cw;        // columns of one group in one block: min(cgo, BN)
  int gpb;       // groups per block
  int nq;        // blocks per group along the columns: ceil(cgo / BN)
};

// Where column slot `slot` of column-block `by` lands: its output channel
// (-1 if the slot is unused) and the first slab row of its group.
struct Slot {
  int col, arow;
};

__device__ __forceinline__ Slot slot_of(const GroupedShape& s, int by, int slot) {
  const int gb = by / s.nq;
  const int q = by - gb * s.nq;
  const int gl = slot / s.cw;
  const int g = gb * s.gpb + gl;
  const int cc = q * s.cw + (slot - gl * s.cw);
  if (gl >= s.gpb || g >= s.groups || cc >= s.cgo) return {-1, 0};
  return {g * s.cgo + cc, gl * s.cgi};
}

template <typename T, bool STATS>
__global__ void __launch_bounds__(THREADS)
grouped_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    T* __restrict__ y, float* __restrict__ partial, GroupedShape s,
                    int relu) {
  __shared__ __align__(16) float smem[A_FLOATS + B_FLOATS];
  __shared__ int pix_base[BM], pix_ih[BM], pix_iw[BM];
  float* As = smem;             // [BM][A_PITCH]: pixel m, slab channel
  float* Bs = smem + A_FLOATS;  // [MAX_CGI][B_PITCH]: depth ci, column slot

  const int tid = threadIdx.x;
  const int M = s.n * s.oh * s.ow;
  const int m0 = blockIdx.x * BM;
  const int by = blockIdx.y;
  const int gb = by / s.nq;
  const int ch0 = gb * s.gpb * s.cgi;  // first input channel of the slab
  const int g_here = min(s.gpb, s.groups - gb * s.gpb);
  const int slab = g_here * s.cgi;       // slab channels that exist
  const bool chunked = s.cgi > MAX_CGI;  // then gpb = 1: one group per block

  for (int m = tid; m < BM; m += THREADS) {
    const int p = m0 + m;
    if (p < M) {
      const int ox = p % s.ow;
      const int t = p / s.ow;
      const int oy = t % s.oh;
      pix_base[m] = (t / s.oh) * s.h * s.w * s.cin + ch0;
      pix_ih[m] = oy * s.sh - s.ph;
      pix_iw[m] = ox * s.sw - s.pw;
    } else {
      pix_base[m] = 0;
      pix_ih[m] = -(1 << 28);  // never inside the image
      pix_iw[m] = 0;
    }
  }

  // this thread's micro-tile: rows ty*TM .., column slots tx*TN ..
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  Slot mine[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) mine[j] = slot_of(s, by, tx * TN + j);
  // all used columns in one group: one A value serves the whole row of
  // FMAs (used slots form a prefix of the block's slots)
  bool one_group = true;
#pragma unroll
  for (int j = 1; j < TN; ++j)
    one_group = one_group && (mine[j].col < 0 || mine[j].arow == mine[0].arow);

  // loaders: A by (pixel row, slab channel), B by (depth row, column slot)
  const int a_c = tid % SLAB;
  const int a_m = tid / SLAB;
  const int b_slot = tid % BN;
  const int b_k = tid / BN;
  const int b_col = slot_of(s, by, b_slot).col;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  __syncthreads();  // pixel tables
  for (int tap = 0; tap < s.kh * s.kw; ++tap) {
    const int ky = tap / s.kw;
    const int kx = tap - ky * s.kw;
    for (int k0 = 0; k0 < s.cgi; k0 += MAX_CGI) {
      // this chunk: depth k0 .. k0+kc-1 of the group; A holds `width` channels
      // from slab channel k0 on (the whole slab when unchunked, k0 = 0)
      const int kc = chunked ? min(MAX_CGI, s.cgi - k0) : s.cgi;
      const int width = chunked ? kc : slab;
      for (int m = a_m; m < BM; m += THREADS / SLAB) {
        const int ih = pix_ih[m] + ky * s.dh;
        const int iw = pix_iw[m] + kx * s.dw;
        float v = 0.f;
        if (a_c < width && (unsigned)ih < (unsigned)s.h && (unsigned)iw < (unsigned)s.w)
          v = to_f(x[pix_base[m] + (ih * s.w + iw) * s.cin + k0 + a_c]);
        As[m * A_PITCH + a_c] = v;
      }
      for (int k = b_k; k < kc; k += THREADS / BN) {
        Bs[k * B_PITCH + b_slot] =
            b_col >= 0 ? to_f(wt[(tap * s.cgi + k0 + k) * s.cout + b_col]) : 0.f;
      }
      __syncthreads();
      for (int ci = 0; ci < kc; ++ci) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[ci * B_PITCH + tx * TN]);
        const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
        if (one_group) {
          const float* ap = &As[(ty * TM) * A_PITCH + mine[0].arow + ci];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float a = ap[i * A_PITCH];
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(As[(ty * TM + i) * A_PITCH + mine[j].arow + ci], b[j],
                               acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  if constexpr (!STATS) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = mine[j].col;
      if (c < 0) continue;
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
  } else {
    // one rounding to T, then the sums of the rounded values; each thread
    // sums its TM rows, then thread (st, slot) adds the BM/TM row groups of
    // its slot in order. The A tile is free after the last barrier.
    float* red = smem;  // [2][BM / TM][BN]
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = mine[j].col;
      float s1 = 0.f, s2 = 0.f;
      if (c >= 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = m0 + ty * TM + i;
          if (m >= M) continue;
          const T v = from_f<T>(acc[i][j]);
          y[m * s.cout + c] = v;
          const float r = to_f(v);
          s1 += r;
          s2 = fmaf(r, r, s2);
        }
      }
      red[(0 * (BM / TM) + ty) * BN + tx * TN + j] = s1;
      red[(1 * (BM / TM) + ty) * BN + tx * TN + j] = s2;
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int st = tid / BN;
      const int sl = tid % BN;
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < BM / TM; ++r) t += red[(st * (BM / TM) + r) * BN + sl];
      const int c = slot_of(s, by, sl).col;
      if (c >= 0) partial[(static_cast<size_t>(blockIdx.x) * 2 + st) * s.cout + c] = t;
    }
  }
}

template <bool STATS>
int launch_grouped(int dtype, const void* x, const void* w, const void* scale,
                   const void* shift, void* y, void* partial, int n, int h, int wd,
                   int cin, int oh, int ow, int cout, int kh, int kw, int sh, int sw,
                   int ph, int pw, int dh, int dw, int groups, int relu, void* stream) {
  if (groups < 1 || cin % groups != 0 || cout % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GroupedShape s{n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw, groups};
  s.cgi = cin / groups;
  s.cgo = cout / groups;
  s.cw = s.cgo < BN ? s.cgo : BN;
  const int widest = s.cgo > s.cgi ? s.cgo : s.cgi;
  s.gpb = widest >= BN ? 1 : BN / widest;
  s.nq = (s.cgo + BN - 1) / BN;
  const int M = n * oh * ow;
  const dim3 grid((M + BM - 1) / BM, ((groups + s.gpb - 1) / s.gpb) * s.nq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    grouped_conv_kernel<float, STATS><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, sf,
        static_cast<float*>(y), part, s, relu);
  } else if (dtype == 1) {
    grouped_conv_kernel<__nv_bfloat16, STATS><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), sc,
        sf, static_cast<__nv_bfloat16*>(y), part, s, relu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// route 0: this CUDA-core loop (fp32 or bf16); route 1: the bf16
// tensor-core grouped mode of conv_wgmma.cu (its shapes only); route 2: the
// bf16 tensor-core loop of grouped_wgmma.cu (any shape). Anything else is
// refused with cudaErrorInvalidValue.
int run_route(bool stats, int dtype, int route, const void* x, const void* w,
              const void* scale, const void* shift, void* y, void* partial, int n, int h,
              int wd, int cin, int oh, int ow, int cout, int kh, int kw, int sh, int sw, int ph,
              int pw, int dh, int dw, int groups, int relu, void* stream) {
  if (route == 0) {
    return stats ? launch_grouped<true>(dtype, x, w, nullptr, nullptr, y, partial, n, h, wd,
                                        cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw,
                                        groups, 0, stream)
                 : launch_grouped<false>(dtype, x, w, scale, shift, y, nullptr, n, h, wd, cin,
                                         oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw, groups,
                                         relu, stream);
  }
  const int geo[15] = {n, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw};
  if (route == 1 && dtype == 1) {
    return conv_wgmma_grouped_run(stats, groups, x, w, scale, shift, y, partial, geo, relu,
                                  stream);
  }
  if (route == 2 && dtype == 1) {
    return grouped_wide_run(stats, groups, x, w, scale, shift, y, partial, geo, relu, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Output pixels per block of every route: grouped_stats writes
// ceil(N*OH*OW / this) rows of partial sums.
extern "C" int grouped_block_rows() { return BM; }

// dtype: 0 = float32, 1 = bfloat16. w (kh, kw, Cin/G, Cout); scale/shift:
// both null (no epilogue) or both (Cout,) fp32. Any stride and dilation >=
// 1. route: the plan of ops/kernels/conv.py:grouped_plan (0 simt, any Cin/G;
// 1 wgmma). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// that is not built.
extern "C" int grouped_fused_launch(int dtype, const void* x, const void* w,
                                    const void* scale, const void* shift, void* y,
                                    int n, int h, int wd, int cin, int oh, int ow,
                                    int cout, int kh, int kw, int sh, int sw, int ph,
                                    int pw, int dh, int dw, int groups, int route, int relu,
                                    void* stream) {
  return run_route(false, dtype, route, x, w, scale, shift, y, nullptr, n, h, wd, cin, oh, ow,
                   cout, kh, kw, sh, sw, ph, pw, dh, dw, groups, relu, stream);
}

// y = grouped conv(x, w) in x's dtype, and partial (ceil(M /
// grouped_block_rows()), 2, Cout) fp32 per-block sums of y and y*y, for
// stats_reduce_launch. Returns as grouped_fused_launch.
extern "C" int grouped_stats_launch(int dtype, const void* x, const void* w, void* y,
                                    void* partial, int n, int h, int wd, int cin, int oh,
                                    int ow, int cout, int kh, int kw, int sh, int sw,
                                    int ph, int pw, int dh, int dw, int groups, int route,
                                    void* stream) {
  return run_route(true, dtype, route, x, w, nullptr, nullptr, y, partial, n, h, wd, cin, oh,
                   ow, cout, kh, kw, sh, sw, ph, pw, dh, dw, groups, 0, stream);
}
