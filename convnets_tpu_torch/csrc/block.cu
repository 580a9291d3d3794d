// A whole stride-1 identity bottleneck block in inference form, as one
// kernel:
//
//   h1  = round(ReLU(s1 * (x . W1) + b1))            1x1, Cin -> Cmid
//   h2  = round(ReLU(s2 * conv3x3(h1, W2) + b2))     3x3 pad 1, Cmid -> Cmid
//   out = round([ReLU](s3 * (h2 . W3) + b3 + x))     1x1, Cmid -> Cin
//
// Replaces convnets_tpu/ops/pallas/block.py:bottleneck_block (:122;
// _block_kernel :42). Its rounding points: h1 and h2 are rounded to x's
// dtype after their fp32 epilogue and ReLU (block.py:69-70, :82); the last
// sum adds the residual in fp32 and rounds once (:86-89). The 3x3 conv
// reads h1 with a zero border (the zeroed scratch of :68): a halo pixel
// outside the image is 0, not ReLU(b1). The mid-width scale/shift rows are
// the first Cmid entries of a (6, Cin) fp32 operand (:145-147).
//
// Two routes, chosen by ops/kernels/block.py:block_plan and passed to
// bottleneck_launch:
//
//  * "wgmma" (route 1): bf16 with Cmid in {64, 128, 256} and Cin % 64 ==
//    0, which holds RN50's three identity shapes. The three products run on
//    the tensor cores, chained through shared memory (csrc/block_wgmma.cu):
//    bound by the MMAs, not by bytes.
//  * "simt" (route 0, this file): fp32 and every other bf16 shape of the
//    envelope (Cmid <= min(Cin, 256)). One CUDA block per (image, TILE x
//    TILE output tile) computes h1 over the tile plus a one-pixel halo,
//    (TILE+2)^2 pixels, then h2 over the tile, and keeps both in dynamic
//    shared memory. Each of the three products is a pass of the block's 256
//    threads over column blocks of at most 256 channels: a thread owns one
//    output channel and a fixed share of the tile's pixels, accumulates in
//    fp32 registers, and reads its operand pixel from shared memory as a
//    broadcast; x and the weight rows are staged through shared memory in
//    chunks of KC channels, widened to fp32. The halo costs (TILE+2)^2 /
//    TILE^2 = 1.65x the first product's FMAs. It is bound by issue, one
//    shared-memory load per fp32 FMA on the CUDA cores, a few percent of
//    the bf16 tensor-core rate; the fp32 checks and the off-route shapes
//    are all it serves.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// csrc/block_wgmma.cu
int block_wgmma_run(const void* x, const void* w1, const void* w2, const void* w3,
                    const void* sb, void* out, int n, int h, int w, int cin, int cmid,
                    int relu_out, int th, void* stream);

namespace {

constexpr int TILE = 7;               // output tile edge (14 and 28 are multiples)
constexpr int HALO = TILE + 2;
constexpr int P1 = HALO * HALO;       // h1 pixels: the tile and its halo
constexpr int P2 = TILE * TILE;       // h2 and output pixels
constexpr int KC = 32;                // depth staged per step
constexpr int THREADS = 256;
constexpr int MAX_COLS = THREADS;     // columns per pass: one per thread
constexpr int XP = KC + 1;            // staged-x row pitch (pixel-major)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float rounded(float v) {
  return to_f(from_f<T>(v));
}

size_t smem_bytes(int cmid) {
  return sizeof(float) *
         (static_cast<size_t>(P1 + P2) * cmid + P1 * XP + KC * MAX_COLS);
}

// NG: pixel groups of the two mid-width passes (NG * Cmid <= 256 threads);
// thread t owns channel t % Cmid and pixels t / Cmid + NG * i.
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w3,
                  const float* __restrict__ sb, T* __restrict__ out, int h, int w,
                  int cin, int cmid, int tiles_w, int relu_out) {
  constexpr int N1 = (P1 + NG - 1) / NG;  // h1 pixels per thread
  constexpr int N2 = (P2 + NG - 1) / NG;  // h2 pixels per thread
  extern __shared__ __align__(16) float smem[];
  float* h1s = smem;              // [P1][cmid]
  float* h2s = h1s + P1 * cmid;   // [P2][cmid]
  float* xs = h2s + P2 * cmid;    // [P1][XP]
  float* ws = xs + P1 * XP;       // [KC][MAX_COLS]

  const int tid = threadIdx.x;
  const int oy0 = (blockIdx.x / tiles_w) * TILE;
  const int ox0 = (blockIdx.x % tiles_w) * TILE;
  const size_t img = static_cast<size_t>(blockIdx.y) * h * w * cin;
  const T* xn = x + img;
  T* on = out + img;
  const float* s1 = sb;
  const float* b1 = sb + cin;
  const float* s2 = sb + 2 * cin;
  const float* b2 = sb + 3 * cin;
  const float* s3 = sb + 4 * cin;
  const float* b3 = sb + 5 * cin;

  const int c = tid % cmid;
  const int pg = tid / cmid;
  const bool mid_active = pg < NG;

  // ---- h1 = round(ReLU(s1 * (x . W1) + b1)) over the halo tile ----------
  {
    float acc[N1];
#pragma unroll
    for (int i = 0; i < N1; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += KC) {
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = tid; idx < P1 * KC; idx += THREADS) {
        const int p = idx / KC;
        const int kk = idx - p * KC;
        const int iy = oy0 - 1 + p / HALO;
        const int ix = ox0 - 1 + p % HALO;
        float v = 0.f;
        if (k0 + kk < cin && (unsigned)iy < (unsigned)h && (unsigned)ix < (unsigned)w)
          v = to_f(xn[(static_cast<size_t>(iy) * w + ix) * cin + k0 + kk]);
        xs[p * XP + kk] = v;
      }
      for (int idx = tid; idx < KC * cmid; idx += THREADS) {
        const int kk = idx / cmid;
        const int cc = idx - kk * cmid;
        ws[kk * MAX_COLS + cc] =
            k0 + kk < cin ? to_f(w1[static_cast<size_t>(k0 + kk) * cmid + cc]) : 0.f;
      }
      __syncthreads();
      if (mid_active) {
        for (int kk = 0; kk < KC; ++kk) {
          const float wv = ws[kk * MAX_COLS + c];
#pragma unroll
          for (int i = 0; i < N1; ++i) {
            const int p = NG == 1 ? i : pg + i * NG;
            if (p < P1) acc[i] = fmaf(xs[p * XP + kk], wv, acc[i]);
          }
        }
      }
    }
    if (mid_active) {
      const float sc = s1[c], sf = b1[c];
#pragma unroll
      for (int i = 0; i < N1; ++i) {
        const int p = NG == 1 ? i : pg + i * NG;
        if (p >= P1) continue;
        const int iy = oy0 - 1 + p / HALO;
        const int ix = ox0 - 1 + p % HALO;
        const bool inside = (unsigned)iy < (unsigned)h && (unsigned)ix < (unsigned)w;
        // the 3x3 conv's zero padding: 0 outside the image, not ReLU(b1)
        h1s[p * cmid + c] = inside ? rounded<T>(fmaxf(acc[i] * sc + sf, 0.f)) : 0.f;
      }
    }
  }

  // ---- h2 = round(ReLU(s2 * conv3x3(h1, W2) + b2)) over the tile --------
  {
    float acc[N2];
    int hbase[N2];  // each pixel's top-left tap in the halo tile
#pragma unroll
    for (int i = 0; i < N2; ++i) {
      const int p = NG == 1 ? i : pg + i * NG;
      acc[i] = 0.f;
      hbase[i] = (p / TILE) * HALO + p % TILE;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - ky * 3;
      for (int c0 = 0; c0 < cmid; c0 += KC) {
        const int kend = min(KC, cmid - c0);
        __syncthreads();  // h1 complete; the previous chunk's readers are done
        for (int idx = tid; idx < kend * cmid; idx += THREADS) {
          const int kk = idx / cmid;
          const int cc = idx - kk * cmid;
          ws[kk * MAX_COLS + cc] =
              to_f(w2[(static_cast<size_t>(tap) * cmid + c0 + kk) * cmid + cc]);
        }
        __syncthreads();
        if (mid_active) {
          for (int kk = 0; kk < kend; ++kk) {
            const float wv = ws[kk * MAX_COLS + c];
            const float* h1k = h1s + (ky * HALO + kx) * cmid + c0 + kk;
#pragma unroll
            for (int i = 0; i < N2; ++i) {
              if ((NG == 1 ? i : pg + i * NG) < P2)
                acc[i] = fmaf(h1k[hbase[i] * cmid], wv, acc[i]);
            }
          }
        }
      }
    }
    if (mid_active) {
      const float sc = s2[c], sf = b2[c];
#pragma unroll
      for (int i = 0; i < N2; ++i) {
        const int p = NG == 1 ? i : pg + i * NG;
        if (p < P2) h2s[p * cmid + c] = rounded<T>(fmaxf(acc[i] * sc + sf, 0.f));
      }
    }
  }

  // ---- out = round([ReLU](s3 * (h2 . W3) + b3 + x)), Cin in passes ------
  for (int c0 = 0; c0 < cin; c0 += MAX_COLS) {
    const int cols = min(MAX_COLS, cin - c0);
    const bool active = tid < cols;
    float acc[P2];
#pragma unroll
    for (int i = 0; i < P2; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cmid; k0 += KC) {
      const int kend = min(KC, cmid - k0);
      __syncthreads();  // h2 complete; the previous chunk's readers are done
      for (int idx = tid; idx < kend * cols; idx += THREADS) {
        const int kk = idx / cols;
        const int cc = idx - kk * cols;
        ws[kk * MAX_COLS + cc] = to_f(w3[static_cast<size_t>(k0 + kk) * cin + c0 + cc]);
      }
      __syncthreads();
      if (active) {
        for (int kk = 0; kk < kend; ++kk) {
          const float wv = ws[kk * MAX_COLS + tid];
#pragma unroll
          for (int i = 0; i < P2; ++i) acc[i] = fmaf(h2s[i * cmid + k0 + kk], wv, acc[i]);
        }
      }
    }
    if (active) {
      const int co = c0 + tid;
      const float sc = s3[co], sf = b3[co];
#pragma unroll
      for (int i = 0; i < P2; ++i) {
        const int oy = oy0 + i / TILE;
        const int ox = ox0 + i % TILE;
        if (oy >= h || ox >= w) continue;
        const size_t at = (static_cast<size_t>(oy) * w + ox) * cin + co;
        float v = acc[i] * sc + sf + to_f(xn[at]);
        if (relu_out) v = fmaxf(v, 0.f);
        on[at] = from_f<T>(v);
      }
    }
  }
}

template <typename T, int NG>
int launch_block(const void* x, const void* w1, const void* w2, const void* w3,
                 const void* sb, void* out, int n, int h, int w, int cin, int cmid,
                 int relu_out, cudaStream_t st) {
  const size_t bytes = smem_bytes(cmid);
  auto kernel = bottleneck_kernel<T, NG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (w + TILE - 1) / TILE;
  const int tiles_h = (h + TILE - 1) / TILE;
  const dim3 grid(tiles_h * tiles_w, n);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), static_cast<const float*>(sb), static_cast<T*>(out), h, w,
      cin, cmid, tiles_w, relu_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, const void* w1, const void* w2, const void* w3,
                 const void* sb, void* out, int n, int h, int w, int cin, int cmid,
                 int relu_out, cudaStream_t st) {
  if (4 * cmid <= THREADS)
    return launch_block<T, 4>(x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out, st);
  if (2 * cmid <= THREADS)
    return launch_block<T, 2>(x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out, st);
  return launch_block<T, 1>(x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out (N, H, W, Cin); w1 (Cin, Cmid),
// w2 (3, 3, Cmid, Cmid), w3 (Cmid, Cin) in x's dtype; sb (6, Cin) fp32, rows
// s1, b1, s2, b2 (their first Cmid entries), s3, b3. route, th: the plan of
// ops/kernels/block.py:block_plan (0 simt, th unused; 1 wgmma, bf16, th
// output rows per CTA). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan that is not built.
extern "C" int bottleneck_launch(int dtype, const void* x, const void* w1, const void* w2,
                                 const void* w3, const void* sb, void* out, int n, int h,
                                 int w, int cin, int cmid, int relu_out, int route, int th,
                                 void* stream) {
  if (cmid < 1 || cmid > THREADS || cin < cmid) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1)
    return block_wgmma_run(x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out, th, stream);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_typed<float>(x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, w1, w2, w3, sb, out, n, h, w, cin, cmid, relu_out,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
