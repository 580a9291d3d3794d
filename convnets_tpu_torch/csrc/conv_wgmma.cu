// The bf16 main loop of the dense convolution on Hopper's tensor cores:
// implicit GEMM with warpgroup MMAs (wgmma) fed through an asynchronous
// shared-memory ring. Two epilogues over one main loop, chosen by a
// template parameter, with the contracts of csrc/conv_fused.cu:
//
//  * STATS = false replaces convnets_tpu/ops/pallas/conv.py:conv2d_fused
//    (_conv_kernel, _conv_tiled_kernel): y = acc*scale + shift in fp32,
//    optional ReLU, ONE rounding to bf16.
//  * STATS = true replaces convnets_tpu/ops/pallas/conv.py:conv2d_stats
//    (_conv_stats_kernel, _conv_tiled_stats_kernel): y rounded once and
//    stored, plus this CTA's per-channel sum and sum of squares of the
//    STORED values, written as one (2, Cout) row of partials that
//    stats_reduce_kernel (conv_fused.cu) adds in a fixed order. No
//    atomics and no split-K: a step is bit-reproducible on one card.
//
// GEMM view: rows M = N*OH*OW output pixels, columns Cout, depth
// K = kh*kw*Cin. A CTA of two warpgroups owns a BM = 128 x BN tile (BN 32,
// 64 or 128, chosen per layer by conv_plan in ops/kernels/conv.py); each
// warpgroup multiplies its 64 rows with wgmma.m64nBNk16 from shared memory
// into fp32 registers. K is walked in 64-deep stages through a ring of
// three slots in dynamic shared memory (fewer when K has fewer stages):
// the next stage's loads are issued while the previous stage's MMAs are
// still in flight, and two CTAs share an SM, so one's loads, epilogue and
// pipeline fill overlap the other's MMAs.
//
//  * A (the implicit im2col gather): K-major, 128-byte swizzle, one
//    128-byte row of 64 depth values per output pixel. With Cin % 8 == 0
//    each 16-byte chunk is 8 channels of one tap of one pixel, copied by
//    cp.async (zero-filled outside the image, past M and past K); strides
//    and padding are addressed directly. Otherwise (the 3-channel stems)
//    the chunk is gathered value by value into the same swizzled layout.
//  * B (weights, (K, Cout) row-major, Cout contiguous): MN-major, 128-byte
//    swizzle, read by wgmma with its transpose bit; 16-byte cp.async per 8
//    channels, or value by value where Cout % 8 != 0.
//  * Epilogue: the accumulators, rounded once, go to a padded tile in the
//    ring; y leaves it in 16-byte chunks of whole rows, and the statistics
//    are summed from it by column in a fixed order.
//
// Shared-memory writes by cp.async and st.shared are made visible to the
// tensor cores' async proxy by fence.proxy.async before the barrier that
// precedes the MMAs.
//
// What bounds it on the H100: at RN50 widths the MMAs (989 TFLOP/s bf16)
// would allow ~2 ms for a b256 forward, and the bytes (each operand read
// once, y written once) ~1.4 ms; the loader is what it spends its time on.
// Every thread issues 4 A and BN/32 B copies per stage with their address
// arithmetic, a slot is refilled only after a barrier, and the scalar stem
// gather waits on its loads. The design keeps the issue cheap (per-row
// pixel bases in registers, the tap and channel stepped incrementally) and
// relies on the second CTA per SM for overlap. Left for later: TMA
// (im2col mode) with a producer warp and mbarriers, so no consumer thread
// computes addresses, and a persistent tile scheduler that overlaps one
// tile's epilogue with the next tile's loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BM = 128;         // output pixels per CTA: two warpgroups of 64 rows
constexpr int BK = 64;          // depth per stage: one 128-byte row of bf16
constexpr int STAGES = 3;       // ring slots
constexpr int AHEAD = 1;        // stages loaded ahead of the one being multiplied
constexpr int THREADS = 256;    // two warpgroups
constexpr int ROW_BYTES = BK * 2;
constexpr int A_BYTES = BM * ROW_BYTES;       // 16 KB per stage
constexpr int ATOM_BYTES = 8 * ROW_BYTES;     // one 8-row swizzle atom
constexpr int B_BLOCK_BYTES = BK * ROW_BYTES; // 64 depth rows x 64 channels
constexpr int A_ROWS = BM / (THREADS / 8);    // 4 pixels per thread

static_assert(STAGES >= AHEAD + 2, "a slot is refilled two stages after its MMAs were issued");

template <int BN>
struct Ring {
  // B keeps rows of 64 channels; BN = 32 fills half of each row
  static constexpr int B_BYTES = (BN < 64 ? 64 : BN) * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the epilogue's use of the ring: the bf16 output tile, then (stats) the
  // column sums of each row group, 4 floats per thread
  static constexpr int EPI = BM * (BN * 2 + 16) + 4 * THREADS * 4;
  // ring slots: a layer with KT < STAGES stages of depth gets KT of them
  // (more CTAs per SM); at least the epilogue's bytes
  __host__ __device__ static constexpr int region(int kt) {
    const int ring = (kt < STAGES ? kt : STAGES) * STAGE;
    return ring > EPI ? ring : EPI;
  }
  // + the CTA's scale and shift (2 x BN floats) + slack to align the ring
  static constexpr int bytes(int kt) { return region(kt) + 2 * BN * 4 + 1024; }
};

struct Shape {
  int n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// tile of 128-byte rows (the tile 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// D(64 x N, fp32 registers) += A(64 x 16, K-major) * B(16 x N, MN-major)
template <int N>
struct Mma;

template <> struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// (ky, kx, ci) of a depth index k = (ky*kw + kx)*Cin + ci
struct Tap {
  int ky, kx, ci;
  __device__ __forceinline__ void init(int k, int cin, int kw) {
    const int tap = k / cin;
    ci = k - tap * cin;
    ky = tap / kw;
    kx = tap - ky * kw;
  }
  __device__ __forceinline__ void step(int cin, int kw) {
    if (++ci == cin) {
      ci = 0;
      if (++kx == kw) {
        kx = 0;
        ++ky;
      }
    }
  }
  __device__ __forceinline__ void advance(int dk, int cin, int kw) {
    ci += dk;
    while (ci >= cin) {
      ci -= cin;
      if (++kx == kw) {
        kx = 0;
        ++ky;
      }
    }
  }
};

// STATS = false: y = acc*scale + shift (both null: no epilogue), optional
// ReLU, one rounding; `partial` unused.
// STATS = true: y rounded once; partial[m_tile][0|1][c] receives this CTA's
// sum and sum of squares of the stored y of channel c.
// VEC_A: the A gather in 16-byte copies (Cin % 8 == 0, x 16-byte aligned).
// vec_b: the same for B (Cout % 8 == 0, w 16-byte aligned); vec_y: y stored
// in 16-byte chunks (Cout % 8 == 0, y 16-byte aligned).
// One-dimensional grid: the column tiles of one row tile are neighbours,
// so the A rows they share are read from device memory about once.
template <int BN, bool STATS, bool VEC_A>
__global__ void __launch_bounds__(THREADS, 2)
conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ partial, Shape s, int relu,
                  int vec_b, int vec_y) {
  constexpr int R = BN / 2;        // accumulators per thread
  constexpr int TILE_ROW = BN * 2 + 16;  // bytes per row of the epilogue tile (padded)
  constexpr int BCH = BN / 8;      // 16-byte chunks of a B depth row
  constexpr int B_STEP = THREADS / BCH;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const uint32_t raw = smem_u32(conv_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int M = s.n * s.oh * s.ow;
  const int K = s.kh * s.kw * s.cin;
  const int KT = (K + BK - 1) / BK;
  const int n_tiles = (s.cout + BN - 1) / BN;
  const int m_tile = blockIdx.x / n_tiles;
  const int m0 = m_tile * BM;
  const int n0 = (blockIdx.x - m_tile * n_tiles) * BN;

  // the epilogue's scale and shift, staged while the main loop runs
  float* const epi = reinterpret_cast<float*>(conv_smem + (ring - raw) + Ring<BN>::region(KT));
  if (!STATS && scale && tid < BN) {
    const int c = n0 + tid;
    epi[tid] = c < s.cout ? scale[c] : 1.f;
    epi[BN + tid] = c < s.cout ? shift[c] : 0.f;
  }

  // A: this thread fills 16-byte chunk `ac` of tile rows ar + 32*i
  const int ac = tid & 7;
  const int ar = tid >> 3;
  int a_pix[A_ROWS], a_iy[A_ROWS], a_ix[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + ar + 32 * i;
    if (m < M) {
      const int ox = m % s.ow;
      const int t = m / s.ow;
      const int oy = t % s.oh;
      a_pix[i] = (t / s.oh) * s.h * s.w;
      a_iy[i] = oy * s.sh - s.ph;
      a_ix[i] = ox * s.sw - s.pw;
    } else {
      a_pix[i] = 0;
      a_iy[i] = -(1 << 28);  // never inside the image
      a_ix[i] = 0;
    }
  }
  Tap ta;  // the tap of chunk `ac` in the next stage to load (vector gather)
  ta.init(ac * 8, s.cin, s.kw);

  // B: this thread fills chunk `bj` (8 output channels) of depth rows bk + B_STEP*i
  const int bj = tid % BCH;
  const int bk = tid / BCH;
  const int bcol = n0 + bj * 8;
  const uint32_t b_col_off = (bj >> 3) * B_BLOCK_BYTES;

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(wt);

  auto load_stage = [&](int kt) {
    if (kt < KT) {
      const uint32_t sa = ring + (kt % STAGES) * Ring<BN>::STAGE;
      const uint32_t sb = sa + A_BYTES;
      const int k0 = kt * BK;
      if constexpr (VEC_A) {
        const bool k_ok = ta.ky < s.kh;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const int iy = a_iy[i] + ta.ky;
          const int ix = a_ix[i] + ta.kx;
          const bool ok = k_ok && (unsigned)iy < (unsigned)s.h && (unsigned)ix < (unsigned)s.w;
          const __nv_bfloat16* src = x;
          if (ok) src = x + ((a_pix[i] + iy * s.w + ix) * s.cin + ta.ci);
          cp_async16(sa + swz(ar + 32 * i, ac), src, ok);
        }
        ta.advance(BK, s.cin, s.kw);
      } else {
        Tap t;
        t.init(k0 + ac * 8, s.cin, s.kw);
        uint32_t v[A_ROWS][4];
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) v[i][q] = 0u;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool k_ok = t.ky < s.kh;
#pragma unroll
          for (int i = 0; i < A_ROWS; ++i) {
            const int iy = a_iy[i] + t.ky;
            const int ix = a_ix[i] + t.kx;
            if (k_ok && (unsigned)iy < (unsigned)s.h && (unsigned)ix < (unsigned)s.w)
              v[i][e >> 1] |= static_cast<uint32_t>(xs[(a_pix[i] + iy * s.w + ix) * s.cin + t.ci])
                              << ((e & 1) * 16);
          }
          t.step(s.cin, s.kw);
        }
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) st_shared16(sa + swz(ar + 32 * i, ac), v[i]);
      }
#pragma unroll
      for (int i = 0; i < BK / B_STEP; ++i) {
        const int r = bk + i * B_STEP;
        const int k = k0 + r;
        const uint32_t dst = sb + b_col_off + swz(r, bj & 7);
        if (vec_b) {
          const bool ok = k < K && bcol < s.cout;
          const __nv_bfloat16* src = wt;
          if (ok) src = wt + (static_cast<size_t>(k) * s.cout + bcol);
          cp_async16(dst, src, ok);
        } else {
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = bcol + 2 * q;
            const size_t at = static_cast<size_t>(k) * s.cout + c;
            const uint32_t lo = (k < K && c < s.cout) ? ws[at] : 0u;
            const uint32_t hi = (k < K && c + 1 < s.cout) ? ws[at + 1] : 0u;
            v[q] = lo | (hi << 16);
          }
          st_shared16(dst, v);
        }
      }
    }
    cp_async_commit();  // empty past the end: keeps the group count uniform
  };

  const int wg = tid >> 7;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

#pragma unroll
  for (int kt = 0; kt < AHEAD; ++kt) load_stage(kt);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of stage kt have landed
    fence_proxy_async();         // ... and are visible to the tensor cores
    __syncthreads();             // everyone's; and every MMA of stage kt - 2 is done
    load_stage(kt + AHEAD);      // into the slot stage kt - 2 used
    const uint32_t sa = ring + (kt % STAGES) * Ring<BN>::STAGE + wg * (64 * ROW_BYTES);
    const uint32_t sb = ring + (kt % STAGES) * Ring<BN>::STAGE + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Mma<BN>::run(acc, smem_desc(sa + kk * 32, 16, ATOM_BYTES),
                   smem_desc(sb + kk * 16 * ROW_BYTES, B_BLOCK_BYTES, ATOM_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // stage kt - 1's MMAs are done; stage kt's stay in flight
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: the epilogue reuses it

  // accumulator fragment of m64nBNk16: thread holds tile rows rl and rl + 8,
  // columns 8j + cq and 8j + cq + 1 in acc[4j + 2h + {0, 1}]. Each value is
  // rounded once and written to a padded bf16 tile in shared memory, which
  // the CTA then stores in whole 16-byte chunks of y's rows (and, STATS,
  // sums by column).
  unsigned char* const tile = conv_smem + (ring - raw);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + cq;
    float sc0 = 1.f, sc1 = 1.f, sf0 = 0.f, sf1 = 0.f;
    if (!STATS && scale) {
      sc0 = epi[cl];
      sc1 = epi[cl + 1];
      sf0 = epi[BN + cl];
      sf1 = epi[BN + cl + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h];
      float v1 = acc[4 * j + 2 * h + 1];
      if (!STATS) {
        if (scale) {
          v0 = v0 * sc0 + sf0;
          v1 = v1 * sc1 + sf1;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + (rl + 8 * h) * TILE_ROW + cl * 2) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();

  // y: 16-byte chunks of the tile's rows, rows past M and columns past Cout
  // left out; value by value where a chunk is ragged or y is not aligned
  constexpr int YCH = BN / 8;
#pragma unroll
  for (int i = 0; i < BM * YCH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx / YCH;
    const int ch = idx - row * YCH;
    const int m = m0 + row;
    const int c = n0 + ch * 8;
    if (m >= M || c >= s.cout) continue;
    const unsigned char* src = tile + row * TILE_ROW + ch * 16;
    __nv_bfloat16* dst = y + (static_cast<size_t>(m) * s.cout + c);
    if (vec_y && c + 8 <= s.cout) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int e = 0; e < 8 && c + e < s.cout; ++e) dst[e] = v[e];
    }
  }
  if constexpr (STATS) {
    // the sums of the stored values, read back from the tile: thread
    // (pair, group) adds one column pair over its group's rows in order
    // (rows past M left out; columns past Cout hold zeros), then thread c
    // of the CTA adds the groups' sums of column c in order
    constexpr int PAIRS = BN / 2;
    constexpr int GROUPS = THREADS / PAIRS;
    constexpr int ROWS = BM / GROUPS;
    float* const red = reinterpret_cast<float*>(tile + BM * TILE_ROW);  // [2][GROUPS][BN]
    const int pr = tid % PAIRS;
    const int gr = tid / PAIRS;
    const int valid = M - m0 - gr * ROWS;
    float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < valid) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(tile + (gr * ROWS + r) * TILE_ROW + pr * 4);
        const float f0 = __low2float(v), f1 = __high2float(v);
        a0 += f0;
        a1 += f1;
        q0 = fmaf(f0, f0, q0);
        q1 = fmaf(f1, f1, q1);
      }
    }
    red[gr * BN + 2 * pr] = a0;
    red[gr * BN + 2 * pr + 1] = a1;
    red[(GROUPS + gr) * BN + 2 * pr] = q0;
    red[(GROUPS + gr) * BN + 2 * pr + 1] = q1;
    __syncthreads();
    if (tid < 2 * BN) {
      const int st = tid / BN;
      const int cl = tid % BN;
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) t += red[(st * GROUPS + g) * BN + cl];
      if (n0 + cl < s.cout)
        partial[(static_cast<size_t>(m_tile) * 2 + st) * s.cout + n0 + cl] = t;
    }
  }
}

template <int BN, bool STATS, bool VEC_A>
int launch(const void* x, const void* w, const void* scale, const void* shift, void* y,
           void* partial, const Shape& s, int relu, int vec_b, int vec_y, cudaStream_t stream) {
  auto kernel = conv_wgmma_kernel<BN, STATS, VEC_A>;
  static bool sized = false;  // the shared-memory opt-in, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::bytes(STAGES));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const int kt = (s.kh * s.kw * s.cin + BK - 1) / BK;
  const long long m_tiles = (static_cast<long long>(s.n) * s.oh * s.ow + BM - 1) / BM;
  const long long blocks = m_tiles * ((s.cout + BN - 1) / BN);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, Ring<BN>::bytes(kt), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), s, relu, vec_b, vec_y);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS, bool VEC_A>
int launch_bn(int bn, const void* x, const void* w, const void* scale, const void* shift,
              void* y, void* partial, const Shape& s, int relu, int vec_b, int vec_y,
              cudaStream_t st) {
  switch (bn) {
    case 32:
      return launch<32, STATS, VEC_A>(x, w, scale, shift, y, partial, s, relu, vec_b, vec_y, st);
    case 64:
      return launch<64, STATS, VEC_A>(x, w, scale, shift, y, partial, s, relu, vec_b, vec_y, st);
    case 128:
      return launch<128, STATS, VEC_A>(x, w, scale, shift, y, partial, s, relu, vec_b, vec_y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The bf16 plans of conv_fused_launch / conv_stats_launch (conv_fused.cu):
// bn 32, 64 or 128 output channels per CTA (BM = 128 rows), vec_a 1 for the
// 16-byte gather (Cin % 8 == 0 and x 16-byte aligned, else refused) or 0
// for the scalar one. geo: n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph,
// pw. Returns a cudaError_t: cudaErrorInvalidValue for a plan not built.
int conv_wgmma_run(int stats, int bn, int vec_a, const void* x, const void* w,
                   const void* scale, const void* shift, void* y, void* partial,
                   const int* geo, int relu, void* stream) {
  const Shape s{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6],
                geo[7], geo[8], geo[9], geo[10], geo[11], geo[12]};
  if (vec_a && (s.cin % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_b = (s.cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) ? 1 : 0;
  const int vec_y = (s.cout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats)
    return vec_a ? launch_bn<true, true>(bn, x, w, nullptr, nullptr, y, partial, s, 0, vec_b,
                                         vec_y, st)
                 : launch_bn<true, false>(bn, x, w, nullptr, nullptr, y, partial, s, 0, vec_b,
                                          vec_y, st);
  return vec_a ? launch_bn<false, true>(bn, x, w, scale, shift, y, nullptr, s, relu, vec_b,
                                        vec_y, st)
               : launch_bn<false, false>(bn, x, w, scale, shift, y, nullptr, s, relu, vec_b,
                                         vec_y, st);
}
