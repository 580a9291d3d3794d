// The bf16 main loop of the dense and the grouped convolution on Hopper's
// tensor cores: implicit GEMM with warpgroup MMAs (wgmma) fed through an
// asynchronous shared-memory ring. Two epilogues over one main loop, chosen
// by a template parameter, with the contracts of csrc/conv_fused.cu:
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
//    cp.async (zero-filled outside the image, past M and past K); strides,
//    dilation and padding are addressed directly (tap (ky, kx) of pixel
//    (oy, ox) reads row oy*sh - ph + ky*dh, column ox*sw - pw + kx*dw).
//    Otherwise (the 3-channel stems, Cin 68 and the like)
//    the chunk is gathered value by value into the same swizzled layout.
//  * B (weights, (K, Cout) row-major, Cout contiguous): MN-major, 128-byte
//    swizzle, read by wgmma with its transpose bit; 16-byte cp.async per 8
//    channels, or value by value where Cout % 8 != 0.
//  * Epilogue: the accumulators, rounded once, go to a padded tile in the
//    ring; y leaves it in 16-byte chunks of whole rows, and the statistics
//    are summed from it by column in a fixed order.
//
// The grouped mode (CG = Cin/G = Cout/G in {4, 8, 16, 32}, Cin = Cout a
// multiple of 64) replaces the grouped paths of the JAX package, which run
// the two dense Pallas kernels above on a block-diagonal weight
// (conv.py:block_diag_weight :628, grouped_conv2d_train :647, and
// fused.py:conv_bn_relu_train :35 with groups): grouped_conv2d_fused and
// grouped_conv2d_stats. A CTA owns 128 pixels x 64 output channels
// n0 .. n0+63, i.e. 64/CG whole groups, whose inputs are the one slab of
// input channels n0 .. n0+63. K is walked one tap per stage (KT = kh*kw)
// through a ring of four slots loaded two stages ahead: A is the dense
// 16-byte gather with the pixel's channel base moved to the slab, the tap
// moved by ky*dh rows and kx*dw columns where the conv is dilated. B is
// block-diagonal in shared memory only: K-major, one 128-byte swizzled row
// of slab depth per output channel, laid out as A is. Every B slot is
// zeroed once; the tap's CG x 64 weights (16-byte rows of w, read as
// stored) are loaded into registers a stage before they are transposed
// into their diagonal blocks, so no thread waits on those loads. MMAs run only on the blocks that hold weights: k16 slice kk
// meets output columns 16kk .. 16kk+15 for CG <= 16 (one m64n16k16 into
// accumulators 8kk .. 8kk+7 of the n64 fragment) and columns 32(kk/2) ..
// +31 for CG = 32 (m64n32k16 into 16(kk/2) .. +15), exactly where the
// m64n64 fragment keeps those columns, so the epilogues serve unchanged.
// The products by zero (16/CG-fold at CG <= 16) are exact: the values
// equal the per-group sums up to their order.
//
// Shared-memory writes by cp.async and st.shared are made visible to the
// tensor cores' async proxy by fence.proxy.async before the barrier that
// precedes the MMAs. The copies, fences, descriptors and MMAs are those of
// csrc/wgmma.cuh, which csrc/block_wgmma.cu shares.
//
// What bounds it on the H100: at RN50 widths the MMAs (989 TFLOP/s bf16)
// would allow ~2 ms for a b256 forward, and the bytes (each operand read
// once, y written once) ~1.4 ms; the loader is what it spends its time on.
// Every thread issues 4 A and BN/32 B copies per stage with their address
// arithmetic, a slot is refilled only after a barrier, and the scalar stem
// gather waits on its loads. The design keeps the issue cheap (per-row
// pixel bases in registers, the tap and channel stepped incrementally) and
// relies on the second CTA per SM for overlap. ResNeXt-50's 16 grouped
// layers at b256 are bound by bytes (118.4 GFLOP, 3.37 GB: 1.005 ms); on
// the fp32 CUDA cores their FLOPs alone would take 1.77 ms, with the
// zero products on the tensor cores 0.22 ms, so the grouped mode leaves
// its loads as the limit. A CTA gathers its 16 KB slab once per tap, so
// the layers pull 9x their output's bytes (12.7 GB) through L2; at ~3.1
// ms they run at 36-38 TFLOP/s, 1.27x cuDNN. What holds them there is not
// established: the deeper ring gained 6-9%, an L1-cached gather (cp.async
// .ca) lost 4%. Left for later: a spatial tile whose input halo is read
// once and shifted per tap in shared memory (grouped), TMA (im2col mode)
// with a producer warp and mbarriers, so no consumer thread computes
// addresses, and a persistent tile scheduler that overlaps one tile's
// epilogue with the next tile's loads.

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr int BM = 128;         // output pixels per CTA: two warpgroups of 64 rows
constexpr int BK = 64;          // depth per stage: one 128-byte row of bf16
constexpr int STAGES = 3;       // ring slots
constexpr int AHEAD = 1;        // stages loaded ahead of the one being multiplied
// the grouped mode's: at b256 on the H100 4 slots 2 ahead beat 3 slots 1
// ahead by 6-9% there and lost 10% on the dense loop; 2 CTAs still fit
constexpr int G_STAGES = 4;
constexpr int G_AHEAD = 2;
constexpr int THREADS = 256;    // two warpgroups
constexpr int A_BYTES = BM * ROW_BYTES;       // 16 KB per stage
constexpr int A_ROWS = BM / (THREADS / 8);    // 4 pixels per thread

static_assert(BK * 2 == ROW_BYTES, "a stage's depth is one swizzled row");
static_assert(STAGES >= AHEAD + 2 && G_STAGES >= G_AHEAD + 2,
              "a slot is refilled two stages after its MMAs were issued");

template <int BN, int SLOTS = STAGES>
struct Ring {
  // B keeps rows of 64 channels; BN = 32 fills half of each row
  static constexpr int B_BYTES = (BN < 64 ? 64 : BN) * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the epilogue's use of the ring: the bf16 output tile, then (stats) the
  // column sums of each row group, 4 floats per thread
  static constexpr int EPI = BM * (BN * 2 + 16) + 4 * THREADS * 4;
  // ring slots: a layer with KT < SLOTS stages of depth gets KT of them
  // (more CTAs per SM); at least the epilogue's bytes
  __host__ __device__ static constexpr int region(int kt) {
    const int ring = (kt < SLOTS ? kt : SLOTS) * STAGE;
    return ring > EPI ? ring : EPI;
  }
  // + the CTA's scale and shift (2 x BN floats) + slack to align the ring
  static constexpr int bytes(int kt) { return region(kt) + 2 * BN * 4 + 1024; }
};

struct Shape {
  int n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw;
};

// The grouped mode's products: D(64 x N) += A(64 x 16, K-major) * B(16 x N,
// K-major, no transpose), D the N/2 accumulators of the CTA's n64 fragment
// from OFF on (the fragment keeps columns 8j .. 8j+7 in acc[4j .. 4j+3])
template <int N, int OFF>
struct MmaK;

template <int OFF> struct MmaK<16, OFF> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[OFF]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
          "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int OFF> struct MmaK<32, OFF> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[OFF]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
          "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
        : "l"(a), "l"(b), "r"(1));
  }
};

// k16 slice KK of a grouped stage (slab channels 16KK .. 16KK+15) against
// the output columns it meets, which are the B rows it reads: 16KK .. +15
// for CG <= 16, 32(KK/2) .. +31 for CG = 32. ops/kernels/conv.py
// grouped_slices states the same map.
template <int CG, int KK>
__device__ __forceinline__ void grouped_mma(float (&acc)[32], uint32_t sa, uint32_t sb) {
  constexpr int N = CG <= 16 ? 16 : 32;
  constexpr int COL = CG <= 16 ? 16 * KK : 32 * (KK / 2);
  MmaK<N, COL / 2>::run(acc, smem_desc(sa + KK * 32, 16, ATOM_BYTES),
                        smem_desc(sb + COL * ROW_BYTES + KK * 32, 16, ATOM_BYTES));
}

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
// CG > 0: the grouped mode (64-wide tiles, vector gather; w (kh, kw, CG,
// Cout), vec_b unused).
// One-dimensional grid: the column tiles of one row tile are neighbours,
// so the A rows they share are read from device memory about once.
template <int BN, bool STATS, bool VEC_A, int CG>
__global__ void __launch_bounds__(THREADS, 2)
conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ partial, Shape s, int relu,
                  int vec_b, int vec_y) {
  static_assert(CG == 0 || (BN == 64 && VEC_A), "the grouped mode: 64-wide tiles, vector gather");
  constexpr int NS = CG ? G_STAGES : STAGES;  // ring slots
  constexpr int AH = CG ? G_AHEAD : AHEAD;     // stages loaded ahead
  using RB = Ring<BN, NS>;
  constexpr int R = BN / 2;        // accumulators per thread
  constexpr int TILE_ROW = BN * 2 + 16;  // bytes per row of the epilogue tile (padded)
  constexpr int BCH = BN / 8;      // 16-byte chunks of a B depth row
  constexpr int B_STEP = THREADS / BCH;
  // grouped B: thread tid < G_THREADS holds GCI input channels of the tap
  // (rows of w) for 8 output channels
  constexpr int GCI = CG == 0 ? 1 : (CG < 8 ? CG : 8);
  constexpr int G_THREADS = 8 * CG / GCI;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const uint32_t raw = smem_u32(conv_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int M = s.n * s.oh * s.ow;
  const int K = s.kh * s.kw * s.cin;
  const int KT = CG ? s.kh * s.kw : (K + BK - 1) / BK;
  const int n_tiles = (s.cout + BN - 1) / BN;
  const int m_tile = blockIdx.x / n_tiles;
  const int m0 = m_tile * BM;
  const int n0 = (blockIdx.x - m_tile * n_tiles) * BN;

  // the epilogue's scale and shift, staged while the main loop runs
  float* const epi = reinterpret_cast<float*>(conv_smem + (ring - raw) + RB::region(KT));
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
  // the tap of chunk `ac` in the next stage to load (vector gather); the
  // grouped mode keeps the channel at the slab's n0 + 8*ac and steps one
  // tap (Cin deep) per stage
  Tap ta;
  ta.init((CG ? n0 : 0) + ac * 8, s.cin, s.kw);

  // B: this thread fills chunk `bj` (8 output channels) of depth rows bk + B_STEP*i
  const int bj = tid % BCH;
  const int bk = tid / BCH;
  const int bcol = n0 + bj * 8;
  const uint32_t b_col_off = (bj >> 3) * B_BLOCK_BYTES;

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(wt);

  // grouped B: input channels gc0 .. gc0+GCI-1 of output channels
  // n0 + 8*gq .. +7, as 16-byte rows of w in registers (gw[r] holds input
  // channel gc0 + r)
  const int gq = tid & 7;
  const int gc0 = (tid >> 3) * GCI;
  uint32_t gw[GCI][4];
  auto load_b_grouped = [&](int kt) {
    if (kt < KT && tid < G_THREADS) {
      const __nv_bfloat16* src = wt + (static_cast<size_t>(kt * CG + gc0) * s.cout + n0 + 8 * gq);
#pragma unroll
      for (int r = 0; r < GCI; ++r) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * s.cout));
        gw[r][0] = u.x;
        gw[r][1] = u.y;
        gw[r][2] = u.z;
        gw[r][3] = u.w;
      }
    }
  };
  // ... transposed into the diagonal blocks of slot kt: row n (output
  // channel n0 + n) takes its GCI values at slab depth (n / CG)*CG + gc0,
  // 16 (GCI 8) or 8 (GCI 4) bytes in one store
  auto store_b_grouped = [&](int kt) {
    if (kt < KT && tid < G_THREADS) {
      const uint32_t sb = ring + (kt % NS) * RB::STAGE + A_BYTES;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = 8 * gq + e;
        const int k = (n / (CG ? CG : 1)) * CG + gc0;
        uint32_t v[GCI / 2 > 0 ? GCI / 2 : 1];
#pragma unroll
        for (int p = 0; p < GCI / 2; ++p)
          v[p] = __byte_perm(gw[2 * p][e >> 1], gw[2 * p + 1][e >> 1], (e & 1) ? 0x7632 : 0x5410);
        const uint32_t dst = sb + swz(n, k >> 3) + (k & 7) * 2;
        if constexpr (GCI == 8) {
          st_shared16(dst, v);
        } else if constexpr (GCI == 4) {
          st_shared8(dst, v);
        }
      }
    }
  };

  auto load_stage = [&](int kt) {
    if (kt < KT) {
      const uint32_t sa = ring + (kt % NS) * RB::STAGE;
      const uint32_t sb = sa + A_BYTES;
      const int k0 = kt * BK;
      if constexpr (VEC_A) {
        const bool k_ok = ta.ky < s.kh;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const int iy = a_iy[i] + ta.ky * s.dh;
          const int ix = a_ix[i] + ta.kx * s.dw;
          const bool ok = k_ok && (unsigned)iy < (unsigned)s.h && (unsigned)ix < (unsigned)s.w;
          const __nv_bfloat16* src = x;
          if (ok) src = x + ((a_pix[i] + iy * s.w + ix) * s.cin + ta.ci);
          cp_async16(sa + swz(ar + 32 * i, ac), src, ok);
        }
        ta.advance(CG ? s.cin : BK, s.cin, s.kw);
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
            const int iy = a_iy[i] + t.ky * s.dh;
            const int ix = a_ix[i] + t.kx * s.dw;
            if (k_ok && (unsigned)iy < (unsigned)s.h && (unsigned)ix < (unsigned)s.w)
              v[i][e >> 1] |= static_cast<uint32_t>(xs[(a_pix[i] + iy * s.w + ix) * s.cin + t.ci])
                              << ((e & 1) * 16);
          }
          t.step(s.cin, s.kw);
        }
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) st_shared16(sa + swz(ar + 32 * i, ac), v[i]);
      }
      if constexpr (CG == 0) {
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
    }
    cp_async_commit();  // empty past the end: keeps the group count uniform
  };

  const int wg = tid >> 7;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

  if constexpr (CG > 0) {
    // the grouped B tiles: zero once; the stages write only their diagonal
    // blocks, the same positions every stage
    const uint32_t zero[4] = {0u, 0u, 0u, 0u};
    constexpr int CHUNKS = RB::B_BYTES / 16;
    const int slots = KT < NS ? KT : NS;
    for (int i = tid; i < slots * CHUNKS; i += THREADS)
      st_shared16(ring + (i / CHUNKS) * RB::STAGE + A_BYTES + (i % CHUNKS) * 16, zero);
    __syncthreads();  // before any thread writes a diagonal block
  }
#pragma unroll
  for (int kt = 0; kt < AH; ++kt) {
    load_stage(kt);
    load_b_grouped(kt);
    store_b_grouped(kt);
  }
  load_b_grouped(AH);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<AH - 1>();     // this thread's copies of stage kt have landed
    fence_proxy_async();         // ... and are visible to the tensor cores
    __syncthreads();             // everyone's; and every MMA of stage kt - 2 is done
    // grouped: the weights of the stage loaded next, in registers since the
    // last stage, go to its slot; then those of the stage after it load
    store_b_grouped(kt + AH);
    load_b_grouped(kt + AH + 1);
    load_stage(kt + AH);         // into the slot stage kt - 2 used
    const uint32_t sa = ring + (kt % NS) * RB::STAGE + wg * (64 * ROW_BYTES);
    const uint32_t sb = ring + (kt % NS) * RB::STAGE + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
    if constexpr (CG > 0) {
      grouped_mma<CG, 0>(acc, sa, sb);
      grouped_mma<CG, 1>(acc, sa, sb);
      grouped_mma<CG, 2>(acc, sa, sb);
      grouped_mma<CG, 3>(acc, sa, sb);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<BN>::run(acc, smem_desc(sa + kk * 32, 16, ATOM_BYTES),
                     smem_desc(sb + kk * 16 * ROW_BYTES, B_BLOCK_BYTES, ATOM_BYTES));
    }
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

template <int BN, bool STATS, bool VEC_A, int CG>
int launch(const void* x, const void* w, const void* scale, const void* shift, void* y,
           void* partial, const Shape& s, int relu, int vec_b, int vec_y, cudaStream_t stream) {
  auto kernel = conv_wgmma_kernel<BN, STATS, VEC_A, CG>;
  using RB = Ring<BN, CG ? G_STAGES : STAGES>;
  // the shared-memory opt-in, once per instantiation and device: one bit
  // per device that has it
  static std::atomic<unsigned long long> sized{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long bit = 1ull << dev;
  if (!(sized.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RB::bytes(CG ? G_STAGES : STAGES));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.fetch_or(bit);
  }
  const int kt = CG ? s.kh * s.kw : (s.kh * s.kw * s.cin + BK - 1) / BK;
  const long long m_tiles = (static_cast<long long>(s.n) * s.oh * s.ow + BM - 1) / BM;
  const long long blocks = m_tiles * ((s.cout + BN - 1) / BN);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, RB::bytes(kt), stream>>>(
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
      return launch<32, STATS, VEC_A, 0>(x, w, scale, shift, y, partial, s, relu, vec_b, vec_y, st);
    case 64:
      return launch<64, STATS, VEC_A, 0>(x, w, scale, shift, y, partial, s, relu, vec_b, vec_y, st);
    case 128:
      return launch<128, STATS, VEC_A, 0>(x, w, scale, shift, y, partial, s, relu, vec_b, vec_y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int CG>
int launch_grouped(bool stats, const void* x, const void* w, const void* scale,
                   const void* shift, void* y, void* partial, const Shape& s, int relu,
                   int vec_y, cudaStream_t st) {
  return stats ? launch<64, true, true, CG>(x, w, nullptr, nullptr, y, partial, s, 0, 1, vec_y, st)
               : launch<64, false, true, CG>(x, w, scale, shift, y, nullptr, s, relu, 1, vec_y,
                                             st);
}

}  // namespace

// The bf16 plans of conv_fused_launch / conv_stats_launch (conv_fused.cu):
// bn 32, 64 or 128 output channels per CTA (BM = 128 rows), vec_a 1 for the
// 16-byte gather (Cin % 8 == 0 and x 16-byte aligned, else refused) or 0
// for the scalar one. geo: n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph,
// pw, dh, dw. Returns a cudaError_t: cudaErrorInvalidValue for a plan not
// built.
int conv_wgmma_run(int stats, int bn, int vec_a, const void* x, const void* w,
                   const void* scale, const void* shift, void* y, void* partial,
                   const int* geo, int relu, void* stream) {
  const Shape s{geo[0], geo[1], geo[2],  geo[3],  geo[4],  geo[5],  geo[6], geo[7],
                geo[8], geo[9], geo[10], geo[11], geo[12], geo[13], geo[14]};
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

// The bf16 plan "wgmma" of grouped_fused_launch / grouped_stats_launch
// (grouped_conv.cu): Cin/G = Cout/G in {4, 8, 16, 32}, Cin = Cout a
// multiple of 64, x and w 16-byte aligned; w (kh, kw, Cin/G, Cout). geo as
// conv_wgmma_run's. Returns a cudaError_t: cudaErrorInvalidValue for a
// shape outside the plan.
int conv_wgmma_grouped_run(int stats, int groups, const void* x, const void* w,
                           const void* scale, const void* shift, void* y, void* partial,
                           const int* geo, int relu, void* stream) {
  const Shape s{geo[0], geo[1], geo[2],  geo[3],  geo[4],  geo[5],  geo[6], geo[7],
                geo[8], geo[9], geo[10], geo[11], geo[12], geo[13], geo[14]};
  if (groups < 1 || s.cin != s.cout || s.cin % 64 != 0 || s.cin % groups != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_y = reinterpret_cast<uintptr_t>(y) % 16 == 0 ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s.cin / groups) {
    case 4: return launch_grouped<4>(stats, x, w, scale, shift, y, partial, s, relu, vec_y, st);
    case 8: return launch_grouped<8>(stats, x, w, scale, shift, y, partial, s, relu, vec_y, st);
    case 16: return launch_grouped<16>(stats, x, w, scale, shift, y, partial, s, relu, vec_y, st);
    case 32: return launch_grouped<32>(stats, x, w, scale, shift, y, partial, s, relu, vec_y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
