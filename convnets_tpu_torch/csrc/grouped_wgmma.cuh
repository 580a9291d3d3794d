// The bf16 grouped convolution on Hopper's tensor cores for every shape of
// the grouped envelope off the grouped mode of csrc/conv_wgmma.cu: route
// "wgmma_wide" of ops/kernels/conv.py:grouped_plan, which the entry points
// of csrc/grouped_conv.cu call. Any Cin/G >= 2, any Cout/G, any kh x kw,
// stride and dilation, any operand alignment; ShuffleNet-v1's grouped 1x1s
// (Cin/G 12-400, Cout/G 12-400, Cout/G != Cin/G) are the shapes it is for.
// Two epilogues over one main loop, chosen by a template parameter, with
// the contracts of csrc/conv_fused.cu:
//
//  * STATS = false (grouped_conv2d_fused, row 1g): y = acc*scale + shift in
//    fp32, optional ReLU, ONE rounding to bf16.
//  * STATS = true (grouped_conv2d_stats, row 5g): y rounded once and
//    stored, plus each row tile's per-channel sum and sum of squares of the
//    STORED values in the (blocks, 2, Cout) layout that conv_fused.cu's
//    stats_reduce_kernel adds in a fixed order (no atomics).
//
// Replaces convnets_tpu/ops/pallas/conv.py:grouped_conv2d_train (:647) and
// fused.py:conv_bn_relu_train (:35) with groups, which run the dense Pallas
// kernels (conv2d_fused :391, conv2d_stats :543) on a block-diagonal weight
// (block_diag_weight :628) where Cin/G <= 32, plus the wide groups (Cin/G
// above 32) that the JAX package leaves to XLA's grouped conv.
//
// What bounds it on the H100: bytes. ShuffleNet's 31 grouped convs of one
// forward at 224^2 b256 move 1.8-3.4 GB (each operand read once, y written
// once: 0.53-1.02 ms at 3.35 TB/s) for 59-64 GFLOP, which the tensor cores
// (989 TFLOP/s bf16) do in a tenth of that. So padding K to 16 and the
// columns to a wgmma width costs time that is free here, and the design
// spends it on keeping the loads wide and the passes over x few:
//
//  * Tiles. A work item is BM = 128 output pixels (two warpgroups of 64
//    rows) times one column tile of NA = 128 accumulator columns. Where
//    Cout/G <= 128 the column tile holds gp whole groups (gp = NA / NW,
//    balanced over the groups), each group NW = the smallest of 16, 32,
//    64, 128 that holds its Cout/G columns; a wider group is split into
//    `pieces` column tiles of pwid (a multiple of 8) columns. The tile's
//    output channels c_lo .. c_lo+W-1 are contiguous in y.
//  * Persistent CTAs. Two CTAs a SM; CTA b keeps column tile b % n_ct and
//    takes row tiles b / n_ct, + gridDim.x / n_ct, ... (the CTAs of a row
//    tile start together, so x is read from device memory about once where
//    a group is split). Its loads run one or two stages ahead through a
//    ring across its row tiles: the next row tile's first stages land
//    while this one's last MMAs and its epilogue run, and a short item (a
//    1x1 of one or two stages) does not pay its load latency alone.
//  * K. Each group is its own chain of MMAs on its own depth: a group's
//    Cin/G channels of a tap are padded with zeros to kp (a multiple of
//    16), the gp groups of a tile laid end to end (the pack's depth
//    gp*kp per tap), walked in 64-deep stages. k16 slice q of a tap
//    belongs to group q / (kp/16) and multiplies only that group's NW
//    columns, into its own accumulators (j*NW/2 onward): no block-diagonal
//    zeros beyond the k16 and wgmma-width padding.
//  * A (x). K-major, 128-byte swizzle, one 128-byte row of 64 pack depth
//    values per pixel. The pack's slab of a tap is read once per item, in
//    copies of ua channels: 16-byte cp.async where Cin/G % 8 == 0 (24, 48,
//    80, 96, 136, 192, ...), 8- or 4-byte cp.async where it is a multiple
//    of 4 or 2 (12, 20, 68, 100; 34, 50), and through registers for odd
//    Cin/G (17, 25); zeros outside the image and past Cin/G.
//  * B (w, (kh, kw, Cin/G, Cout) as stored). MN-major like w, read by
//    wgmma with its transpose bit: per k16 slice of a stage, its group's
//    16 rows of w and NW columns in two 64-column halves of swizzled
//    128-byte rows, so every group's block starts at column 0 and no
//    descriptor starts inside a swizzled row. Copied by cp.async in runs
//    of ub columns (16 bytes where Cout/G % 8 == 0, 8 or 4 bytes where it
//    is a multiple of 4 or 2, through registers for odd Cout/G), zeros
//    past Cin/G. Where a column tile has at most two stages (every
//    narrow shape, the wide ones up to 128 pack channels) its CTA loads B
//    once and keeps it; else B streams beside A through the ring.
//  * Epilogue. The accumulators, scaled or not and rounded once, go to a
//    padded bf16 tile of its own in shared memory at their compacted
//    column (group j's column c at j*width + c), two columns in one store
//    where the width is even; y leaves it in whole runs of its rows in the
//    widest copies that c_lo, W, Cout and y's alignment allow, and the
//    statistics are summed from it by column in a fixed order. The ring
//    keeps loading the next row tile meanwhile.
//
// Shared-memory writes by cp.async and st.shared reach the tensor cores'
// async proxy through fence.proxy.async before the barrier that precedes
// the MMAs; the copies, fences, descriptors and products are those of
// csrc/wgmma.cuh. ops/kernels/conv.py:grouped_wide_tiles states the same
// tile map, and the CPU tests multiply over it. csrc/grouped_wgmma.cu builds
// the fused epilogue and the entry point, csrc/grouped_wgmma_stats.cu the
// statistics epilogue: two sources, so nvcc compiles them side by side.

#pragma once

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr int BM = 128;           // output pixels per row tile: two warpgroups of 64 rows
constexpr int NA = 128;           // accumulator columns per column tile (B rows per stage)
constexpr int THREADS = 256;      // two warpgroups
constexpr int A_BYTES = BM * ROW_BYTES;       // A of one stage: 16 KB
constexpr int B_BYTES = NA * ROW_BYTES;       // B of one stage: 16 KB
constexpr int RING = 4 * A_BYTES;             // A slots and B, resident or streamed: 64 KB
constexpr int RESIDENT_KT = 2;                // B stays resident up to this many stages
constexpr int A_ROWS = BM / (THREADS / 8);    // 4 pixels per thread
// B of a stage: per k16 slice a 16-deep block of NA columns, MN-major (as w
// stores it) in two 64-column halves of 16 swizzled 128-byte rows each
constexpr int SLICE_BLOCK = 16 * ROW_BYTES;   // one half: 2 KB
constexpr int SLICE = 2 * SLICE_BLOCK;        // one slice: 4 KB, four to a stage
constexpr int TILE_ROW = NA * 2 + 16;         // bytes per row of the epilogue tile (padded)
constexpr int SUM_GROUPS = THREADS / (NA / 2);  // row groups of the column sums
// the epilogue tile, then the column sums of its row groups
constexpr int EPI = BM * TILE_ROW + 2 * SUM_GROUPS * NA * 4;
// slack to align the ring, the ring, the epilogue, scale and shift: two
// CTAs fit on an SM
constexpr int SMEM = 1024 + RING + EPI + 2 * NA * 4;

static_assert(A_BYTES == B_BYTES, "the ring is cut in 16 KB pieces");
static_assert(4 * SLICE == B_BYTES && NA == 128, "a stage's four slices of two 64-column halves");
static_assert(RESIDENT_KT * B_BYTES + (RESIDENT_KT) * A_BYTES <= RING &&
              B_BYTES + 3 * A_BYTES <= RING, "resident B and its A slots fit the ring");
static_assert(BM % SUM_GROUPS == 0, "row groups of the sums");

struct WideShape {
  int n, h, w, cin, oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw;
  int groups, cgi, cgo;
  int kp;        // one group's depth per tap, padded to a multiple of 16
  int gp;        // whole groups per column tile (1 where a group is split)
  int pieces;    // column tiles per group (1 where groups are packed)
  int pwid;      // columns of a group per column tile
  int nw;        // accumulator columns per group: 16, 32, 64 or 128
  int n_ct;      // column tiles
  int m_tiles;   // row tiles of BM output pixels
  int kt;        // 64-deep stages of a full column tile
  int resident;  // 1: a CTA keeps its column tile's B of all kt stages in shared memory
  int slots;     // A slots of the ring (B beside each where it is streamed)
  int pointwise; // 1x1, stride 1, no padding: the row tile's pixels are rows of x
  int ua;        // channels per copy of A: 8, 4, 2 (cp.async) or 1 (registers)
  int ub;        // columns per copy of B, the same way
  float inv_kp;  // 1 / kp, for the divisions by kp
};

// The tile map; ops/kernels/conv.py:grouped_wide_tiles is its mirror.
int wide_nw(int cols) { return cols <= 16 ? 16 : cols <= 32 ? 32 : cols <= 64 ? 64 : NA; }

void wide_plan(WideShape& s) {
  s.kp = (s.cgi + 15) / 16 * 16;
  if (s.cgo <= NA) {
    s.pieces = 1;
    s.pwid = s.cgo;
    s.nw = wide_nw(s.cgo);
    const int most = NA / s.nw;
    const int tiles = (s.groups + most - 1) / most;
    s.gp = (s.groups + tiles - 1) / tiles;
    s.n_ct = (s.groups + s.gp - 1) / s.gp;
  } else {
    s.gp = 1;
    s.pieces = (s.cgo + NA - 1) / NA;
    s.pwid = ((s.cgo + s.pieces - 1) / s.pieces + 7) / 8 * 8;
    s.nw = wide_nw(s.pwid);
    s.n_ct = s.groups * s.pieces;
  }
  s.m_tiles = static_cast<int>((static_cast<long long>(s.n) * s.oh * s.ow + BM - 1) / BM);
  s.kt = s.kh * s.kw * ((s.gp * s.kp / 16 + 3) / 4);
  s.resident = s.kt <= RESIDENT_KT;
  s.slots = s.resident ? (RING - s.kt * B_BYTES) / A_BYTES : RING / (A_BYTES + B_BYTES);
  s.pointwise = s.kh == 1 && s.kw == 1 && s.sh == 1 && s.sw == 1 && s.ph == 0 && s.pw == 0;
  s.inv_kp = 1.f / s.kp;
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// D(64 x N) += A(64 x 16, K-major) * B(16 x N, MN-major, read with the
// transpose bit), D the N/2 accumulators from OFF on of the CTA's n128
// fragment (which keeps columns 8j .. 8j+7 in acc[4j .. 4j+3])
template <int N, int OFF>
struct MmaG;

#define ACC4(i) "+f"(d[OFF + (i)]), "+f"(d[OFF + (i) + 1]), "+f"(d[OFF + (i) + 2]), \
    "+f"(d[OFF + (i) + 3])
#define ACC16(i) ACC4(i), ACC4((i) + 4), ACC4((i) + 8), ACC4((i) + 12)

template <int OFF> struct MmaG<16, OFF> {
  static __device__ __forceinline__ void run(float (&d)[NA / 2], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : ACC4(0), ACC4(4)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int OFF> struct MmaG<32, OFF> {
  static __device__ __forceinline__ void run(float (&d)[NA / 2], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : ACC16(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int OFF> struct MmaG<64, OFF> {
  static __device__ __forceinline__ void run(float (&d)[NA / 2], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : ACC16(0), ACC16(16)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int OFF> struct MmaG<128, OFF> {
  static __device__ __forceinline__ void run(float (&d)[NA / 2], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC16
#undef ACC4

// one k16 slice of group j of the tile: A's slice at a (the slice's depth
// offset in each pixel's row), B's at b (the slice's 16 x NW block)
template <int NW, int J = 0>
__device__ __forceinline__ void group_mma(float (&acc)[NA / 2], int j, uint32_t a, uint32_t b) {
  if constexpr (J < NA / NW) {
    if (j == J) {
      MmaG<NW, J * NW / 2>::run(acc, smem_desc(a, 16, ATOM_BYTES),
                                smem_desc(b, SLICE_BLOCK, ATOM_BYTES));
    } else {
      group_mma<NW, J + 1>(acc, j, a, b);
    }
  }
}

// a / kp for 0 <= a < 2^20 (kp a multiple of 16 below 2^12): the float
// product is within 1/2^22 of the exact quotient plus 0.5/kp, which never
// reaches the next integer
__device__ __forceinline__ int div_kp(int a, float inv_kp) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv_kp);
}

// STATS = false: y = acc*scale + shift (both null: no epilogue), optional
// ReLU, one rounding; `partial` unused. STATS = true: y rounded once;
// partial[m_tile][0|1][c] receives the sum and sum of squares of the
// stored y of channel c over the row tile. NW: accumulator columns per
// group. Persistent: CTA b keeps column tile ct = b % n_ct and takes the
// row tiles b / n_ct, + gridDim.x / n_ct, ... (the CTAs of one row tile
// start together, so its rows of x are read from device memory about
// once); its loads run slots - 1 stages ahead across its row tiles, so the
// next row tile's first stages land while this one's last MMAs and its
// epilogue run.
template <int NW, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
grouped_wide_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ partial, WideShape s,
                    int relu) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const uint32_t raw = smem_u32(wide_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* const tile = wide_smem + (ring - raw) + RING;  // the epilogue's bf16 tile
  float* const red = reinterpret_cast<float*>(tile + BM * TILE_ROW);  // [2][SUM_GROUPS][NA]
  float* const epi = red + 2 * SUM_GROUPS * NA;  // the tile's scale and shift, [2][NA]

  const int tid = threadIdx.x;
  const int M = s.n * s.oh * s.ow;
  // this CTA's column tile: groups g0 .. g0+ng-1, columns col0 .. col0+width-1
  // of each, output channels c_lo .. c_lo+W-1 (contiguous in y)
  const int ct = blockIdx.x % s.n_ct;
  const int r_step = gridDim.x / s.n_ct;
  int g0, ng, col0, width;
  if (s.pieces > 1) {
    g0 = ct / s.pieces;
    ng = 1;
    col0 = (ct - g0 * s.pieces) * s.pwid;
    width = min(s.pwid, s.cgo - col0);
  } else {
    g0 = ct * s.gp;
    ng = min(s.gp, s.groups - g0);
    col0 = 0;
    width = s.cgo;
  }
  const int W = ng * width;
  const int c_lo = g0 * s.cgo + col0;
  const int nq = ng * (s.kp / 16);  // k16 slices per tap
  const int spt = (nq + 3) / 4;     // stages per tap
  const int KT = s.kh * s.kw * spt; // stages per row tile
  if (!STATS && scale && tid < W) {
    epi[tid] = scale[c_lo + tid];
    epi[NA + tid] = shift[c_lo + tid];
  }
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  // B of stage kt into sb: slice kk (k16 slice q = 4*st + kk of the tap,
  // group j = q / (kp/16), its depth k0 .. k0+15) holds w's rows tap*cgi +
  // k0 .. +15 of the group's columns col0 .. col0+width-1 as stored, zeros
  // past Cin/G; columns past the width are not written (they feed only
  // accumulators that are never stored)
  auto load_b = [&](int kt, uint32_t sb) {
    constexpr int CH = NW / 8;  // 16-byte chunks of a slice row
    const int tap = kt / spt;
    const int st = kt - tap * spt;
    for (int it = tid; it < 4 * 16 * CH; it += THREADS) {
      const int chunk = it % CH;
      const int row = (it / CH) % 16;
      const int kk = it / (16 * CH);
      const int q = 4 * st + kk;
      const int n = chunk * 8;
      if (q >= nq || n >= width) continue;
      const int j = q / (s.kp / 16);
      const int k = (q - j * (s.kp / 16)) * 16 + row;
      const bool ok = k < s.cgi;
      const int have = min(8, width - n);
      const __nv_bfloat16* src =
          wt + (static_cast<size_t>(tap * s.cgi + k) * s.cout + (g0 + j) * s.cgo + col0 + n);
      const uint32_t dst = sb + kk * SLICE + (chunk >> 3) * SLICE_BLOCK + (row >> 3) * ATOM_BYTES +
                           swz(row & 7, chunk & 7);
      if (s.ub == 8) {
        cp_async16(dst, ok ? src : wt, ok);
      } else if (s.ub == 4) {
        cp_async8(dst, ok ? src : wt, ok);
        cp_async8(dst + 8, ok && have > 4 ? src + 4 : wt, ok && have > 4);
      } else if (s.ub == 2) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          cp_async4(dst + 4 * u, ok && 2 * u < have ? src + 2 * u : wt, ok && 2 * u < have);
      } else {
        const unsigned short* sw = reinterpret_cast<const unsigned short*>(src);
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ok && e < have) v[e >> 1] |= static_cast<uint32_t>(__ldg(sw + e)) << ((e & 1) * 16);
        st_shared16(dst, v);
      }
    }
  };
  // the ring: resident, B of stage kt at kt*B_BYTES and A slot i after all
  // of B; streamed, slot i holds A and then B
  auto a_slot = [&](int i) -> uint32_t {
    return ring + (s.resident ? s.kt * B_BYTES + i * A_BYTES : i * (A_BYTES + B_BYTES));
  };
  auto b_stage = [&](int slot, int kt) -> uint32_t {
    return ring + (s.resident ? kt * B_BYTES : slot * (A_BYTES + B_BYTES) + A_BYTES);
  };
  if (s.resident)
    for (int kt = 0; kt < KT; ++kt) load_b(kt, b_stage(0, kt));

  // the load cursor: row tile lr, its stage lk; this thread fills 16-byte
  // chunk `ac` of A's rows ar + 32*i: pixel a_pix[i] (pointwise: row of x,
  // -1 past M), or image base a_pix[i] and the tap's origin a_iy[i], a_ix[i]
  const int ac = tid & 7;
  const int ar = tid >> 3;
  int lr = blockIdx.x / s.n_ct, lk = 0;
  int a_pix[A_ROWS], a_iy[A_ROWS], a_ix[A_ROWS];
  auto set_rows = [&]() {
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int m = lr * BM + ar + 32 * i;
      if (s.pointwise) {
        a_pix[i] = m < M ? m : -1;
        a_iy[i] = a_ix[i] = 0;
      } else if (m < M) {
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
  };
  if (lr < s.m_tiles) set_rows();

  auto load_next = [&](int slot) {
    if (lr < s.m_tiles) {
      const uint32_t sa = a_slot(slot);
      const int tap = lk / spt;
      const int st = lk - tap * spt;
      const int ky = tap / s.kw;
      const int kx = tap - ky * s.kw;
      // A: pack depth 64*st + 8*ac .. +7 = channels k .. k+7 of group j
      const int pa = 64 * st + 8 * ac;
      if (pa < nq * 16) {
        const int j = div_kp(pa, s.inv_kp);
        const int k = pa - j * s.kp;
        const int have = min(8, s.cgi - k);  // of those that exist (<= 0: none)
        const int ch = (g0 + j) * s.cgi + k;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const uint32_t dst = sa + swz(ar + 32 * i, ac);
          bool in;
          int at;
          if (s.pointwise) {
            in = have > 0 && a_pix[i] >= 0;
            at = a_pix[i] * s.cin + ch;
          } else {
            const int iy = a_iy[i] + ky * s.dh;
            const int ix = a_ix[i] + kx * s.dw;
            in = have > 0 && (unsigned)iy < (unsigned)s.h && (unsigned)ix < (unsigned)s.w;
            at = (a_pix[i] + iy * s.w + ix) * s.cin + ch;
          }
          if (!in) {
            cp_async16(dst, x, false);
          } else if (s.ua == 8) {
            cp_async16(dst, x + at, true);
          } else if (s.ua == 4) {
            cp_async8(dst, x + at, true);
            cp_async8(dst + 8, have > 4 ? x + at + 4 : x, have > 4);
          } else if (s.ua == 2) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              cp_async4(dst + 4 * u, 2 * u < have ? x + at + 2 * u : x, 2 * u < have);
          } else {
            uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < have) v[e >> 1] |= static_cast<uint32_t>(__ldg(xs + at + e)) << ((e & 1) * 16);
            st_shared16(dst, v);
          }
        }
      }
      if (!s.resident) load_b(lk, b_stage(slot, lk));
      if (++lk == KT) {
        lk = 0;
        lr += r_step;
        if (lr < s.m_tiles) set_rows();
      }
    }
    cp_async_commit();  // empty past the last row tile: keeps the group count uniform
  };

  // accumulator fragment of m64n128k16: thread holds rows rl and rl + 8 of
  // the tile, accumulator columns 8b + cq and 8b + cq + 1 in
  // acc[4b + 2h + {0, 1}]; column a is column a % NW of group a / NW, tile
  // column (a / NW)*width + a % NW
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int rl = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[NA / 2];

  int slot = 0;  // of the stage multiplied next; its loads run slots - 1 ahead
  for (int i = 0; i + 1 < s.slots; ++i) load_next(i);
  for (int r = blockIdx.x / s.n_ct; r < s.m_tiles; r += r_step) {
#pragma unroll
    for (int i = 0; i < NA / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      if (s.slots >= 3) {
        cp_async_wait<1>();  // this thread's copies of this stage have landed
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();  // ... and, with its stores, are visible to the tensor cores
      __syncthreads();      // everyone's; every MMA of the previous stage is done
      const uint32_t sa = a_slot(slot) + wg * (64 * ROW_BYTES);
      const uint32_t sb = b_stage(slot, kt);
      const int st = kt % spt;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int q = 4 * st + kk;
        if (q < nq) group_mma<NW>(acc, q / (s.kp / 16), sa + kk * 32, sb + kk * SLICE);
      }
      wgmma_commit();
      // into the slot of the previous stage, while this one multiplies
      load_next(slot > 0 ? slot - 1 : s.slots - 1);
      wgmma_wait<0>();
      fence_acc(acc);
      slot = slot + 1 < s.slots ? slot + 1 : 0;
    }

    // epilogue: each value rounded once to the tile (two columns in one
    // store where the groups' width is even), then y from the tile in runs
    // of uy, the statistics summed from the tile by column in a fixed order
    const int m0 = r * BM;
#pragma unroll
    for (int b = 0; b < NA / 8; ++b) {
      constexpr int PER = NW / 8;
      const int j = b / PER;
      if (j >= ng) continue;
      const int cl = 8 * (b - j * PER) + cq;  // columns cl, cl + 1 of group j
      if (cl >= width) continue;
      const int t = j * width + cl;           // ... tile columns t, t + 1
      const bool two = cl + 1 < width;
      float sc[2] = {1.f, 1.f}, sf[2] = {0.f, 0.f};
      if (!STATS && scale) {
        sc[0] = epi[t];
        sf[0] = epi[NA + t];
        if (two) {
          sc[1] = epi[t + 1];
          sf[1] = epi[NA + t + 1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[4 * b + 2 * h + e];
          if (!STATS) {
            if (scale) v[e] = v[e] * sc[e] + sf[e];
            if (relu) v[e] = fmaxf(v[e], 0.f);
          }
        }
        unsigned char* dst = tile + (rl + 8 * h) * TILE_ROW + t * 2;
        if (two && (width & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          reinterpret_cast<__nv_bfloat16*>(dst)[0] = __float2bfloat16_rn(v[0]);
          if (two) reinterpret_cast<__nv_bfloat16*>(dst)[1] = __float2bfloat16_rn(v[1]);
        }
      }
    }
    __syncthreads();
    // y: runs of uy elements of the tile's rows, uy the largest of 8, 4, 2,
    // 1 that divides c_lo, W and Cout and y's alignment, the runs of a row
    // on 2^lg threads
    const int y_align = static_cast<int>(reinterpret_cast<uintptr_t>(y) & 15);
    int uy = 8;
    while (uy > 1 && ((c_lo | W | s.cout) % uy != 0 || y_align % (2 * uy) != 0)) uy >>= 1;
    const int runs = W / uy;
    int lg = 0;
    while ((1 << lg) < runs) ++lg;
    for (int row = tid >> lg; row < BM; row += THREADS >> lg) {
      const int u = tid & ((1 << lg) - 1);
      const int m = m0 + row;
      if (u >= runs || m >= M) continue;
      const unsigned char* src = tile + row * TILE_ROW + u * uy * 2;
      __nv_bfloat16* dst = y + (static_cast<size_t>(m) * s.cout + c_lo + u * uy);
      if (uy == 8) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else if (uy == 4) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      } else if (uy == 2) {
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
      } else {
        *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
      }
    }
    if constexpr (STATS) {
      // thread (pair, group) adds one column pair over its group's rows in
      // order (rows past M left out), then thread c of the CTA adds the
      // groups' sums of column c in order; columns past W are not written
      constexpr int PAIRS = NA / 2;
      constexpr int ROWS = BM / SUM_GROUPS;
      const int pr = tid % PAIRS;
      const int gr = tid / PAIRS;
      const int valid = M - m0 - gr * ROWS;
      float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll 8
      for (int rr = 0; rr < ROWS; ++rr) {
        if (rr < valid) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              tile + (gr * ROWS + rr) * TILE_ROW + pr * 4);
          const float f0 = __low2float(v), f1 = __high2float(v);
          a0 += f0;
          a1 += f1;
          q0 = fmaf(f0, f0, q0);
          q1 = fmaf(f1, f1, q1);
        }
      }
      red[gr * NA + 2 * pr] = a0;
      red[gr * NA + 2 * pr + 1] = a1;
      red[(SUM_GROUPS + gr) * NA + 2 * pr] = q0;
      red[(SUM_GROUPS + gr) * NA + 2 * pr + 1] = q1;
      __syncthreads();
      if (tid < 2 * NA) {
        const int stat = tid / NA;
        const int cl = tid % NA;
        float sum = 0.f;
#pragma unroll
        for (int gg = 0; gg < SUM_GROUPS; ++gg) sum += red[(stat * SUM_GROUPS + gg) * NA + cl];
        if (cl < W) partial[(static_cast<size_t>(r) * 2 + stat) * s.cout + c_lo + cl] = sum;
      }
    }
    // the next row tile's stage barriers come before its epilogue writes the
    // tile and the sums again
  }
  cp_async_wait<0>();
}

template <int NW, bool STATS>
int launch(const void* x, const void* w, const void* scale, const void* shift, void* y,
           void* partial, const WideShape& s, int relu, cudaStream_t stream) {
  auto kernel = grouped_wide_kernel<NW, STATS>;
  // the shared-memory opt-in and the CTAs the card holds at once, once per
  // instantiation and device: one bit per device that has them
  static std::atomic<unsigned long long> sized{0};
  static int resident[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long bit = 1ull << dev;
  if (!(sized.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident[dev] = (per_sm > 1 ? per_sm : 1) * sms;
    sized.fetch_or(bit);
  }
  if (s.m_tiles == 0) return static_cast<int>(cudaSuccess);
  // CTAs per column tile: as many as the card holds, at most one per row tile
  const int per_ct = resident[dev] / s.n_ct;
  const long long rows = per_ct < 1 ? 1 : (per_ct < s.m_tiles ? per_ct : s.m_tiles);
  const long long blocks = rows * s.n_ct;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), s, relu);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int launch_nw(const void* x, const void* w, const void* scale, const void* shift, void* y,
              void* partial, const WideShape& s, int relu, cudaStream_t st) {
  switch (s.nw) {
    case 16: return launch<16, STATS>(x, w, scale, shift, y, partial, s, relu, st);
    case 32: return launch<32, STATS>(x, w, scale, shift, y, partial, s, relu, st);
    case 64: return launch<64, STATS>(x, w, scale, shift, y, partial, s, relu, st);
    case 128: return launch<128, STATS>(x, w, scale, shift, y, partial, s, relu, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shape, tile map and copy widths of a call: geo is n, h, w, cin, oh,
// ow, cout, kh, kw, sh, sw, ph, pw, dh, dw. Returns false for channels the
// groups do not divide.
bool wide_shape(WideShape& s, int groups, const void* x, const void* w, const int* geo) {
  s = WideShape{geo[0], geo[1],  geo[2],  geo[3],  geo[4],  geo[5], geo[6], geo[7],
                geo[8], geo[9], geo[10], geo[11], geo[12], geo[13], geo[14], groups};
  if (groups < 1 || s.cin % groups != 0 || s.cout % groups != 0) return false;
  s.cgi = s.cin / groups;
  s.cgo = s.cout / groups;
  wide_plan(s);
  // the widest copy of A that every group's channel runs and x allow
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  s.ua = 8;
  while (s.ua > 1 && ((s.cgi | s.cin) % s.ua != 0 || xa % (2 * s.ua) != 0)) s.ua >>= 1;
  // ... and of B, whose tiles start at multiples of 8 columns of a group
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  s.ub = 8;
  while (s.ub > 1 && ((s.cgo | s.cout) % s.ub != 0 || wa % (2 * s.ub) != 0)) s.ub >>= 1;
  return true;
}

}  // namespace
