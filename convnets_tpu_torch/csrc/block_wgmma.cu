// The bf16 route of the whole-bottleneck-block kernel on Hopper's tensor
// cores: one launch computes
//
//   h1  = round(ReLU(s1 * (x . W1) + b1))            1x1, Cin -> Cmid
//   h2  = round(ReLU(s2 * conv3x3(h1, W2) + b2))     3x3 pad 1, Cmid -> Cmid
//   out = round([ReLU](s3 * (h2 . W3) + b3 + x))     1x1, Cmid -> Cin
//
// as three chained warpgroup MMAs (wgmma, fp32 accumulators) with h1 and h2
// held in shared memory. Replaces convnets_tpu/ops/pallas/block.py:
// bottleneck_block (:122; _block_kernel :42), with the rounding points of
// csrc/block.cu (whose CUDA-core loop stays the fp32 route and the route of
// the other bf16 shapes): h1 and h2 rounded once each, the residual added in
// fp32, one rounding at the end; a pixel outside the image is 0 in h1, not
// ReLU(b1). The route is chosen by ops/kernels/block.py:block_plan: Cmid in
// {64, 128, 256}, Cin % 64 == 0, and a tile that fits.
//
// A CTA of two warpgroups owns TH whole output rows of one image (TH*W <=
// 128 pixels: the MMA rows M2 = 128 of conv2 and conv3, 64 per warpgroup),
// so the 3x3 conv's halo is only the row above and the row below. Columns
// outside the image are the zero border of h1 and are never computed.
//
//  * conv1: A is the (TH+2)*W x rows of the tile and its halo, zero outside
//    the image, K-major with the 128-byte swizzle, 16-byte cp.async; B is W1
//    in 64-deep stages. Warpgroup g multiplies m64 blocks g, g+2 (at most
//    MB1 of them: MB1 = 1 at Cmid = 256, whose n256 accumulator is 128
//    registers, else 2). The epilogue applies s1/b1 and ReLU, rounds, and
//    writes h1 into a bordered (TH+2) x (W+2) x Cmid tile in shared memory:
//    the border columns and the rows outside the image hold 0. The pixel
//    pitch is a multiple of 128 bytes, so each pixel's 16-byte chunks are
//    XOR-swizzled by (pixel mod 8): the eight rows of an ldmatrix tile land
//    in eight different bank groups.
//  * conv2: 9 taps x Cmid/64 stages of four k16 steps. The tap-shifted rows
//    of a multi-row tile are not evenly strided, so no descriptor can
//    address them: A is loaded from h1 into registers with ldmatrix.x4
//    (each lane the address of its own pixel's chunk for the tap) and the
//    MMAs take A from registers. Two fragment sets alternate between
//    stages, so a stage's loads never write registers that the MMAs still in
//    flight read. B is the tap's W2 slice from the ring. After the last MMA
//    has retired and a barrier has passed, h1 is dead: the epilogue (s2/b2,
//    ReLU, one rounding) writes h2 over it, K-major and swizzled as a
//    descriptor reads it.
//  * conv3: A is h2 through descriptors, B is W3 in passes of 128 output
//    channels (64 for a last odd half). The pass's last stage also copies
//    the tile's x rows for those channels into its ring slot (L2-resident:
//    conv1 read them); the epilogue adds s3*acc + b3 + x in fp32, applies
//    the optional ReLU, rounds once in place, and the tile leaves in 16-byte
//    chunks of whole rows.
//
// The ring: three 48 KB slots, one stream of stages through all three
// products (conv1's A + B, conv2's B, conv3's B + the residual), so each
// phase's first loads are in flight during the last MMAs of the phase
// before. A stage begins with a barrier, after which every MMA two stages
// back is retired (each warpgroup's wgmma.wait_group 1), and issues the next
// stage's copies into that slot at once; only then does each thread wait
// for its copies of this stage, fence the async proxy, and pass a second
// barrier to the MMAs. So two stages' copies are in flight while the MMAs
// of the stage before run.
//
// What bounds it on the H100: the MMAs alone would take about a third of
// its time. At RN50's identity shapes they do 1.3-1.4x the useful work
// (conv1 recomputes the two halo rows of h1, and 98 or 112 output pixels
// fill 128 MMA rows). Every CTA streams all three weight matrices from L2
// (2.2 MB at 14x14x1024/256, 0.54 MB at 28x28x512/128) for its 98 or 112
// pixels, and one CTA fits per SM (222 KB of shared memory at 14x14), so
// the stages wait on their copies and the epilogues are not overlapped with
// another CTA's MMAs (PERF.md, section 6). Tried on the H100 and slower:
// draining the MMAs every stage to load two stages ahead, a second
// accumulator set to overlap conv3's epilogues with the next pass (register
// pressure), and the weights by TMA, per CTA or multicast to a cluster of
// two CTAs (each stage then waits on the other CTA as well).

#include <atomic>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;   // two consumer warpgroups
constexpr int M2 = 128;        // output pixels per CTA: MMA rows of conv2 and conv3
constexpr int BK = 64;         // depth per stage: one 128-byte row of bf16
constexpr int NP = 128;        // conv3 output channels per pass
constexpr int SLOTS = 3;       // ring slots
constexpr int AHEAD = 1;       // stages loaded ahead of the one being multiplied
constexpr int SLOT_BYTES = 48 * 1024;
constexpr int B3_BYTES = BK * NP * 2;      // a conv3 stage's W3 rows
constexpr int RES_PITCH = NP * 2;          // bytes per residual row
constexpr int RES_BYTES = M2 * RES_PITCH;  // the residual x tile of one pass
constexpr int MAX_SMEM = 232448;           // the H100's opt-in limit per block
static_assert(BK * 2 == ROW_BYTES, "a stage's depth is one swizzled row");
static_assert(SLOTS >= AHEAD + 2, "a slot is refilled two stages after its MMAs were issued");
static_assert(B3_BYTES + RES_BYTES <= SLOT_BYTES, "conv3 stage");

template <int CM, int MB1>
struct Cfg {
  static constexpr int CB = CM / BK;                       // 64-channel blocks of Cmid
  static constexpr int A1_BYTES = 2 * MB1 * 64 * ROW_BYTES;  // conv1's x rows
  static constexpr int B_BYTES = BK * CM * 2;                // a W1 or W2 stage
  static constexpr int PITCH = CM * 2;                       // h1 bytes per pixel
  static_assert(A1_BYTES + B_BYTES <= SLOT_BYTES, "conv1 stage");
  static_assert(MB1 * CM <= 256, "conv1's accumulators: at most 128 per thread");
};

// bytes of shared memory of a tile of th rows of width w: the ring, the
// bordered h1 (or h2 where larger), 1 KB to align the ring
template <int CM>
int smem_bytes(int th, int w) {
  const int h1 = (th + 2) * (w + 2) * CM * 2;
  const int h2 = M2 * CM * 2;
  return 1024 + SLOTS * SLOT_BYTES + (((h1 > h2 ? h1 : h2) + 1023) & ~1023);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1;
  const __nv_bfloat16* w2;
  const __nv_bfloat16* w3;
  const float* sb;  // (6, Cin): s1, b1, s2, b2 (first Cmid entries), s3, b3
  __nv_bfloat16* out;
  int h, w, cin, th, tiles_h, relu_out;
};

__device__ __forceinline__ uint32_t ld_shared32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __bfloat1622float2(v);
}

// One CTA: output rows oy0 .. oy0+th-1 of image blockIdx.x / tiles_h.
template <int CM, int MB1>
__global__ void __launch_bounds__(THREADS, 1) block_wgmma_kernel(Args a) {
  using C = Cfg<CM, MB1>;
  extern __shared__ __align__(16) unsigned char block_smem[];
  const uint32_t raw = smem_u32(block_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t h1s = ring + SLOTS * SLOT_BYTES;  // bordered h1; h2 overlays it

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int cq = 2 * (lane & 3);  // the fragment's first column of each 8
  const int img = blockIdx.x / a.tiles_h;
  const int oy0 = (blockIdx.x - img * a.tiles_h) * a.th;
  const int W = a.w;
  const int W2 = W + 2;
  const int P1 = (a.th + 2) * W;  // h1 pixels: the tile's rows and its halo rows
  const int NB1 = (P1 + 63) / 64;  // conv1's m64 blocks
  const int P2 = a.th * W;         // output pixels
  const int KT1 = a.cin / BK;
  constexpr int KT2 = 9 * C::CB;
  constexpr int KT3 = C::CB;
  const int S2 = KT1, S3 = KT1 + KT2;
  const int total = S3 + ((a.cin + NP - 1) / NP) * KT3;
  const size_t img_off = static_cast<size_t>(img) * a.h * W * a.cin;
  const __nv_bfloat16* xi = a.x + img_off;
  __nv_bfloat16* oi = a.out + img_off;

  // conv1's A: this thread copies chunk ac of rows ar + 32i; a_off is the
  // row's x pixel (element offset in the image), -1 where it is zero
  constexpr int AR = 4 * MB1;
  const int ac = tid & 7;
  const int ar = tid >> 3;
  int a_off[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int q = ar + 32 * i;
    const int hr = q / W;
    const int iy = oy0 - 1 + hr;
    a_off[i] = (q < P1 && iy >= 0 && iy < a.h) ? (iy * W + q - hr * W) * a.cin : -1;
  }
  // the residual and out: this thread moves chunk oc of tile rows or + 16i
  const int oc = tid & 15;
  const int orow = tid >> 4;
  int o_off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = orow + 16 * i;
    const int r = p / W;
    o_off[i] = (p < P2 && oy0 + r < a.h) ? ((oy0 + r) * W + p - r * W) * a.cin : -1;
  }

  // 64 rows of a weight matrix (row stride `stride`), `cols` columns from
  // src, into 64-column blocks of swizzled rows at dst
  auto load_b = [&](uint32_t dst, const __nv_bfloat16* src, int stride, int chunks_per_row,
                    int cols) {
    const int chunks = 64 * chunks_per_row;
    for (int idx = tid; idx < chunks; idx += THREADS) {
      const int r = idx / chunks_per_row;
      const int c8 = idx - r * chunks_per_row;
      if (c8 * 8 < cols)
        cp_async16(dst + (c8 >> 3) * B_BLOCK_BYTES + swz(r, c8 & 7),
                   src + static_cast<size_t>(r) * stride + c8 * 8, true);
    }
  };

  auto load_stage = [&](int s) {
    if (s < total) {
      const uint32_t sl = ring + (s % SLOTS) * SLOT_BYTES;
      if (s < S2) {  // conv1: x rows (A) and W1 rows k0 .. k0+63 (B)
        const int k0 = s * BK;
#pragma unroll
        for (int i = 0; i < AR; ++i) {
          const bool ok = a_off[i] >= 0;
          cp_async16(sl + swz(ar + 32 * i, ac), ok ? xi + a_off[i] + k0 + ac * 8 : a.x, ok);
        }
        load_b(sl + C::A1_BYTES, a.w1 + static_cast<size_t>(k0) * CM, CM, CM / 8, CM);
      } else if (s < S3) {  // conv2: W2 of tap j / CB, input channels 64 (j % CB) ..
        const int j = s - S2;
        const int tap = j / C::CB;
        const int k0 = tap * CM + (j - tap * C::CB) * BK;
        load_b(sl, a.w2 + static_cast<size_t>(k0) * CM, CM, CM / 8, CM);
      } else {  // conv3: W3 rows of the pass's columns; the residual with its last stage
        const int j = s - S3;
        const int pass = j / KT3;
        const int ks = j - pass * KT3;
        const int n0 = pass * NP;
        const int cols = a.cin - n0 < NP ? a.cin - n0 : NP;
        load_b(sl, a.w3 + static_cast<size_t>(ks * BK) * a.cin + n0, a.cin, NP / 8, cols);
        if (ks == KT3 - 1 && oc * 8 < cols) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int p = orow + 16 * i;
            const bool ok = o_off[i] >= 0;
            cp_async16(sl + B3_BYTES + p * RES_PITCH + ((oc ^ (p & 7)) << 4),
                       ok ? xi + o_off[i] + n0 + oc * 8 : a.x, ok);
          }
        }
      }
    }
    cp_async_commit();  // empty past the end: keeps the group count uniform
  };

  // every stage: once every MMA two stages back is done (each warpgroup's
  // wgmma.wait_group 1 of the stage before), the next stage's loads go to
  // their slot; then this thread's copies of this stage have landed and are
  // visible to the tensor cores, and everyone's too. Two stages' loads are
  // in flight while the MMAs of the stage before run.
  auto stage_top = [&](int s) {
    __syncthreads();
    load_stage(s + AHEAD);  // into the slot that stage s - 2 used
    cp_async_wait<AHEAD>();
    fence_proxy_async();
    __syncthreads();
    return ring + (s % SLOTS) * SLOT_BYTES;
  };

  // h1's border columns: the 3x3 conv's zero padding at the left and right
  {
    const uint32_t zero[4] = {0u, 0u, 0u, 0u};
    constexpr int CH = CM / 8;
    for (int i = tid; i < (a.th + 2) * 2 * CH; i += THREADS) {
      const int r = i / (2 * CH);
      const int side = (i / CH) & 1;
      st_shared16(h1s + (r * W2 + side * (W + 1)) * C::PITCH + (i % CH) * 16, zero);
    }
  }

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) load_stage(s);
  int s = 0;

  // ---- conv1: h1 = round(ReLU(s1 * (x . W1) + b1)) over the tile and halo
  {
    float acc[MB1][CM / 2];
#pragma unroll
    for (int i = 0; i < MB1; ++i)
#pragma unroll
      for (int e = 0; e < CM / 2; ++e) acc[i][e] = 0.f;
    for (int k = 0; k < KT1; ++k, ++s) {
      const uint32_t sl = stage_top(s);
#pragma unroll
      for (int i = 0; i < MB1; ++i) fence_acc(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MB1; ++i) {
        const int b = wg + 2 * i;
        if (b < NB1) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            Mma<CM>::run(acc[i], smem_desc(sl + b * 64 * ROW_BYTES + kk * 32, 16, ATOM_BYTES),
                         smem_desc(sl + C::A1_BYTES + kk * 16 * ROW_BYTES, B_BLOCK_BYTES,
                                   ATOM_BYTES));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage s - 1's MMAs are done; stage s's stay in flight
#pragma unroll
      for (int i = 0; i < MB1; ++i) fence_acc(acc[i]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MB1; ++i) fence_acc(acc[i]);
    // accumulator fragment: rows 16*warp + lane/4 (+8), columns 8j + cq (+1)
    // in acc[4j + 2h + {0, 1}]
#pragma unroll
    for (int i = 0; i < MB1; ++i) {
      const int b = wg + 2 * i;
      if (b >= NB1) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = b * 64 + warp * 16 + (lane >> 2) + 8 * hh;
        if (q >= P1) continue;
        const int hr = q / W;
        const int iy = oy0 - 1 + hr;
        const bool inside = iy >= 0 && iy < a.h;
        const int pix = hr * W2 + (q - hr * W) + 1;
        const uint32_t dst = h1s + pix * C::PITCH + cq * 2;
#pragma unroll
        for (int j = 0; j < CM / 8; ++j) {
          const float2 sc = __ldg(reinterpret_cast<const float2*>(a.sb + 8 * j + cq));
          const float2 sf = __ldg(reinterpret_cast<const float2*>(a.sb + a.cin + 8 * j + cq));
          // outside the image h1 is the 3x3 conv's zero padding, not ReLU(b1)
          const float v0 = inside ? fmaxf(acc[i][4 * j + 2 * hh] * sc.x + sf.x, 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[i][4 * j + 2 * hh + 1] * sc.y + sf.y, 0.f) : 0.f;
          st_shared32(dst + ((j ^ (pix & 7)) << 4), pack_bf16(v0, v1));
        }
      }
    }
  }

  // ---- conv2: h2 = round(ReLU(s2 * conv3x3(h1, W2) + b2)) over the tile
  const int rl = wg * 64 + warp * 16 + (lane >> 2);  // this thread's first fragment row
  {
    float acc[CM / 2];
#pragma unroll
    for (int e = 0; e < CM / 2; ++e) acc[e] = 0.f;
    // this lane's ldmatrix row: output pixel p (pixel 0 for the padding
    // rows, whose results are never stored), at tap (0, 0) of bordered h1
    const int p = wg * 64 + warp * 16 + (lane & 15);
    const int pc = p < P2 ? p : 0;
    const int pr = pc / W;
    const int pbase = pr * W2 + (pc - pr * W);
    const int hi = lane >> 4;
    uint32_t fa[BK / 16][4], fb[BK / 16][4];
    auto stage2 = [&](uint32_t (&f)[BK / 16][4]) {
      const uint32_t sl = stage_top(s);
      const int j = s - S2;
      const int tap = j / C::CB;
      const int cb = j - tap * C::CB;
      const int ky = tap / 3;
      const int pix = pbase + ky * W2 + (tap - 3 * ky);
      const uint32_t row = h1s + pix * C::PITCH;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        ldmatrix_x4(f[kk], row + (((cb * 8 + kk * 2 + hi) ^ (pix & 7)) << 4));
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        MmaR<CM>::run(acc, f[kk],
                      smem_desc(sl + kk * 16 * ROW_BYTES, B_BLOCK_BYTES, ATOM_BYTES));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      ++s;
    };
    for (int k = 0; k < KT2; k += 2) {
      stage2(fa);
      if (k + 1 < KT2) stage2(fb);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // every warp's reads of h1 are done: h2 overlays it
    // h2, K-major: Cmid/64 blocks of M2 swizzled 128-byte rows
#pragma unroll
    for (int j = 0; j < CM / 8; ++j) {
      const float2 sc = __ldg(reinterpret_cast<const float2*>(a.sb + 2 * a.cin + 8 * j + cq));
      const float2 sf = __ldg(reinterpret_cast<const float2*>(a.sb + 3 * a.cin + 8 * j + cq));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v0 = fmaxf(acc[4 * j + 2 * hh] * sc.x + sf.x, 0.f);
        const float v1 = fmaxf(acc[4 * j + 2 * hh + 1] * sc.y + sf.y, 0.f);
        st_shared32(h1s + (j >> 3) * (M2 * ROW_BYTES) + swz(rl + 8 * hh, j & 7) + cq * 2,
                    pack_bf16(v0, v1));
      }
    }
  }

  // ---- conv3: out = round([ReLU](s3 * (h2 . W3) + b3 + x)), NP columns a pass
  auto pass3 = [&](auto width, int n0) {
    constexpr int NW = decltype(width)::value;
    float acc[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
    for (int ks = 0; ks < KT3; ++ks, ++s) {
      const uint32_t sl = stage_top(s);
      const uint32_t sa = h1s + ks * (M2 * ROW_BYTES) + wg * 64 * ROW_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<NW>::run(acc, smem_desc(sa + kk * 32, 16, ATOM_BYTES),
                     smem_desc(sl + kk * 16 * ROW_BYTES, B_BLOCK_BYTES, ATOM_BYTES));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // the residual x of these columns is in the slot of the pass's last
    // stage; each value is read, finished and rounded in place
    const uint32_t res = ring + ((s - 1) % SLOTS) * SLOT_BYTES + B3_BYTES;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float2 sc = __ldg(reinterpret_cast<const float2*>(a.sb + 4 * a.cin + n0 + 8 * j + cq));
      const float2 sf = __ldg(reinterpret_cast<const float2*>(a.sb + 5 * a.cin + n0 + 8 * j + cq));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rl + 8 * hh;
        const uint32_t at = res + r * RES_PITCH + ((j ^ (r & 7)) << 4) + cq * 2;
        const float2 xv = unpack_bf16(ld_shared32(at));
        float v0 = acc[4 * j + 2 * hh] * sc.x + sf.x + xv.x;
        float v1 = acc[4 * j + 2 * hh + 1] * sc.y + sf.y + xv.y;
        if (a.relu_out) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        st_shared32(at, pack_bf16(v0, v1));
      }
    }
    __syncthreads();
    if (oc * 8 < NW) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = orow + 16 * i;
        if (o_off[i] >= 0)
          *reinterpret_cast<uint4*>(oi + o_off[i] + n0 + oc * 8) =
              ld_shared16(res + p * RES_PITCH + ((oc ^ (p & 7)) << 4));
      }
    }
  };
  int n0 = 0;
  for (; n0 + NP <= a.cin; n0 += NP) pass3(std::integral_constant<int, NP>{}, n0);
  if (n0 < a.cin) pass3(std::integral_constant<int, 64>{}, n0);
}

template <int CM, int MB1>
int launch(const Args& a, int n, cudaStream_t st) {
  auto kernel = block_wgmma_kernel<CM, MB1>;
  const int bytes = smem_bytes<CM>(a.th, a.w);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory opt-in, once per instantiation and device: one bit
  // per device that has it
  static std::atomic<unsigned long long> sized{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long bit = 1ull << dev;
  if (!(sized.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.fetch_or(bit);
  }
  const long long blocks = static_cast<long long>(n) * a.tiles_h;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 route "wgmma" of bottleneck_launch (block.cu): Cmid in {64, 128,
// 256}, Cin % 64 == 0, Cmid <= Cin, th output rows per CTA with th*w <= 128
// and (th+2)*w <= 128 (Cmid 256) or 256 (Cmid 64, 128), every operand
// 16-byte aligned. Returns a cudaError_t: cudaErrorInvalidValue for a shape
// or tile outside the route.
int block_wgmma_run(const void* x, const void* w1, const void* w2, const void* w3,
                    const void* sb, void* out, int n, int h, int w, int cin, int cmid,
                    int relu_out, int th, void* stream) {
  const int mb1 = cmid == 256 ? 1 : 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                          reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(w3) |
                          reinterpret_cast<uintptr_t>(out);
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || h < 1 || w < 1 || th < 1 || cin % 64 != 0 || cmid > cin ||
      th * w > M2 || (th + 2) * w > 128 * mb1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
               static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(w3),
               static_cast<const float*>(sb), static_cast<__nv_bfloat16*>(out),
               h, w, cin, th, (h + th - 1) / th, relu_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cmid) {
    case 64: return launch<64, 2>(a, n, st);
    case 128: return launch<128, 2>(a, n, st);
    case 256: return launch<256, 1>(a, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
