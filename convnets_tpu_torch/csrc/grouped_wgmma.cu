// Route "wgmma_wide" of the grouped conv (ops/kernels/conv.py:grouped_plan):
// the fused epilogue's instantiations of csrc/grouped_wgmma.cuh, which holds
// the kernel and its notes (rows 1g and 5g of the JAX package's grouped
// paths on Hopper's tensor cores), and the entry point of both epilogues.

#include "grouped_wgmma.cuh"

// csrc/grouped_wgmma_stats.cu
int grouped_wide_stats_run(int groups, const void* x, const void* w, void* y, void* partial,
                           const int* geo, void* stream);

// The bf16 plan "wgmma_wide" of grouped_fused_launch / grouped_stats_launch
// (grouped_conv.cu): any grouped shape (both channel counts divisible by
// the groups), any alignment; w (kh, kw, Cin/G, Cout). geo: n, h, w, cin,
// oh, ow, cout, kh, kw, sh, sw, ph, pw, dh, dw. stats: y and partial
// ((ceil(N*OH*OW / 128), 2, Cout) fp32) with scale, shift and relu unused.
// Returns a cudaError_t.
int grouped_wide_run(int stats, int groups, const void* x, const void* w, const void* scale,
                     const void* shift, void* y, void* partial, const int* geo, int relu,
                     void* stream) {
  if (stats) return grouped_wide_stats_run(groups, x, w, y, partial, geo, stream);
  WideShape s;
  if (!wide_shape(s, groups, x, w, geo)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_nw<false>(x, w, scale, shift, y, nullptr, s, relu,
                          static_cast<cudaStream_t>(stream));
}
