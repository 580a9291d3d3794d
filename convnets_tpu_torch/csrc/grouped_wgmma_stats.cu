// Route "wgmma_wide" of the grouped conv: the statistics epilogue's
// instantiations of csrc/grouped_wgmma.cuh (y rounded once and stored, each
// row tile's sums of the stored y and y*y per channel), apart from the fused
// ones so that nvcc compiles the two side by side.

#include "grouped_wgmma.cuh"

// y and partial ((ceil(N*OH*OW / 128), 2, Cout) fp32) of a grouped conv on
// the "wgmma_wide" route; arguments as grouped_wide_run's (grouped_wgmma.cu).
// Returns a cudaError_t.
int grouped_wide_stats_run(int groups, const void* x, const void* w, void* y, void* partial,
                           const int* geo, void* stream) {
  WideShape s;
  if (!wide_shape(s, groups, x, w, geo)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_nw<true>(x, w, nullptr, nullptr, y, partial, s, 0,
                         static_cast<cudaStream_t>(stream));
}
