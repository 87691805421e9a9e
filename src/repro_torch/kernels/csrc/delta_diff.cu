// delta_diff: per-row dirty bitmap of two (n, c) uint8 grids.
//
// Replaces the JAX package's kernels/delta_diff.py:_delta_diff_kernel.
// Bound on the card: bytes (reads 2*n*c, writes n).  One block per row with
// 16-byte vector loads and a block-wide OR (__syncthreads_or); rows of the
// dump path are 64 KiB, so one row is enough work for a block and the grid
// keeps every SM streaming.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads) delta_diff_kernel(
    const uint8_t* __restrict__ old_grid, const uint8_t* __restrict__ new_grid,
    uint8_t* __restrict__ dirty, int64_t n, int64_t c, bool vec) {
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const bool d = row_differs(old_grid + r * c, new_grid + r * c, c, vec);
    if (threadIdx.x == 0) dirty[r] = d ? 1 : 0;
  }
}

}  // namespace repro_torch

extern "C" int repro_delta_diff(const void* old_grid, const void* new_grid, void* dirty,
                                int64_t n, int64_t c, int vec, void* stream) {
  using namespace repro_torch;
  if (n > 0) {
    delta_diff_kernel<<<row_grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(old_grid), static_cast<const uint8_t*>(new_grid),
        static_cast<uint8_t*>(dirty), n, c, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
