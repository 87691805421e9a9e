// delta_apply: scatter compacted rows into a base grid in place,
// base[idx[j]] = data[j] for 0 <= idx[j] < n; idx -1 is padding.
//
// Replaces the JAX package's kernels/delta_apply.py:_delta_apply_kernel.
// Bound on the card: bytes (reads the valid rows of data and idx, writes the
// same rows of base).  One block per compacted row: a padding row returns at
// once, a valid row is copied with 16-byte vector loads and stores.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads) delta_apply_kernel(
    uint8_t* __restrict__ base, const uint8_t* __restrict__ data,
    const int32_t* __restrict__ idx, int64_t n, int64_t m, int64_t c, bool vec) {
  for (int64_t j = blockIdx.x; j < m; j += gridDim.x) {
    const int64_t i = idx[j];
    if (i < 0 || i >= n) continue;
    row_copy(base + i * c, data + j * c, c, vec);
  }
}

}  // namespace repro_torch

extern "C" int repro_delta_apply(void* base, const void* data, const void* idx, int64_t n,
                                 int64_t m, int64_t c, int vec, void* stream) {
  using namespace repro_torch;
  if (m > 0) {
    delta_apply_kernel<<<row_grid(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(base), static_cast<const uint8_t*>(data),
        static_cast<const int32_t*>(idx), n, m, c, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
