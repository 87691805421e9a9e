// page_copy: copy-on-write page privatization of a stacked KV pool, in place:
// pool[r, dst[j]] = pool[r, src[j]] for every period r and pair j.
//
// Replaces the JAX package's kernels/page_copy.py:page_copy_stacked (and
// page_copy, which is the same copy with one period).  Bound on the card:
// bytes (each source page is read once and each destination page written
// once; one (page_size, KVH, D) page is 32 KiB at the qwen3-14b width).
// One block per (pair, period) copies one page with 16-byte vector loads and
// stores.  The caller guarantees distinct dst pages and src and dst disjoint,
// so the blocks commute and need no ordering.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads) page_copy_kernel(
    uint8_t* __restrict__ pool, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, int64_t n_periods, int64_t n_pages, int64_t n_pairs,
    int64_t page_bytes, bool vec) {
  const int64_t total = n_pairs * n_periods;
  for (int64_t w = blockIdx.x; w < total; w += gridDim.x) {
    const int64_t j = w / n_periods;
    const int64_t r = w - j * n_periods;
    uint8_t* period = pool + r * n_pages * page_bytes;
    row_copy(period + static_cast<int64_t>(dst[j]) * page_bytes,
             period + static_cast<int64_t>(src[j]) * page_bytes, page_bytes, vec);
  }
}

}  // namespace repro_torch

extern "C" int repro_page_copy(void* pool, const void* src, const void* dst, int64_t n_periods,
                               int64_t n_pages, int64_t n_pairs, int64_t page_bytes, int vec,
                               void* stream) {
  using namespace repro_torch;
  if (n_pairs > 0 && n_periods > 0) {
    page_copy_kernel<<<row_grid(n_pairs * n_periods), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(pool), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(dst), n_periods, n_pages, n_pairs, page_bytes, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
