// page_copy: copy-on-write page privatization of stacked KV pools, in place:
// pool[r, dst[j]] = pool[r, src[j]] for every pool, period r and pair j.
//
// Replaces the JAX package's kernels/page_copy.py:page_copy_stacked (and
// page_copy, which is the same copy with one period).  Bound on the card:
// bytes (each source page is read once and each destination page written
// once; one (page_size, KVH, D) page is 32 KiB at the qwen3-14b width).
//
// One launch covers up to kMaxPools pools of one shape (the K and V pools
// of every attention sublayer) and up to kMaxPairs pairs.  The pool
// pointers and the pairs travel by value in the kernel's parameter struct
// (2,144 bytes, inside the 4 KB limit), so the caller copies nothing to
// the card and no block loads an index from device memory before its first
// page load.  One block per (pool, pair, period, 4 KiB segment of the
// page): each of its 128 threads issues both of its 16-byte loads before
// any store.  Unaligned pages take a byte path.  The caller guarantees
// distinct dst pages and src and dst disjoint, so the blocks commute and
// need no ordering.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMaxPools = 8;           // page_copy.py: MAX_POOLS
constexpr int kMaxPairs = 256;         // page_copy.py: MAX_PAIRS
constexpr int kSegBytes = 4096;
constexpr int kCopyThreads = 128;
constexpr int kVecsPerThread = kSegBytes / 16 / kCopyThreads;

struct PageCopyArgs {
  uint8_t* pools[kMaxPools];
  int32_t src[kMaxPairs];
  int32_t dst[kMaxPairs];
  int64_t period_bytes;                // n_pages * page_bytes
  int64_t page_bytes;
  uint32_t n_periods, n_pairs, segs;   // segs: 4 KiB segments of a page
  uint32_t vec;
};

__global__ void __launch_bounds__(kCopyThreads) page_copy_kernel(
    const __grid_constant__ PageCopyArgs a) {
  uint32_t b = blockIdx.x;
  const uint32_t seg = b % a.segs;
  b /= a.segs;
  const uint32_t period = b % a.n_periods;
  b /= a.n_periods;
  const uint32_t pair = b % a.n_pairs;
  const uint32_t pool = b / a.n_pairs;
  uint8_t* base = a.pools[pool] + static_cast<int64_t>(period) * a.period_bytes;
  const int64_t off = static_cast<int64_t>(seg) * kSegBytes;
  const int64_t rest = a.page_bytes - off;
  const int len = static_cast<int>(rest < kSegBytes ? rest : kSegBytes);
  const uint8_t* s = base + static_cast<int64_t>(a.src[pair]) * a.page_bytes + off;
  uint8_t* d = base + static_cast<int64_t>(a.dst[pair]) * a.page_bytes + off;
  if (a.vec) {
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    uint4* dv = reinterpret_cast<uint4*>(d);
    const int nv = len >> 4;
    uint4 v[kVecsPerThread];
#pragma unroll
    for (int q = 0; q < kVecsPerThread; ++q) {
      const int k = threadIdx.x + q * kCopyThreads;
      if (k < nv) v[q] = sv[k];
    }
#pragma unroll
    for (int q = 0; q < kVecsPerThread; ++q) {
      const int k = threadIdx.x + q * kCopyThreads;
      if (k < nv) dv[k] = v[q];
    }
  } else {
    for (int k = threadIdx.x; k < len; k += kCopyThreads) d[k] = s[k];
  }
}

}  // namespace repro_torch

// pools: host array of n_pools device pointers to pools of one shape
// (n_periods, n_pages, page_bytes...); src, dst: host int32 arrays of
// n_pairs pages.  One launch; the caller splits larger batches.
extern "C" int repro_page_copy(void* const* pools, int n_pools, const int32_t* src,
                               const int32_t* dst, int64_t n_pairs, int64_t n_periods,
                               int64_t n_pages, int64_t page_bytes, int vec, void* stream) {
  using namespace repro_torch;
  if (n_pools < 1 || n_pools > kMaxPools || n_pairs < 1 || n_pairs > kMaxPairs ||
      n_periods < 1 || page_bytes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PageCopyArgs a;
  for (int i = 0; i < n_pools; ++i) a.pools[i] = static_cast<uint8_t*>(pools[i]);
  for (int64_t j = 0; j < n_pairs; ++j) {
    a.src[j] = src[j];
    a.dst[j] = dst[j];
  }
  a.period_bytes = n_pages * page_bytes;
  a.page_bytes = page_bytes;
  a.n_periods = static_cast<uint32_t>(n_periods);
  a.n_pairs = static_cast<uint32_t>(n_pairs);
  a.segs = static_cast<uint32_t>((page_bytes + kSegBytes - 1) / kSegBytes);
  a.vec = vec != 0;
  const int64_t blocks = n_pools * n_pairs * n_periods * static_cast<int64_t>(a.segs);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  page_copy_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
