// Shared device helpers for the delta kernels (row compare, checksum
// lanes, row grid).  The kernels work on (rows, row_bytes) uint8 grids;
// row_differs lets one thread block own one row at a time, its threads
// striding over the row in 16-byte vectors when the caller says the rows are
// 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;          // threads per row block
constexpr int kMaxGrid = 65535;        // row blocks launched (grid-stride)

// True (in every thread) when any byte of the two rows differs.
static __device__ __forceinline__ bool row_differs(
    const uint8_t* a, const uint8_t* b, int64_t c, bool vec) {
  unsigned diff = 0;
  if (vec) {
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    const int64_t nv = c >> 4;
#pragma unroll 4
    for (int64_t k = threadIdx.x; k < nv; k += blockDim.x) {
      const uint4 x = av[k];
      const uint4 y = bv[k];
      diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
    }
  } else {
    for (int64_t k = threadIdx.x; k < c; k += blockDim.x) diff |= a[k] ^ b[k];
  }
  return __syncthreads_or(diff != 0) != 0;
}

// Checksum lane constants: the JAX package's kernels/ref.py, byte for byte.
constexpr uint32_t kCsMult = 2654435761u;
constexpr uint32_t kCsAdd = 40503u;
constexpr uint32_t kCsXor = 2246822519u;

struct Lanes {
  uint32_t s0, s1, s2, s3;
};

// Fold one byte x at row position p into the four lanes (uint32 wraparound,
// so any summation order gives the same bits).
static __device__ __forceinline__ void lanes_add(Lanes& l, uint32_t x, uint32_t p) {
  const uint32_t w = p * kCsMult + kCsAdd;
  l.s0 += x;
  l.s1 += x * (p + 1u);
  l.s2 += x * w;
  l.s3 += (x + 1u) * (w ^ kCsXor);
}

static inline int row_grid(int64_t rows) {
  return static_cast<int>(rows < kMaxGrid ? rows : kMaxGrid);
}

}  // namespace repro_torch
