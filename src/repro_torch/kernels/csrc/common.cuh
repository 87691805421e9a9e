// Shared device helpers for the delta kernels (row compare, row copy,
// checksum lanes).  Every kernel here works on (rows, row_bytes) uint8 grids:
// one thread block owns one row at a time, threads stride over the row in
// 16-byte vectors when the caller says the rows are 16-byte aligned.
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

// Copy one row of c bytes.
static __device__ __forceinline__ void row_copy(
    uint8_t* dst, const uint8_t* src, int64_t c, bool vec) {
  if (vec) {
    uint4* dv = reinterpret_cast<uint4*>(dst);
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    const int64_t nv = c >> 4;
#pragma unroll 4
    for (int64_t k = threadIdx.x; k < nv; k += blockDim.x) dv[k] = sv[k];
  } else {
    for (int64_t k = threadIdx.x; k < c; k += blockDim.x) dst[k] = src[k];
  }
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

// Block-wide sum of the four lanes; the result is valid in thread 0.
static __device__ __forceinline__ Lanes block_sum(Lanes l) {
  __shared__ uint32_t part[4][32];
  for (int o = 16; o > 0; o >>= 1) {
    l.s0 += __shfl_down_sync(0xffffffffu, l.s0, o);
    l.s1 += __shfl_down_sync(0xffffffffu, l.s1, o);
    l.s2 += __shfl_down_sync(0xffffffffu, l.s2, o);
    l.s3 += __shfl_down_sync(0xffffffffu, l.s3, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = l.s0;
    part[1][warp] = l.s1;
    part[2][warp] = l.s2;
    part[3][warp] = l.s3;
  }
  __syncthreads();
  Lanes r{0u, 0u, 0u, 0u};
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    if (lane < nw) r = Lanes{part[0][lane], part[1][lane], part[2][lane], part[3][lane]};
    for (int o = 16; o > 0; o >>= 1) {
      r.s0 += __shfl_down_sync(0xffffffffu, r.s0, o);
      r.s1 += __shfl_down_sync(0xffffffffu, r.s1, o);
      r.s2 += __shfl_down_sync(0xffffffffu, r.s2, o);
      r.s3 += __shfl_down_sync(0xffffffffu, r.s3, o);
    }
  }
  __syncthreads();                     // part[] is reused by the next row
  return r;
}

static inline int row_grid(int64_t rows) {
  return static_cast<int>(rows < kMaxGrid ? rows : kMaxGrid);
}

}  // namespace repro_torch

// The dirty-flag pass of delta_diff.cu, which delta_fused.cu launches as its
// first step.
extern "C" int repro_delta_diff(const void* old_grid, const void* new_grid, void* dirty,
                                int64_t n, int64_t c, int vec, void* stream);
