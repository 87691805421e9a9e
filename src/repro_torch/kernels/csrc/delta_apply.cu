// delta_apply: scatter compacted rows into a base grid in place,
// base[idx[j]] = data[j] for 0 <= idx[j] < n; idx -1 is padding.
//
// Replaces the JAX package's kernels/delta_apply.py:_delta_apply_kernel.
// Bound on the card: bytes (reads the valid rows of data and idx, writes the
// same rows of base).
//
// Design: a grid over (row segment, row).  A row is cut into 4 KiB
// segments, one block each (128 threads, two 16-byte vectors a thread), so
// a few long rows still spread over the SMs: 8 rows of 64 KiB give 128
// blocks, 2 page rows of 1.31 MB (a serving restore) give 640.  Every
// thread issues all its loads before any store, so a block has its whole
// segment in flight.  The row's index is loaded together with the row's
// bytes, not before them: the address of data[j] does not depend on idx[j],
// only the store does, so one memory latency is paid instead of two.  The
// price is that a padding row's bytes are read and dropped (23 of 64 rows,
// 1.5 MB, at the heap shape of the checkpoint cell); the slow restore pads
// its rows only up to the next power of two, so under half are padding.  The
// loads are volatile so that the compiler cannot sink them under the index
// test.  Rows that are not 16-byte aligned take the same grid byte by byte.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kSegThreads = 128;
constexpr int kSegVecs = 2;                                  // 16-byte vectors per thread
constexpr int64_t kSegBytes = kSegThreads * kSegVecs * 16;   // 4 KiB
constexpr int kSegScalar = static_cast<int>(kSegBytes / kSegThreads);  // unaligned: bytes a thread
constexpr int64_t kMaxRowBlocks = 65535;                     // grid.y; rows beyond it stride

__device__ __forceinline__ int32_t load_index(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 load_vec16(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t load_byte(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kSegThreads) delta_apply_kernel(
    uint8_t* __restrict__ base, const uint8_t* __restrict__ data,
    const int32_t* __restrict__ idx, int64_t n, int64_t m, int64_t c, bool vec) {
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kSegBytes;
  const int64_t len = c - seg < kSegBytes ? c - seg : kSegBytes;
  for (int64_t j = blockIdx.y; j < m; j += gridDim.y) {
    const uint8_t* src = data + j * c + seg;
    const int64_t i = load_index(idx + j);
    if (vec) {
      uint4 x[kSegVecs];
#pragma unroll
      for (int k = 0; k < kSegVecs; ++k) {
        const int64_t off = static_cast<int64_t>(threadIdx.x + k * kSegThreads) * 16;
        if (off < len) x[k] = load_vec16(src + off);
      }
      if (i < 0 || i >= n) continue;
      uint8_t* dst = base + i * c + seg;
#pragma unroll
      for (int k = 0; k < kSegVecs; ++k) {
        const int64_t off = static_cast<int64_t>(threadIdx.x + k * kSegThreads) * 16;
        if (off < len) *reinterpret_cast<uint4*>(dst + off) = x[k];
      }
    } else {
      uint32_t x[kSegScalar];
#pragma unroll
      for (int k = 0; k < kSegScalar; ++k) {
        const int64_t off = threadIdx.x + static_cast<int64_t>(k) * kSegThreads;
        if (off < len) x[k] = load_byte(src + off);
      }
      if (i < 0 || i >= n) continue;
      uint8_t* dst = base + i * c + seg;
#pragma unroll
      for (int k = 0; k < kSegScalar; ++k) {
        const int64_t off = threadIdx.x + static_cast<int64_t>(k) * kSegThreads;
        if (off < len) dst[off] = static_cast<uint8_t>(x[k]);
      }
    }
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_delta_apply(void* base, const void* data, const void* idx, int64_t n,
                                 int64_t m, int64_t c, int vec, void* stream) {
  using namespace repro_torch;
  if (m > 0 && c > 0) {
    const dim3 grid(static_cast<unsigned>((c + kSegBytes - 1) / kSegBytes),
                    static_cast<unsigned>(m < kMaxRowBlocks ? m : kMaxRowBlocks));
    delta_apply_kernel<<<grid, kSegThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(base), static_cast<const uint8_t*>(data),
        static_cast<const int32_t*>(idx), n, m, c, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
