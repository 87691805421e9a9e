// delta_fused: diff + ordered compaction + checksum lanes for delta dumps.
//
// Replaces the JAX package's kernels/delta_fused.py:_fused_kernel.  The TPU
// kernel walks its grid in order and carries the compaction cursor in SMEM
// from step to step.  Hopper blocks run in parallel and in no order, so the
// order comes from a scan instead (an atomic cursor would break the
// ascending slot order the contract fixes):
//
//   1. delta_diff_kernel   — one block per row: flag[r] = any byte differs
//                            (the launch of delta_diff.cu, into a uint8
//                            scratch);
//   2. fused_scan_kernel   — one block: exclusive prefix of the flags (the
//                            slot of every dirty row) and the total count;
//   3. fused_emit_kernel   — one block per row or slot: a dirty row with
//                            slot < cap is copied into its slot while its
//                            four checksum lanes are summed from the same
//                            registers; slots past min(count, cap) are
//                            zeroed (data 0, idx -1, sums 0).
//
// Bound on the card: bytes (reads 2*n*c for the compare, writes cap*c rows
// plus idx, count and sums).  The emit pass re-reads the dirty rows only, and
// each output byte is written exactly once, so no memset precedes it.
#include "common.cuh"

namespace repro_torch {

constexpr int kScanThreads = 1024;

// Single-block exclusive scan over n flags in tiles of kScanThreads.
__global__ void __launch_bounds__(kScanThreads) fused_scan_kernel(
    const uint8_t* __restrict__ flags, int32_t* __restrict__ slots,
    int32_t* __restrict__ count, int64_t n) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < n; base += blockDim.x) {
    const int64_t r = base + threadIdx.x;
    const int32_t v = r < n ? static_cast<int32_t>(flags[r]) : 0;
    int32_t x = v;                                   // inclusive scan in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                                 // scan of the warp totals
      const int nw = blockDim.x >> 5;
      int32_t s = lane < nw ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      if (lane < nw) warp_sums[lane] = s;
    }
    __syncthreads();
    const int32_t incl = carry + x + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (r < n) slots[r] = incl - v;
    __syncthreads();                                 // everyone has read carry
    if (threadIdx.x == blockDim.x - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void __launch_bounds__(kThreads) fused_emit_kernel(
    const uint8_t* __restrict__ new_grid, const uint8_t* __restrict__ flags,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ count,
    uint8_t* __restrict__ data, int32_t* __restrict__ idx, uint32_t* __restrict__ sums,
    int64_t n, int64_t c, int64_t cap, bool vec) {
  const int64_t total = n > cap ? n : cap;
  const int64_t used = *count < cap ? static_cast<int64_t>(*count) : cap;
  for (int64_t b = blockIdx.x; b < total; b += gridDim.x) {
    // (a) row b is dirty and fits: copy it to its slot, summing the lanes
    if (b < n && flags[b] != 0 && slots[b] < cap) {
      const int64_t s = slots[b];
      const uint8_t* src = new_grid + b * c;
      uint8_t* dst = data + s * c;
      Lanes l{0u, 0u, 0u, 0u};
      if (vec) {
        const uint4* sv = reinterpret_cast<const uint4*>(src);
        uint4* dv = reinterpret_cast<uint4*>(dst);
        const int64_t nv = c >> 4;
        for (int64_t k = threadIdx.x; k < nv; k += blockDim.x) {
          const uint4 v = sv[k];
          dv[k] = v;
          const uint32_t words[4] = {v.x, v.y, v.z, v.w};
          const uint32_t p0 = static_cast<uint32_t>(k << 4);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              lanes_add(l, (words[w] >> (8 * q)) & 0xffu, p0 + 4u * w + q);
            }
          }
        }
      } else {
        for (int64_t k = threadIdx.x; k < c; k += blockDim.x) {
          const uint8_t v = src[k];
          dst[k] = v;
          lanes_add(l, v, static_cast<uint32_t>(k));
        }
      }
      const Lanes t = block_sum(l);
      if (threadIdx.x == 0) {
        idx[s] = static_cast<int32_t>(b);
        sums[4 * s + 0] = t.s0;
        sums[4 * s + 1] = t.s1;
        sums[4 * s + 2] = t.s2;
        sums[4 * s + 3] = t.s3;
      }
    }
    // (b) slot b is unused: zero it, bit for bit like the plain version
    if (b < cap && b >= used) {
      uint8_t* dst = data + b * c;
      if (vec) {
        uint4* dv = reinterpret_cast<uint4*>(dst);
        const int64_t nv = c >> 4;
        for (int64_t k = threadIdx.x; k < nv; k += blockDim.x) dv[k] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int64_t k = threadIdx.x; k < c; k += blockDim.x) dst[k] = 0;
      }
      if (threadIdx.x == 0) {
        idx[b] = -1;
        sums[4 * b + 0] = 0u;
        sums[4 * b + 1] = 0u;
        sums[4 * b + 2] = 0u;
        sums[4 * b + 3] = 0u;
      }
    }
  }
}

}  // namespace repro_torch

// flags (n,) uint8 and slots (n,) int32 are scratch tensors owned by the caller.
extern "C" int repro_delta_fused(const void* old_grid, const void* new_grid, void* flags,
                                 void* slots, void* data, void* idx, void* count, void* sums,
                                 int64_t n, int64_t c, int64_t cap, int vec, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  int32_t* sl = static_cast<int32_t*>(slots);
  int32_t* cnt = static_cast<int32_t*>(count);
  const int err = repro_delta_diff(old_grid, new_grid, flags, n, c, vec, stream);
  if (err != 0) return err;
  fused_scan_kernel<<<1, kScanThreads, 0, st>>>(fl, sl, cnt, n);
  const int64_t total = n > cap ? n : cap;
  if (total > 0) {
    fused_emit_kernel<<<row_grid(total), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(new_grid), fl, sl, cnt, static_cast<uint8_t*>(data),
        static_cast<int32_t*>(idx), static_cast<uint32_t*>(sums), n, c, cap, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
