// delta_fused: diff + ordered compaction + checksum lanes for delta dumps,
// in one kernel launch.
//
// Replaces the JAX package's kernels/delta_fused.py:_fused_kernel.
//
// Bound on the card: bytes.  The compare reads 2*n*c; the outputs are
// cap*c bytes of data plus idx, count and sums, each written once.
//
// The TPU kernel walks its grid in order and carries the compaction cursor
// in SMEM from step to step.  Hopper blocks run in parallel and in no
// order, so the cursor becomes a prefix computed inside the same launch by
// a decoupled look-back (Merrill and Garland's single-pass scan):
//
//   * A tile is one row, or where rows are narrow the fewest whole rows
//     that give a block about 64 KiB of each grid (delta_fused.py:
//     tile_rows).  A block takes its tile number from an atomic ticket,
//     not from blockIdx, so every tile it waits on has already started.
//   * The block compares its rows of old and new once, with 16-byte loads
//     where the rows allow, and publishes its tile's dirty count as an
//     aggregate in a 64-bit status word (state << 32 | value, one store).
//     Warp 0 then reads its predecessors' words 32 at a time, adding
//     aggregates until it meets an inclusive prefix, and publishes its own
//     inclusive prefix.
//     incl(r) is the number of dirty rows at or before row r.
//   * A dirty row r with slot s = incl(r) - 1 < cap is copied from new
//     (which the compare has just brought into L2) to data[s], with its
//     four checksum lanes in sums[s] and idx[s] = r.  Where s >= cap the
//     row writes nothing and still counts.  The lanes need no slot, so in
//     a tile of wide rows (a block per row) warps 1.. sum them while warp
//     0 looks back, and the copy after it is loads and stores alone; in a
//     tile of narrow rows (a warp per row) each warp sums its rows' lanes
//     after the copy.
//   * A clean row r zeroes slot z = incl(r) + (n - 1 - r) when z < cap.
//     z equals count plus the number of clean rows after r, so the clean
//     rows zero exactly the slots [count, n), each once, in reverse order,
//     and a block needs only its own prefix, not count, to find them.
//     Slots [n, cap), when cap > n, belong to tiles past the last row.
//     Every output byte is therefore written exactly once and no memset
//     of data precedes the kernel.
//   * The tile holding row n - 1 writes count from its inclusive prefix.
//
// The status words and the ticket live in a per-call scratch of
// 16 + 8 * row_tiles bytes that the C entry point zeroes with one
// cudaMemsetAsync on the launch's stream.  A call owns its scratch, so
// back-to-back calls, CUDA-graph replays (the memset is a node of the
// graph) and calls from two host threads on two streams never share one.
#include "common.cuh"

namespace repro_torch {

constexpr int kFusedThreads = 256;
constexpr int kWarps = kFusedThreads / 32;
constexpr int kMaxTileRows = 128;      // delta_fused.py: MAX_TILE_ROWS
constexpr int kRowsPerLane = kMaxTileRows / 32;
constexpr uint32_t kAggregate = 1u;    // status word states (0: not yet published)
constexpr uint32_t kPrefix = 2u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;              // 16-byte loads a thread issues before using any

// A status word carries its state and its value in one 64-bit access, and
// no other memory is published through it, so relaxed ordering at device
// scope is enough: a reader sees either the whole old word or the new one.
static __device__ __forceinline__ void store_status(unsigned long long* p, uint32_t state,
                                                    uint32_t value) {
  const unsigned long long w = (static_cast<unsigned long long>(state) << 32) | value;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

static __device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// OR of the XOR of two rows over the bytes this thread of a group takes
// (threads t, t + stride, ...).  Row a (old) is read with the streaming
// hint, since nothing reads it again; row b (new) stays in L2 for the
// emit.  The outputs are stored with the streaming hint too.
static __device__ __forceinline__ unsigned diff_bits(const uint8_t* a, const uint8_t* b,
                                                     int64_t c, bool vec, int t, int stride) {
  unsigned diff = 0;
  if (vec) {
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    const int64_t nv = c >> 4;
    for (int64_t k0 = t; k0 < nv; k0 += kBatch * stride) {
      uint4 x[kBatch], y[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t k = k0 + u * stride;
        x[u] = k < nv ? __ldcs(av + k) : make_uint4(0u, 0u, 0u, 0u);   // old: read once
        y[u] = k < nv ? bv[k] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        diff |= (x[u].x ^ y[u].x) | (x[u].y ^ y[u].y) | (x[u].z ^ y[u].z) | (x[u].w ^ y[u].w);
      }
    }
  } else {
    for (int64_t k = t; k < c; k += stride) diff |= a[k] ^ b[k];
  }
  return diff;
}

// Fold 16 bytes at row positions p0 .. p0 + 15 into the lanes.  With
// S = sum x_j and J = sum j * x_j over the 16 bytes (two dp4a per word),
// lane 1 gains (p0 + 1) S + J and lane 2 gains (p0 M + A) S + M J, since
// w(p0 + j) = (p0 M + A) + j M in uint32; lane 3's XOR needs each byte.
static __device__ __forceinline__ void lanes_add16(Lanes& l, const uint4 v, uint32_t p0) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t S = 0, J = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t j4 = (4u * w) | ((4u * w + 1u) << 8) | ((4u * w + 2u) << 16) |
                        ((4u * w + 3u) << 24);
    S = __dp4a(words[w], 0x01010101u, S);
    J = __dp4a(words[w], j4, J);
  }
  const uint32_t base = p0 * kCsMult + kCsAdd;
  l.s0 += S;
  l.s1 += (p0 + 1u) * S + J;
  l.s2 += base * S + kCsMult * J;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x = (words[w] >> (8 * q)) & 0xffu;
      l.s3 += (x + 1u) * ((base + (4u * w + q) * kCsMult) ^ kCsXor);
    }
  }
}

// This thread's share of the four checksum lanes of one row.
static __device__ __forceinline__ Lanes row_lanes(const uint8_t* src, int64_t c, bool vec, int t,
                                                  int stride) {
  Lanes l{0u, 0u, 0u, 0u};
  if (vec) {
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    const int64_t nv = c >> 4;
    for (int64_t k0 = t; k0 < nv; k0 += kBatch * stride) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t k = k0 + u * stride;
        if (k < nv) v[u] = sv[k];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t k = k0 + u * stride;
        if (k < nv) lanes_add16(l, v[u], static_cast<uint32_t>(k << 4));
      }
    }
  } else {
    for (int64_t k = t; k < c; k += stride) lanes_add(l, src[k], static_cast<uint32_t>(k));
  }
  return l;
}

// Copy one row with the threads of a group.
static __device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src, int64_t c,
                                                  bool vec, int t, int stride) {
  if (vec) {
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    uint4* dv = reinterpret_cast<uint4*>(dst);
    const int64_t nv = c >> 4;
    for (int64_t k0 = t; k0 < nv; k0 += kBatch * stride) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t k = k0 + u * stride;
        if (k < nv) v[u] = sv[k];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t k = k0 + u * stride;
        if (k < nv) __stcs(dv + k, v[u]);
      }
    }
  } else {
    for (int64_t k = t; k < c; k += stride) dst[k] = src[k];
  }
}

static __device__ __forceinline__ void zero_bytes(uint8_t* dst, int64_t c, bool vec, int t,
                                                  int stride) {
  if (vec) {
    uint4* dv = reinterpret_cast<uint4*>(dst);
    const int64_t nv = c >> 4;
    for (int64_t k = t; k < nv; k += stride) __stcs(dv + k, make_uint4(0u, 0u, 0u, 0u));
  } else {
    for (int64_t k = t; k < c; k += stride) dst[k] = 0;
  }
}

static __device__ __forceinline__ Lanes warp_sum(Lanes l) {
  for (int o = 16; o > 0; o >>= 1) {
    l.s0 += __shfl_xor_sync(kFull, l.s0, o);
    l.s1 += __shfl_xor_sync(kFull, l.s1, o);
    l.s2 += __shfl_xor_sync(kFull, l.s2, o);
    l.s3 += __shfl_xor_sync(kFull, l.s3, o);
  }
  return l;
}

static __device__ __forceinline__ void write_slot(int32_t* idx, uint32_t* sums, int64_t s,
                                                  int32_t row, Lanes t) {
  idx[s] = row;
  sums[4 * s + 0] = t.s0;
  sums[4 * s + 1] = t.s1;
  sums[4 * s + 2] = t.s2;
  sums[4 * s + 3] = t.s3;
}

// Zero slot z (data row, idx -1, sums 0) with the threads of a group; its
// thread 0 (first) writes the control words.
static __device__ __forceinline__ void zero_slot(uint8_t* data, int32_t* idx, uint32_t* sums,
                                                 int64_t z, int64_t c, bool vec, int t,
                                                 int stride) {
  zero_bytes(data + z * c, c, vec, t, stride);
  if (t == 0) write_slot(idx, sums, z, -1, Lanes{0u, 0u, 0u, 0u});
}

// Warp 0: the tile's exclusive prefix.  Publishes the tile's aggregate,
// then reads its predecessors' status words 32 at a time (lane l the word l
// places behind j).  It waits only for the words nearer than the nearest
// inclusive prefix in view, adds them and that prefix, and publishes the
// tile's own inclusive prefix; a view without a prefix adds all its
// aggregates and steps 32 tiles further back.
static __device__ __forceinline__ uint32_t look_back(unsigned long long* status, int64_t tile,
                                                     uint32_t agg, int lane) {
  if (tile == 0) {
    if (lane == 0) store_status(&status[0], kPrefix, agg);
    return 0u;
  }
  if (lane == 0) store_status(&status[tile], kAggregate, agg);
  uint32_t excl = 0;
  for (int64_t j = tile - 1;; j -= 32) {
    const int64_t p = j - lane;       // p < 0: before tile 0, a prefix of 0
    unsigned long long w = p >= 0 ? load_status(&status[p])
                                  : static_cast<unsigned long long>(kPrefix) << 32;
    unsigned prefixes;
    for (;;) {
      const uint32_t state = static_cast<uint32_t>(w >> 32);
      prefixes = __ballot_sync(kFull, state == kPrefix);
      const unsigned unset = __ballot_sync(kFull, state == 0);
      const unsigned nearer = prefixes ? (prefixes & (0u - prefixes)) - 1u : kFull;
      if ((unset & nearer) == 0) break;
      if (state == 0) w = load_status(&status[p]);
    }
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    uint32_t val = lane <= stop ? static_cast<uint32_t>(w) : 0u;
    for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(kFull, val, o);
    excl += val;
    if (prefixes) break;
  }
  if (lane == 0) store_status(&status[tile], kPrefix, excl + agg);
  return excl;
}

__global__ void __launch_bounds__(kFusedThreads) delta_fused_kernel(
    const uint8_t* __restrict__ old_grid, const uint8_t* __restrict__ new_grid,
    uint8_t* __restrict__ data, int32_t* __restrict__ idx, int32_t* __restrict__ count,
    uint32_t* __restrict__ sums, unsigned int* __restrict__ ticket,
    unsigned long long* __restrict__ status, int64_t n, int64_t c, int64_t cap,
    int rows_per_tile, int64_t row_tiles, bool vec) {
  __shared__ int64_t s_tile;
  __shared__ int32_t s_excl;
  __shared__ int32_t s_incl[kMaxTileRows];   // inclusive prefix of the flags in the tile
  __shared__ uint8_t s_flag[kMaxTileRows];
  __shared__ uint32_t s_lanes[kWarps][4];    // block mode: the lanes of each dirty row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows_per_tile <= kWarps: the whole block takes one row at a time;
  // otherwise each warp takes every kWarps-th row of the tile
  const bool block_rows = rows_per_tile <= kWarps;
  const int t = block_rows ? static_cast<int>(threadIdx.x) : lane;
  const int stride = block_rows ? kFusedThreads : 32;
  const int first = block_rows ? 0 : warp;
  const int step = block_rows ? 1 : kWarps;

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  if (threadIdx.x < kWarps * 4) s_lanes[threadIdx.x >> 2][threadIdx.x & 3] = 0u;
  __syncthreads();
  const int64_t tile = s_tile;

  if (tile >= row_tiles) {            // past the last row: slots [n, cap)
    const int64_t z0 = n + (tile - row_tiles) * rows_per_tile;
    for (int i = first; i < rows_per_tile && z0 + i < cap; i += step) {
      zero_slot(data, idx, sums, z0 + i, c, vec, t, stride);
    }
    if (n == 0 && tile == 0 && threadIdx.x == 0) *count = 0;
    return;
  }

  const int64_t r0 = tile * rows_per_tile;
  const int rows = static_cast<int>(n - r0 < rows_per_tile ? n - r0 : rows_per_tile);

  // -- 1. compare the tile's rows
  for (int i = first; i < rows; i += step) {
    const int64_t off = (r0 + i) * c;
    const unsigned d = diff_bits(old_grid + off, new_grid + off, c, vec, t, stride);
    const bool dirty = block_rows ? __syncthreads_or(d != 0) != 0 : __any_sync(kFull, d != 0);
    if (t == 0) s_flag[i] = dirty ? 1 : 0;
  }
  __syncthreads();

  // -- 2. warp 0 finds the tile's prefix; meanwhile, in block mode, the
  //       other warps sum the checksum lanes of the tile's dirty rows (new
  //       is in L2 from the compare), which need no slot
  if (warp == 0) {
    int32_t v[kRowsPerLane];
    int32_t mine = 0;
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int i = lane * kRowsPerLane + q;
      v[q] = i < rows ? s_flag[i] : 0;
      mine += v[q];
    }
    int32_t x = mine;                 // inclusive scan over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int32_t agg = __shfl_sync(kFull, x, 31);
    int32_t run = x - mine;
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int i = lane * kRowsPerLane + q;
      run += v[q];
      if (i < rows) s_incl[i] = run;
    }
    const uint32_t excl = look_back(status, tile, static_cast<uint32_t>(agg), lane);
    if (lane == 0) {
      s_excl = static_cast<int32_t>(excl);
      if (r0 + rows == n) *count = static_cast<int32_t>(excl) + agg;
    }
  } else if (block_rows) {
    for (int i = 0; i < rows; ++i) {
      if (!s_flag[i]) continue;
      const Lanes l = warp_sum(row_lanes(new_grid + (r0 + i) * c, c, vec,
                                         static_cast<int>(threadIdx.x) - 32, kFusedThreads - 32));
      if (lane == 0) {
        atomicAdd(&s_lanes[i][0], l.s0);
        atomicAdd(&s_lanes[i][1], l.s1);
        atomicAdd(&s_lanes[i][2], l.s2);
        atomicAdd(&s_lanes[i][3], l.s3);
      }
    }
  }
  __syncthreads();

  // -- 3. emit: dirty rows into their slots, clean rows zero the slots past count
  const int64_t excl = s_excl;
  for (int i = first; i < rows; i += step) {
    const int64_t r = r0 + i;
    const int64_t incl = excl + s_incl[i];
    if (s_flag[i]) {
      const int64_t s = incl - 1;
      if (s >= cap) continue;
      if (block_rows) {
        copy_bytes(data + s * c, new_grid + r * c, c, vec, t, stride);
        if (t == 0) {
          write_slot(idx, sums, s, static_cast<int32_t>(r),
                     Lanes{s_lanes[i][0], s_lanes[i][1], s_lanes[i][2], s_lanes[i][3]});
        }
      } else {
        copy_bytes(data + s * c, new_grid + r * c, c, vec, t, stride);
        const Lanes l = warp_sum(row_lanes(new_grid + r * c, c, vec, t, stride));
        if (t == 0) write_slot(idx, sums, s, static_cast<int32_t>(r), l);
      }
    } else {
      const int64_t z = incl + (n - 1 - r);
      if (z < cap) zero_slot(data, idx, sums, z, c, vec, t, stride);
    }
  }
}

}  // namespace repro_torch

// scratch: 16 + 8 * row_tiles bytes (the ticket, then one status word per
// row tile), zeroed here before the launch.
extern "C" int repro_delta_fused(const void* old_grid, const void* new_grid, void* scratch,
                                 void* data, void* idx, void* count, void* sums, int64_t n,
                                 int64_t c, int64_t cap, int64_t rows_per_tile, int vec,
                                 void* stream) {
  using namespace repro_torch;
  if (rows_per_tile < 1 || rows_per_tile > kMaxTileRows || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t row_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int64_t spare = cap > n ? cap - n : 0;
  const int64_t zero_tiles = (spare + rows_per_tile - 1) / rows_per_tile;
  const int64_t grid = row_tiles + zero_tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 16 + 8 * row_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  delta_fused_kernel<<<static_cast<unsigned>(grid), kFusedThreads, 0, st>>>(
      static_cast<const uint8_t*>(old_grid), static_cast<const uint8_t*>(new_grid),
      static_cast<uint8_t*>(data), static_cast<int32_t*>(idx), static_cast<int32_t*>(count),
      static_cast<uint32_t*>(sums), reinterpret_cast<unsigned int*>(s),
      reinterpret_cast<unsigned long long*>(s + 16), n, c, cap,
      static_cast<int>(rows_per_tile), row_tiles, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
