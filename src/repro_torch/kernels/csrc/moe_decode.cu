// moe_decode: one decode step of a dropless top-k MoE layer over the experts
// its rows routed to, and no others.
//
//   x      (B, d)        float32 or bfloat16, the rows' normed hidden states
//   ids    (B, K)        int32 router ids, distinct within a row
//   gates  (B, K)        float32 gate weights
//   w_gate (E', d, f)    x's type, the held experts [lo, hi) of the router's
//   w_up   (E', d, f)
//   w_down (E', f, d)
//   out    (B, d)        x's type: sum over k of gates[b,k] *
//                        w_down[e]^T (silu(w_gate[e]^T x_b) * w_up[e]^T x_b),
//                        e = ids[b,k]; an id outside [lo, hi) adds nothing.
//
// Replaces no kernel of the JAX package: its MoE decode dispatches every
// row into capacity slots of every expert and multiplies all of them
// (layers.py's einsum over the whole expert axis), as the port's
// all-experts bmm did.  At a decode step's few rows that reads every
// expert's weights for a handful of routed ones (Qwen3-30B-A3B: 58 GB a
// step where 3 rows route to about 22 of 128 experts a layer).
//
// Bound on the card: the bytes of the distinct routed experts' three
// matrices (2 * 3 * d * f a held expert) over 3.35 TB/s; the rows'
// activations are a few KB.
//
// Design: three launches, no floating-point atomics, one cast.
// * Routing on the device.  Every block loads the B*K ids and ranks the
//   distinct held experts in ascending order (a slot is first of its expert
//   when no earlier slot has it; its rank counts the first slots with
//   smaller ids).  Block row g of a grid takes the g-th distinct expert and
//   the slots routed to it, in slot order; the grid has B*K block rows (the
//   most there can be), and those past the distinct count return at once.
//   Nothing is read back to the host, and the shapes are static, so a CUDA
//   graph captures the step.
// * gate_up: a block computes one 64-column tile of f for its expert:
//   its 256 threads stream the d x 64 tiles of w_gate and w_up once,
//   16-byte loads, neighbouring lanes on neighbouring columns (128 bytes of
//   a row per 8 lanes in bfloat16), four rows of each in flight a thread,
//   and multiply each element into every routed row's float32 sum.  Warps
//   reduce their row groups by shuffles, then across warps through shared
//   memory, in a fixed order; h = silu(gate) * up goes out in float32.
//   Qwen3-30B-A3B at B = 3: ~22 experts x 12 tiles, each 0.5 MB.
// * down: a block computes one 128-column tile of d for its expert over
//   one split of f's rows (splits of 2048 rows, so Jamba's 14336 spread
//   over 7 x 32 tiles an expert), the same way with eight rows in flight a
//   thread, into a float32 partial per slot.
// * combine: each output element sums its slots' partials in split order,
//   weights them by their gates in k order and is cast once.
// Filling the card: a block keeps sums for 4 routed rows, so that two
// blocks fit an SM's registers (an expert with more rows is taken in
// chunks of 4, each reading it again: never at the cells' 4 rows a step).
// A launch whose wide tiles would give an SM fewer than two blocks, counting
// the step's most distinct experts (B*K, at most the held ones), takes tiles
// half as wide (Qwen3-30B-A3B at B <= 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Output columns of a block: wide, or narrow where the wide tiles would
// give an SM fewer than kBlocksPerSm blocks (launch()).
constexpr int kTile = 64, kTileNarrow = 32;           // gate/up
constexpr int kTileDown = 128, kTileDownNarrow = 64;  // down
constexpr int kUnroll = 4;          // rows of each weight in flight a gate/up thread
constexpr int kUnrollDown = 8;      // weight rows in flight a down thread
constexpr int kBlocksPerSm = 2;
constexpr int kMaxSlots = 256;      // B * K
constexpr int kMaxRows = 4;         // routed rows a block keeps sums for
constexpr int kCombineThreads = 256;

__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Element type traits: N elements in a 16-byte vector, unpacked to float.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* o) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    const uint16_t bits = __ldg(reinterpret_cast<const uint16_t*>(p));
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float silu(float g) { return g / (1.f + __expf(-g)); }

// The block's expert: the g-th distinct held id of the step in ascending
// order, and the slots routed to it in slot order.  Returns false (in every
// thread) when the step has fewer distinct held experts than g + 1.
struct Route {
  int expert;
  int n;
  int slots[kMaxSlots];
};

__device__ bool find_route(const int32_t* __restrict__ ids, int s_n, int lo, int hi, int g,
                           Route& r, int* s_ids, unsigned char* s_first) {
  for (int t = threadIdx.x; t < s_n; t += blockDim.x) s_ids[t] = ids[t];
  if (threadIdx.x == 0) r.expert = -1;
  __syncthreads();
  for (int t = threadIdx.x; t < s_n; t += blockDim.x) {
    const int e = s_ids[t];
    bool first = e >= lo && e < hi;
    for (int u = 0; u < t && first; ++u) first = s_ids[u] != e;
    s_first[t] = first;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < s_n; t += blockDim.x) {
    if (!s_first[t]) continue;
    const int e = s_ids[t];
    int rank = 0;
    for (int u = 0; u < s_n; ++u) rank += s_first[u] && s_ids[u] < e;
    if (rank == g) r.expert = e;
  }
  __syncthreads();
  if (r.expert < 0) return false;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < s_n; ++t)
      if (s_ids[t] == r.expert) r.slots[n++] = t;
    r.n = n;
  }
  __syncthreads();
  return true;
}

// Sum each lane's float32 partials (R rows, M matrices of V columns) over
// the lanes that share its columns (lanes lpr apart), and leave each warp's
// sums in red[warp][j][m * TILE + column], in a fixed order.
template <int R, int M, int TILE, int V>
__device__ __forceinline__ void reduce_tile(float (&acc)[R][M * V], float (*red)[R][M * TILE],
                                            int lpr) {
  constexpr int A = M * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int a = 0; a < A; ++a)
      for (int o = lpr; o < 32; o <<= 1) acc[j][a] += __shfl_xor_sync(0xffffffffu, acc[j][a], o);
  if (lane < lpr) {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int a = 0; a < A; ++a) red[warp][j][(a / V) * TILE + lane * V + a % V] = acc[j][a];
  }
  __syncthreads();
}

// One chunk of at most R routed rows of the block's expert through one
// 64-column tile of w_gate and w_up: h[slot] = silu(x w_gate) * (x w_up).
template <typename T, int R, int TILE>
__device__ void gate_up_rows(const T* __restrict__ x, const T* __restrict__ wg,
                             const T* __restrict__ wu, float* __restrict__ h, const int* rows,
                             const int* slots, int n, int d, int f, int col0,
                             float* red) {
  constexpr int V = Elt<T>::N;
  constexpr int LPR = TILE / V;                  // lanes across a tile row
  constexpr int G = kThreads / LPR;              // row groups of the block
  const int lane_col = threadIdx.x % LPR, grp = threadIdx.x / LPR;
  const int col = col0 + lane_col * V;
  const bool live = col < f;
  float acc[R][2 * V];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int a = 0; a < 2 * V; ++a) acc[j][a] = 0.f;
  for (int r0 = grp; r0 < d; r0 += G * kUnroll) {
    uint4 vg[kUnroll], vu[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * G;
      if (live && r < d) {
        vg[u] = load_stream(wg + static_cast<int64_t>(r) * f + col);
        vu[u] = load_stream(wu + static_cast<int64_t>(r) * f + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * G;
      if (!live || r >= d) continue;
      float g[V], w[V];
      Elt<T>::unpack(vg[u], g);
      Elt<T>::unpack(vu[u], w);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j >= n) break;
        const float xv = Elt<T>::load(x + static_cast<int64_t>(rows[j]) * d + r);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[j][v] = fmaf(xv, g[v], acc[j][v]);
          acc[j][V + v] = fmaf(xv, w[v], acc[j][V + v]);
        }
      }
    }
  }
  // reduce: acc[j][a] for a < V is gate column lane_col*V + a, else up
  float(*red_r)[R][2 * TILE] = reinterpret_cast<float(*)[R][2 * TILE]>(red);
  reduce_tile<R, 2, TILE, V>(acc, red_r, LPR);
  for (int i = threadIdx.x; i < n * TILE; i += kThreads) {
    const int j = i / TILE, c = i % TILE;
    if (col0 + c >= f) continue;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += red_r[w][j][c];
      u += red_r[w][j][TILE + c];
    }
    h[static_cast<int64_t>(slots[j]) * f + col0 + c] = silu(g) * u;
  }
  __syncthreads();
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) moe_gate_up_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ ids, const T* __restrict__ w_gate,
    const T* __restrict__ w_up, float* __restrict__ h, int k_n, int s_n, int d, int f, int lo,
    int hi) {
  __shared__ Route route;
  __shared__ int s_ids[kMaxSlots];
  __shared__ unsigned char s_first[kMaxSlots];
  __shared__ float red[kWarps * kMaxRows * 2 * kTile];
  __shared__ int rows[kMaxRows];
  if (!find_route(ids, s_n, lo, hi, blockIdx.y, route, s_ids, s_first)) return;
  const int64_t off = static_cast<int64_t>(route.expert - lo) * d * f;
  const int col0 = blockIdx.x * TILE;
  for (int c0 = 0; c0 < route.n; c0 += kMaxRows) {
    const int n = route.n - c0 < kMaxRows ? route.n - c0 : kMaxRows;
    if (threadIdx.x < n) rows[threadIdx.x] = route.slots[c0 + threadIdx.x] / k_n;
    __syncthreads();
    const int* slots = route.slots + c0;
    if (n == 1)
      gate_up_rows<T, 1, TILE>(x, w_gate + off, w_up + off, h, rows, slots, n, d, f, col0, red);
    else if (n == 2)
      gate_up_rows<T, 2, TILE>(x, w_gate + off, w_up + off, h, rows, slots, n, d, f, col0, red);
    else
      gate_up_rows<T, 4, TILE>(x, w_gate + off, w_up + off, h, rows, slots, n, d, f, col0, red);
  }
}

// One chunk of at most R routed rows through one 128-column tile of w_down
// over the rows [f0, f1) of f: part[slot] = h[slot, f0:f1] w_down[f0:f1].
template <typename T, int R, int TILE>
__device__ void down_rows(const float* __restrict__ h, const T* __restrict__ wd,
                          float* __restrict__ part, const int* slots, int n, int d, int f, int f0,
                          int f1, int col0, float* red) {
  constexpr int V = Elt<T>::N;
  constexpr int LPR = TILE / V;
  constexpr int G = kThreads / LPR;
  const int lane_col = threadIdx.x % LPR, grp = threadIdx.x / LPR;
  const int col = col0 + lane_col * V;
  const bool live = col < d;
  float acc[R][V];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int a = 0; a < V; ++a) acc[j][a] = 0.f;
  for (int r0 = f0 + grp; r0 < f1; r0 += G * kUnrollDown) {
    uint4 vw[kUnrollDown];
#pragma unroll
    for (int u = 0; u < kUnrollDown; ++u) {
      const int r = r0 + u * G;
      if (live && r < f1) vw[u] = load_stream(wd + static_cast<int64_t>(r) * d + col);
    }
#pragma unroll
    for (int u = 0; u < kUnrollDown; ++u) {
      const int r = r0 + u * G;
      if (!live || r >= f1) continue;
      float w[V];
      Elt<T>::unpack(vw[u], w);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j >= n) break;
        const float hv = __ldg(h + static_cast<int64_t>(slots[j]) * f + r);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[j][v] = fmaf(hv, w[v], acc[j][v]);
      }
    }
  }
  float(*red_r)[R][TILE] = reinterpret_cast<float(*)[R][TILE]>(red);
  reduce_tile<R, 1, TILE, V>(acc, red_r, LPR);
  for (int i = threadIdx.x; i < n * TILE; i += kThreads) {
    const int j = i / TILE, c = i % TILE;
    if (col0 + c >= d) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_r[w][j][c];
    part[static_cast<int64_t>(slots[j]) * d + col0 + c] = s;
  }
  __syncthreads();
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) moe_down_kernel(
    const float* __restrict__ h, const int32_t* __restrict__ ids, const T* __restrict__ w_down,
    float* __restrict__ part, int s_n, int d, int f, int f_split, int lo, int hi) {
  __shared__ Route route;
  __shared__ int s_ids[kMaxSlots];
  __shared__ unsigned char s_first[kMaxSlots];
  __shared__ float red[kWarps * kMaxRows * kTileDown];
  if (!find_route(ids, s_n, lo, hi, blockIdx.z, route, s_ids, s_first)) return;
  const T* wd = w_down + static_cast<int64_t>(route.expert - lo) * f * d;
  const int f0 = blockIdx.y * f_split;
  const int f1 = f0 + f_split < f ? f0 + f_split : f;
  float* p = part + static_cast<int64_t>(blockIdx.y) * s_n * d;
  const int col0 = blockIdx.x * TILE;
  for (int c0 = 0; c0 < route.n; c0 += kMaxRows) {
    const int n = route.n - c0 < kMaxRows ? route.n - c0 : kMaxRows;
    const int* slots = route.slots + c0;
    if (n == 1)
      down_rows<T, 1, TILE>(h, wd, p, slots, n, d, f, f0, f1, col0, red);
    else if (n == 2)
      down_rows<T, 2, TILE>(h, wd, p, slots, n, d, f, f0, f1, col0, red);
    else
      down_rows<T, 4, TILE>(h, wd, p, slots, n, d, f, f0, f1, col0, red);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) moe_combine_kernel(
    const float* __restrict__ part, const int32_t* __restrict__ ids,
    const float* __restrict__ gates, T* __restrict__ out, int k_n, int s_n, int d, int splits,
    int lo, int hi) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kCombineThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int k = 0; k < k_n; ++k) {
    const int s = b * k_n + k;
    const int e = ids[s];
    if (e < lo || e >= hi) continue;
    float t = 0.f;
    for (int sp = 0; sp < splits; ++sp) t += part[(static_cast<int64_t>(sp) * s_n + s) * d + c];
    acc = fmaf(gates[s], t, acc);
  }
  Elt<T>::store(out + static_cast<int64_t>(b) * d + c, acc);
}

template <typename T, int TILE>
void launch_gate_up(dim3 grid, cudaStream_t stream, const void* x, const void* ids,
                    const void* wg, const void* wu, void* h, int k_n, int s_n, int d, int f,
                    int lo, int hi) {
  moe_gate_up_kernel<T, TILE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(ids), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<float*>(h), k_n, s_n, d, f, lo, hi);
}

template <typename T, int TILE>
void launch_down(dim3 grid, cudaStream_t stream, const void* h, const void* ids, const void* wd,
                 void* part, int s_n, int d, int f, int f_split, int lo, int hi) {
  moe_down_kernel<T, TILE><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const int32_t*>(ids), static_cast<const T*>(wd),
      static_cast<float*>(part), s_n, d, f, f_split, lo, hi);
}

// The wide tiles where the step's most distinct experts (B*K, at most the
// held ones) give every SM kBlocksPerSm blocks, else the narrow ones.
template <typename T>
int launch(const void* x, const void* ids, const void* gates, const void* wg, const void* wu,
           const void* wd, void* h, void* part, void* out, int b_n, int k_n, int d, int f,
           int f_split, int lo, int hi, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int s_n = b_n * k_n;
  const int experts = s_n < hi - lo ? s_n : hi - lo;
  const int splits = (f + f_split - 1) / f_split;
  const int want = kBlocksPerSm * sms;
  if (experts * ((f + kTile - 1) / kTile) >= want)
    launch_gate_up<T, kTile>(dim3((f + kTile - 1) / kTile, s_n), stream, x, ids, wg, wu, h, k_n,
                             s_n, d, f, lo, hi);
  else
    launch_gate_up<T, kTileNarrow>(dim3((f + kTileNarrow - 1) / kTileNarrow, s_n), stream, x,
                                   ids, wg, wu, h, k_n, s_n, d, f, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (experts * ((d + kTileDown - 1) / kTileDown) * splits >= want)
    launch_down<T, kTileDown>(dim3((d + kTileDown - 1) / kTileDown, splits, s_n), stream, h, ids,
                              wd, part, s_n, d, f, f_split, lo, hi);
  else
    launch_down<T, kTileDownNarrow>(
        dim3((d + kTileDownNarrow - 1) / kTileDownNarrow, splits, s_n), stream, h, ids, wd, part,
        s_n, d, f, f_split, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g3((d + kCombineThreads - 1) / kCombineThreads, b_n);
  moe_combine_kernel<T><<<g3, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(ids),
      static_cast<const float*>(gates), static_cast<T*>(out), k_n, s_n, d, splits, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16; the experts' activation is silu.  h is a
// (B*K, f) and part a (ceil(f / f_split), B*K, d) float32 scratch.
extern "C" int repro_moe_decode(const void* x, const void* ids, const void* gates,
                                const void* w_gate, const void* w_up, const void* w_down,
                                void* h, void* part, void* out, int64_t b_n, int64_t k_n,
                                int64_t d, int64_t f, int64_t f_split, int64_t lo, int64_t hi,
                                int dtype, void* stream) {
  using namespace repro_torch;
  if (b_n <= 0 || k_n <= 0 || b_n * k_n > kMaxSlots || d <= 0 || f <= 0 || f_split <= 0 ||
      lo < 0 || hi <= lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int args[] = {static_cast<int>(b_n), static_cast<int>(k_n), static_cast<int>(d),
                      static_cast<int>(f), static_cast<int>(f_split), static_cast<int>(lo),
                      static_cast<int>(hi)};
  if (dtype == 0)
    return launch<float>(x, ids, gates, w_gate, w_up, w_down, h, part, out, args[0], args[1],
                         args[2], args[3], args[4], args[5], args[6], s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ids, gates, w_gate, w_up, w_down, h, part, out, args[0],
                                 args[1], args[2], args[3], args[4], args[5], args[6], s);
  return static_cast<int>(cudaErrorInvalidValue);
}
