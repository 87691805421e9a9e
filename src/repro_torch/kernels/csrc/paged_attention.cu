// paged_attention: GQA decode attention reading K/V through a page table.
//
//   q        (B, KVH, G, D)          float32 or bfloat16
//   k, v     (P, page_size, KVH, D)  same type as q
//   table    (B, max_pages)          int32, valid page ids
//   seq_lens (B,)                    int32
//   out      (B, KVH, G, D)          q's type; 0 where seq_len == 0
//
// Replaces the JAX package's kernels/paged_attention.py:paged_attention,
// whose grid walks (B, KVH, max_pages) in order and carries the online
// softmax (m, l, acc) in VMEM scratch from one page to the next.  On the
// card the work is bound by bytes: every active K and V page of a session
// is read once, for a handful of flops per byte (2·G per element).
//
// Design: one block per (b, kvh), kWarps warps.  The G query rows of the
// head sit in registers, pre-scaled in float32; lane i of a warp holds
// elements [i·D/32, (i+1)·D/32) of each row.  The warps split the active
// pages 0 .. ceil(seq_len / page_size) - 1, warp w taking w, w + kWarps, ...,
// so the sequential page axis of the TPU grid becomes kWarps independent
// online softmaxes in float32.  Each warp reads K and V rows through the
// table with vector loads, kTok tokens issued ahead of their use, takes
// each score with a butterfly reduction over its lanes and folds it in.
// Pages past the active count are never read.  At the end the warps merge
// their (m, l, acc) through shared memory with the log-sum-exp combine and
// write acc / l.  With B·KVH blocks (32 at the served shape) most SMs stay
// idle: splitting the pages across blocks (flash-decoding) is the next step.
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;          // warps per (b, kvh) block
constexpr int kTok = 4;            // tokens whose K/V rows are loaded ahead
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N consecutive elements widened to float, in vector loads of at most 16
// bytes (p is aligned to the load width).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int kPer = (16 / static_cast<int>(sizeof(T))) < N ? 16 / static_cast<int>(sizeof(T)) : N;
#pragma unroll
  for (int c = 0; c < N; c += kPer) {
    const Vec<T, kPer> x = *reinterpret_cast<const Vec<T, kPer>*>(p + c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c + i] = to_float(x.v[i]);
  }
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* __restrict__ table, const int32_t* __restrict__ seq_lens,
    T* __restrict__ out, int kvh_n, int g_n, int page_size, int max_pages, float scale) {
  constexpr int VEC = D / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x / kvh_n;
  const int h = blockIdx.x - b * kvh_n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seq_len = max(0, min(seq_lens[b], max_pages * page_size));
  const int n_pages = (seq_len + page_size - 1) / page_size;
  const int64_t head = static_cast<int64_t>(b) * kvh_n + h;

  float qr[GMAX][VEC], acc[GMAX][VEC], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < g_n) {
      load_vec<T, VEC>(q + (head * g_n + g) * D + lane * VEC, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int64_t tok_stride = static_cast<int64_t>(kvh_n) * D;
  for (int i = warp; i < n_pages; i += kWarps) {
    const int64_t page = table[static_cast<int64_t>(b) * max_pages + i];
    const int64_t off = (page * page_size * kvh_n + h) * D + lane * VEC;
    const T* kb = k_pages + off;
    const T* vb = v_pages + off;
    const int valid = min(page_size, seq_len - i * page_size);
    for (int t0 = 0; t0 < valid; t0 += kTok) {
      float kr[kTok][VEC], vr[kTok][VEC];
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        if (t0 + u < valid) {
          load_vec<T, VEC>(kb + (t0 + u) * tok_stride, kr[u]);
          load_vec<T, VEC>(vb + (t0 + u) * tok_stride, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        if (t0 + u >= valid) break;  // uniform across the warp
        float s[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(qr[g][e], kr[u][e], part);
          s[g] = part;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float m_next = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_next);
          const float p = expf(s[g] - m_next);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(acc[g][e], alpha, p * vr[u][e]);
          m[g] = m_next;
        }
      }
    }
  }

  // merge the warps' softmaxes: smem = acc [kWarps][g_n][D], m [kWarps][g_n], l [kWarps][g_n]
  float* acc_s = smem;
  float* m_s = acc_s + kWarps * g_n * D;
  float* l_s = m_s + kWarps * g_n;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < g_n) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[(warp * g_n + g) * D + lane * VEC + e] = acc[g][e];
      if (lane == 0) {
        m_s[warp * g_n + g] = m[g];
        l_s[warp * g_n + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g_n * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * g_n + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * g_n + g] - mx);
      lsum = fmaf(l_s[w * g_n + g], c, lsum);
      a = fmaf(acc_s[(w * g_n + g) * D + d], c, a);
    }
    out[(head * g_n + g) * D + d] = from_float<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, int D, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* table,
                   const void* lens, void* out, int64_t b_n, int64_t kvh_n, int64_t g_n,
                   int64_t page_size, int64_t max_pages, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * g_n * (D + 2);
  auto kernel = paged_attention_kernel<T, D, GMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(b_n * kvh_n), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), static_cast<int>(kvh_n), static_cast<int>(g_n),
      static_cast<int>(page_size), static_cast<int>(max_pages), scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const void* q, const void* k, const void* v, const void* table,
                     const void* lens, void* out, int64_t b_n, int64_t kvh_n, int64_t g_n,
                     int64_t page_size, int64_t max_pages, float scale, cudaStream_t stream) {
  if (g_n <= 1) return launch<T, D, 1>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
  if (g_n <= 2) return launch<T, D, 2>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
  if (g_n <= 4) return launch<T, D, 4>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
  return launch<T, D, 8>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* table,
                     const void* lens, void* out, int64_t b_n, int64_t kvh_n, int64_t g_n,
                     int64_t d, int64_t page_size, int64_t max_pages, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 64: return launch_g<T, 64>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
    case 128: return launch_g<T, 128>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
    case 256: return launch_g<T, 256>(q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D in {64, 128, 256}, 1 <= G <= 8.
extern "C" int repro_paged_attention(const void* q, const void* k, const void* v,
                                     const void* table, const void* lens, void* out, int64_t b_n,
                                     int64_t kvh_n, int64_t g_n, int64_t d, int64_t page_size,
                                     int64_t max_pages, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (g_n < 1 || g_n > 8 || page_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b_n * kvh_n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(q, k, v, table, lens, out, b_n, kvh_n, g_n, d, page_size, max_pages, scale, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(q, k, v, table, lens, out, b_n, kvh_n, g_n, d, page_size, max_pages, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
