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
// Design: split-K over a thread-block cluster, one launch.
//
// * Too few blocks.  Each (b, kv head) gets a cluster of `split` blocks
//   (chosen on the host from B, KVH and max_pages so that the grid covers
//   the SMs: 8 at B = 4, KVH = 8; 16 at B = 1).  Block r of a cluster takes
//   pages [r·n/split, (r+1)·n/split) of the session's n = ceil(seq_len /
//   page_size) active pages; its 4 warps keep float32 (m, l, acc) for the G
//   query rows, and a warp or block with no pages keeps m = -1e30, l = 0.
//   The warps merge in shared memory; after cluster.sync() every block
//   reads the others' (m, l, acc) through distributed shared memory and
//   writes its 1/split of the G·D outputs with the log-sum-exp merge, so
//   there is no second kernel and no workspace.
// * Loads in flight.  Pages are staged in tiles of 16 tokens (K and V of
//   one head, 8 KiB in bf16 at D = 128) with 16-byte cp.async copies into
//   a ring of shared-memory stages; positions at or past seq_len are
//   zero-filled.  The page id of a tile is read from the table one tile
//   before its copies are issued, so the indirection never waits in front
//   of them.
// * Per-token work.  A staged tile is scored at once, with one
//   online-softmax update per tile, not per token.
//   - bfloat16 (the served type) runs on the tensor cores: each warp owns
//     whole tiles in a ring of its own (no block barrier per tile).  The
//     G <= 8 query rows, zero-padded to 16, are the A operand of
//     mma.sync.m16n8k16 against K (ldmatrix from an XOR-swizzled tile),
//     the scores stay in the accumulator layout, which is the A layout of
//     the P·V product against V (ldmatrix.trans), so a tile costs two
//     shuffles for its row maxima, two for its row sums, and D/4 mma.
//     P enters the product rounded to bfloat16; sums stay float32.
//   - float32 runs on the CUDA cores: the 4 warps share a block ring and
//     take 4 tokens of each tile; every lane holds D/32 elements of the G
//     query rows and makes GMAX·4 partial dot products, and one
//     transposing butterfly (31 shuffles at GMAX = 8) leaves one finished
//     score in each lane.
//   Masked positions get p = 0, and the mask value is the TPU kernel's
//   -1e30.
//
// Summation order differs from a single sequential softmax (per-warp, then
// per-block, then per-cluster merges), within float32 rounding.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;                        // warps per block
constexpr int kBlock = kWarps * 32;
constexpr int kTileTok = 16;                     // tokens per staged tile
constexpr int kTokPerWarp = kTileTok / kWarps;   // tokens each warp scores per tile
constexpr int kMaxSplit = 16;                    // largest cluster (non-portable above 8)
constexpr float kNegInf = -1e30f;                // the TPU kernel's mask value

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

template <int N>
struct alignas(sizeof(float) * N) Vec {
  float v[N];
};

// N consecutive floats in vector loads of at most 16 bytes (p is aligned
// to the load width).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  constexpr int kPer = N < 4 ? N : 4;
#pragma unroll
  for (int c = 0; c < N; c += kPer) {
    const Vec<kPer> x = *reinterpret_cast<const Vec<kPer>*>(p + c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c + i] = x.v[i];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;                   // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum each of the N per-lane values over the warp; the result for value v
// ends in every lane whose index shifted right by 5 - log2(N) is v.  Each
// step halves the values a lane holds: lanes with bit o set keep the upper
// half and send the lower one, so N values cost N - 1 shuffles plus
// 5 - log2(N) for the lanes left over.
template <int N, int n = N, int o = 16>
__device__ __forceinline__ float transpose_reduce(float (&x)[N], int lane) {
  if constexpr (n > 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? x[i] : x[i + n / 2];
      const float keep = upper ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    return transpose_reduce<N, n / 2, o / 2>(x, lane);
  } else {
    float r = x[0];
#pragma unroll
    for (int s = o; s > 0; s >>= 1) r += __shfl_xor_sync(0xffffffffu, r, s);
    return r;
  }
}

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// Shared memory of one block: the tile ring (reused for the warps' partial
// sums once the last tile is consumed), then the merge area, which the
// other blocks of the cluster read, then per-warp scratch of the float32
// path.  Merge area: res_acc [GMAX][D], res_m, res_l [GMAX], warp m and
// warp l [kWarps][GMAX], the blocks' m and l and then the merge weights
// [kMaxSplit][GMAX].
template <int D, int GMAX>
struct Merge {
  static constexpr size_t kFloats =
      GMAX * D + 2 * GMAX + 2 * kWarps * GMAX + 2 * kMaxSplit * GMAX;
  float* res_acc;
  float* res_m;
  float* res_l;
  float* wm;
  float* wl;
  float* coef;                                           // the blocks' m, then the weights
  float* ls;                                             // the blocks' l
  __device__ explicit Merge(float* base)
      : res_acc(base), res_m(base + GMAX * D), res_l(res_m + GMAX), wm(res_l + GMAX),
        wl(wm + kWarps * GMAX), coef(wl + kWarps * GMAX), ls(coef + kMaxSplit * GMAX) {}
};

template <size_t A, size_t B>
__host__ __device__ constexpr size_t max_of() { return A > B ? A : B; }

// float32 path: a ring of block-wide stages, 4 tokens of each tile per warp
template <typename T, int D, int GMAX>
struct Layout {
  static constexpr int kTileElems = kTileTok * D;                        // K or V of one tile
  static constexpr int kTileBytes = 2 * kTileElems * static_cast<int>(sizeof(T));
  static constexpr int kStages = kTileBytes > 16384 ? 3 : 4;
  static constexpr int kVals = GMAX * kTokPerWarp;                       // partial scores per lane
  static constexpr size_t kFront = max_of<static_cast<size_t>(kStages) * kTileBytes,
                                          sizeof(float) * kWarps * GMAX * D>();
  // after the merge area: p [kWarps][kVals], alpha [kWarps][GMAX]
  static constexpr size_t kBytes =
      kFront + sizeof(float) * (Merge<D, GMAX>::kFloats + kWarps * kVals + kWarps * GMAX);
};

// bfloat16 path: a ring of per-warp stages, whole tiles per warp, 8 query
// rows.  Two stages a warp from D = 128 on keep a block at 69 KB, so three
// blocks fit an SM and the served launch (32 clusters of 8) runs in one
// wave; with three stages (101 KB) the H100 cannot hold all 32 at once,
// and the last ones wait for a second wave.
template <int D>
struct MmaLayout {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kTileBytes = 2 * kTileTok * kRowBytes;            // K then V
  static constexpr int kStages = D >= 128 ? 2 : 3;                       // per warp
  static constexpr size_t kWarpRing = static_cast<size_t>(kStages) * kTileBytes;
  static constexpr size_t kFront = max_of<kWarps * kWarpRing, sizeof(float) * kWarps * 8 * D>();
  static constexpr size_t kBytes = kFront + sizeof(float) * Merge<D, 8>::kFloats;
};

// The warps' partials (part_acc [kWarps][GMAX][D] and m.wm / m.wl, written
// by the caller, then a __syncthreads) become the block's softmax, then the
// cluster's: one thread per query row turns the blocks' (m, l) into
// weights, and this block writes outputs [rank, rank + 1) · G·D / split.
template <typename T, int D, int GMAX>
__device__ __forceinline__ void merge_and_store(cg::cluster_group cluster,
                                                const float* part_acc, Merge<D, GMAX> m,
                                                int g_n, int split, int rank, int head,
                                                T* __restrict__ out) {
  for (int i = threadIdx.x; i < g_n * D; i += kBlock) {
    const int g = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m.wm[w * GMAX + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m.wm[w * GMAX + g] - mx);
      a = fmaf(part_acc[w * GMAX * D + i], c, a);
      l = fmaf(m.wl[w * GMAX + g], c, l);
    }
    m.res_acc[i] = a;
    if (i - g * D == 0) {
      m.res_m[g] = mx;
      m.res_l[g] = l;
    }
  }
  cluster.sync();
  for (int i = threadIdx.x; i < split * g_n; i += kBlock) {    // every (rank, row) at once
    const int r = i / g_n;
    const int g = i - r * g_n;
    m.coef[r * GMAX + g] = *cluster.map_shared_rank(m.res_m + g, r);
    m.ls[r * GMAX + g] = *cluster.map_shared_rank(m.res_l + g, r);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < g_n; g += kBlock) {
    float mx = kNegInf;
    for (int r = 0; r < split; ++r) mx = fmaxf(mx, m.coef[r * GMAX + g]);
    float l = 0.f;
    for (int r = 0; r < split; ++r) {
      const float c = expf(m.coef[r * GMAX + g] - mx);
      m.coef[r * GMAX + g] = c;
      l = fmaf(m.ls[r * GMAX + g], c, l);
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;           // seq_len == 0 gives 0
    for (int r = 0; r < split; ++r) m.coef[r * GMAX + g] *= inv;
  }
  __syncthreads();
  const int n_out = g_n * D;
  const int o_begin = rank * n_out / split;
  const int o_end = (rank + 1) * n_out / split;
  for (int i = o_begin + threadIdx.x; i < o_end; i += kBlock) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll 4
    for (int r = 0; r < split; ++r) {
      a = fmaf(*cluster.map_shared_rank(m.res_acc + i, r), m.coef[r * GMAX + g], a);
    }
    out[static_cast<int64_t>(head) * n_out + i] = from_float<T>(a);
  }
  cluster.sync();                                        // keep the merge area alive for readers
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a · b for a 16x16 bf16 A (rows 8-15 zero here: a1 = a3 = 0), a
// 16x8 bf16 B and a 16x8 float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Where each block's pages and tiles lie; shared by both paths.
struct Split {
  int rank, head, b, h, seq_len, p_begin, tiles_per_page, n_tiles;
  const int32_t* pages;                                  // table entries of the block's pages
  int64_t tok_stride, page_stride;                       // in elements

  __device__ Split(cg::cluster_group cluster, const int32_t* table,
                   const int32_t* seq_lens, int kvh_n, int page_size, int max_pages, int split,
                   int d) {
    rank = static_cast<int>(cluster.block_rank());
    head = blockIdx.x / split;                           // b * kvh_n + h
    b = head / kvh_n;
    h = head - b * kvh_n;
    seq_len = max(0, min(seq_lens[b], max_pages * page_size));
    const int n_pages = (seq_len + page_size - 1) / page_size;
    p_begin = static_cast<int>(static_cast<int64_t>(rank) * n_pages / split);
    const int p_end = static_cast<int>(static_cast<int64_t>(rank + 1) * n_pages / split);
    tiles_per_page = (page_size + kTileTok - 1) / kTileTok;
    n_tiles = (p_end - p_begin) * tiles_per_page;
    pages = table + static_cast<int64_t>(b) * max_pages + p_begin;
    tok_stride = static_cast<int64_t>(kvh_n) * d;
    page_stride = static_cast<int64_t>(page_size) * tok_stride;
  }
  // tokens of block tile t that lie before seq_len (<= 0 for a tile past it)
  __device__ int valid(int t, int page_size, int& tok0) const {
    tok0 = (t % tiles_per_page) * kTileTok;
    const int pos = (p_begin + t / tiles_per_page) * page_size + tok0;
    return min(min(kTileTok, page_size - tok0), seq_len - pos);
  }
  __device__ int page(int t) const { return t < n_tiles ? __ldg(pages + t / tiles_per_page) : 0; }
};

template <int D>
__global__ void __launch_bounds__(kBlock) paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out, int kvh_n, int g_n,
    int page_size, int max_pages, int split, float scale) {
  using L = MmaLayout<D>;
  constexpr int kChunks = D / 8;                         // 16-byte chunks of a K/V row
  constexpr int kTileChunks = 2 * kTileTok * kChunks;
  constexpr int kKSteps = D / 16;
  constexpr int kNBlocks = D / 8;
  static_assert(kTileChunks % 32 == 0 && kChunks >= 8, "tile copies must divide over a warp");

  extern __shared__ __align__(128) unsigned char smem[];
  Merge<D, 8> merge(reinterpret_cast<float*>(smem + L::kFront));
  cg::cluster_group cluster = cg::this_cluster();
  const Split sp(cluster, table, seq_lens, kvh_n, page_size, max_pages, split, D);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 2;                             // query row of this lane's fragments
  const int quad = lane & 3;

  // Q as the A operand: a0 = (row, k 2·quad..+1), a2 = (row, k 8 + 2·quad..+1)
  uint32_t qa[kKSteps][2];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    if (row < g_n) {
      const __nv_bfloat16* qp =
          q + (static_cast<int64_t>(sp.head) * g_n + row) * D + kk * 16 + quad * 2;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qp);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qp + 8);
    } else {
      qa[kk][0] = qa[kk][1] = 0u;
    }
  }
  float o[kNBlocks][4];
#pragma unroll
  for (int nb = 0; nb < kNBlocks; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m_run = kNegInf, l_run = 0.f;                    // for query row `row`

  // this warp takes block tiles warp, warp + 4, ...; stage j % kStages of its ring
  unsigned char* ring = smem + warp * L::kWarpRing;
  const int n_mine = sp.n_tiles > warp ? (sp.n_tiles - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int j, int page) {
    int tok0;
    const int valid = sp.valid(warp + j * kWarps, page_size, tok0);
    unsigned char* slot = ring + (j % L::kStages) * L::kTileBytes;
    const int64_t base =
        static_cast<int64_t>(page) * sp.page_stride + static_cast<int64_t>(sp.h) * D;
#pragma unroll
    for (int u = 0; u < kTileChunks / 32; ++u) {
      const int i = lane + u * 32;
      const int kv = i / (kTileTok * kChunks);
      const int r = (i / kChunks) % kTileTok;
      const int c = i % kChunks;
      const bool fill = r < valid;
      const __nv_bfloat16* src = (kv ? v_pages : k_pages) + base + c * 8 +
                                 (fill ? static_cast<int64_t>(tok0 + r) * sp.tok_stride : 0);
      cp_async16(slot + kv * (kTileTok * L::kRowBytes) + r * L::kRowBytes + ((c ^ (r & 7)) << 4),
                 src, fill);
    }
  };
  auto page_of = [&](int j) { return j < n_mine ? sp.page(warp + j * kWarps) : 0; };

#pragma unroll
  for (int j = 0; j < L::kStages - 1; ++j) {
    if (j < n_mine) issue(j, page_of(j));
    cp_async_commit();
  }
  int next_page = page_of(L::kStages - 1);
  for (int j = 0; j < n_mine; ++j) {
    const int ahead = j + L::kStages - 1;
    if (ahead < n_mine) issue(ahead, next_page);
    cp_async_commit();
    next_page = page_of(ahead + 1);                      // in flight while tile j is consumed
    cp_async_wait<L::kStages - 1>();
    __syncwarp();

    const unsigned kt = smem_u32(ring + (j % L::kStages) * L::kTileBytes);
    const unsigned vt = kt + kTileTok * L::kRowBytes;
    int tok0;
    const int valid = sp.valid(warp + j * kWarps, page_size, tok0);
    // S = Q · K^T: s[h] holds (row, tokens 8h + 2·quad..+1) in [0], [1]
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int mat = lane >> 3;                           // the 8x8 matrix this lane addresses
    const int mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int r = (mat >> 1) * 8 + mrow;               // tokens 0-7, then 8-15
      const int c = kk * 2 + (mat & 1);                  // k 0-7, then 8-15
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + r * L::kRowBytes + ((c ^ (r & 7)) << 4));
      mma_bf16(s[0], qa[kk][0], qa[kk][1], kb[0], kb[1]);
      mma_bf16(s[1], qa[kk][0], qa[kk][1], kb[2], kb[3]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[hh][e] *= scale;
        if (hh * 8 + quad * 2 + e < valid) mx = fmaxf(mx, s[hh][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float p[2][2], psum = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[hh][e] = hh * 8 + quad * 2 + e < valid ? expf(s[hh][e] - m_new) : 0.f;
        psum += p[hh][e];
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    // O += P · V, P from the score accumulators as the A operand
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb) {
      o[nb][0] *= alpha;
      o[nb][1] *= alpha;
    }
#pragma unroll
    for (int nb = 0; nb < kNBlocks; nb += 2) {
      const int r = (mat & 1) * 8 + mrow;                // tokens 0-7, then 8-15
      const int c = nb + (mat >> 1);                     // columns of n-block nb, then nb + 1
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + r * L::kRowBytes + ((c ^ (r & 7)) << 4));
      mma_bf16(o[nb], pa0, pa2, vb[0], vb[1]);
      mma_bf16(o[nb + 1], pa0, pa2, vb[2], vb[3]);
    }
    __syncwarp();                                        // the slot is refilled next
  }

  cp_async_wait<0>();
  __syncthreads();                                       // every warp is done with the ring
  float* part_acc = reinterpret_cast<float*>(smem);      // [kWarps][8][D]
#pragma unroll
  for (int nb = 0; nb < kNBlocks; ++nb) {
    *reinterpret_cast<float2*>(part_acc + (warp * 8 + row) * D + nb * 8 + quad * 2) =
        make_float2(o[nb][0], o[nb][1]);
  }
  if (quad == 0) {
    merge.wm[warp * 8 + row] = m_run;
    merge.wl[warp * 8 + row] = l_run;
  }
  __syncthreads();
  merge_and_store<__nv_bfloat16, D, 8>(cluster, part_acc, merge, g_n, split, sp.rank, sp.head,
                                        out);
}

template <int D, int GMAX>
__global__ void __launch_bounds__(kBlock) paged_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ seq_lens, float* __restrict__ out, int kvh_n, int g_n,
    int page_size, int max_pages, int split, float scale) {
  using L = Layout<float, D, GMAX>;
  constexpr int DL = D / 32;                             // row elements per lane
  constexpr int kVals = L::kVals;
  constexpr int kLow = 5 - log2_of(kVals);               // lane bits holding copies of one score
  constexpr int kVecElems = 4;
  constexpr int kRowChunks = D / kVecElems;              // 16-byte chunks of a K/V row
  constexpr int kTileChunks = 2 * kTileTok * kRowChunks;
  static_assert(kTileChunks % kBlock == 0, "tile copies must divide over the block");
  static_assert((1 << log2_of(kVals)) == kVals && kVals <= 32, "GMAX must be 1, 2, 4 or 8");

  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* merge_base = reinterpret_cast<float*>(smem + L::kFront);
  Merge<D, GMAX> merge(merge_base);
  float* p_s = merge_base + Merge<D, GMAX>::kFloats;    // [kWarps][kVals]
  float* alpha_s = p_s + kWarps * kVals;                 // [kWarps][GMAX]

  cg::cluster_group cluster = cg::this_cluster();
  const Split sp(cluster, table, seq_lens, kvh_n, page_size, max_pages, split, D);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the score this lane ends with after the transposing butterfly
  const int my_val = lane >> kLow;
  const int my_g = my_val / kTokPerWarp;
  const int my_u = my_val % kTokPerWarp;
  const bool writer = (lane & ((1 << kLow) - 1)) == 0;   // one lane per score

  float qr[GMAX][DL], acc[GMAX][DL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < g_n) {
      load_vec<DL>(q + (static_cast<int64_t>(sp.head) * g_n + g) * D + lane * DL, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < DL; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
  }
  float m_run = kNegInf, l_run = 0.f;                    // for query row my_g

  auto issue = [&](int t, int page) {
    int tok0;
    const int valid = sp.valid(t, page_size, tok0);
    float* slot = ring + (t % L::kStages) * 2 * L::kTileElems;
    const int64_t base =
        static_cast<int64_t>(page) * sp.page_stride + static_cast<int64_t>(sp.h) * D;
#pragma unroll
    for (int u = 0; u < kTileChunks / kBlock; ++u) {
      const int i = threadIdx.x + u * kBlock;
      const int kv = i / (kTileTok * kRowChunks);
      const int r = i - kv * (kTileTok * kRowChunks);
      const int tok = r / kRowChunks;
      const int col = (r - tok * kRowChunks) * kVecElems;
      const bool fill = tok < valid;
      const float* src = (kv ? v_pages : k_pages) + base + col +
                         (fill ? static_cast<int64_t>(tok0 + tok) * sp.tok_stride : 0);
      cp_async16(slot + kv * L::kTileElems + tok * D + col, src, fill);
    }
  };

#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < sp.n_tiles) issue(t, sp.page(t));
    cp_async_commit();
  }
  int next_page = sp.page(L::kStages - 1);
  for (int t = 0; t < sp.n_tiles; ++t) {
    const int ahead = t + L::kStages - 1;
    if (ahead < sp.n_tiles) issue(ahead, next_page);
    cp_async_commit();
    next_page = sp.page(ahead + 1);                      // in flight while tile t is consumed
    cp_async_wait<L::kStages - 1>();
    __syncthreads();

    const float* kt = ring + (t % L::kStages) * 2 * L::kTileElems;
    const float* vt = kt + L::kTileElems;
    int tok0;
    const int valid = sp.valid(t, page_size, tok0);
    const int tw = warp * kTokPerWarp;                   // the warp's first token in the tile
    float part[kVals];
#pragma unroll
    for (int u = 0; u < kTokPerWarp; ++u) {
      float kr[DL];
      load_vec<DL>(kt + (tw + u) * D + lane * DL, kr);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) s = fmaf(qr[g][e], kr[e], s);
        part[g * kTokPerWarp + u] = s;
      }
    }
    const float s = transpose_reduce<kVals>(part, lane);
    const bool ok = tw + my_u < valid;
    float mx = ok ? s : kNegInf;
#pragma unroll
    for (int o = 1; o < kTokPerWarp; o <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o << kLow));
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = 1; o < kTokPerWarp; o <<= 1) {
      psum += __shfl_xor_sync(0xffffffffu, psum, o << kLow);
    }
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (writer) {
      p_s[warp * kVals + my_val] = p;
      if (my_u == 0) alpha_s[warp * GMAX + my_g] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < g_n) {
        const float a = alpha_s[warp * GMAX + g];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[g][e] *= a;
      }
    }
#pragma unroll
    for (int u = 0; u < kTokPerWarp; ++u) {
      float vr[DL];
      load_vec<DL>(vt + (tw + u) * D + lane * DL, vr);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < g_n) {
          const float pu = p_s[warp * kVals + g * kTokPerWarp + u];
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[g][e] = fmaf(pu, vr[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                                     // the slot and p_s are rewritten next
  }

  cp_async_wait<0>();
  __syncthreads();                                       // the ring holds no copy any more
  float* part_acc = reinterpret_cast<float*>(smem);      // [kWarps][GMAX][D]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < g_n) {
#pragma unroll
      for (int e = 0; e < DL; ++e) part_acc[(warp * GMAX + g) * D + lane * DL + e] = acc[g][e];
    }
  }
  if (writer && my_u == 0) {
    merge.wm[warp * GMAX + my_g] = m_run;
    merge.wl[warp * GMAX + my_g] = l_run;
  }
  __syncthreads();
  merge_and_store<float, D, GMAX>(cluster, part_acc, merge, g_n, split, sp.rank, sp.head, out);
}

struct Args {
  const void *q, *k, *v, *table, *lens;
  void* out;
  int64_t b_n, kvh_n, g_n, page_size, max_pages, split;
  float scale;
  cudaStream_t stream;
  int* clusters;                                         // set: report, do not launch
};

// One cluster launch: split blocks per (b, kv head), dynamic shared memory
// set once per kernel instance.  A launch the card refuses is returned.
// With a.clusters set, nothing is launched: the number of such clusters the
// card can hold at once is written there instead.
template <typename T, typename Kernel>
cudaError_t launch_cluster(Kernel kernel, size_t smem_bytes, bool& configured, const Args& a) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.split * a.b_n * a.kvh_n), 1, 1);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.clusters != nullptr) return cudaOccupancyMaxActiveClusters(a.clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.table),
      static_cast<const int32_t*>(a.lens), static_cast<T*>(a.out), static_cast<int>(a.kvh_n),
      static_cast<int>(a.g_n), static_cast<int>(a.page_size), static_cast<int>(a.max_pages),
      static_cast<int>(a.split), a.scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D, int GMAX>
cudaError_t launch_f32(const Args& a) {
  static bool configured = false;
  return launch_cluster<float>(paged_attention_f32_kernel<D, GMAX>,
                               Layout<float, D, GMAX>::kBytes, configured, a);
}

template <int D>
cudaError_t launch_f32_g(const Args& a) {
  if (a.g_n <= 1) return launch_f32<D, 1>(a);
  if (a.g_n <= 2) return launch_f32<D, 2>(a);
  if (a.g_n <= 4) return launch_f32<D, 4>(a);
  return launch_f32<D, 8>(a);
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  static bool configured = false;
  return launch_cluster<__nv_bfloat16>(paged_attention_mma_kernel<D>, MmaLayout<D>::kBytes,
                                       configured, a);
}

}  // namespace
}  // namespace repro_torch

namespace {

int dispatch(int64_t d, int dtype, const repro_torch::Args& a) {
  using namespace repro_torch;
  if (dtype == 0) {
    return d == 64 ? launch_f32_g<64>(a) : d == 128 ? launch_f32_g<128>(a) : launch_f32_g<256>(a);
  }
  return d == 64 ? launch_bf16<64>(a) : d == 128 ? launch_bf16<128>(a) : launch_bf16<256>(a);
}

bool valid_args(int64_t g_n, int64_t d, int64_t page_size, int64_t split, int dtype) {
  return g_n >= 1 && g_n <= 8 && page_size >= 1 && split >= 1 &&
         split <= repro_torch::kMaxSplit && (d == 64 || d == 128 || d == 256) &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {64, 128, 256}, 1 <= G <= 8,
// 1 <= split <= 16 blocks per (b, kv head) cluster.
extern "C" int repro_paged_attention(const void* q, const void* k, const void* v,
                                     const void* table, const void* lens, void* out, int64_t b_n,
                                     int64_t kvh_n, int64_t g_n, int64_t d, int64_t page_size,
                                     int64_t max_pages, int64_t split, float scale, int dtype,
                                     void* stream) {
  if (!valid_args(g_n, d, page_size, split, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (b_n * kvh_n == 0) return static_cast<int>(cudaGetLastError());
  const repro_torch::Args a{q, k, v, table, lens, out, b_n, kvh_n, g_n, page_size, max_pages,
                            split, scale, static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(d, dtype, a);
}

// How many clusters of `split` blocks of the kernel for (d, dtype, g_n) the
// card holds at once (cudaOccupancyMaxActiveClusters), written to *clusters.
extern "C" int repro_paged_attention_clusters(int64_t g_n, int64_t d, int64_t split, int dtype,
                                              void* clusters) {
  if (!valid_args(g_n, d, 1, split, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const repro_torch::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, g_n, 1,
                            1, split, 1.f, nullptr, static_cast<int*>(clusters)};
  return dispatch(d, dtype, a);
}
