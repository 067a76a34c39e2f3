// The TDM kernel body shared by token_drop.cu (hard TDM) and
// token_package.cu (soft TDM), fp32: the stable top-k, the weights, the
// gather and the fused row, all in one launch.
//
// Input: tokens z [B, N, D] (CLS at row 0) and scores [B, N] (CLS at column
// 0, body from column 1, rows `s_stride` apart; token-padded rows score
// exactly 0). With kPackage, the carried package mass [B] and its body
// index [B] (int32 or int64; default the last body row), both nullable.
// Output out [B, k + 2, D]: the CLS row, the k kept body rows in top-k
// order, and the fused row; and, where kept_idx is not null (the hard
// TDM's training form), the kept body indices [B, k] int32 in top-k
// order, written by the blocks of column slice 0. Hard TDM: the fused row
// is sum_n w[n] z[1 + n] with w[n] = s[n] / (sum of the dropped scores +
// 1e-9), 0 at kept rows.
// Soft TDM: w holds the RAW dropped scores and the package's carried mass
// at its row (the package is pinned out of the selection at -inf); the
// package row is (sum_n w[n] z[1 + n]) / (sum_n w[n] + 1e-9) and
// new_mass [B] = sum_n w[n].
//
// Selection. The top k are the body rows of rank < k, where
//   rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i},
// the position torch.sort(descending=True, stable=True) and
// jax.lax.top_k give row i, tie for tie; kept row i goes to out row
// 1 + rank_i. This is a rank count, O(N^2) compares per batch row, taken
// over a bitonic network because it needs one barrier instead of
// log2(N) (log2(N) + 1) / 2 of them, compares straight from broadcast
// shared reads (four per 16-byte read), and leaves every rank in place for
// the gather; at N <= 197 it is ~200 compares per thread, hidden under the
// first z loads, which are issued before it. Every block of a batch row
// recomputes the selection and the weight sum itself (no cluster): the
// result is the same in each, because both depend on the scores alone.
//
// Layout: one block per (16-column slice of D, batch row), 4 float4
// columns x 64 row groups = 256 threads. Group g reads body rows g, g + 64,
// g + 128, ... of its columns, four rows (one chunk) in flight at a time,
// and either stores a row at its kept slot or adds it, in that order, into
// its fused sum; so each z element is read once and each kept row written
// once. Summation order depends on the body index alone, never on N, B,
// padding or the launch: the weight sum runs over a fixed kMaxBody-slot
// tree (zeros past the last row), the fused sum over the 64 groups' chains
// combined by a fixed butterfly and warp order. So a request's rows have
// the same bits alone and in a token-padded tile, whose padded rows score
// 0 (they lose every tie, are dropped and add w = 0).
//
// Bound on the H100: memory. At the main path's shapes (B <= 4, N <= 197,
// D = 384) a call reads z once (~1.2 MB) and writes ~0.9 MB; the time is
// the launch, two dependent L2 round trips (scores, then z) and the
// selection between them.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace tdm_tile {

constexpr int kLanes = 4;     // float4 columns per block (16 columns)
constexpr int kGroups = 64;   // row groups per block
constexpr int kThreads = kLanes * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;      // body rows a thread keeps in flight (a chunk)
constexpr int kChunk = kGroups * kRows;  // body rows per chunk
constexpr int kMaxBody = 1024;  // body rows a call may have: N <= 1025

static_assert(kThreads % 32 == 0 && 32 % kLanes == 0, "warp layout");
static_assert(kMaxBody % kThreads == 0 && kMaxBody % 32 == 0, "weight tree");

// The soft TDM's package: carried mass [B] (nullptr: no package yet) and
// body index [B] (nullptr: the last body row), int64 when pos64.
struct Package {
  const float* mass;
  const void* pos;
  int pos64;
};

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 a) {
  return make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y),
                     fmaf(w, v.z, a.z), fmaf(w, v.w, a.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(float4 a, int mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, a.x, mask),
                     __shfl_xor_sync(0xffffffffu, a.y, mask),
                     __shfl_xor_sync(0xffffffffu, a.z, mask),
                     __shfl_xor_sync(0xffffffffu, a.w, mask));
}

// Rank of body row i (see the top of this file) over the selection scores
// sel[0, 4 * nb4) (-inf past the last row). j0 is the first row of the
// calling warp's 32-row window: below it every row is at a lower index, so
// a tie counts; above it none is; only the window itself compares indices.
// j0 is the same for the whole warp, so the three loops do not diverge.
__device__ __forceinline__ int rank_of(const float* sel, int i, int j0,
                                       int nb4) {
  const float si = sel[i];
  const float4* s4 = reinterpret_cast<const float4*>(sel);
  int r = 0;
  for (int q = 0; q < j0 / 4; ++q) {
    const float4 v = s4[q];
    r += (v.x >= si) + (v.y >= si) + (v.z >= si) + (v.w >= si);
  }
  const int j1 = min(j0 + 32, 4 * nb4);
  for (int j = j0; j < j1; ++j) {
    const float v = sel[j];
    r += (v > si) || (v == si && j < i);
  }
  for (int q = j1 / 4; q < nb4; ++q) {
    const float4 v = s4[q];
    r += (v.x > si) + (v.y > si) + (v.z > si) + (v.w > si);
  }
  return r;
}

// Put body rows base + g + r * kGroups (r < kRows) of this thread's float4
// column in flight; zc points at the column in row 0 of the batch row.
__device__ __forceinline__ void load_chunk(float4 (&v)[kRows],
                                           const float* zc, int base, int g,
                                           int nb, int D, bool col) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = base + g + r * kGroups;
    if (col && n < nb)
      v[r] = __ldg(reinterpret_cast<const float4*>(
          zc + static_cast<size_t>(1 + n) * D));
  }
}

template <bool kPackage>
__device__ __forceinline__ void tdm(const float* __restrict__ z,
                                    const float* __restrict__ scores,
                                    int s_stride, Package pkg,
                                    float* __restrict__ out,
                                    float* __restrict__ new_mass,
                                    int* __restrict__ kept_idx, int N,
                                    int D, int k) {
  __shared__ __align__(16) float sel[kMaxBody];  // selection scores
  __shared__ int rank[kMaxBody];
  __shared__ float w[kMaxBody];                  // weights, 0 past the rows
  __shared__ float wpart[kWarps];
  __shared__ float4 part[kWarps][kLanes];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int g = tid / kLanes;
  const int b = blockIdx.y;
  const int nb = N - 1;
  const int c4 = blockIdx.x * kLanes + lane;
  const bool col = c4 < D / 4;
  const float* zc = z + static_cast<size_t>(b) * N * D + 4 * c4;
  float* oc = out + static_cast<size_t>(b) * (k + 2) * D + 4 * c4;

  // 1. the first chunk of z (and CLS) in flight before the selection
  float4 v[kRows], cls;
  load_chunk(v, zc, 0, g, nb, D, col);
  if (g == 0 && col) cls = __ldg(reinterpret_cast<const float4*>(zc));

  // 2. the selection scores, the package pinned at -inf
  const float* sb = scores + static_cast<size_t>(b) * s_stride + 1;
  int pos = -1;
  float mass = 0.f;
  if constexpr (kPackage) {
    if (pkg.mass != nullptr) {
      mass = pkg.mass[b];
      long long p = nb - 1;
      if (pkg.pos != nullptr)
        p = pkg.pos64 ? static_cast<const long long*>(pkg.pos)[b]
                      : static_cast<const int*>(pkg.pos)[b];
      pos = (p >= 0 && p < nb) ? static_cast<int>(p) : -1;
    }
  }
  for (int j = tid; j < kMaxBody; j += kThreads)
    sel[j] = (j < nb && j != pos) ? sb[j] : -CUDART_INF_F;
  __syncthreads();

  // 3. ranks
  const int nb4 = (nb + 3) / 4;
  for (int i = tid; i < nb; i += kThreads)
    rank[i] = rank_of(sel, i, i & ~31, nb4);
  __syncthreads();

  // 4. the kept indices where asked for; the weights and their sum: each
  // thread its strided slots in order, then a butterfly over the warp, then
  // the warps in order
  if (kept_idx != nullptr && blockIdx.x == 0)
    for (int i = tid; i < nb; i += kThreads)
      if (rank[i] < k) kept_idx[static_cast<size_t>(b) * k + rank[i]] = i;
  float m = 0.f;
  for (int j = tid; j < kMaxBody; j += kThreads) {
    float wj = 0.f;
    if (j < nb && rank[j] >= k) wj = (j == pos) ? mass : sb[j];
    w[j] = wj;
    m += wj;
  }
#pragma unroll
  for (int mask = 16; mask > 0; mask /= 2)
    m += __shfl_xor_sync(0xffffffffu, m, mask);
  if (tid % 32 == 0) wpart[tid / 32] = m;
  __syncthreads();
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) wsum += wpart[i];
  const float denom = wsum + 1e-9f;

  // 5. gather and fuse: each body row stored at its kept slot or added
  if (g == 0 && col) *reinterpret_cast<float4*>(oc) = cls;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = 0; base < nb; base += kChunk) {
    if (base > 0) load_chunk(v, zc, base, g, nb, D, col);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int n = base + g + r * kGroups;
      if (col && n < nb) {
        const int rk = rank[n];
        if (rk < k)
          *reinterpret_cast<float4*>(oc + static_cast<size_t>(1 + rk) * D) =
              v[r];
        else
          acc = fma4(kPackage ? w[n] : w[n] / denom, v[r], acc);
      }
    }
  }

  // 6. the fused row: the warp's 8 groups by butterfly, then the warps in
  // order
#pragma unroll
  for (int mask = kLanes; mask < 32; mask *= 2)
    acc = add4(acc, shfl_xor4(acc, mask));
  if (tid % 32 < kLanes) part[tid / 32][lane] = acc;
  __syncthreads();
  if (tid < kLanes) {
    float4 f = part[0][lane];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) f = add4(f, part[i][lane]);
    if constexpr (kPackage)
      f = make_float4(f.x / denom, f.y / denom, f.z / denom, f.w / denom);
    if (col)
      *reinterpret_cast<float4*>(oc + static_cast<size_t>(k + 1) * D) = f;
    if (kPackage && blockIdx.x == 0 && tid == 0) new_mass[b] = wsum;
  }
}

// Grid of a call, or an error: cudaSuccess with *empty set when there is
// nothing to compute. D must be a multiple of 4 (float4 columns).
inline cudaError_t grid_for(int B, int N, int D, int k, dim3* grid,
                            bool* empty) {
  *empty = B <= 0 || D <= 0;
  if (*empty) return cudaSuccess;
  if (N < 2 || N - 1 > kMaxBody || k < 1 || k > N - 1 || D % 4 != 0 ||
      B > 65535)
    return cudaErrorInvalidValue;
  *grid = dim3((D / 4 + kLanes - 1) / kLanes, B);
  return cudaSuccess;
}

}  // namespace tdm_tile
