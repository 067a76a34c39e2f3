// The TDM gather shared by token_drop.cu (hard TDM) and token_package.cu
// (soft TDM), fp32.
//
// Input: tokens z [B, N, D] (CLS at row 0), the kept body indices
// keep_idx [B, k] (top-k chosen by the wrapper with a stable sort) and the
// weights w [B, N - 1] of the body rows (0 at kept rows and at padded rows).
// Output out [B, k + 2, D]: the CLS row, the k kept rows in top-k order, and
// the fused row sum_n w[n] * z[1 + n]. With kPackage the weights are raw
// (the dropped rows' scores and the carried package mass), the fused row is
// normalised here as (sum_n w[n] * z[1 + n]) / (sum_n w[n] + 1e-9), and
// new_mass [B] = sum_n w[n] is written for the next soft TDM.
//
// One thread block per (32-column slice of D, batch row): 32 x 8 threads.
// Each of the 8 row groups copies every 8th kept row and accumulates every
// 8th body row of the fused sum (and of the weight sum); the 8 partial sums
// are added in a fixed order, so the result does not depend on B or on the
// launch, and every block of a row computes the same weight sum.
//
// Bound on the H100: memory. At the main path's shapes (B <= 4, N <= 197,
// D = 384) the call reads z once (~1.2 MB) and writes ~0.9 MB, with ~1e6
// flops; each z row is read by one block per column slice, the kept rows a
// second time (from L2). Blocks are small, so at this size the launch
// dominates — the fix is fusion with its neighbours, later work.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tdm_tile {

constexpr int kTD = 32;     // columns per block (one warp wide)
constexpr int kGroups = 8;  // row groups per block
constexpr int kThreads = kTD * kGroups;

template <bool kPackage>
__device__ __forceinline__ void gather(const float* __restrict__ z,
                                       const int* __restrict__ keep_idx,
                                       const float* __restrict__ w,
                                       float* __restrict__ out,
                                       float* __restrict__ new_mass, int N,
                                       int D, int k) {
  __shared__ float part[kGroups][kTD + 1];
  __shared__ float wpart[kGroups];
  const int col = blockIdx.x * kTD + threadIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.y;
  const float* zb = z + static_cast<size_t>(b) * N * D;
  const int* kb = keep_idx + static_cast<size_t>(b) * k;
  const float* wb = w + static_cast<size_t>(b) * (N - 1);
  float* ob = out + static_cast<size_t>(b) * (k + 2) * D;

  float a = 0.f, m = 0.f;
  if constexpr (kPackage)
    for (int n = g; n < N - 1; n += kGroups) m += wb[n];
  if (col < D) {
    if (g == 0) ob[col] = zb[col];  // CLS
    for (int r = g; r < k; r += kGroups)
      ob[static_cast<size_t>(1 + r) * D + col] =
          zb[static_cast<size_t>(1 + kb[r]) * D + col];
    for (int n = g; n < N - 1; n += kGroups)
      a = fmaf(wb[n], zb[static_cast<size_t>(1 + n) * D + col], a);
  }
  part[g][threadIdx.x] = a;
  if (kPackage && threadIdx.x == 0) wpart[g] = m;
  __syncthreads();
  if (g == 0) {
    float f = 0.f, mass = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      f += part[i][threadIdx.x];
      if constexpr (kPackage) mass += wpart[i];
    }
    if (col < D)
      ob[static_cast<size_t>(k + 1) * D + col] =
          kPackage ? f / (mass + 1e-9f) : f;
    if (kPackage && blockIdx.x == 0 && threadIdx.x == 0) new_mass[b] = mass;
  }
}

// Grid of a call, or an error: cudaSuccess with *empty set when there is
// nothing to compute.
inline cudaError_t grid_for(int B, int N, int D, int k, dim3* grid,
                            bool* empty) {
  *empty = B <= 0 || D <= 0;
  if (*empty) return cudaSuccess;
  if (N < 2 || k < 1 || k > N - 1 || B > 65535) return cudaErrorInvalidValue;
  *grid = dim3((D + kTD - 1) / kTD, B);
  return cudaSuccess;
}

}  // namespace tdm_tile
