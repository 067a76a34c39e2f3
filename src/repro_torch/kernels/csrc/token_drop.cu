// Token drop — the hard TDM's gather and fuse on Hopper, fp32.
//
// Replaces the Pallas kernel `_token_drop_kernel` / `token_drop_pallas`
// (src/repro/kernels/token_drop/token_drop.py); on the reference main path
// this stage is `token_pruning.tdm` (core/packed_runner.py).
//
// Input: tokens z [B, N, D] (CLS at row 0), the kept body indices
// keep_idx [B, k] (top-k chosen by the wrapper with a stable sort) and the
// normalized drop weights w [B, N - 1] (0 at kept rows and at padded rows).
// Output [B, k + 2, D]: the CLS row, the k kept rows in top-k order, and
// the fused row sum_n w[n] * z[1 + n].
//
// One thread block per (32-column slice of D, batch row): 32 x 8 threads.
// Each of the 8 row groups copies every 8th kept row and accumulates every
// 8th body row of the fused sum; the 8 partial sums are added in a fixed
// order, so the result does not depend on B or on the launch.
//
// Bound on the H100: memory. At the main path's shapes (B <= 4, N <= 197,
// D = 384) the call reads z once (~1.2 MB) and writes ~0.9 MB, with ~1e6
// flops; each z row is read by one block per column slice, the kept rows a
// second time (from L2). Blocks are small, so at this size the launch
// dominates — the fix is fusion with its neighbours, later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTD = 32;     // columns per block (one warp wide)
constexpr int kGroups = 8;  // row groups per block

__global__ void __launch_bounds__(kTD * kGroups)
token_drop_kernel(const float* __restrict__ z, const int* __restrict__ keep_idx,
                  const float* __restrict__ w, float* __restrict__ out, int N,
                  int D, int k) {
  __shared__ float part[kGroups][kTD + 1];
  const int col = blockIdx.x * kTD + threadIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.y;
  const float* zb = z + static_cast<size_t>(b) * N * D;
  const int* kb = keep_idx + static_cast<size_t>(b) * k;
  const float* wb = w + static_cast<size_t>(b) * (N - 1);
  float* ob = out + static_cast<size_t>(b) * (k + 2) * D;

  float a = 0.f;
  if (col < D) {
    if (g == 0) ob[col] = zb[col];  // CLS
    for (int r = g; r < k; r += kGroups)
      ob[static_cast<size_t>(1 + r) * D + col] =
          zb[static_cast<size_t>(1 + kb[r]) * D + col];
    for (int n = g; n < N - 1; n += kGroups)
      a = fmaf(wb[n], zb[static_cast<size_t>(1 + n) * D + col], a);
  }
  part[g][threadIdx.x] = a;
  __syncthreads();
  if (g == 0 && col < D) {
    float f = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) f += part[i][threadIdx.x];
    ob[static_cast<size_t>(k + 1) * D + col] = f;
  }
}

}  // namespace

// z [B, N, D], keep_idx [B, k] int32 in [0, N - 1), w [B, N - 1],
// out [B, k + 2, D]; all fp32 except keep_idx, all contiguous.
extern "C" int token_drop_f32(const void* z, const void* keep_idx,
                              const void* w, void* out, int B, int N, int D,
                              int k, void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (N < 2 || k < 1 || k > N - 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((D + kTD - 1) / kTD, B);
  dim3 block(kTD, kGroups);
  token_drop_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(keep_idx),
      static_cast<const float*>(w), static_cast<float*>(out), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
