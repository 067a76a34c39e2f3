// Token drop — the hard TDM on Hopper, fp32: stable top-k, normalised drop
// weights, gather and fused row in one launch per call; and its gradient
// for training.
//
// Replaces the Pallas kernel `_token_drop_kernel` / `token_drop_pallas`
// (src/repro/kernels/token_drop/token_drop.py) together with the top-k and
// the weights its wrapper computes outside it; on the reference main path
// this stage is `token_pruning.tdm` (core/packed_runner.py). As the FPGA's
// TDHM does, the kernel selects the kept rows itself. The selection, the
// layout, the summation order and the bound are in tdm_tile.cuh, shared
// with token_package.cu. In training the forward also writes the kept
// indices, which the backward reads.
//
// The backward (token_drop_bwd_f32) is the gradient JAX takes of
// `token_pruning.tdm` (src/repro/core/token_pruning.py:45-89) in the
// reference's Algorithm 1. With S = sum of the dropped scores + 1e-9, w_n
// = s_n / S at a dropped body row n, dy_f the fused row's gradient and y_f
// the fused row the forward wrote:
//   dz[0] = dy[0]; dz[1 + idx_j] = dy[1 + j] at the kept rows;
//   dz[1 + n] = w_n dy_f at the dropped rows;
//   dscores[1 + n] = (g_n - c) / S at the dropped rows, g_n = <dy_f,
//   z[1 + n]>, c = <dy_f, y_f> = sum_m w_m g_m; dscores is 0 at CLS and at
//   the kept rows (the selection is an integer: no gradient flows through
//   it). c comes from the forward's fused row, so no block needs another
//   block's g.
// Bound: bytes. At layer 2 of full-width DeiT-Small in training (z [64,
// 197, 384], k = 138) a call reads the dropped rows of z, dy and the fused
// rows and writes dz whole, ~53 MB at most, ~16 us at 3.35 TB/s.
// Layout: one block of 256 threads per (32 rows of the token axis, batch
// row); each warp takes every eighth row, its lanes float4 columns. Every
// block rebuilds the kept set from the indices, S over the same fixed
// kMaxBody-slot tree as the forward (so S has the forward's bits) and c by
// one warp in a fixed order, then writes each of its dz rows once (a copy
// of its dy row, or w_n dy_f) and each dscores element once: no atomics,
// no zero fill, and two launches are bitwise equal.
#include "tdm_tile.cuh"

using namespace tdm_tile;

namespace {

constexpr int kBwdRows = 32;  // token rows per backward block

__global__ void __launch_bounds__(kThreads)
token_drop_f32_kernel(const float* __restrict__ z,
                      const float* __restrict__ scores, int s_stride,
                      float* __restrict__ out, int* __restrict__ kept_idx,
                      int N, int D, int k) {
  tdm<false>(z, scores, s_stride, Package{nullptr, nullptr, 0}, out, nullptr,
             kept_idx, N, D, k);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int mask = 16; mask > 0; mask /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, mask);
  return x;
}

__global__ void __launch_bounds__(kThreads)
token_drop_bwd_f32_kernel(const float* __restrict__ z,
                          const float* __restrict__ scores, int s_stride,
                          const int* __restrict__ kept_idx,
                          const float* __restrict__ y,
                          const float* __restrict__ dy,
                          float* __restrict__ dz,
                          float* __restrict__ dscores, int N, int D, int k) {
  __shared__ int slot[kMaxBody];  // a body row's kept slot, or -1
  __shared__ float wpart[kWarps];
  __shared__ float cpart;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, nb = N - 1, d4 = D / 4;
  const float* sb = scores + static_cast<size_t>(b) * s_stride + 1;
  const int* kb = kept_idx + static_cast<size_t>(b) * k;
  const size_t out_b = static_cast<size_t>(b) * (k + 2) * D;
  const float4* dyf = reinterpret_cast<const float4*>(
      dy + out_b + static_cast<size_t>(k + 1) * D);

  for (int j = tid; j < nb; j += kThreads) slot[j] = -1;
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) slot[kb[j]] = j;
  __syncthreads();

  // S: the forward's tree (tdm_tile.cuh, step 4)
  float m = 0.f;
  for (int j = tid; j < kMaxBody; j += kThreads)
    m += (j < nb && slot[j] < 0) ? sb[j] : 0.f;
  m = warp_sum(m);
  if (lane == 0) wpart[warp] = m;
  if (warp == 0) {  // c = <dy_f, y_f>
    const float4* yf = reinterpret_cast<const float4*>(
        y + out_b + static_cast<size_t>(k + 1) * D);
    float c = 0.f;
    for (int i = lane; i < d4; i += 32) c = dot4(dyf[i], yf[i], c);
    c = warp_sum(c);
    if (lane == 0) cpart = c;
  }
  __syncthreads();
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) wsum += wpart[i];
  const float denom = wsum + 1e-9f;
  const float c = cpart;

  const int r1 = min((blockIdx.x + 1) * kBwdRows, N);
  for (int n = blockIdx.x * kBwdRows + warp; n < r1; n += kWarps) {
    float4* dzr = reinterpret_cast<float4*>(
        dz + (static_cast<size_t>(b) * N + n) * D);
    const int src = n == 0 ? 0 : slot[n - 1] >= 0 ? 1 + slot[n - 1] : -1;
    float ds = 0.f;
    if (src >= 0) {  // CLS or a kept row: its dy row
      const float4* dyr = reinterpret_cast<const float4*>(
          dy + out_b + static_cast<size_t>(src) * D);
      for (int i = lane; i < d4; i += 32) dzr[i] = dyr[i];
    } else {  // a dropped row
      const float4* zr = reinterpret_cast<const float4*>(
          z + (static_cast<size_t>(b) * N + n) * D);
      const float wn = sb[n - 1] / denom;
      float g = 0.f;
      for (int i = lane; i < d4; i += 32) {
        const float4 a = dyf[i];
        g = dot4(a, zr[i], g);
        dzr[i] = make_float4(wn * a.x, wn * a.y, wn * a.z, wn * a.w);
      }
      ds = (warp_sum(g) - c) / denom;
    }
    if (lane == 0) dscores[static_cast<size_t>(b) * N + n] = ds;
  }
}

}  // namespace

// z [B, N, D] contiguous, 16-byte aligned; scores [B, N], rows s_stride
// apart (CLS at column 0); out [B, k + 2, D]; all fp32; kept_idx [B, k]
// int32 or null (then no indices: the serve). 1 <= k <= N - 1, 2 <= N <=
// kMaxBody + 1, D a multiple of 4.
extern "C" int token_drop_f32(const void* z, const void* scores, void* out,
                              void* kept_idx, int B, int N, int D, int k,
                              int s_stride, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(B, N, D, k, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  token_drop_f32_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(scores),
      s_stride, static_cast<float*>(out), static_cast<int*>(kept_idx), N, D,
      k);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of token_drop_f32: z, scores, k as there; kept_idx [B, k]
// int32 and y [B, k + 2, D] what its forward wrote; dy [B, k + 2, D] the
// output's gradient; dz [B, N, D] and dscores [B, N] (contiguous) the
// inputs' gradients, every element written. z, y, dy and dz 16-byte
// aligned.
extern "C" int token_drop_bwd_f32(const void* z, const void* scores,
                                  const void* kept_idx, const void* y,
                                  const void* dy, void* dz, void* dscores,
                                  int B, int N, int D, int k, int s_stride,
                                  void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(B, N, D, k, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  grid = dim3((N + kBwdRows - 1) / kBwdRows, B);
  token_drop_bwd_f32_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(scores),
      s_stride, static_cast<const int*>(kept_idx),
      static_cast<const float*>(y), static_cast<const float*>(dy),
      static_cast<float*>(dz), static_cast<float*>(dscores), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
