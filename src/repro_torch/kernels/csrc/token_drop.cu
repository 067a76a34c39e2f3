// Token drop — the hard TDM's gather and fuse on Hopper, fp32.
//
// Replaces the Pallas kernel `_token_drop_kernel` / `token_drop_pallas`
// (src/repro/kernels/token_drop/token_drop.py); on the reference main path
// this stage is `token_pruning.tdm` (core/packed_runner.py).
//
// The weights w are the normalized drop weights (0 at kept rows and at
// padded rows), so the fused row is sum_n w[n] * z[1 + n] as it stands. The
// gather, its layout and its summation order are in tdm_tile.cuh, shared
// with token_package.cu.
#include "tdm_tile.cuh"

using namespace tdm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
token_drop_f32_kernel(const float* __restrict__ z,
                      const int* __restrict__ keep_idx,
                      const float* __restrict__ w, float* __restrict__ out,
                      int N, int D, int k) {
  gather<false>(z, keep_idx, w, out, nullptr, N, D, k);
}

}  // namespace

// z [B, N, D], keep_idx [B, k] int32 in [0, N - 1), w [B, N - 1],
// out [B, k + 2, D]; all fp32 except keep_idx, all contiguous.
extern "C" int token_drop_f32(const void* z, const void* keep_idx,
                              const void* w, void* out, int B, int N, int D,
                              int k, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(B, N, D, k, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  token_drop_f32_kernel<<<grid, dim3(kTD, kGroups), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(keep_idx),
      static_cast<const float*>(w), static_cast<float*>(out), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
