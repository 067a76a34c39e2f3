// Token drop — the hard TDM on Hopper, fp32: stable top-k, normalised drop
// weights, gather and fused row in one launch per call.
//
// Replaces the Pallas kernel `_token_drop_kernel` / `token_drop_pallas`
// (src/repro/kernels/token_drop/token_drop.py) together with the top-k and
// the weights its wrapper computes outside it; on the reference main path
// this stage is `token_pruning.tdm` (core/packed_runner.py). As the FPGA's
// TDHM does, the kernel selects the kept rows itself. The selection, the
// layout, the summation order and the bound are in tdm_tile.cuh, shared
// with token_package.cu.
#include "tdm_tile.cuh"

using namespace tdm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
token_drop_f32_kernel(const float* __restrict__ z,
                      const float* __restrict__ scores, int s_stride,
                      float* __restrict__ out, int N, int D, int k) {
  tdm<false>(z, scores, s_stride, Package{nullptr, nullptr, 0}, out, nullptr,
             N, D, k);
}

}  // namespace

// z [B, N, D] contiguous, 16-byte aligned; scores [B, N], rows s_stride
// apart (CLS at column 0); out [B, k + 2, D]; all fp32. 1 <= k <= N - 1,
// 2 <= N <= kMaxBody + 1, D a multiple of 4.
extern "C" int token_drop_f32(const void* z, const void* scores, void* out,
                              int B, int N, int D, int k, int s_stride,
                              void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(B, N, D, k, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  token_drop_f32_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(scores),
      s_stride, static_cast<float*>(out), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
