// Token package — the soft TDM on Hopper, fp32: stable top-k with the
// package pinned out, raw weights with the carried mass, gather, package
// row and new mass in one launch per call.
//
// Replaces the Pallas kernel `_token_package_kernel` /
// `token_package_pallas` (src/repro/kernels/token_package/token_package.py)
// together with the top-k and the weights its wrapper computes outside it;
// on the reference main path this stage is `token_pruning.tdm_soft`
// (core/packed_runner.py, `vit_tdm_soft_layer`). The package's body index
// is per row (the serving path pins each request's package at
// n_valid - 2), read in the caller's int32 or int64. The selection, the
// layout, the summation order and the bound are in tdm_tile.cuh, shared
// with token_drop.cu.
#include "tdm_tile.cuh"

using namespace tdm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
token_package_f32_kernel(const float* __restrict__ z,
                         const float* __restrict__ scores, int s_stride,
                         Package pkg, float* __restrict__ out,
                         float* __restrict__ new_mass, int N, int D, int k) {
  tdm<true>(z, scores, s_stride, pkg, out, new_mass, nullptr, N, D, k);
}

}  // namespace

// z [B, N, D] contiguous, 16-byte aligned; scores [B, N], rows s_stride
// apart (CLS at column 0); pkg_mass [B] or nullptr (no package yet);
// pkg_pos [B] int32, or int64 when pos64, or nullptr (the last body row);
// out [B, k + 2, D], new_mass [B]; fp32 but pkg_pos. 1 <= k <= N - 1
// (N - 2 with a package), 2 <= N <= kMaxBody + 1, D a multiple of 4.
extern "C" int token_package_f32(const void* z, const void* scores,
                                 const void* pkg_mass, const void* pkg_pos,
                                 void* out, void* new_mass, int B, int N,
                                 int D, int k, int s_stride, int pos64,
                                 void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(B, N, D, k, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  token_package_f32_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(scores),
      s_stride,
      Package{static_cast<const float*>(pkg_mass), pkg_pos, pos64},
      static_cast<float*>(out), static_cast<float*>(new_mass), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
