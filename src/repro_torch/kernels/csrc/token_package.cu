// Token package — the soft TDM's gather and package update on Hopper,
// fp32.
//
// Replaces the Pallas kernel `_token_package_kernel` /
// `token_package_pallas` (src/repro/kernels/token_package/token_package.py);
// on the reference main path this stage is `token_pruning.tdm_soft`
// (core/packed_runner.py, `vit_tdm_soft_layer`).
//
// The weights w are RAW: the dropped rows' scores, the carried package mass
// at the package row (the wrapper pins the package out of the top-k), 0 at
// kept rows and at padded rows. The package row is normalised here, as the
// Pallas kernel does, and new_mass [B] = sum_n w[n] is the mass the next
// soft TDM carries. The gather, its layout and its summation order are in
// tdm_tile.cuh, shared with token_drop.cu.
#include "tdm_tile.cuh"

using namespace tdm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
token_package_f32_kernel(const float* __restrict__ z,
                         const int* __restrict__ keep_idx,
                         const float* __restrict__ w, float* __restrict__ out,
                         float* __restrict__ new_mass, int N, int D, int k) {
  gather<true>(z, keep_idx, w, out, new_mass, N, D, k);
}

}  // namespace

// z [B, N, D], keep_idx [B, k] int32 in [0, N - 1), w [B, N - 1],
// out [B, k + 2, D], new_mass [B]; all fp32 except keep_idx, all
// contiguous.
extern "C" int token_package_f32(const void* z, const void* keep_idx,
                                 const void* w, void* out, void* new_mass,
                                 int B, int N, int D, int k, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(B, N, D, k, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  token_package_f32_kernel<<<grid, dim3(kTD, kGroups), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(keep_idx),
      static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float*>(new_mass), N, D, k);
  return static_cast<int>(cudaGetLastError());
}
