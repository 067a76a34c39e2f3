// SBMM — block-sparse y = x @ W on Hopper CUDA cores over fp32 or fp16
// blocks, fp32 arithmetic.
//
// Replaces the Pallas kernel `_sbmm_kernel` / `sbmm_pallas`
// (src/repro/kernels/sbmm/sbmm.py) of the reference package, which the fp32
// tier runs over fp32 blocks and the fp16 tier over fp16 blocks (there
// `jnp.dot` of fp32 x with an fp16 block promotes the block to fp32). The
// tile, its layout and its fma order are in sbmm_tile.cuh; the two entry
// points differ only in the loader, which converts an fp16 block to fp32
// as it stages it in shared memory.
//
// Bound on the H100: at the main path's shapes (M <= 788, K = 384, 24 block
// columns, about half the blocks kept) the call does ~1e8 fp32 operations
// on ~3 MB, so the fp32 CUDA-core rate bounds it, and at this size the
// launch and the short per-block loop dominate in practice. The design
// keeps every weight block read once per row tile and every activation
// element read once per kept block that needs it (from L2 after the first
// tile), with shared-memory reuse across the 64 rows of a tile (x) and the
// 16 columns of a block (W). fp16 blocks halve the weight bytes, a small
// share of the call's. Tensor cores are deliberately unused: the fp32
// tier must not round through TF32, and the fp16 tier multiplies in fp32
// as the reference does.
#include "sbmm_tile.cuh"

using namespace sbmm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
sbmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ blocks,
                const int* __restrict__ header, float* __restrict__ y, int M,
                int K, int C, int S) {
  tile<LoadF32>(x, blocks, nullptr, header, y, M, K, C, S);
}

__global__ void __launch_bounds__(kThreads)
sbmm_f16w_kernel(const float* __restrict__ x, const __half* __restrict__ blocks,
                 const int* __restrict__ header, float* __restrict__ y, int M,
                 int K, int C, int S) {
  tile<LoadF16>(x, blocks, nullptr, header, y, M, K, C, S);
}

}  // namespace

// x [M, K] fp32 (K a multiple of 16), blocks [C, S, 16, 16] fp32,
// header [C, S] int32, y [M, C * 16] fp32 in stored column order.
extern "C" int sbmm_f32(const void* x, const void* blocks, const void* header,
                        void* y, int M, int K, int C, int S, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(M, K, C, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  sbmm_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(blocks),
      static_cast<const int*>(header), static_cast<float*>(y), M, K, C, S);
  return static_cast<int>(cudaGetLastError());
}

// As sbmm_f32, with blocks [C, S, 16, 16] fp16.
extern "C" int sbmm_f16w(const void* x, const void* blocks, const void* header,
                         void* y, int M, int K, int C, int S, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(M, K, C, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  sbmm_f16w_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __half*>(blocks),
      static_cast<const int*>(header), static_cast<float*>(y), M, K, C, S);
  return static_cast<int>(cudaGetLastError());
}
