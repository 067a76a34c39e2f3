// Dequant-in-kernel SBMM — block-sparse y = x @ W over int8 blocks with
// fp32 scales, on Hopper CUDA cores, fp32 arithmetic.
//
// Replaces the Pallas kernel `_sbmm_quant_kernel` / `sbmm_quant_pallas`
// (src/repro/kernels/sbmm/quant.py) of the reference package, the int8
// tier's SBMM. The tile, its layout and its fma order are those of the
// fp32 SBMM (sbmm_tile.cuh); only the loader differs: each int8 element
// is staged in shared memory as float(q) * scale, with one scale per kept
// block (`sbmm_i8_block`, scales [C, S]) or one per output column of each
// kept block (`sbmm_i8_channel`, scales [C, S, 16]: column n of the block
// is scaled by scales[j, s, n]). The dequantized block is bitwise the
// reference's `q.astype(f32) * scale`, so the tier's weights are exactly
// the reference's.
//
// Bound on the H100: as for the fp32 SBMM, the fp32 CUDA-core rate at the
// main path's shapes (~1e8 operations on ~2.5 MB: int8 blocks are a
// quarter of the fp32 weight bytes, x and y unchanged). The scale read is
// one fp32 per block (or per column) and comes from L1. Tensor cores are
// unused: the reference multiplies and accumulates in fp32.
#include "sbmm_tile.cuh"

using namespace sbmm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
sbmm_i8_block_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ blocks,
                     const float* __restrict__ scales,
                     const int* __restrict__ header, float* __restrict__ y,
                     int M, int K, int C, int S) {
  tile<LoadI8Block>(x, blocks, scales, header, y, M, K, C, S);
}

__global__ void __launch_bounds__(kThreads)
sbmm_i8_channel_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ blocks,
                       const float* __restrict__ scales,
                       const int* __restrict__ header, float* __restrict__ y,
                       int M, int K, int C, int S) {
  tile<LoadI8Channel>(x, blocks, scales, header, y, M, K, C, S);
}

}  // namespace

// x [M, K] fp32 (K a multiple of 16), blocks [C, S, 16, 16] int8,
// scales [C, S] fp32, header [C, S] int32, y [M, C * 16] fp32 in stored
// column order.
extern "C" int sbmm_i8_block(const void* x, const void* blocks,
                             const void* scales, const void* header, void* y,
                             int M, int K, int C, int S, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(M, K, C, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  sbmm_i8_block_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(blocks),
      static_cast<const float*>(scales), static_cast<const int*>(header),
      static_cast<float*>(y), M, K, C, S);
  return static_cast<int>(cudaGetLastError());
}

// As sbmm_i8_block, with scales [C, S, 16] fp32 (per output column).
extern "C" int sbmm_i8_channel(const void* x, const void* blocks,
                               const void* scales, const void* header, void* y,
                               int M, int K, int C, int S, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = grid_for(M, K, C, &grid, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  sbmm_i8_channel_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(blocks),
      static_cast<const float*>(scales), static_cast<const int*>(header),
      static_cast<float*>(y), M, K, C, S);
  return static_cast<int>(cudaGetLastError());
}
