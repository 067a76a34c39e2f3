// Dequant-in-kernel SBMM — block-sparse y = x @ W over int8 blocks with
// fp32 scales, on Hopper CUDA cores, fp32 arithmetic.
//
// Replaces the Pallas kernel `_sbmm_quant_kernel` / `sbmm_quant_pallas`
// (src/repro/kernels/sbmm/quant.py) of the reference package, the int8
// tier's SBMM, and the column un-permute of its wrapper. The tile, its
// layout and its fma order are those of the fp32 SBMM (sbmm_tile.cuh);
// only the loader differs: the raw int8 block and its scales are staged
// by cp.async like any other slot, then dequantized once per thread block
// into an fp32 block in shared memory as float(q) * scale, with one scale
// per kept block (`sbmm_i8_block`, scales [C, S]) or one per output column
// of each kept block (`sbmm_i8_channel`, scales [C, S, 16]: column n of
// the block is scaled by scales[j, s, n]). That is bitwise the reference's
// `q.astype(f32) * scale`, so the tier's weights are exactly the
// reference's.
//
// Bound on the H100: as for the fp32 SBMM (sbmm.cu), ~1.2e8 fp32
// operations at the main path's shapes, held above that by the walk's
// latency, which the same ring answers. The int8 blocks are a quarter of
// the fp32 weight bytes; the dequantization is four elements per thread
// per slot, its shared-memory reads hidden behind the previous slot's
// multiply. Tensor cores are unused: the reference multiplies and
// accumulates in fp32.
#include "sbmm_tile.cuh"

using namespace sbmm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
sbmm_i8_block_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ blocks,
                     const float* __restrict__ scales,
                     const int* __restrict__ header,
                     const int* __restrict__ col_map, float* __restrict__ y,
                     int M, int K, int S, int N) {
  tile<LoadI8Block>(x, blocks, scales, header, col_map, y, M, K, S, N);
}

__global__ void __launch_bounds__(kThreads)
sbmm_i8_channel_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ blocks,
                       const float* __restrict__ scales,
                       const int* __restrict__ header,
                       const int* __restrict__ col_map, float* __restrict__ y,
                       int M, int K, int S, int N) {
  tile<LoadI8Channel>(x, blocks, scales, header, col_map, y, M, K, S, N);
}

}  // namespace

// x [M, K] fp32 (K a multiple of 16, 16-byte aligned), blocks
// [C, S, 16, 16] int8, scales [C, S] fp32, header [C, S] int32 (-1 padding
// skipped), col_map [C] int32; y [M, N] fp32 as sbmm_f32.
extern "C" int sbmm_i8_block(const void* x, const void* blocks,
                             const void* scales, const void* header,
                             const void* col_map, void* y, int M, int K,
                             int C, int S, int N, void* stream) {
  return launch<int8_t>(sbmm_i8_block_kernel, x, blocks, scales, header,
                        col_map, y, M, K, C, S, N, stream);
}

// As sbmm_i8_block, with scales [C, S, 16] fp32 (per output column).
extern "C" int sbmm_i8_channel(const void* x, const void* blocks,
                               const void* scales, const void* header,
                               const void* col_map, void* y, int M, int K,
                               int C, int S, int N, void* stream) {
  return launch<int8_t>(sbmm_i8_channel_kernel, x, blocks, scales, header,
                        col_map, y, M, K, C, S, N, stream);
}
