// SBMM — block-sparse y = x @ W on Hopper CUDA cores over fp32 or fp16
// blocks, fp32 arithmetic.
//
// Replaces the Pallas kernel `_sbmm_kernel` / `sbmm_pallas`
// (src/repro/kernels/sbmm/sbmm.py) of the reference package, which the fp32
// tier runs over fp32 blocks and the fp16 tier over fp16 blocks (there
// `jnp.dot` of fp32 x with an fp16 block promotes the block to fp32), and
// the column un-permute of its wrapper `ops.sbmm`: the kernel stores each
// stored block column at its logical place. The tile, its layout and its
// fma order are in sbmm_tile.cuh; the two entry points differ only in the
// loader, which widens an fp16 block to fp32 once per staged slot.
//
// Bound on the H100: at the main path's shapes (M <= 788, K = N = 384, 24
// block columns of which the heaviest keeps 16 of 24 row blocks) a call
// does ~1.2e8 fp32 operations on ~3 MB, 1.7 us at the CUDA-core rate.
// What holds a kernel above that is the walk's latency: the heaviest
// column's row tiles take their slots one after another, and a slot whose
// x sub-tile and block are fetched only when it is reached waits out an L2
// round trip. So the copies run kStages - 1 slots ahead (cp.async ring,
// one barrier per slot), and a thread's 4 x 2 register tile keeps the
// shared-memory reads per fma low. 32-row tiles (64 threads) make 600
// blocks at M = 788 and keep every heavy tile's walk short; 64-row tiles
// were slower at every M tried. What remains is issue and copy latency
// per slot under load, and x re-read from L2 by every column that keeps
// its row block (~15 MB per call at M = 788). Tensor cores stay unused:
// the fp32 tier must not round through TF32, and the fp16 tier multiplies
// in fp32 as the reference does.
#include "sbmm_tile.cuh"

using namespace sbmm_tile;

namespace {

__global__ void __launch_bounds__(kThreads)
sbmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ blocks,
                const float* __restrict__ scales,
                const int* __restrict__ header,
                const int* __restrict__ col_map, float* __restrict__ y, int M,
                int K, int S, int N) {
  tile<LoadF32>(x, blocks, scales, header, col_map, y, M, K, S, N);
}

__global__ void __launch_bounds__(kThreads)
sbmm_f16w_kernel(const float* __restrict__ x, const __half* __restrict__ blocks,
                 const float* __restrict__ scales,
                 const int* __restrict__ header,
                 const int* __restrict__ col_map, float* __restrict__ y, int M,
                 int K, int S, int N) {
  tile<LoadF16>(x, blocks, scales, header, col_map, y, M, K, S, N);
}

}  // namespace

// x [M, K] fp32 (K a multiple of 16, 16-byte aligned), blocks
// [C, S, 16, 16] fp32, header [C, S] int32 (-1 padding skipped),
// col_map [C] int32; y [M, N] fp32: stored block column j lands at
// columns col_map[j] * 16 .. + 15, those below N.
extern "C" int sbmm_f32(const void* x, const void* blocks, const void* header,
                        const void* col_map, void* y, int M, int K, int C,
                        int S, int N, void* stream) {
  return launch<float>(sbmm_f32_kernel, x, blocks, nullptr, header, col_map,
                       y, M, K, C, S, N, stream);
}

// As sbmm_f32, with blocks [C, S, 16, 16] fp16.
extern "C" int sbmm_f16w(const void* x, const void* blocks, const void* header,
                         const void* col_map, void* y, int M, int K, int C,
                         int S, int N, void* stream) {
  return launch<__half>(sbmm_f16w_kernel, x, blocks, nullptr, header, col_map,
                        y, M, K, C, S, N, stream);
}
