// SBMM — block-sparse y = x @ W on Hopper CUDA cores, fp32.
//
// Replaces the Pallas kernel `_sbmm_kernel` / `sbmm_pallas`
// (src/repro/kernels/sbmm/sbmm.py) of the reference package.
//
// W is stored in the packed format of core/packing.py: per stored block
// column j, `S` header slots name the surviving row blocks (-1 = padding)
// and `blocks[j, s]` holds the 16x16 block. One thread block computes one
// [TM, 16] output tile: it walks the S header slots of its block column,
// stages the [TM, 16] activation sub-tile at column header[j, s] * 16 and
// the [16, 16] weight block in shared memory, and accumulates in fp32
// registers. Padding slots (idx < 0) are skipped, so the work done is the
// work the kept blocks need.
//
// Bound on the H100: at the main path's shapes (M <= 788, K = 384, 24 block
// columns, about half the blocks kept) the call does ~1e8 fp32 operations
// on ~3 MB, so the fp32 CUDA-core rate bounds it, and at this size the
// launch and the short per-block loop dominate in practice. The design
// keeps every weight block read once per row tile and every activation
// element read once per kept block that needs it (from L2 after the first
// tile), with shared-memory reuse across the 64 rows of a tile (x) and the
// 16 columns of a block (W). Tensor cores are deliberately unused: the fp32
// tier must not round through TF32.
//
// Determinism: an output element is the fma chain over the slots in header
// order and, inside a slot, over the 16 block rows in order — the same code
// for every row whatever M or the number of row tiles is, so the batch a
// row rides in cannot change its bits.
#include <cuda_runtime.h>

namespace {

constexpr int kB = 16;         // block size (PruningConfig.block_size)
constexpr int kTM = 64;        // output rows per thread block
constexpr int kThreads = 256;  // 16 columns x 16 row groups
constexpr int kRowsPerThread = kTM / (kThreads / kB);

__global__ void __launch_bounds__(kThreads)
sbmm_kernel(const float* __restrict__ x, const float* __restrict__ blocks,
            const int* __restrict__ header, float* __restrict__ y,
            int M, int K, int C, int S) {
  __shared__ float xs[kTM][kB + 1];
  __shared__ float ws[kB][kB];
  const int j = blockIdx.y;             // stored block column
  const int row0 = blockIdx.x * kTM;
  const int n = threadIdx.x % kB;       // column inside the block
  const int r = threadIdx.x / kB;       // row group: rows r + 16 * i
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int s = 0; s < S; ++s) {
    const int idx = header[j * S + s];  // same for the whole block
    if (idx < 0) continue;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = row0 + r + kB * i;
      xs[r + kB * i][n] =
          m < M ? x[static_cast<size_t>(m) * K + idx * kB + n] : 0.f;
    }
    ws[r][n] = blocks[(static_cast<size_t>(j) * S + s) * kB * kB + r * kB + n];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float a = acc[i];
#pragma unroll
      for (int kk = 0; kk < kB; ++kk) a = fmaf(xs[r + kB * i][kk], ws[kk][n], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  const size_t ld = static_cast<size_t>(C) * kB;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = row0 + r + kB * i;
    if (m < M) y[m * ld + j * kB + n] = acc[i];
  }
}

}  // namespace

// x [M, K] fp32 (K a multiple of 16), blocks [C, S, 16, 16] fp32,
// header [C, S] int32, y [M, C * 16] fp32 in stored column order.
extern "C" int sbmm_f32(const void* x, const void* blocks, const void* header,
                        void* y, int M, int K, int C, int S, void* stream) {
  if (M <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (K % kB != 0 || C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + kTM - 1) / kTM, C);
  sbmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(blocks),
      static_cast<const int*>(header), static_cast<float*>(y), M, K, C, S);
  return static_cast<int>(cudaGetLastError());
}
