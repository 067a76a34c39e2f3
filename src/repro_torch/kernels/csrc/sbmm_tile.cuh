// The SBMM tile shared by sbmm.cu (fp32 and fp16 blocks) and
// sbmm_quant.cu (int8 blocks with scales): block-sparse y = x @ W on
// Hopper CUDA cores, fp32 arithmetic.
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
// The block type is a template parameter, the loader: it reads one weight
// element of block `blk` (= j * S + s) and returns it as fp32 — a plain
// read, an fp16 -> fp32 conversion, or float(q) * scale for int8. The
// staged block is fp32 either way, so the fma chain below is the same for
// every tier.
//
// Determinism: an output element is the fma chain over the slots in header
// order and, inside a slot, over the 16 block rows in order — the same code
// for every row whatever M or the number of row tiles is, so the batch a
// row rides in cannot change its bits.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace sbmm_tile {

constexpr int kB = 16;         // block size (PruningConfig.block_size)
constexpr int kTM = 64;        // output rows per thread block
constexpr int kThreads = 256;  // 16 columns x 16 row groups
constexpr int kRowsPerThread = kTM / (kThreads / kB);

// Loaders: element e = r * 16 + n of block blk, as fp32 (n is the block's
// output column).
struct LoadF32 {
  using T = float;
  static __device__ __forceinline__ float at(const float* blocks,
                                             const float*, size_t blk, int e,
                                             int) {
    return blocks[blk * kB * kB + e];
  }
};

struct LoadF16 {
  using T = __half;
  static __device__ __forceinline__ float at(const __half* blocks,
                                             const float*, size_t blk, int e,
                                             int) {
    return __half2float(blocks[blk * kB * kB + e]);
  }
};

struct LoadI8Block {  // scales [C, S]: one per kept block
  using T = int8_t;
  static __device__ __forceinline__ float at(const int8_t* blocks,
                                             const float* scales, size_t blk,
                                             int e, int) {
    return static_cast<float>(blocks[blk * kB * kB + e]) * scales[blk];
  }
};

struct LoadI8Channel {  // scales [C, S, 16]: one per output column
  using T = int8_t;
  static __device__ __forceinline__ float at(const int8_t* blocks,
                                             const float* scales, size_t blk,
                                             int e, int n) {
    return static_cast<float>(blocks[blk * kB * kB + e]) *
           scales[blk * kB + n];
  }
};

template <class Load>
__device__ __forceinline__ void tile(const float* __restrict__ x,
                                     const typename Load::T* __restrict__ blocks,
                                     const float* __restrict__ scales,
                                     const int* __restrict__ header,
                                     float* __restrict__ y, int M, int K,
                                     int C, int S) {
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
    ws[r][n] = Load::at(blocks, scales, static_cast<size_t>(j) * S + s,
                        r * kB + n, n);
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

// Grid of a call, or an error: cudaSuccess with *empty set when there is
// nothing to compute.
inline cudaError_t grid_for(int M, int K, int C, dim3* grid, bool* empty) {
  *empty = M <= 0 || C <= 0;
  if (*empty) return cudaSuccess;
  if (K % kB != 0 || C > 65535) return cudaErrorInvalidValue;
  *grid = dim3((M + kTM - 1) / kTM, C);
  return cudaSuccess;
}

}  // namespace sbmm_tile
