// The SBMM tile shared by sbmm.cu (fp32 and fp16 blocks) and
// sbmm_quant.cu (int8 blocks with scales): block-sparse y = x @ W on
// Hopper CUDA cores, fp32 arithmetic, the output written in logical column
// order.
//
// W is stored in the packed format of core/packing.py: per stored block
// column j, the header's non-negative slots name the surviving row blocks
// (-1 is padding, which pack_weight puts last; a pad slot anywhere is
// skipped) and `blocks[j, s]` holds the 16x16 block. One thread block
// computes one [kTM, 16] output tile: it lists the live slots of its
// block column from the header row, in header order, then walks them and,
// per slot, multiplies the [kTM, 16] activation sub-tile at column
// header[j, s] * 16 by the block.
// Stored block column j is written to output block column col_map[j];
// output columns at or past N are not written (the padded last column).
//
// The walk (what bounds it is noted in sbmm.cu): each slot's raw x
// sub-tile, raw weight block and scales are staged by 16-byte cp.async
// into a ring of kStages stages, kStages - 1 slots ahead of the multiply,
// with one barrier per slot. A converting loader (fp16, int8) turns the
// raw block of slot s + 1 into an fp32 block in shared memory while slot
// s is multiplied, once per thread block and element: converting at each
// register read would repeat it for every row group. Each thread owns a
// kR x kCN register tile (rows rg + kRowGroups * i, columns cg * kCN + q);
// per four block rows it reads one float4 of x per row, which the eight
// threads of a quarter warp share, and one float2 of W per block row.
//
// Determinism: an output element is the fma chain over the live slots in
// header order and, inside a slot, over the 16 block rows in order — the
// same code for every row whatever M, the row tile or the row's place in
// it is, so the batch a row rides in cannot change its bits.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace sbmm_tile {

constexpr int kB = 16;                              // block size
constexpr int kTM = 32;                             // output rows per block
constexpr int kR = 4;                               // rows per thread
constexpr int kCN = 2;                              // columns per thread
constexpr int kColGroups = kB / kCN;                // 8
constexpr int kRowGroups = kTM / kR;                // 8
constexpr int kThreads = kColGroups * kRowGroups;   // 64
constexpr int kStages = 6;                          // ring depth
static_assert(kCN == 2, "W is read as float2");
// x rows in shared memory: 16 floats padded to 20 (16-byte copies stay
// aligned; the four rows a warp's float4 reads touch use distinct banks)
constexpr int kXLd = kB + 4;
constexpr int kMaxSlots = 2048;  // live-slot list in dynamic shared memory
static_assert(kThreads % 32 == 0, "whole warps list the live slots");

// Loaders of one stored weight block. `T` is the stored element,
// `kScales` the fp32 scales staged per slot (0, 1 per block, 16 per
// column) and `at` the fp32 value of element e = r * 16 + n.
struct LoadF32 {
  using T = float;
  static constexpr int kScales = 0;
  static __device__ __forceinline__ float at(const T* w, const float*, int e) {
    return w[e];
  }
};

struct LoadF16 {  // widened exactly
  using T = __half;
  static constexpr int kScales = 0;
  static __device__ __forceinline__ float at(const T* w, const float*, int e) {
    return __half2float(w[e]);
  }
};

struct LoadI8Block {  // scales [C, S]: float(q) * scale, one rounding
  using T = int8_t;
  static constexpr int kScales = 1;
  static __device__ __forceinline__ float at(const T* w, const float* sc,
                                             int e) {
    return static_cast<float>(w[e]) * sc[0];
  }
};

struct LoadI8Channel {  // scales [C, S, 16]: column n scaled by sc[n]
  using T = int8_t;
  static constexpr int kScales = kB;
  static __device__ __forceinline__ float at(const T* w, const float* sc,
                                             int e) {
    return static_cast<float>(w[e]) * sc[e % kB];
  }
};

template <class Load>
constexpr bool kConverts = !std::is_same<typename Load::T, float>::value;

// acc[i][q] += x[rg + kRowGroups * i, k] * w[k, cg * kCN + q], k = 0..15
__device__ __forceinline__ void mac(const float* xt, const float* wt,
                                    float (&acc)[kR][kCN], int rg, int cg) {
#pragma unroll
  for (int k4 = 0; k4 < kB / 4; ++k4) {
    float4 xv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      xv[i] = *reinterpret_cast<const float4*>(
          xt + (rg + kRowGroups * i) * kXLd + 4 * k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 v = *reinterpret_cast<const float2*>(
          wt + (4 * k4 + kk) * kB + cg * kCN);
      const float wv[kCN] = {v.x, v.y};
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float xk = kk == 0 ? xv[i].x
                         : kk == 1 ? xv[i].y
                         : kk == 2 ? xv[i].z
                                   : xv[i].w;
#pragma unroll
        for (int q = 0; q < kCN; ++q) acc[i][q] = fmaf(xk, wv[q], acc[i][q]);
      }
    }
  }
}

template <class Load>
__device__ __forceinline__ void tile(
    const float* __restrict__ x, const typename Load::T* __restrict__ blocks,
    const float* __restrict__ scales, const int* __restrict__ header,
    const int* __restrict__ col_map, float* __restrict__ y, int M, int K,
    int S, int N) {
  using T = typename Load::T;
  constexpr bool kConvert = kConverts<Load>;
  constexpr int kWChunks = kB * kB * sizeof(T) / 16;  // 16-byte copies
  __shared__ __align__(16) float xs[kStages][kTM * kXLd];
  __shared__ __align__(16) T ws[kStages][kB * kB];
  __shared__ __align__(16) float ss[kStages][Load::kScales ? Load::kScales : 1];
  __shared__ __align__(16) float wf[kConvert ? 2 : 1][kConvert ? kB * kB : 1];
  // the live slots of header row j in header order: live[t] is the row
  // block of the t-th, live[S + t] its slot
  extern __shared__ int live[];
  __shared__ int warp_live[kThreads / 32];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = blockIdx.y;
  const int row0 = blockIdx.x * kTM;
  const int out_col = col_map[j] * kB;
  // each thread takes one slot of every kThreads; a slot's rank is the
  // live slots before it (earlier passes, lower lanes, lower warps)
  int n_live = 0;
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    const int s = s0 + tid;
    const int h = s < S ? header[static_cast<size_t>(j) * S + s] : -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, h >= 0);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int rank = n_live + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) rank += warp_live[w];
      n_live += warp_live[w];
    }
    if (h >= 0) {
      live[rank] = h;
      live[S + rank] = s;
    }
    __syncthreads();  // the list is whole; warp_live may be rewritten
  }

  // stage live slot s: x rows row0 .. row0 + kTM - 1 at column live[s] * 16
  // (rows past M zero-filled), the raw block and its scales. Each thread
  // copies the same 16-byte pieces of every slot's x sub-tile, so their
  // row offsets are fixed once (rows past M read row M - 1, and nothing).
  constexpr int kXCopies = kTM * 4 / kThreads;
  static_assert(kTM * 4 % kThreads == 0, "x pieces per thread");
  const float* xsrc[kXCopies];
  int xdst[kXCopies];
  bool xok[kXCopies];
#pragma unroll
  for (int i = 0; i < kXCopies; ++i) {
    const int c = tid + i * kThreads, r = c >> 2, part = c & 3;
    xok[i] = row0 + r < M;
    xsrc[i] = x + static_cast<size_t>(min(row0 + r, M - 1)) * K + part * 4;
    xdst[i] = r * kXLd + part * 4;
  }
  auto issue = [&](int s) {
    const int st = s % kStages;
    const int col = live[s] * kB;
#pragma unroll
    for (int i = 0; i < kXCopies; ++i)
      cp_async16(&xs[st][xdst[i]], xsrc[i] + col, xok[i]);
    const size_t blk = static_cast<size_t>(j) * S + live[S + s];
#pragma unroll
    for (int i = 0; i < (kWChunks + kThreads - 1) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      if (c < kWChunks)
        cp_async16(&ws[st][c * (16 / sizeof(T))],
                   blocks + blk * kB * kB + c * (16 / sizeof(T)), true);
    }
    if constexpr (Load::kScales == 1) {
      if (tid == 0) cp_async4(&ss[st][0], scales + blk);
    } else if constexpr (Load::kScales == kB) {
      if (tid < kB / 4)
        cp_async16(&ss[st][tid * 4], scales + blk * kB + tid * 4, true);
    }
  };
  // a converting loader turns slot s's raw block into wf[s & 1], this
  // thread's kConv elements: read (`fetch`) before the multiply of slot
  // s - 1 and written (`put`) after it, so the multiply hides the reads.
  // Past the last slot it converts a stale stage that nothing reads.
  constexpr int kConv = kB * kB / kThreads;
  static_assert(kB * kB % kThreads == 0, "weights per thread");
  auto fetch = [&](int s, float (&cv)[kConv]) {
    const int st = s % kStages;
#pragma unroll
    for (int i = 0; i < kConv; ++i)
      cv[i] = Load::at(ws[st], ss[st], tid + i * kThreads);
  };
  auto put = [&](int s, const float (&cv)[kConv]) {
#pragma unroll
    for (int i = 0; i < kConv; ++i) wf[s & 1][tid + i * kThreads] = cv[i];
  };

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_live) issue(p);
    cp_async_commit();
  }
  float cv[kConv];
  if constexpr (kConvert) {
    cp_async_wait<kStages - 2>();  // slot 0 has landed
    __syncthreads();
    fetch(0, cv);
    put(0, cv);
  }

  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  float acc[kR][kCN];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int q = 0; q < kCN; ++q) acc[i][q] = 0.f;

  for (int s = 0; s < n_live; ++s) {
    // slot s (and, to convert, slot s + 1) has landed; after the barrier
    // every thread sees it and is done with slot s - 1, whose stage the
    // next copies reuse
    cp_async_wait<kConvert ? kStages - 3 : kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < n_live) issue(s + kStages - 1);
    cp_async_commit();
    if constexpr (kConvert) {
      fetch(s + 1, cv);
      mac(xs[s % kStages], wf[s & 1], acc, rg, cg);
      put(s + 1, cv);
    } else {
      mac(xs[s % kStages], reinterpret_cast<const float*>(ws[s % kStages]),
          acc, rg, cg);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int m = row0 + rg + kRowGroups * i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < kCN; ++q) {
      const int col = out_col + cg * kCN + q;
      if (col < N) y[static_cast<size_t>(m) * N + col] = acc[i][q];
    }
  }
}

template <class T>
using Kernel = void (*)(const float*, const T*, const float*, const int*,
                        const int*, float*, int, int, int, int);

// Launch `kernel` over x [M, K] and C stored block columns of S slots on
// `stream`; the cudaError_t of the launch (cudaSuccess when M, C or N is 0).
template <class T>
inline int launch(Kernel<T> kernel, const void* x, const void* blocks,
                  const void* scales, const void* header,
                  const void* col_map, void* y, int M, int K, int C, int S,
                  int N, void* stream) {
  if (M <= 0 || C <= 0 || N <= 0) return 0;
  if (K % kB != 0 || C > 65535 || S < 1 || S > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kTM - 1) / kTM, C);
  kernel<<<grid, kThreads, 2 * S * sizeof(int),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const T*>(blocks),
      static_cast<const float*>(scales), static_cast<const int*>(header),
      static_cast<const int*>(col_map), static_cast<float*>(y), M, K, S, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sbmm_tile
