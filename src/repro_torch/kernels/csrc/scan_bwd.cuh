// The pieces the scans' backward kernels (mamba_scan_bwd.cu, wkv6_bwd.cu)
// share in their sequential form (below kBwdChunkMin steps; the chunked
// form's are in scan_bwd_chunk.cuh): the 4 x 4 tile each thread owns of a
// 64 x 64 fp32 state, that tile's copies to and from memory in the thread's
// own layout, and the checkpoint scratch of a persistent block.
//
// Both kernels walk a recurrence backward without dividing by a decay (a
// decay can underflow to exactly 0, as the forward kernels note), so the state
// before each step is recomputed forward from a stored copy: the forward
// pass keeps the state every kCk steps in the block's scratch, and the
// reverse walk recomputes one checkpoint interval at a time, keeping the
// state at every kW-th step there too, then each window of kW steps in
// shared memory. A block is persistent: it takes the (head, batch row) items
// blockIdx.x, blockIdx.x + gridDim.x, ..., so the scratch is one slot a
// block (the wrapper allocates `slots` of them), a few hundred KB that stay
// close to L2 while the block reads them back.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan_bwd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMax = 64;                  // widths padded to 64
constexpr int kVals = 16;                 // state values a thread (4 x 4)
constexpr int kState = kVals * kThreads;  // 4096 floats, one 64 x 64 state
constexpr int kCk = 32;                   // steps between checkpoints
constexpr int kW = 4;                     // steps a window of the walk back
constexpr int kSnaps = kCk / kW;          // window starts of an interval

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The thread's tile: rows 4 rt .. 4 rt + 3, columns 4 ct .. 4 ct + 3. A warp
// holds two row tiles (8 rows) across all 64 columns, so a sum over a row
// is a thread's 4 values and then 4 shuffles among 16 lanes, a sum over a
// column a thread's 4 values and one shuffle, then one value a warp.
struct Tile {
  int rt, ct, lane, warp;
  __device__ Tile() {
    lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    rt = 2 * warp + lane / 16;
    ct = lane % 16;
  }
};

// value v = 4 i + k of every thread's tile, thread-major: a warp's 32 lanes
// touch 32 consecutive floats (coalesced in memory, no bank conflict in
// shared memory), and a thread only ever reads back what it wrote
__device__ __forceinline__ int own(int v) {
  return v * kThreads + threadIdx.x;
}

__device__ __forceinline__ void store_own(float* dst,
                                          const float (&st)[kVals]) {
#pragma unroll
  for (int v = 0; v < kVals; ++v) dst[own(v)] = st[v];
}

__device__ __forceinline__ void load_own(float (&st)[kVals],
                                         const float* src) {
#pragma unroll
  for (int v = 0; v < kVals; ++v) st[v] = src[own(v)];
}

// A [rows, cols] row-major state (rows < nr and cols < nc real, the rest 0)
// into the tile, or the tile into it.
__device__ __forceinline__ void load_state(float (&st)[kVals],
                                           const float* src, const Tile& tl,
                                           int nr, int nc) {
#pragma unroll
  for (int v = 0; v < kVals; ++v) {
    const int r = 4 * tl.rt + v / 4, c = 4 * tl.ct + v % 4;
    st[v] = (r < nr && c < nc) ? src[(size_t)r * nc + c] : 0.f;
  }
}

__device__ __forceinline__ void store_state(float* dst,
                                            const float (&st)[kVals],
                                            const Tile& tl, int nr, int nc) {
#pragma unroll
  for (int v = 0; v < kVals; ++v) {
    const int r = 4 * tl.rt + v / 4, c = 4 * tl.ct + v % 4;
    if (r < nr && c < nc) dst[(size_t)r * nc + c] = st[v];
  }
}

__device__ __forceinline__ void read4(float (&out)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

// sum over the 16 lanes of a half warp (one row tile's column tiles)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int m = 1; m < 16; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int m = 1; m < 32; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Scratch floats of one slot: a checkpoint every kCk steps and the window
// starts of one interval.
__host__ __device__ inline size_t slot_floats(int S) {
  return (size_t)((S + kCk - 1) / kCk + kSnaps) * kState;
}

}  // namespace scan_bwd
