// Pieces shared by the two causal GQA attention kernels (flash_decode.cu,
// flash_prefill.cu): the per-row key window of a query row; their
// asynchronous copies and shared memory limit come from cp_async.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace causal {

using bf16 = __nv_bfloat16;

// Batch row b's bounds: query row i sees keys [lo, min(len, off + i + 1)).
// Null bounds default to q_offset 0, kv_len S and kv_start 0; kv_len past
// S acts as S.
struct Window {
  int off, len, lo;
  __device__ __forceinline__ Window(const int* q_offset, const int* kv_len,
                                    const int* kv_start, int b, int S)
      : off(q_offset != nullptr ? q_offset[b] : 0),
        len(min(kv_len != nullptr ? kv_len[b] : S, S)),
        lo(max(kv_start != nullptr ? kv_start[b] : 0, 0)) {}
  // the end of query row i's keys
  __device__ __forceinline__ int hi(int i) const { return min(len, off + i + 1); }
};

}  // namespace causal
