// Products of fp32 tiles on the TF32 tensor cores at fp32 accuracy, shared
// by the chunked forms of the recurrent scans (mamba_scan.cu, wkv6.cu) and
// of their gradients (mamba_scan_bwd.cu, wkv6_bwd.cu, scan_bwd_chunk.cuh).
//
// 3xTF32: each fp32 operand a is split as a = hi + lo, hi rounded to TF32
// and lo = a - hi as the tensor core reads it, and a b is taken as lo_a
// hi_b + hi_a lo_b + hi_a hi_b (the small terms first), summed in fp32 by
// mma.sync m16n8k8. The dropped lo lo term and lo's truncation leave about
// 2^-21 of each product, against 2^-11 for one TF32 product: the fp32 tier
// never runs single-pass TF32.
//
// Fragments of mma.sync.m16n8k8 (tf32), lane = 4 g + q:
//   A (16 x 8, row-major): (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
//   B (8 x 8, k by column): (q, g), (q + 4, g)
//   C (16 x 8):             (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)
// Loaders take the element as a callable of (row, column), so a caller
// folds a decay factor into an operand as it reads it.
#pragma once

#include <cstdint>

#include "cp_async.cuh"

namespace scan_mma {

// Start copying rows [0, rows) of row_bytes bytes each from global memory
// (row r at src + r * src_stride bytes) into shared memory (row r at dst +
// r * dst_stride), spread over the block's threads: 16 bytes a cp.async
// where every address and length allows it, else 4 bytes, else 2 bytes
// through registers (an odd width of 16-bit values). The caller commits.
__device__ __forceinline__ void copy_rows(void* dst, int dst_stride,
                                          const void* src, size_t src_stride,
                                          int rows, int row_bytes) {
  const size_t align = reinterpret_cast<uintptr_t>(src) | src_stride |
                       static_cast<size_t>(row_bytes) |
                       static_cast<size_t>(dst_stride);
  const int shift = align % 16 == 0 ? 4 : align % 4 == 0 ? 2 : 1;
  const int per_row = row_bytes >> shift;
  // a warp takes 32 / per_row rows at a time (one row if longer): two
  // divisions a call, none an element
  const int lanes = per_row < 32 ? per_row : 32;
  const int sub = (threadIdx.x % 32) / lanes, col0 = (threadIdx.x % 32) % lanes;
  const int rows_at_once = 32 / lanes, warps = blockDim.x / 32;
  if (sub >= rows_at_once) return;
  auto* d0 = static_cast<unsigned char*>(dst);
  const auto* s0 = static_cast<const unsigned char*>(src);
  for (int r = threadIdx.x / 32 * rows_at_once + sub; r < rows;
       r += warps * rows_at_once)
    for (int c = col0; c < per_row; c += lanes) {
      unsigned char* d = d0 + r * dst_stride + (c << shift);
      const unsigned char* s = s0 + r * src_stride + (c << shift);
      if (shift == 4)
        cp_async16(d, s, true);
      else if (shift == 2)
        cp_async4(d, s);
      else
        *reinterpret_cast<uint16_t*>(d) =
            *reinterpret_cast<const uint16_t*>(s);
    }
}

// x rounded to TF32 (half an ulp of TF32 added to the magnitude's bits,
// the 13 low bits cleared: round half away from zero); x finite. Two
// integer operations: cvt.rna.tf32.f32 is emulated on sm_90 in about four,
// with checks for infinities the scans' values never reach.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int K>
struct Split {
  uint32_t hi[K], lo[K];
  // lo = x - hi is exact, and the tensor core reads its 19 high bits (it
  // truncates: |lo| < 2^-11 |x|, so that costs under 2^-21 of x)
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = tf32_hi(x);
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// the A fragment of rows r0..r0+15, columns k0..k0+7 of f(row, col)
template <class F>
__device__ __forceinline__ Split<4> frag_a(const F& f, int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  Split<4> s;
  s.set(0, f(r0 + g, k0 + q));
  s.set(1, f(r0 + g + 8, k0 + q));
  s.set(2, f(r0 + g, k0 + q + 4));
  s.set(3, f(r0 + g + 8, k0 + q + 4));
  return s;
}

// the B fragment of rows (the summed index) k0..k0+7, columns c0..c0+7
template <class F>
__device__ __forceinline__ Split<2> frag_b(const F& f, int k0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  Split<2> s;
  s.set(0, f(k0 + q, c0 + g));
  s.set(1, f(k0 + q + 4, c0 + g));
  return s;
}

// row and column of accumulator element e (0..3) of a 16 x 8 tile at
// (r0, c0)
__device__ __forceinline__ int acc_row(int r0, int e) {
  return r0 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int c0, int e) {
  return c0 + 2 * (threadIdx.x & 3) + (e & 1);
}

}  // namespace scan_mma
