// Tensor-core fragments of 16-bit operands (fp16 or bf16) with fp32
// accumulation, shared by the attention kernels that run their products on
// mma.sync.m16n8k16: the causal prefill (flash_prefill.cu, bf16) and the
// ViT's non-causal kernel (flash_attention.cu, its fp16 tier). Fragments
// are loaded from shared memory by ldmatrix; the fp32 probabilities P enter
// a product as two 16-bit halves (split_hi_lo), so P.V is two MMAs into the
// same fp32 accumulator.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace mma16 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 matrices of 16-bit elements; lane l gives the address of row
// l % 8 of matrix l / 8
template <typename T>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const T* p) {
  static_assert(sizeof(T) == 2, "ldmatrix of 16-bit elements");
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each 8x8 matrix transposed
template <typename T>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const T* p) {
  static_assert(sizeof(T) == 2, "ldmatrix of 16-bit elements");
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, a 16x16 of T (row), b 16x8 of T (col), c 16x8 fp32
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<T, __half>::value, "fp16 or bf16 operands");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// (x0, x1) = hi + lo with hi = T(x) and lo = T(x - hi), each rounded to
// nearest, packed as the A operand wants: the lower column in the lower
// half. x is kept to ~2^-16 relative in bf16 and ~2^-22 in fp16 (where hi
// is subnormal, to half of fp16's smallest step, ~3e-8 absolute).
template <typename T>
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
  } else {
    static_assert(std::is_same<T, __half>::value, "fp16 or bf16 operands");
    __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
  }
}

}  // namespace mma16
