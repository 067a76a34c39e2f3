// Hopper pieces shared by the attention kernels that run their products on
// the warpgroup tensor cores (wgmma) over tiles staged by the Tensor Memory
// Accelerator (TMA) under mbarriers: the causal backward
// (flash_prefill_bwd.cu) and the non-causal prefill (flash_prefill.cu).
//
// A tile is 64 rows (positions or keys) of one head, Dh bf16 each, as TMA
// writes it: rows of at most 128 bytes, so a head of 128 lies in two halves
// of 64 columns, one box each, the second 64 rows x 128 bytes after the
// first; the 128-byte swizzle where a row is 128 bytes, the 32-byte one at
// Dh 16. The wgmma descriptors read that layout K-major (the product's depth
// along Dh: Q.K^T) and MN-major (the depth along the rows: P.V, dS.K). The
// tensor maps are encoded on the host through the driver entry point the
// runtime returns (cudaGetDriverEntryPoint*), so no library needs -lcuda.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "mma16.cuh"

namespace wgt {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows (positions or keys) per tile

// A 64-row tile of DH bf16 columns: kHalves halves of kCols columns, rows
// of kRowBytes; the descriptor's layout type and its strides between 8-row
// groups (SBO) and, MN-major, between the halves (LBO).
template <int DH>
struct TileFmt {
  static_assert(DH == 16 || DH == 64 || DH == 128, "head width 16, 64, 128");
  static constexpr int kCols = DH < 64 ? DH : 64;
  static constexpr int kHalves = DH / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kHalfBytes = kTile * kRowBytes;
  static constexpr int kTileBytes = kHalves * kHalfBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 3;  // 128B / 32B
  static constexpr uint32_t kSbo = 8 * kRowBytes;
  static constexpr uint32_t kLbo = kHalves > 1 ? kHalfBytes : 16;
  // byte offset of 16-byte chunk c (of DH / 8) of row r
  static __device__ __forceinline__ int chunk(int r, int c) {
    constexpr int kPer = kRowBytes / 16;  // chunks in a half's row
    const int h = c / kPer, cc = c % kPer;
    return h * kHalfBytes + r * kRowBytes +
           ((cc ^ (kRowBytes == 128 ? r & 7 : (r >> 2) & 1)) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; a wait of more
// than kStallNs (a lost arrival) traps, so a fault ends the launch with an
// error instead of hanging the card
constexpr uint64_t kStallNs = 4000000000ull;
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t since = 0;
  for (uint32_t n = 1;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      else if (now - since > kStallNs) __trap();
    }
  }
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the tile of 64 rows from row c0 of head h, batch row b, of a [B, N, H,
// DH] tensor (rows_map): one box per half
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int c0, int b) {
#pragma unroll
  for (int x = 0; x < TileFmt<DH>::kHalves; ++x)
    tma_4d(dst + x * TileFmt<DH>::kHalfBytes, map, bar,
           x * TileFmt<DH>::kCols, h, c0, b);
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk16, bf16 operands, fp32 accumulators
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers an in-flight wgmma writes or reads: no use moves across this
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// a tile as TMA swizzled it, as a wgmma operand: K-major (the product's
// depth along Dh) for k-step kk, and MN-major (the depth along the rows,
// the product's columns along Dh)
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  using L = TileFmt<DH>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(L::kLbo >> 4) << 16) |
         (static_cast<uint64_t>(L::kSbo >> 4) << 32) | (L::kLayout << 62);
}
template <int DH>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  using L = TileFmt<DH>;
  constexpr int kSteps = L::kCols / 16;  // k-steps in a half
  return desc<DH>(tile + (kk / kSteps) * L::kHalfBytes + 32 * (kk % kSteps));
}
template <int DH>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return desc<DH>(tile + 16 * kk * TileFmt<DH>::kRowBytes);
}

#define WG_ACC8(o)                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),        \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], both from shared memory, K-major
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x DH] += a[64 x 16] b[16 x DH]: a in registers, b from shared memory
// MN-major
template <int DH>
__device__ __forceinline__ void mma_rs(float (&d)[DH / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DH == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32),
          WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (DH == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "1;\n}\n"
        : WG_ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}
// d[64 x 64] (+)= a[64 x 16] b[16 x 64]: a in registers, b from shared
// memory K-major
__device__ __forceinline__ void mma_rs64(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef WG_ACC8

// a 64-row tile of DH columns as TMA swizzled it -> register A operands of
// its DH / 16 k-steps (this thread's rows ra and ra + 8 of its warpgroup's
// 64, four lanes a row as in an accumulator)
template <int DH>
__device__ __forceinline__ void tile_a(const unsigned char* tile, int ra,
                                       int q4, uint32_t (&a)[DH / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ra + 8 * (r & 1), col = 16 * kk + 8 * (r >> 1) + 2 * q4;
      a[kk][r] = *reinterpret_cast<const uint32_t*>(
          tile + TileFmt<DH>::chunk(row, col >> 3) + 2 * (col & 7));
    }
}

// s[64 x 64] = a[64 x DH] b[64 x DH]^T: a as register A operands (tile_a),
// b a tile read K-major
template <int DH>
__device__ __forceinline__ void mma_at(float (&s)[32],
                                       const uint32_t (&a)[DH / 16][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    mma_rs64(s, a[kk], k_major<DH>(b, kk), kk > 0);
}

// x[64 x 64] fp32 accumulator -> register A operands of its four k-steps,
// each value as a hi and a lo bf16 half (mma16.cuh's split_hi_lo)
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&hi)[4][4],
                                     uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      mma16::split_hi_lo<bf16>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1],
                               hi[kk][r], lo[kk][r]);
}

// acc[64 x DH] += x[64 x 64] b[64 x DH], x split as hi + lo, b a tile read
// MN-major
template <int DH>
__device__ __forceinline__ void mma_xb(float (&acc)[DH / 2],
                                       const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4],
                                       uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_rs<DH>(acc, hi[kk], mn_major<DH>(tile, kk));
    mma_rs<DH>(acc, lo[kk], mn_major<DH>(tile, kk));
  }
}

// s[64 x 64] = a[64 x DH] b[64 x DH]^T, both tiles K-major
template <int DH>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    mma_ss64(s, k_major<DH>(a, kk), k_major<DH>(b, kk), kk > 0);
}

// store an fp32 accumulator [64 x DH] (this thread's rows ra, ra + 8) as
// bf16 rows, times `scale`; a null row is not stored
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2],
                                           bf16* row_a, bf16* row_b,
                                           float scale, int lane) {
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    bf16* row = x == 0 ? row_a : row_b;
    if (row == nullptr) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * x] * scale,
                                acc[4 * j + 2 * x + 1] * scale);
  }
}

// the 1024-aligned base of dynamic shared memory, as a shared address and
// as a generic pointer
struct Base {
  uint32_t addr;
  unsigned char* ptr;
  __device__ __forceinline__ explicit Base(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    addr = (r + 1023u) & ~1023u;
    ptr = raw + (addr - r);
  }
  __device__ __forceinline__ unsigned char* at(uint32_t a) const {
    return ptr + (a - addr);
  }
};

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, N, H, DH] bf16 tensor, boxes of 64 positions x one head x one half
// (rows past N zero-filled), swizzled for the wgmma descriptors
template <int DH>
bool rows_map(CUtensorMap* map, const void* ptr, int B, int N, int H) {
  using L = TileFmt<DH>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(DH) * 2, static_cast<cuuint64_t>(H) * DH * 2,
      static_cast<cuuint64_t>(N) * H * DH * 2};
  const cuuint32_t box[4] = {L::kCols, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_32B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgt
