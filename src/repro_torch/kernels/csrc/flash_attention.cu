// Non-causal flash attention for the packed ViT on Hopper, with the CLS
// row's attention probabilities as a by-product (the TDM scores).
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/
// flash_attention/flash_attention.py:25, its pallas_call at :92) in the
// non-causal form the reference ViT path computes in jnp:
// `flash_attention_jnp(q, k, v, causal=False, kv_len=)` plus
// `attention_probs_row(q[:, 0], k, kv_len=)` (core/packed_runner.py). Its
// causal GQA form, for the dense LMs, is flash_decode.cu and
// flash_prefill.cu. q, k, v, o [B, N, H, Dh] with Dh 16 or 64; keys at or
// past kv_len[b] are masked. Two entry points over the operand type, one
// kernel body each:
//   flash_attention_f32: fp32 q, k, v and o, on the CUDA cores: no TF32
//     and no split product, the fp32 tier keeps full fp32 products;
//   flash_attention_f16: fp16 q, k, v and o (the fp16 tier), Q.K^T and
//     P.V on the tensor cores with fp32 accumulation.
// Statistics and sums are fp32 in both; o is rounded to its type on the
// store (`flash_attention_jnp` returns q.dtype), the probabilities are
// fp32. Training (the ViT's Algorithm 1, fp32 only) also asks for each
// row's natural log-sum-exp, lse [B, H, N] fp32, which the backward
// (flash_attention_bwd.cu) reads to rebuild P; the combine writes it from
// the row's final m and l. The pointer is nullable, and the serve passes
// null: o and probs do not depend on it.
//
// Rows without a key (ROADMAP C1): a row with kv_len[b] <= 0 has no valid
// key. The reference masks with the finite NEG_INF, so every key scores
// the same and it returns the mean of V over all N tokens with
// probabilities 1/N. The kernel does the same: such a row takes L = N keys
// and scores every key 0 in place of q.k, so the ordinary loop yields the
// uniform row. kv_len past N acts as N; no kv_len means every key is
// valid.
//
// Bound on the H100 at the main path's shape (q, k, v [4, 197, 6, 64],
// kv_len (197, 170, 140, 50): 658,374 (query, key, head) triples): Q.K^T
// and P.V take 2 Dh operations each per triple, 1.69e8 in all, and the
// call moves q and o whole and k, v up to kv_len, 4.14 MB at fp32 and
// 2.07 MB at fp16. fp32: 2.52 us of CUDA-core operations (67 TFLOP/s)
// against 1.23 us of bytes (3.35 TB/s), bound by operations. fp16: the
// products on the tensor cores (989 TFLOP/s, P.V counted twice for the
// split below) take 0.26 us and the bytes 0.62 us, bound by bytes.
//
// Design. A block of four warps owns one tile of 16 query rows of one
// (head, batch row). The key range [0, L) is cut into chunks of 16 keys,
// dealt round robin to the warps (warp w takes chunks w, w + 4, ...), and
// each warp runs an online softmax over its chunks (running max m and sum
// l per row, fp32, in base 2). At the main path's shape that is 13 x 6 x 4
// = 312 blocks, 8 to 12 warps on every SM; the kernel this replaced ran
// 168 blocks of four warps whose query rows walked every key themselves,
// about one block per SM and no latency hidden. After the loop each warp
// writes its partial (m, l, acc) to shared memory and the block combines
// them in warp order, without atomics. Which chunks a warp takes, in which
// order, depends on L alone, so a row's bits depend on its own q, its
// batch row's first L keys and L: not on N, B, the other rows or any
// padding past L.
//   Staging: Q is copied once per block; each warp copies its own chunks
// of K and V by 16-byte cp.async into two stages of its own, the next
// chunk's copy in flight under this chunk's products, and the loop has
// warp barriers only. Rows past N and keys at or past L are zero-filled;
// a masked key scores -inf, so its p is exactly 0 against a zero V row and
// it never enters a valid row's sum. Chunks wholly past L are never
// loaded.
//   fp16 core: mma.sync.m16n8k16, fragments by ldmatrix (mma16.cuh, shared
// with flash_prefill.cu), shared rows padded by 16 bytes so that ldmatrix
// is conflict-free. Q.K^T of fp16 values is exact per product in fp32, as
// the reference computes it. P is fp32 and enters P.V as two fp16 halves,
// hi = fp16(P) and lo = fp16(P - hi), two MMAs into the fp32 accumulator
// (V by ldmatrix.trans): P is kept to ~2^-22 relative, ~3e-8 absolute
// where hi is subnormal, far below o's fp16 rounding.
//   fp32 core: each lane owns 4 query rows (rows rg + 4 i of its row group
// rg = lane / 8) and, per chunk, 2 keys of the scores and Dh / 8 columns
// of the output. A score step reads one float4 of Q per row and one of K
// per key: 6 vector reads per 32 fmas (two scalar reads per fma before),
// the Q rows shared by the 8 lanes of a row group and the K rows padded so
// that the 8 keys of a read fall in distinct banks. P.V reads a float4 of
// P per row and float4s of V per key, 12 reads per 128 fmas (17 per 16
// before). P goes through the chunk's K stage, free once its scores are
// taken. Every fma chain runs in a fixed order (over d, then over the keys
// in chunk order), so a row's bits repeat from run to run.
//   CLS scores in the loop: in the block of query tile 0 the lanes that
// hold row 0 park its scaled scores in `probs` itself as each chunk
// computes them (keys below L). After the combine the block rewrites
// probs[b, h, j] = exp2(s_0j - m) / l with row 0's final m and l, and
// exactly 0 at keys at or past L. No score is recomputed from global K
// (the kernel this replaced re-read K after its loop for row 0, serially
// per key). The head mean is the wrapper's.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma16.cuh"

namespace {

constexpr int kTQ = 16;  // query rows per block: one m16 tile
constexpr int kTK = 16;  // keys per chunk
constexpr int kWarps = 4;  // the chunks of [0, L) dealt round robin
constexpr int kThreads = 32 * kWarps;
constexpr int kCLd = 8;  // the combine's row padding, floats
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kThreads == kTQ * 8, "the combine gives 8 threads to a row");

// The keys batch row b attends to: [0, L), scored q.k, or (a row without
// a key) all N keys scored 0.
struct Keys {
  int L;
  bool uniform;
  __device__ __forceinline__ Keys(const int* kv_len, int b, int N) {
    const int n = kv_len != nullptr ? kv_len[b] : N;
    uniform = n <= 0;
    L = uniform ? N : min(n, N);
  }
};

// Copy rows r0 .. r0 + 15 of one head of a [*, H, DH] operand (row stride
// ldt elements) into shared rows `ld` elements apart by 16-byte cp.async,
// rows at or past `end` zero-filled; kN threads, this one t.
template <int DH, int kN, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           size_t ldt, int r0, int end,
                                           int t) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  constexpr int kCopies = kTK * DH / kPer;
#pragma unroll
  for (int i = 0; i < (kCopies + kN - 1) / kN; ++i) {
    const int e = t + i * kN;
    if (kCopies % kN != 0 && e >= kCopies) break;
    const int r = e / (DH / kPer), ch = e % (DH / kPer), n = r0 + r;
    const bool ok = n < end;
    cp_async16(dst + r * ld + ch * kPer, src + (ok ? n * ldt + ch * kPer : 0),
               ok);
  }
}

// fp16 tier: a warp's 16 query rows on the tensor cores. Accumulator
// element i of n-tile nt is row lane / 4 + 8 (i / 2), column nt * 8 +
// (lane % 4) * 2 + i % 2.
template <int DH>
struct MmaCore {
  using T = __half;
  static constexpr int kQLd = DH + 8;  // shared rows, elements
  static constexpr int kKLd = DH + 8;
  static constexpr int kVLd = DH + 8;
  uint32_t qa[DH / 16][4];  // Q as A fragments, all of Dh
  float m[2], l[2];  // rows lane / 4 and lane / 4 + 8; l this lane's part
  float acc[DH / 8][4];

  __device__ __forceinline__ void init(const T* qs, int lane) {
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd)
      mma16::ldmatrix_x4(qa[kd], qs + (lane & 15) * kQLd + kd * 16 +
                                     (lane >> 4) * 8);
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  __device__ __forceinline__ void step(T* ks, const T* vs, int c0,
                                       const Keys& keys, float scale_log2,
                                       float* park, int lane) {
    // S = Q K^T: 16 rows x 16 keys
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
      uint32_t kf[4];
      mma16::ldmatrix_x4(kf, ks + ((lane >> 4) * 8 + (lane & 7)) * kKLd +
                                 kd * 16 + ((lane >> 3) & 1) * 8);
      mma16::mma<T>(s[0], qa[kd], kf[0], kf[1]);
      mma16::mma<T>(s[1], qa[kd], kf[2], kf[3]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + nt * 8 + (lane & 3) * 2 + (i & 1);
        float x = keys.uniform ? 0.f : s[nt][i] * scale_log2;
        if (c >= keys.L) x = -INFINITY;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    if (park != nullptr && lane < 4) {  // lanes 0-3 hold row 0
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = c0 + nt * 8 + lane * 2 + i;
          if (c < keys.L) park[c] = s[nt][i];
        }
      }
    }
    // every chunk holds a valid key (a uniform row's score 0 included), so
    // the new max is finite; the first chunk's correction is exp2(-inf) = 0
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      corr[x] = exp2f(m[x] - mx[x]);
      m[x] = mx[x];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[nt][i] - m[i >> 1]);  // exactly 0 if masked
        s[nt][i] = p;
        psum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + psum[x];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
    // O += P V with P as fp16 hi + lo halves; the score accumulators of
    // the 16 keys are the A fragment of the k-step
    uint32_t ph[4], pl[4];
    mma16::split_hi_lo<T>(s[0][0], s[0][1], ph[0], pl[0]);
    mma16::split_hi_lo<T>(s[0][2], s[0][3], ph[1], pl[1]);
    mma16::split_hi_lo<T>(s[1][0], s[1][1], ph[2], pl[2]);
    mma16::split_hi_lo<T>(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vf[4];
      mma16::ldmatrix_x4_trans(vf, vs + (((lane >> 3) & 1) * 8 + (lane & 7)) *
                                            kVLd + dp * 16 + (lane >> 4) * 8);
      mma16::mma<T>(acc[2 * dp], ph, vf[0], vf[1]);
      mma16::mma<T>(acc[2 * dp], pl, vf[0], vf[1]);
      mma16::mma<T>(acc[2 * dp + 1], ph, vf[2], vf[3]);
      mma16::mma<T>(acc[2 * dp + 1], pl, vf[2], vf[3]);
    }
  }

  // this warp's partial (acc, m, l) into its combine region: acc rows
  // kCLd + DH floats apart, then m and l of the 16 rows
  __device__ __forceinline__ void store(float* cw, int lane) {
    constexpr int ld = DH + kCLd;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    }
    const int g = lane >> 2, col = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      *reinterpret_cast<float2*>(cw + g * ld + nt * 8 + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(cw + (g + 8) * ld + nt * 8 + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    if ((lane & 3) == 0) {
      float* mw = cw + kTQ * ld;
      mw[g] = m[0];
      mw[g + 8] = m[1];
      mw[kTQ + g] = l[0];
      mw[kTQ + g + 8] = l[1];
    }
  }
};

// fp32 tier: a warp's 16 query rows on the CUDA cores. Lane (rg, kl) =
// (lane / 8, lane % 8) owns rows rg + 4 i (i < 4), the chunk's keys kl and
// kl + 8, and output columns kVW kl + 8 kVW h + e (h < kVN, e < kVW).
template <int DH>
struct FmaCore {
  using T = float;
  static constexpr int kQLd = DH + 4;  // Q and K rows padded: conflict-free
  static constexpr int kKLd = DH + 4;
  static constexpr int kVLd = DH;
  static constexpr int kPLd = DH >= 32 ? kTK + 8 : kTK + 4;  // P rows
  static constexpr int kVW = DH >= 32 ? 4 : 2;  // V read width, floats
  static constexpr int kVN = DH / 8 / kVW;  // V reads per key
  static constexpr int kCols = DH / 8;
  static_assert(kPLd <= kKLd, "P fits in the chunk's K stage");
  const float* qs;
  float m[4], l[4];  // l: this lane's part
  float acc[4][kCols];

  __device__ __forceinline__ void init(const float* q, int) {
    qs = q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
    }
  }

  __device__ __forceinline__ void step(float* ks, const float* vs, int c0,
                                       const Keys& keys, float scale_log2,
                                       float* park, int lane) {
    const int rg = lane >> 3, kl = lane & 7;
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 4 * i) * kQLd + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (kl + 8 * j) * kKLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = keys.uniform ? 0.f : s[i][j] * scale_log2;
        if (c0 + kl + 8 * j >= keys.L) x = -INFINITY;
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    if (park != nullptr && rg == 0) {  // row 0 is row group 0's i = 0
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (c0 + kl + 8 * j < keys.L) park[c0 + kl + 8 * j] = s[0][j];
    }
    // finite: every chunk holds a valid key (see MmaCore::step)
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = exp2f(s[i][j] - m[i]);  // exactly 0 if masked
        psum += s[i][j];
      }
      l[i] = l[i] * corr[i] + psum;
    }
    __syncwarp();  // every lane has read this chunk's K: P takes its place
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) ps[(rg + 4 * i) * kPLd + kl + 8 * j] = s[i][j];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr[i];
#pragma unroll
    for (int c4 = 0; c4 < kTK; c4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg + 4 * i) * kPLd + c4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = vs + (c4 + kk) * kVLd + kVW * kl;
        float vv[kCols];
#pragma unroll
        for (int h = 0; h < kVN; ++h) {
          if constexpr (kVW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + 32 * h);
            vv[4 * h] = x.x;
            vv[4 * h + 1] = x.y;
            vv[4 * h + 2] = x.z;
            vv[4 * h + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vrow + 16 * h);
            vv[2 * h] = x.x;
            vv[2 * h + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = kk == 0 ? pv[i].x
                          : kk == 1 ? pv[i].y
                          : kk == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  // as MmaCore::store
  __device__ __forceinline__ void store(float* cw, int lane) {
    constexpr int ld = DH + kCLd;
    const int rg = lane >> 3, kl = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
      float* row = cw + (rg + 4 * i) * ld + kVW * kl;
#pragma unroll
      for (int h = 0; h < kVN; ++h) {
        if constexpr (kVW == 4)
          *reinterpret_cast<float4*>(row + 32 * h) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
        else
          *reinterpret_cast<float2*>(row + 16 * h) =
              make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
      if (kl == 0) {
        float* mw = cw + kTQ * ld;
        mw[rg + 4 * i] = m[i];
        mw[kTQ + rg + 4 * i] = l[i];
      }
    }
  }
};

// Dynamic shared memory of a block: Q, then each warp's two stages of (K,
// V); after the loop the warps' combine regions take the stages' place.
template <class Core, int DH>
struct Smem {
  using T = typename Core::T;
  static constexpr int kStage = kTK * (Core::kKLd + Core::kVLd);  // elements
  static constexpr size_t kQBytes = sizeof(T) * kTQ * Core::kQLd;
  static constexpr size_t kWarpBytes = sizeof(T) * 2 * kStage;
  static constexpr int kCombWarp = kTQ * (DH + kCLd) + 2 * kTQ;  // floats
  static_assert(sizeof(float) * kCombWarp <= kWarpBytes,
                "a warp's combine region fits in its stages");
  static_assert(kQBytes % 16 == 0 && kWarpBytes % 16 == 0 &&
                    sizeof(float) * kCombWarp % 16 == 0,
                "regions stay 16-byte aligned");
  static constexpr size_t kBytes = kQBytes + kWarps * kWarpBytes;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Combine the warps' partials in warp order: row r = t / 8 of the tile,
// Dh / 8 columns from (t % 8) Dh / 8 on. Row 0's final (m, l) goes to
// row0, and each row's natural log-sum-exp to lse_bh (the (b, h) row of
// lse) where it is not null. A warp without a chunk has m = -inf and adds
// exactly 0.
template <int DH, typename T>
__device__ __forceinline__ void combine_store(const float* comb, T* ob,
                                              size_t ldt, int n0, int N,
                                              int t, float* row0,
                                              float* lse_bh) {
  constexpr int ld = DH + kCLd;
  constexpr int kW = kTQ * ld + 2 * kTQ;
  constexpr int kOut = DH / 8;
  const int r = t >> 3, c0 = (t & 7) * kOut;
  float mw[kWarps], f[kWarps], M = -INFINITY, l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mw[w] = comb[w * kW + kTQ * ld + r];
    M = fmaxf(M, mw[w]);
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = exp2f(mw[w] - M);
    l = fmaf(comb[w * kW + kTQ * ld + kTQ + r], f[w], l);
  }
  if (row0 != nullptr && t == 0) {
    row0[0] = M;
    row0[1] = l;
  }
  if (n0 + r >= N) return;
  // M is in base 2 of the scaled scores: lse = ln 2 (M + log2 l)
  if (lse_bh != nullptr && (t & 7) == 0)
    lse_bh[n0 + r] = (M + log2f(l)) * kLn2;
  T* orow = ob + (n0 + r) * ldt + c0;
#pragma unroll
  for (int c = 0; c < kOut; c += 2) {
    float a[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        x = fmaf(comb[w * kW + r * ld + c0 + c + e], f[w], x);
      a[e] = x / l;
    }
    store2(orow + c, a[0], a[1]);
  }
}

// One block: query tile blockIdx.x of head blockIdx.y of batch row
// blockIdx.z (the design is in the head comment).
template <class Core, int DH>
__device__ __forceinline__ void attention_tile(
    const typename Core::T* __restrict__ q,
    const typename Core::T* __restrict__ k,
    const typename Core::T* __restrict__ v, const int* __restrict__ kv_len,
    typename Core::T* __restrict__ o, float* __restrict__ probs,
    float* __restrict__ lse, int N, int H, float scale) {
  using T = typename Core::T;
  using S = Smem<Core, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float row0[2];  // row 0's final m and l

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const Keys keys(kv_len, b, N);
  const size_t ldt = static_cast<size_t>(H) * DH;  // token stride
  const size_t base = static_cast<size_t>(b) * N * ldt +
                      static_cast<size_t>(h) * DH;
  T* qs = reinterpret_cast<T*>(smem);
  T* mine_st = reinterpret_cast<T*>(smem + S::kQBytes + warp * S::kWarpBytes);
  auto kst = [&](int st) { return mine_st + st * S::kStage; };
  auto vst = [&](int st) { return mine_st + st * S::kStage + kTK * Core::kKLd; };
  const int n_chunks = (keys.L + kTK - 1) / kTK;
  const int n_mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;
  auto load = [&](int i, int st) {  // this warp's i-th chunk into stage st
    const int c0 = (warp + i * kWarps) * kTK;
    stage_rows<DH, 32>(kst(st), Core::kKLd, k + base, ldt, c0, keys.L, lane);
    stage_rows<DH, 32>(vst(st), Core::kVLd, v + base, ldt, c0, keys.L, lane);
  };

  stage_rows<DH, kThreads>(qs, Core::kQLd, q + base, ldt, qt * kTQ, N, t);
  if (n_mine > 0) load(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  Core core;
  core.init(qs, lane);
  float* park = probs != nullptr && qt == 0
                    ? probs + (static_cast<size_t>(b) * H + h) * N
                    : nullptr;
  const float scale_log2 = scale * kLog2e;
  for (int i = 0; i < n_mine; ++i) {
    if (i + 1 < n_mine) {
      load(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // chunk i has landed for every lane
    core.step(kst(i & 1), vst(i & 1), (warp + i * kWarps) * kTK, keys,
              scale_log2, park, lane);
    __syncwarp();  // its stage is free for the chunk two on
  }

  __syncthreads();  // every warp is done with its stages
  float* comb = reinterpret_cast<float*>(smem + S::kQBytes);
  core.store(comb + warp * S::kCombWarp, lane);
  __syncthreads();
  combine_store<DH>(comb, o + base, ldt, qt * kTQ, N, t,
                    park != nullptr ? row0 : nullptr,
                    lse != nullptr
                        ? lse + (static_cast<size_t>(b) * H + h) * N
                        : nullptr);
  if (park != nullptr) {  // the block of query tile 0
    __syncthreads();  // row 0's m and l, and every parked score
    const float m0 = row0[0], l0 = row0[1];
    for (int j = t; j < N; j += kThreads)
      park[j] = j < keys.L ? exp2f(park[j] - m0) / l0 : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ kv_len,
                           float* __restrict__ o, float* __restrict__ probs,
                           float* __restrict__ lse,
                           int N, int H, float scale) {
  attention_tile<FmaCore<DH>, DH>(q, k, v, kv_len, o, probs, lse, N, H,
                                 scale);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f16_kernel(const __half* __restrict__ q,
                           const __half* __restrict__ k,
                           const __half* __restrict__ v,
                           const int* __restrict__ kv_len,
                           __half* __restrict__ o, float* __restrict__ probs,
                           float* __restrict__ lse,
                           int N, int H, float scale) {
  attention_tile<MmaCore<DH>, DH>(q, k, v, kv_len, o, probs, lse, N, H,
                                 scale);
}

template <typename T>
using FlashKernel = void (*)(const T*, const T*, const T*, const int*, T*,
                             float*, float*, int, int, float);

template <class Core, int DH>
int launch_dh(FlashKernel<typename Core::T> kernel, const void* q,
              const void* k, const void* v, const void* kv_len, void* o,
              void* probs, void* lse, int B, int N, int H, float scale,
              void* stream) {
  using T = typename Core::T;
  static size_t raised = 0;
  constexpr size_t kBytes = Smem<Core, DH>::kBytes;
  const cudaError_t err = allow_smem(kernel, kBytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTQ - 1) / kTQ, H, B);
  kernel<<<grid, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(o), static_cast<float*>(probs),
      static_cast<float*>(lse), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <template <int> class Core, typename T>
int launch(FlashKernel<T> k16, FlashKernel<T> k64, const void* q,
           const void* k, const void* v, const void* kv_len, void* o,
           void* probs, void* lse, int B, int N, int H, int Dh, float scale,
           void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 16)
    return launch_dh<Core<16>, 16>(k16, q, k, v, kv_len, o, probs, lse, B,
                                   N, H, scale, stream);
  if (Dh == 64)
    return launch_dh<Core<64>, 64>(k64, q, k, v, kv_len, o, probs, lse, B,
                                   N, H, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o [B, N, H, Dh] fp32 contiguous, each 16-byte aligned, Dh in
// {16, 64}; kv_len [B] int32 or null (all N keys): keys at or past
// kv_len[b] are masked, kv_len[b] > N acts as N, and a row with kv_len[b]
// <= 0 attends to all N keys uniformly (the mean of V, probabilities 1/N:
// the reference's fully masked row); probs [B, H, N] fp32 or null (then no
// CLS-row probabilities); lse [B, H, N] fp32 or null (then no log-sum-exp;
// the serve passes null).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, void* probs,
                                   void* lse, int B, int N, int H, int Dh,
                                   float scale, void* stream) {
  return launch<FmaCore, float>(flash_attention_f32_kernel<16>,
                                flash_attention_f32_kernel<64>, q, k, v,
                                kv_len, o, probs, lse, B, N, H, Dh, scale,
                                stream);
}

// As flash_attention_f32 with q, k, v and o fp16 (o rounded to nearest);
// probs and lse stay fp32 (the wrapper passes a null lse: the fp16 tier
// has no gradient).
extern "C" int flash_attention_f16(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, void* probs,
                                   void* lse, int B, int N, int H, int Dh,
                                   float scale, void* stream) {
  return launch<MmaCore, __half>(flash_attention_f16_kernel<16>,
                                 flash_attention_f16_kernel<64>, q, k, v,
                                 kv_len, o, probs, lse, B, N, H, Dh, scale,
                                 stream);
}
