// The gradient of the non-causal fp32 attention on Hopper: the ViT's
// training (Algorithm 1), with the gradient of the CLS row's attention
// probabilities (the TDM's scores) folded into the same passes.
//
// Replaces the gradient JAX takes, in the reference's Algorithm 1
// (src/repro/core/simultaneous.py) and ViT step (models/steps.py), of the
// non-causal form of the Pallas kernel `_flash_kernel` (src/repro/kernels/
// flash_attention/flash_attention.py:25, its pallas_call at :92), which
// that path computes in jnp as `flash_attention_jnp(causal=False)` plus
// `attention_probs_row(q[:, 0], k)` (models/attention.py). The forward is
// flash_attention_f32 writing each row's log-sum-exp (flash_attention.cu).
//
// Inputs: q, k, v, o, dO [B, N, H, Dh] fp32 (Dh 16 or 64, every key
// valid: training has no padded rows), lse [B, H, N] (the forward's
// natural log-sum-exp) and dprobs [B, H, N] or null, the gradient of the
// CLS row's per-head probabilities (the wrapper passes the head mean's
// gradient made contiguous: dscores / H at every head). Outputs dq, dk,
// dv [B, N, H, Dh] fp32. With s = scale q.k:
//   P = exp(s - lse), D = rowsum(dO o O), dP = dO V^T, dS = P o (dP - D),
//   dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
// The CLS probabilities are row 0 of P (the same scores, the same scale),
// so their gradient enters the same dS: for row 0 only, dP_0j += dprobs_j
// and D_0 += sum_j P_0j dprobs_j (the softmax's Jacobian). No separate
// launch computes it.
//
// Bound on the H100 at the training shapes (DeiT-Small, batch 64, 6 heads,
// Dh 64, N = 197 at layers 0-2, 140, 100 and 72 after each TDM): five
// products of 2 N^2 Dh operations per (b, h), all fp32 on the CUDA cores
// (no TF32: the fp32 tier keeps full fp32 products); at N = 197 that is
// 9.5e9 operations a call, 0.142 ms at 67 TFLOP/s, against 0.046 ms for
// its 155 MB (five inputs read and three outputs written once, 19.4 MB
// each): bound by operations.
//
// Design: a simple one, two kernels per launch as in flash_prefill_bwd.cu
// (dQ with D, then dK/dV), blocks of four warps on the CUDA cores with the
// lane layout of flash_attention.cu's fp32 core, every sum in a fixed
// order and no atomics, so two launches are bitwise equal.
//   dQ kernel: one block per (16-row query tile, head, batch row). D of
// the tile's rows is read from o and dO while Q and dO are staged; in the
// block holding row 0, the 128 threads also take sum_j P_0j dprobs_j over
// all keys (one Q.K row, N Dh operations) before the loop. The keys are
// cut into chunks of 16 dealt round robin to the warps; per chunk a warp
// takes S = Q K^T and dP = dO V^T (each lane 4 rows x 2 keys), forms dS in
// registers, parks it where the chunk's V was, and adds dS K into its
// partial dQ (each lane 4 rows x Dh / 8 columns). Chunks are staged by
// 16-byte cp.async, two stages per warp. The warps' partials are summed in
// warp order; the kernel writes dQ and each row's D (with row 0's
// probability term) to the scratch dsum [B, H, N].
//   dK/dV kernel: one block per (16-key tile, head, batch row), K and V
// held, the query rows in chunks of 16 dealt to the warps; per chunk S^T =
// K Q^T and dP^T = V dO^T, P^T from lse, dS^T from dsum (and, at query
// row 0, dprobs), both parked in the warp's buffers, then dV += P^T dO and
// dK += dS^T Q. Partials summed in warp order; dK scaled on the store.
// Rows and keys past N are staged as zeros and masked to P = 0.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kT = 16;  // rows of a tile and of a chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCLd = 8;  // the combine's row padding, floats
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == kT * 8, "D and the combine give 8 threads a row");

template <int DH>
struct Tile {
  // staged rows, padded so that the float4 reads of 8 rows by the 8 lanes
  // of a row group fall in distinct banks
  static constexpr int kLd = DH + 4;
  static constexpr int kRow = kT * kLd;  // floats of a staged 16-row tile
  static constexpr int kPLd = DH >= 32 ? kT + 8 : kT + 4;  // P / dS rows
  static constexpr int kVW = DH >= 32 ? 4 : 2;  // output read width
  static constexpr int kVN = DH / 8 / kVW;  // reads per row
  static constexpr int kCols = DH / 8;  // output columns of a lane
  static constexpr int kComb = kT * (DH + kCLd);  // a warp's partial
  static_assert(kPLd <= kLd, "dS fits in a staged tile");
};

// Copy rows r0 .. r0 + 15 of one head of a [*, H, DH] fp32 operand (token
// stride ldt) into shared rows kLd apart by 16-byte cp.async, rows at or
// past `end` zero-filled; kN threads, this one t.
template <int DH, int kN>
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        size_t ldt, int r0, int end, int t) {
  constexpr int kCopies = kT * DH / 4;
#pragma unroll
  for (int i = 0; i < (kCopies + kN - 1) / kN; ++i) {
    const int e = t + i * kN;
    if (kCopies % kN != 0 && e >= kCopies) break;
    const int r = e / (DH / 4), ch = e % (DH / 4), n = r0 + r;
    const bool ok = n < end;
    cp_async16(dst + r * Tile<DH>::kLd + ch * 4,
               src + (ok ? static_cast<size_t>(n) * ldt + ch * 4 : 0), ok);
  }
}

// s[i][j] += sum_d a[rg + 4 i][d] b[kl + 8 j][d] over staged tiles, d in
// order: the lane's 4 rows of `a` against its 2 rows of `b`.
template <int DH>
__device__ __forceinline__ void dot16(const float* a, const float* b, int rg,
                                      int kl, float (&s)[4][2]) {
  constexpr int ld = Tile<DH>::kLd;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (rg + 4 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (kl + 8 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_j p[rg + 4 i][j] m[j][col c], j in order: p a parked
// 16 x 16 tile (rows kPLd apart), m a staged tile; the lane's columns are
// kVW kl + 8 kVW h + e for c = kVW h + e.
template <int DH>
__device__ __forceinline__ void accum16(const float* p, const float* m,
                                        int rg, int kl,
                                        float (&acc)[4][Tile<DH>::kCols]) {
  using TL = Tile<DH>;
#pragma unroll
  for (int c4 = 0; c4 < kT; c4 += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (rg + 4 * i) * TL::kPLd +
                                               c4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* mrow = m + (c4 + kk) * TL::kLd + TL::kVW * kl;
      float mv[TL::kCols];
#pragma unroll
      for (int h = 0; h < TL::kVN; ++h) {
        if constexpr (TL::kVW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(mrow + 32 * h);
          mv[4 * h] = x.x;
          mv[4 * h + 1] = x.y;
          mv[4 * h + 2] = x.z;
          mv[4 * h + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(mrow + 16 * h);
          mv[2 * h] = x.x;
          mv[2 * h + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pe = kk == 0 ? pv[i].x
                         : kk == 1 ? pv[i].y
                         : kk == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
        for (int c = 0; c < TL::kCols; ++c)
          acc[i][c] = fmaf(pe, mv[c], acc[i][c]);
      }
    }
  }
}

// A lane's partial into its warp's combine region (rows DH + kCLd apart).
template <int DH>
__device__ __forceinline__ void store_partial(
    float* cw, int rg, int kl, const float (&acc)[4][Tile<DH>::kCols]) {
  using TL = Tile<DH>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = cw + (rg + 4 * i) * (DH + kCLd) + TL::kVW * kl;
#pragma unroll
    for (int h = 0; h < TL::kVN; ++h) {
      if constexpr (TL::kVW == 4)
        *reinterpret_cast<float4*>(row + 32 * h) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      else
        *reinterpret_cast<float2*>(row + 16 * h) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
}

// The warps' partials summed in warp order, times `mult`, into row n0 + r
// (r = t / 8, columns (t % 8) Dh / 8 on) of a [B, N, H, DH] output whose
// (b, h) head starts at `out`; rows past N are not stored.
template <int DH>
__device__ __forceinline__ void combine_store(const float* comb, int stride,
                                              float* out, size_t ldt, int n0,
                                              int N, int t, float mult) {
  constexpr int kOut = DH / 8;
  const int r = t >> 3, c0 = (t & 7) * kOut;
  if (n0 + r >= N) return;
  float* orow = out + static_cast<size_t>(n0 + r) * ldt + c0;
#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      x += comb[w * stride + r * (DH + kCLd) + c0 + c];
    orow[c] = x * mult;
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 + 4 * kWarps) * Tile<DH>::kRow;
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * ((2 + 4 * kWarps) * Tile<DH>::kRow +
                          kWarps * 2 * kT * Tile<DH>::kPLd);
}

// dQ and D: query tile blockIdx.x of head blockIdx.y of batch row
// blockIdx.z (the design is in the head comment). Shared memory: Q, dO,
// then each warp's two stages of (K, V); after the loop the warps' combine
// regions take the stages' place.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_f32_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dprobs, float* __restrict__ dsum,
    float* __restrict__ dq, int N, int H, float scale) {
  using TL = Tile<DH>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float dd_s[kT];
  __shared__ float red[kWarps];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rg = lane >> 3, kl = lane & 7;
  const size_t ldt = static_cast<size_t>(H) * DH;
  const size_t base = static_cast<size_t>(b) * N * ldt +
                      static_cast<size_t>(h) * DH;
  const size_t bh = (static_cast<size_t>(b) * H + h) * N;
  const int n0 = qt * kT;
  const float scale_log2 = scale * kLog2e;
  float* qs = smem;
  float* dos = smem + TL::kRow;
  float* mine = smem + (2 + 4 * warp) * TL::kRow;
  auto kst = [&](int st) { return mine + 2 * st * TL::kRow; };
  auto vst = [&](int st) { return mine + (2 * st + 1) * TL::kRow; };
  const int n_chunks = (N + kT - 1) / kT;
  const int n_mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;
  auto load = [&](int i, int st) {  // this warp's i-th chunk into stage st
    const int c0 = (warp + i * kWarps) * kT;
    stage16<DH, 32>(kst(st), k + base, ldt, c0, N, lane);
    stage16<DH, 32>(vst(st), v + base, ldt, c0, N, lane);
  };

  stage16<DH, kThreads>(qs, q + base, ldt, n0, N, t);
  stage16<DH, kThreads>(dos, dO + base, ldt, n0, N, t);
  if (n_mine > 0) load(0, 0);
  cp_async_commit();
  {  // D of row t / 8: its 8 threads' column eighths, then a butterfly
    const int r = t >> 3, c0 = (t & 7) * (DH / 8);
    float d = 0.f;
    if (n0 + r < N) {
      const size_t off = base + static_cast<size_t>(n0 + r) * ldt + c0;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) d = fmaf(dO[off + c], o[off + c], d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if ((t & 7) == 0) dd_s[r] = d;
  }
  cp_async_wait<0>();
  __syncthreads();

  if (qt == 0 && dprobs != nullptr) {
    // row 0's probability term: D_0 += sum_j P_0j dprobs_j over all keys
    const float lse2 = lse[bh] * kLog2e;
    float acc = 0.f;
    for (int j = t; j < N; j += kThreads) {
      const float* krow = k + base + static_cast<size_t>(j) * ldt;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + d);
        const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + d));
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      acc = fmaf(exp2f(s * scale_log2 - lse2), dprobs[bh + j], acc);
    }
#pragma unroll
    for (int mask = 16; mask > 0; mask /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, mask);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (t == 0) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += red[w];
      dd_s[0] += x;
    }
    __syncthreads();
  }

  // the lane's rows rg + 4 i: log2-domain lse and D (0 past N)
  float lse2[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + rg + 4 * i;
    lse2[i] = n < N ? lse[bh + n] * kLog2e : 0.f;
    dd[i] = dd_s[rg + 4 * i];
  }
  const bool row0 = qt == 0 && rg == 0 && dprobs != nullptr;

  float acc[4][TL::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) acc[i][c] = 0.f;
  for (int it = 0; it < n_mine; ++it) {
    if (it + 1 < n_mine) {
      load(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // chunk it has landed for every lane
    float* ks = kst(it & 1);
    float* vs = vst(it & 1);
    const int c0 = (warp + it * kWarps) * kT;
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    dot16<DH>(qs, ks, rg, kl, s);
    dot16<DH>(dos, vs, rg, kl, dp);
    __syncwarp();  // every lane has read V: dS takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + kl + 8 * j;
        const float p = c < N ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
        float g = dp[i][j];
        if (row0 && i == 0 && c < N) g += dprobs[bh + c];
        vs[(rg + 4 * i) * TL::kPLd + kl + 8 * j] = p * (g - dd[i]);
      }
    }
    __syncwarp();
    accum16<DH>(vs, ks, rg, kl, acc);  // dQ += dS K
    __syncwarp();  // the stage is free for the chunk two on
  }

  __syncthreads();  // every warp is done with its stages
  float* comb = smem + 2 * TL::kRow;
  store_partial<DH>(comb + warp * 4 * TL::kRow, rg, kl, acc);
  __syncthreads();
  combine_store<DH>(comb, 4 * TL::kRow, dq + base, ldt, n0, N, t, scale);
  if (t < kT && n0 + t < N) dsum[bh + n0 + t] = dd_s[t];
}

// dK and dV: key tile blockIdx.x of head blockIdx.y of batch row
// blockIdx.z. Shared memory: K, V, each warp's two stages of (Q, dO), then
// each warp's P^T and dS^T buffers; after the loop the warps' combine
// regions (dV, then dK) take the stages' place.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_f32_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dprobs,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int N, int H, float scale) {
  using TL = Tile<DH>;
  extern __shared__ __align__(16) float smem[];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rg = lane >> 3, kl = lane & 7;
  const size_t ldt = static_cast<size_t>(H) * DH;
  const size_t base = static_cast<size_t>(b) * N * ldt +
                      static_cast<size_t>(h) * DH;
  const size_t bh = (static_cast<size_t>(b) * H + h) * N;
  const int n0 = kt * kT;
  const float scale_log2 = scale * kLog2e;
  float* ks = smem;
  float* vs = smem + TL::kRow;
  float* mine = smem + (2 + 4 * warp) * TL::kRow;
  float* pbuf = smem + (2 + 4 * kWarps) * TL::kRow + warp * 2 * kT * TL::kPLd;
  float* sbuf = pbuf + kT * TL::kPLd;
  auto qst = [&](int st) { return mine + 2 * st * TL::kRow; };
  auto dost = [&](int st) { return mine + (2 * st + 1) * TL::kRow; };
  const int n_chunks = (N + kT - 1) / kT;
  const int n_mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;
  auto load = [&](int i, int st) {  // this warp's i-th query chunk
    const int c0 = (warp + i * kWarps) * kT;
    stage16<DH, 32>(qst(st), q + base, ldt, c0, N, lane);
    stage16<DH, 32>(dost(st), dO + base, ldt, c0, N, lane);
  };

  stage16<DH, kThreads>(ks, k + base, ldt, n0, N, t);
  stage16<DH, kThreads>(vs, v + base, ldt, n0, N, t);
  if (n_mine > 0) load(0, 0);
  cp_async_commit();
  // the lane's keys rg + 4 i: their CLS-probability gradient
  float dpr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + rg + 4 * i;
    dpr[i] = dprobs != nullptr && key < N ? dprobs[bh + key] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc_v[4][TL::kCols], acc_k[4][TL::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) acc_v[i][c] = acc_k[i][c] = 0.f;
  for (int it = 0; it < n_mine; ++it) {
    if (it + 1 < n_mine) {
      load(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // chunk it has landed for every lane
    const float* qs = qst(it & 1);
    const float* dos = dost(it & 1);
    const int c0 = (warp + it * kWarps) * kT;
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    dot16<DH>(ks, qs, rg, kl, s);    // S^T: keys x query rows
    dot16<DH>(vs, dos, rg, kl, dp);  // dP^T
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = c0 + kl + 8 * j;  // the query row
      const bool ok = n < N;
      const float lse2 = ok ? lse[bh + n] * kLog2e : 0.f;
      const float d = ok ? dsum[bh + n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2) : 0.f;
        const float g = n == 0 ? dp[i][j] + dpr[i] : dp[i][j];
        pbuf[(rg + 4 * i) * TL::kPLd + kl + 8 * j] = p;
        sbuf[(rg + 4 * i) * TL::kPLd + kl + 8 * j] = p * (g - d);
      }
    }
    __syncwarp();
    accum16<DH>(pbuf, dos, rg, kl, acc_v);  // dV += P^T dO
    accum16<DH>(sbuf, qs, rg, kl, acc_k);   // dK += dS^T Q
    __syncwarp();  // the stage and the buffers are free
  }

  __syncthreads();  // every warp is done with its stages
  float* comb = smem + 2 * TL::kRow;
  store_partial<DH>(comb + warp * 4 * TL::kRow, rg, kl, acc_v);
  store_partial<DH>(comb + warp * 4 * TL::kRow + TL::kComb, rg, kl, acc_k);
  __syncthreads();
  combine_store<DH>(comb, 4 * TL::kRow, dv + base, ldt, n0, N, t, 1.f);
  combine_store<DH>(comb + TL::kComb, 4 * TL::kRow, dk + base, ldt, n0, N, t,
                    scale);
}

static_assert(2 * Tile<64>::kComb <= 4 * Tile<64>::kRow &&
                  2 * Tile<16>::kComb <= 4 * Tile<16>::kRow,
              "a warp's combine regions fit in its stages");

template <int DH>
int launch_dh(const float* q, const float* k, const float* v, const float* o,
              const float* dO, const float* lse, const float* dprobs,
              float* dsum, float* dq, float* dk, float* dv, int B, int N,
              int H, float scale, cudaStream_t stream) {
  static size_t raised_dq = 0, raised_dkdv = 0;
  constexpr size_t kDq = dq_smem_bytes<DH>(), kDkdv = dkdv_smem_bytes<DH>();
  cudaError_t err = allow_smem(flash_attention_bwd_f32_dq_kernel<DH>, kDq,
                               &raised_dq);
  if (err == cudaSuccess)
    err = allow_smem(flash_attention_bwd_f32_dkdv_kernel<DH>, kDkdv,
                     &raised_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kT - 1) / kT, H, B);
  flash_attention_bwd_f32_dq_kernel<DH><<<grid, kThreads, kDq, stream>>>(
      q, k, v, o, dO, lse, dprobs, dsum, dq, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_f32_dkdv_kernel<DH><<<grid, kThreads, kDkdv, stream>>>(
      q, k, v, dO, lse, dprobs, dsum, dk, dv, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv [B, N, H, Dh] fp32 contiguous, each 16-byte
// aligned, Dh in {16, 64}, every key valid; lse [B, H, N] fp32, the
// forward's natural log-sum-exp per row; dprobs [B, H, N] fp32 or null,
// the gradient of the CLS row's per-head probabilities; dsum [B, H, N]
// fp32 scratch (each row's D, written by the dQ kernel, read by the dK/dV
// kernel). Two kernels on `stream`; nothing is synchronized.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, const void* dprobs, void* dsum, void* dq,
    void* dk, void* dv, int B, int N, int H, int Dh, float scale,
    void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 16)
    return launch_dh<16>(f(q), f(k), f(v), f(o), f(dO), f(lse), f(dprobs),
                         w(dsum), w(dq), w(dk), w(dv), B, N, H, scale, st);
  if (Dh == 64)
    return launch_dh<64>(f(q), f(k), f(v), f(o), f(dO), f(lse), f(dprobs),
                         w(dsum), w(dq), w(dk), w(dv), B, N, H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
