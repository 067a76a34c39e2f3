// The gradient of the non-causal fp32 attention on Hopper: the ViT's
// training (Algorithm 1), with the gradient of the CLS row's attention
// probabilities (the TDM's scores) folded into the same pass.
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
// natural log-sum-exp) and dprobs or null, the gradient of the CLS row's
// per-head probabilities, element (b, h, j) at b sb + h sh + j (the head
// mean's gradient is a broadcast view, sh = 0). Outputs dq, dk, dv [B, N,
// H, Dh] fp32. With s = scale q.k:
//   P = exp(s - lse), D = rowsum(dO o O), dP = dO V^T, dS = P o (dP - D),
//   dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
// The CLS probabilities are row 0 of P (the same scores, the same scale),
// so their gradient enters the same dS: for row 0 only, dP_0j += dprobs_j
// and D_0 += sum_j P_0j dprobs_j (the softmax's Jacobian).
//
// Bound on the H100 at the training shapes (DeiT-Small, batch 64, 6 heads,
// Dh 64, N = 197 at layers 0-2, 140, 100 and 72 after each TDM): five
// products of 2 N^2 Dh operations per (b, h), all fp32 on the CUDA cores
// (no TF32: the fp32 tier keeps full fp32 products); at N = 197 that is
// 9.5e9 operations a call, 0.142 ms at 67 TFLOP/s, against 0.046 ms for
// its 155 MB: bound by operations. What feeds the FP32 lanes is shared
// memory: an SM moves 128 bytes a clock into registers (a warp's 16-byte
// load takes four clocks, broadcast or not) against 128 FFMA, so a thread
// must do 4 FFMA for each float it reads to keep the lanes busy. 8 x 8
// register tiles do (dV and dK here), 8 x 4 do 2.7 (S and dP), 4 x 4 do 2
// (dQ). 8 x 8 tiles in S, dP or dQ need a trade of partial sums between
// warps, which cost what the larger tiles saved when measured; at 216
// registers a thread, two blocks share an SM.
//
// Design: two kernels per launch, each product done once.
//   The main kernel: one block of four warps per (64-key tile, head, batch
// row). It holds the tile's K and V in shared memory and dK, dV in
// registers, and walks the query rows in tiles of 32, Q, dO and O staged
// one tile ahead by 16-byte cp.async. Per query tile:
//   S = Q K^T (warps 0, 1) and dP = dO V^T (warps 2, 3), each warp 32 keys
//   on 8 x 4 register tiles (a ragged last tile only on the rows it has);
//   warps 0, 1 form P from lse and park it;
//   dV += P^T dO (warps 0, 1), and warps 2, 3 take D from the staged dO
//   and O, form dS and park dS and dS^T, then dK += dS^T Q; 8 x 8 tiles,
//   each warp 32 of the tile's keys;
//   the tile's partial dQ = dS K_tile, 4 x 4 tiles over the tile's keys,
//   stored to a scratch [T, B, N, H, Dh] at the key tile's index.
// Row 0's term sum_j P_0j dprobs_j needs every key: each block sums it
// over all keys, in the same threads and order, so every block holds the
// same bits.
//   The sum kernel: dQ = scale x the T partials of each element, added in
// key-tile order.
// The partials go through device memory rather than a thread-block
// cluster's shared memory: summing each query tile across a cluster took a
// cluster barrier a tile, and the blocks then ran in lockstep with the
// slowest (a 5-key last tile at N = 197 held its SM as long as a full
// one); measured, that cost more than the sum kernel does.
// No atomics, every sum in a fixed order: two launches are bitwise equal.
// Rows and keys past N are staged as zeros and masked to P = 0; warps
// whose keys all lie past N skip their products.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kKT = 64;  // keys of a key tile
constexpr int kQT = 32;  // rows of a query tile
constexpr int kThreads = 128;
constexpr int kXLd = kKT + 8;  // rows of the parked P and dS (conflict-free
                               // scalar stores of 4 rows x 8 keys)
constexpr int kTLd = kQT + 4;  // rows of the parked dS^T
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  // staged rows, padded so that the float4 reads of 4 or 8 rows fall in
  // distinct banks
  static constexpr int kLd = DH + 4;
  // dK / dV: kG keys x 4 kCh columns a thread (columns 4 g + 4 kG c of
  // column group g); dQ: kR rows x 4 columns a thread
  static constexpr int kG = DH >= 64 ? 8 : 4;
  static constexpr int kCh = DH / (4 * kG);
  static constexpr int kR = kQT * DH / (4 * kThreads);
  static constexpr int kT = kKT * kTLd > kQT * kLd ? kKT * kTLd : kQT * kLd;
  // K, V; two stages of (Q, dO); P, dS; two of O, then dS^T
  static constexpr int kFloats =
      2 * kKT * kLd + 4 * kQT * kLd + 2 * kQT * kXLd + 2 * kT;
  static_assert(kG * kCh * 4 == DH, "the d groups cover Dh");
  static_assert(kR >= 1, "dQ splits over the threads");
};

// Copy rows r0 .. r0 + ROWS - 1 of one head of a [*, H, DH] fp32 operand
// (token stride ldt) into shared rows kLd apart by 16-byte cp.async, rows
// at or past `end` zero-filled; thread t of the block.
template <int DH, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t ldt, int r0, int end, int t) {
  constexpr int kCopies = ROWS * DH / 4;
  static_assert(kCopies % kThreads == 0, "a tile stages evenly");
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int e = t + i * kThreads;
    const int r = e / (DH / 4), ch = e % (DH / 4), n = r0 + r;
    const bool ok = n < end;
    cp_async16(dst + r * Tile<DH>::kLd + ch * 4,
               src + (ok ? static_cast<size_t>(n) * ldt + ch * 4 : 0), ok);
  }
}

// W consecutive floats of shared memory, W / 4 float4s (W 4 or 8) or one.
template <int W>
__device__ __forceinline__ void load_w(const float* p, float (&x)[W]) {
  if constexpr (W == 1) {
    x[0] = *p;
  } else {
    static_assert(W % 4 == 0, "whole float4s");
#pragma unroll
    for (int w = 0; w < W; w += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + w);
      x[w] = v.x;
      x[w + 1] = v.y;
      x[w + 2] = v.z;
      x[w + 3] = v.w;
    }
  }
}

// acc[r][4 c + e] += sum_j a[j][r] m[j][4 G c + e] for j in [0, n) in
// order: R floats of row j of a (rows lda apart), CH float4s of row j of m
// (rows ldm apart, G float4s apart).
template <int R, int G, int CH>
__device__ __forceinline__ void outer(const float* a, int lda,
                                      const float* m, int ldm, int n,
                                      float (&acc)[R][4 * CH]) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float x[R];
    load_w<R>(a + j * lda, x);
    float4 y[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c)
      y[c] = *reinterpret_cast<const float4*>(m + j * ldm + 4 * G * c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        acc[r][4 * c] = fmaf(x[r], y[c].x, acc[r][4 * c]);
        acc[r][4 * c + 1] = fmaf(x[r], y[c].y, acc[r][4 * c + 1]);
        acc[r][4 * c + 2] = fmaf(x[r], y[c].z, acc[r][4 * c + 2]);
        acc[r][4 * c + 3] = fmaf(x[r], y[c].w, acc[r][4 * c + 3]);
      }
    }
  }
}

// acc[i][j] += sum_d a[r_i][d] b[8 j][d] over d < DH in order, for rows
// r_i = 4 i of a (i < I) and rows 8 j of b (j < 4), rows kLd apart: a
// lane's 8 x 4 tile of S or dP (I < 8 on a ragged last tile).
template <int DH, int I>
__device__ __forceinline__ void dot_tile(const float* am, const float* bm,
                                         float (&acc)[8][4]) {
  constexpr int kLd = Tile<DH>::kLd;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[I];
#pragma unroll
    for (int i = 0; i < I; ++i)
      a[i] = *reinterpret_cast<const float4*>(am + 4 * i * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(bm + 8 * j * kLd + d);
#pragma unroll
      for (int i = 0; i < I; ++i) {
        acc[i][j] = fmaf(a[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// Grid (T, H, B): key tile blockIdx.x of head blockIdx.y of batch row
// blockIdx.z. The design is in the head comment.
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dprobs, long long dp_sb, long long dp_sh,
    float* __restrict__ dq_part, float* __restrict__ dk,
    float* __restrict__ dv, int N, int H, float scale) {
  using TL = Tile<DH>;
  constexpr int kLd = TL::kLd, kG = TL::kG, kCh = TL::kCh, kR = TL::kR;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32];
  __shared__ float dd_s[kQT];  // D of the tile's rows
  __shared__ float dpk_s[kKT];  // dprobs at the tile's keys

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // pair 0 (warps 0, 1): S, P, dV; pair 1 (warps 2, 3): dP, D, dS, dK;
  // half: the warp's 32 keys of the tile
  const int pair = warp >> 1, half = warp & 1, p = t & 63;
  const size_t ldt = static_cast<size_t>(H) * DH;
  const size_t base = static_cast<size_t>(b) * N * ldt +
                      static_cast<size_t>(h) * DH;
  const size_t bh = (static_cast<size_t>(b) * H + h) * N;
  const float scale_log2 = scale * kLog2e;
  const int key0 = blockIdx.x * kKT, nk = min(kKT, N - key0);
  float* ks = smem;
  float* vs = ks + kKT * kLd;
  float* stg = vs + kKT * kLd;  // stage s: Q, dO at stg + 2 s kQT kLd
  float* xp = stg + 4 * kQT * kLd;  // P [row][key]
  float* xds = xp + kQT * kXLd;  // dS [row][key]
  float* trs = xds + kQT * kXLd;  // stage s: O at trs + s kT, then dS^T
  const int nqt = (N + kQT - 1) / kQT;
  const float* dpr =
      dprobs == nullptr ? nullptr : dprobs + b * dp_sb + h * dp_sh;
  float* part = dq_part + static_cast<size_t>(blockIdx.x) *
                              gridDim.z * N * ldt;  // this key tile's dQ

  auto load_tile = [&](int tile, int s) {
    float* dst = stg + 2 * s * kQT * kLd;
    stage<DH, kQT>(dst, q + base, ldt, tile * kQT, N, t);
    stage<DH, kQT>(dst + kQT * kLd, dO + base, ldt, tile * kQT, N, t);
    stage<DH, kQT>(trs + s * TL::kT, o + base, ldt, tile * kQT, N, t);
  };
  // phase A: rows qg + 4 i (i < 8), keys kc + 8 j (j < 4)
  const int qg = lane >> 3, kc = 32 * half + (lane & 7);
  float lse2[8];  // pair 0: log2-domain lse of the tile's rows qg + 4 i
  auto load_lse = [&](int q0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = q0 + qg + 4 * i;
      lse2[i] = pair == 0 && n < N ? lse[bh + n] * kLog2e : 0.f;
    }
  };

  stage<DH, kKT>(ks, k + base, ldt, key0, N, t);
  stage<DH, kKT>(vs, v + base, ldt, key0, N, t);
  load_tile(0, 0);
  cp_async_commit();
  load_lse(0);
  if (t < kKT) dpk_s[t] = dpr != nullptr && t < nk ? dpr[key0 + t] : 0.f;

  // row 0's term c0 = sum_j P_0j dprobs_j over all keys, the same threads
  // and order in every block
  float c0 = 0.f;
  if (dpr != nullptr) {
    const float lse0 = lse[bh] * kLog2e;
    const float4* q0v = reinterpret_cast<const float4*>(q + base);
    float acc = 0.f;
    for (int j = t; j < N; j += kThreads) {
      const float4* kr = reinterpret_cast<const float4*>(
          k + base + static_cast<size_t>(j) * ldt);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH / 4; ++d) {
        const float4 a = __ldg(q0v + d), c = __ldg(kr + d);
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      acc = fmaf(exp2f(s * scale_log2 - lse0), dpr[j], acc);
    }
#pragma unroll
    for (int mask = 16; mask > 0; mask /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, mask);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) c0 += red[w];
  }

  // dV / dK: keys kb + kk (kk < kG), column group gb; dQ: rows qr + r
  // (r < kR), columns 4 gq ..
  const int kb = p / kG * kG, gb = p % kG;
  const int qr = t / (DH / 4) * kR, gq = t % (DH / 4);
  const bool keys_live = 32 * half < nk;
  float accb[kG][4 * kCh];  // dV (pair 0) or dK (pair 1)
#pragma unroll
  for (int kk = 0; kk < kG; ++kk)
#pragma unroll
    for (int c = 0; c < 4 * kCh; ++c) accb[kk][c] = 0.f;
  for (int tile = 0; tile < nqt; ++tile) {
    const int q0 = tile * kQT, nq = min(kQT, N - q0);
    cp_async_wait<0>();
    __syncthreads();  // the tile has landed; the last tile's readers are done
    if (tile + 1 < nqt) {
      load_tile(tile + 1, (tile + 1) & 1);
      cp_async_commit();
    }
    const float* qs = stg + 2 * (tile & 1) * kQT * kLd;
    const float* dos = qs + kQT * kLd;
    float* tr = trs + (tile & 1) * TL::kT;  // O, then dS^T

    // phase A: S (pair 0) or dP (pair 1) on rows qg + 4 i (i < 8) and
    // keys kc + 8 j (j < 4) of the warp's 32, Dh in order
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (keys_live) {  // rows past the last tile's nq are left at 0
      const float* am = (pair == 0 ? qs : dos) + qg * kLd;
      const float* bm = (pair == 0 ? ks : vs) + kc * kLd;
      if (nq > 16)
        dot_tile<DH, 8>(am, bm, acc);
      else if (nq > 8)
        dot_tile<DH, 4>(am, bm, acc);
      else if (nq > 4)
        dot_tile<DH, 2>(am, bm, acc);
      else
        dot_tile<DH, 1>(am, bm, acc);
    }
    if (pair == 0) {  // P from lse, 0 past N
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = qg + 4 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = kc + 8 * j;
          xp[row * kXLd + key] = q0 + row < N && key < nk
                                     ? exp2f(acc[i][j] * scale_log2 - lse2[i])
                                     : 0.f;
        }
      }
    }
    __syncthreads();  // P is in
    if (tile + 1 < nqt) load_lse(q0 + kQT);

    // phase B: dV += P^T dO (pair 0); D, dS, then dK += dS^T Q (pair 1);
    // each warp over its 32 keys
    if (pair == 1) {
      {  // D of row p / 2: two threads' column halves
        const int r = p >> 1, c = (p & 1) * (DH / 2);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < DH / 2; e += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(dos + r * kLd + c + e);
          const float4 y =
              *reinterpret_cast<const float4*>(tr + r * kLd + c + e);
          d = fmaf(x.x, y.x, d);
          d = fmaf(x.y, y.y, d);
          d = fmaf(x.z, y.z, d);
          d = fmaf(x.w, y.w, d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if ((p & 1) == 0) dd_s[r] = d;
      }
      asm volatile("bar.sync 1, 64;\n" ::: "memory");  // D is in
      // every load before any store: a shared store would order the loads
      // after it
      float pv[8][4], dd[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = qg + 4 * i;
        dd[i] = dd_s[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[i][j] = xp[row * kXLd + kc + 8 * j];
      }
      if (q0 == 0 && qg == 0 && dpr != nullptr) {  // row 0: the CLS term
        dd[0] += c0;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0][j] += dpk_s[kc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = qg + 4 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = kc + 8 * j;
          const float ds = pv[i][j] * (acc[i][j] - dd[i]);
          xds[row * kXLd + key] = ds;
          tr[key * kTLd + row] = ds;
        }
      }
      asm volatile("bar.sync 1, 64;\n" ::: "memory");  // dS is in
    }
    if (keys_live)
      outer<kG, kG, kCh>((pair == 0 ? xp : xds) + kb, kXLd,
                         (pair == 0 ? dos : qs) + 4 * gb, kLd, nq, accb);
    __syncthreads();  // dS^T is in

    // phase C: the tile's partial dQ = dS K_tile, keys in order, stored to
    // this key tile's scratch
    if (qr < nq) {
      float accq[kR][4];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        accq[r][0] = accq[r][1] = accq[r][2] = accq[r][3] = 0.f;
      outer<kR, 1, 1>(tr + qr, kTLd, ks + 4 * gq, kLd, max(nk, 0), accq);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (q0 + qr + r >= N) break;
        *reinterpret_cast<float4*>(
            part + base + static_cast<size_t>(q0 + qr + r) * ldt + 4 * gq) =
            make_float4(accq[r][0], accq[r][1], accq[r][2], accq[r][3]);
      }
    }
  }

  // dV and dK of the tile's keys
  float* out = pair == 0 ? dv : dk;
  const float mult = pair == 0 ? 1.f : scale;
#pragma unroll
  for (int kk = 0; kk < kG; ++kk) {
    const int key = key0 + kb + kk;
    if (key >= N) break;
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      *reinterpret_cast<float4*>(out + base + static_cast<size_t>(key) * ldt +
                                 4 * gb + 4 * kG * c) =
          make_float4(accb[kk][4 * c] * mult, accb[kk][4 * c + 1] * mult,
                      accb[kk][4 * c + 2] * mult, accb[kk][4 * c + 3] * mult);
  }
}

// dq = scale x the sum over the T key tiles of their partials, in tile
// order: n4 float4s, the tiles n4 float4s apart. It walks the float4s from
// the last: the main kernel's last blocks (the last batch rows) wrote
// theirs last, so those are the ones still in L2.
__global__ void __launch_bounds__(256)
flash_attention_bwd_f32_dq_sum_kernel(const float4* __restrict__ part,
                                      float4* __restrict__ dq, size_t n4,
                                      int T, float scale) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n4; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t i = n4 - 1 - e;
    float4 s = part[i];
    for (int r = 1; r < T; ++r) {
      const float4 x = part[r * n4 + i];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    dq[i] = make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
  }
}

template <int DH>
int launch_dh(const float* q, const float* k, const float* v, const float* o,
              const float* dO, const float* lse, const float* dprobs,
              long long dp_sb, long long dp_sh, float* dq_part, float* dq,
              float* dk, float* dv, int B, int N, int H, float scale,
              cudaStream_t stream) {
  static size_t raised = 0;
  constexpr size_t kBytes = sizeof(float) * Tile<DH>::kFloats;
  cudaError_t err =
      allow_smem(flash_attention_bwd_f32_kernel<DH>, kBytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (N + kKT - 1) / kKT;
  flash_attention_bwd_f32_kernel<DH><<<dim3(T, H, B), kThreads, kBytes,
                                       stream>>>(
      q, k, v, o, dO, lse, dprobs, dp_sb, dp_sh, dq_part, dk, dv, N, H,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(B) * N * H * DH / 4;
  const size_t blocks = n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16;
  flash_attention_bwd_f32_dq_sum_kernel<<<static_cast<unsigned>(blocks), 256,
                                          0, stream>>>(
      reinterpret_cast<const float4*>(dq_part),
      reinterpret_cast<float4*>(dq), n4, T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv [B, N, H, Dh] fp32 contiguous, each 16-byte
// aligned, Dh in {16, 64}, every key valid; lse [B, H, N] fp32 contiguous,
// the forward's natural log-sum-exp per row; dprobs fp32 or null, the
// gradient of the CLS row's per-head probabilities, (b, h, j) at dprobs +
// b dp_sb + h dp_sh + j (strides in elements, any sign or 0); dq_part fp32
// scratch of ceil(N / 64) x B N H Dh, 16-byte aligned (each key tile's
// partial dQ). Two kernels on `stream`; nothing is synchronized.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, const void* dprobs, void* dq_part,
    void* dq, void* dk, void* dv, int B, int N, int H, int Dh,
    long long dp_sb, long long dp_sh, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 16)
    return launch_dh<16>(f(q), f(k), f(v), f(o), f(dO), f(lse), f(dprobs),
                         dp_sb, dp_sh, w(dq_part), w(dq), w(dk), w(dv), B, N,
                         H, scale, st);
  if (Dh == 64)
    return launch_dh<64>(f(q), f(k), f(v), f(o), f(dO), f(lse), f(dprobs),
                         dp_sb, dp_sh, w(dq_part), w(dq), w(dk), w(dv), B, N,
                         H, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
