// The gradient of causal GQA attention over a whole sequence (training):
// dQ, dK and dV of o = softmax(scale Q K^T + mask) V, with Q.K^T, dO.V^T,
// P^T.dO, dS^T.Q and dS.K on the bf16 tensor cores.
//
// Replaces the gradient that JAX takes of the reference's train-mode
// attention, `flash_attention_jnp(q, k, v, causal=True, kv_start)`
// (src/repro/models/attention.py:311-313), whose forward is the Pallas
// kernel `_flash_kernel` (src/repro/kernels/flash_attention/
// flash_attention.py:25) in its causal mode with the GQA head repeat. The
// forward on the card is flash_prefill.cu, which also writes each row's
// log-sum-exp; `CausalAttention` (kernels/flash_attention/ops.py) pairs the
// two as an autograd function. Inputs: bf16 q, o, dO [B, N, Hq, Dh] and k,
// v [B, N, KV, Dh] (query head h reads KV head h / (Hq / KV) in place), fp32
// lse [B, Hq, N], optional kv_start [B]: query row i sees keys
// [kv_start[b], i + 1). Outputs bf16 dq [B, N, Hq, Dh] and dk, dv [B, N,
// KV, Dh]; each dk / dv row is the fp32 sum over its group's query heads,
// rounded once.
//
// Maths (FlashAttention-2's backward): D = rowsum(dO o O) in fp32; per
// (row, key) P = exp(scale s - lse), recomputed; dV += P^T dO; dP = dO V^T;
// dS = P o (dP - D); dK += scale dS^T Q; dQ += scale dS K. A row without a
// valid key (a pad row, only where kv_start is given) has P = 0 at every
// key: it adds nothing to dK, dV and gets dQ = 0 (its forward wrote 0).
//
// Bound on the H100, full-width StableLM-1.6B at batch 8, seq 512 (32
// heads, Dh 64): 3.4e7 causal (row, head, key) pairs, 10 Dh products each
// (2.1e10 FLOP). q, k, v, o, dO are read and dq, dk, dv written once: 134
// MB, 40 us at 3.35 TB/s; the products at the bf16 tensor-core rate take
// 22 us (35 us as this design runs them, P and dS split in two halves, 16
// Dh per pair): bound by bytes.
//
// Design: three kernels, no atomics. (1) `dot`: D per row, eight lanes per
// row, coalesced. (2) `dkdv`: a block of four warps owns 64 keys of one KV
// head; each warp holds its 16 keys' K and V as mma A fragments in
// registers and walks every query tile that sees them (64 rows of
// (position, head-in-group), position-major, so the group's query heads
// are rows like any other and their sum stays in the fp32 accumulators).
// It works in the transposed frame, keys as rows: S^T = K Q^T and dP^T = V
// dO^T take Q and dO as the B operand (ldmatrix), P^T and dS^T are the
// accumulators re-used as A fragments for dV += P^T dO and dK += dS^T Q
// (dO and Q by ldmatrix.trans), exactly the forward's data flow. (3) `dq`:
// the forward's blocking (64 rows of one KV head, each key tile staged
// once for the group), S = Q K^T, dP = dO V^T, dS, then dQ += dS K (K by
// ldmatrix.trans). Tiles are double-buffered with 16-byte cp.async; fp32 P
// and dS enter the tensor cores as two bf16 halves (mma16.cuh's
// split_hi_lo), as P does in the forward. Making it fast (wgmma, TMA, one
// pass for dQ and dK/dV) is later work.
#include <math.h>
#include <stdint.h>

#include "causal_tile.cuh"
#include "mma16.cuh"

namespace {

using causal::bf16;
using mma16::ldmatrix_x4;
using mma16::ldmatrix_x4_trans;
using mma16::mma;
using mma16::split_hi_lo;

constexpr int kRows = 64;      // query rows per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;  // four warps of 16 rows (or 16 keys)
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct BwdSmem {
  static constexpr int kLd = DH + 8;  // bf16 row stride: ldmatrix without
                                      // bank conflicts
  static constexpr int kTile = 64 * kLd;
  // six 64-row tiles (dkdv: K, V, two stages of Q, dO; dq: Q, dO, two
  // stages of K, V), then dkdv's per-row stats: two stages of lse, D and
  // position (64 each)
  static constexpr size_t kBytes =
      sizeof(bf16) * 6 * kTile + sizeof(float) * 2 * 3 * kRows;
};

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], fp32; DH / 8 lanes per
// row, one 16-byte piece of each operand per lane
template <int DH>
__global__ void __launch_bounds__(256)
flash_prefill_bwd_bf16_dot_kernel(const bf16* __restrict__ o,
                                  const bf16* __restrict__ dout,
                                  float* __restrict__ dsum, int N, int Hq,
                                  long long rows) {
  constexpr int kLanes = DH / 8;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long r = e / kLanes;  // row of [B, N, Hq]
  const int piece = static_cast<int>(e % kLanes);
  float s = 0.f;
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + r * DH + piece * 8);
    const uint4 c =
        *reinterpret_cast<const uint4*>(dout + r * DH + piece * 8);
    const bf16* ap = reinterpret_cast<const bf16*>(&a);
    const bf16* cp = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int x = 0; x < 8; ++x)
      s = fmaf(__bfloat162float(ap[x]), __bfloat162float(cp[x]), s);
  }
#pragma unroll
  for (int w = kLanes / 2; w > 0; w >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, w);
  if (r < rows && piece == 0) {
    const int h = static_cast<int>(r % Hq);
    const long long bi = r / Hq;  // b N + i
    const long long b = bi / N;
    const int i = static_cast<int>(bi % N);
    dsum[(b * Hq + h) * N + i] = s;
  }
}

// 16-byte pieces of 64 query rows (position, head-in-group) from row j0 on
// of KV head g, batch row b, into a [64][kLd] tile; rows past n_rows are 0
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int j0, int n_rows, int N, int Hq,
                                          int g, int per, int t) {
  constexpr int kChunks = DH / 8, kLd = DH + 8;
  for (int e = t; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks, j = j0 + r;
    const bool ok = j < n_rows;
    const size_t at =
        ok ? ((static_cast<size_t>(b) * N + j / per) * Hq + g * per +
              j % per) * DH + ch * 8
           : 0;
    cp_async16(dst + r * kLd + ch * 8, src + at, ok);
  }
}

// 16-byte pieces of 64 keys from key c0 on of KV head g into a [64][kLd]
// tile; keys outside [lo, hi) are 0
template <int DH>
__device__ __forceinline__ void load_keys(bf16* dst, const bf16* src, int b,
                                          int c0, int lo, int hi, int N,
                                          int KV, int g, int t) {
  constexpr int kChunks = DH / 8, kLd = DH + 8;
  for (int e = t; e < kKeys * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks, c = c0 + r;
    const bool ok = c >= lo && c < hi;
    const size_t at =
        ok ? ((static_cast<size_t>(b) * N + c) * KV + g) * DH + ch * 8 : 0;
    cp_async16(dst + r * kLd + ch * 8, src + at, ok);
  }
}

// c[16 x 64] += a[16 x DH] b[64 x DH]^T: a as A fragments, b's rows (the
// product's columns) in a [64][kLd] tile
template <int DH>
__device__ __forceinline__ void mma_abt(float (&c)[kKeys / 8][4],
                                        const uint32_t (&a)[DH / 16][4],
                                        const bf16* bs, int lane) {
  constexpr int kLd = DH + 8;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t f[4];
      ldmatrix_x4(f, bs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                         kd * 16 + ((lane >> 3) & 1) * 8);
      mma<bf16>(c[2 * np], a[kd], f[0], f[1]);
      mma<bf16>(c[2 * np + 1], a[kd], f[2], f[3]);
    }
  }
}

// acc[16 x DH] += x[16 x 64] b[64 x DH]: x an fp32 accumulator (its 16-column
// pieces are the A fragments, each split into two bf16 halves), b a
// [64][kLd] tile read transposed
template <int DH>
__device__ __forceinline__ void mma_xb(float (&acc)[DH / 8][4],
                                       const float (&x)[kKeys / 8][4],
                                       const bf16* bs, int lane) {
  constexpr int kLd = DH + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ph[4], pl[4];
    split_hi_lo<bf16>(x[2 * kk][0], x[2 * kk][1], ph[0], pl[0]);
    split_hi_lo<bf16>(x[2 * kk][2], x[2 * kk][3], ph[1], pl[1]);
    split_hi_lo<bf16>(x[2 * kk + 1][0], x[2 * kk + 1][1], ph[2], pl[2]);
    split_hi_lo<bf16>(x[2 * kk + 1][2], x[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, bs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * kLd +
                               dp * 16 + (lane >> 4) * 8);
      mma<bf16>(acc[2 * dp], ph, f[0], f[1]);
      mma<bf16>(acc[2 * dp], pl, f[0], f[1]);
      mma<bf16>(acc[2 * dp + 1], ph, f[2], f[3]);
      mma<bf16>(acc[2 * dp + 1], pl, f[2], f[3]);
    }
  }
}

// this warp's 16 rows of a [64][kLd] tile as A fragments over all of DH
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4],
                                       const bf16* s, int warp, int lane) {
  constexpr int kLd = DH + 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(a[ks], s + (warp * 16 + (lane & 15)) * kLd + ks * 16 +
                           (lane >> 4) * 8);
}

// store an fp32 accumulator [16 x DH] (rows ra, ra + 8 of this thread) as
// bf16 rows, times `scale`; `row_a` / `row_b` null where a row is not stored
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4],
                                           bf16* row_a, bf16* row_b,
                                           float scale, int lane) {
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    bf16* row = x == 0 ? row_a : row_b;
    if (row == nullptr) continue;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + col) =
          __floats2bfloat162_rn(acc[i][2 * x] * scale,
                                acc[i][2 * x + 1] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_bwd_bf16_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const int* __restrict__ kv_start, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int N, int Hq, int KV, float scale) {
  using L = BwdSmem<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::kTile;
  bf16* rows = vs + L::kTile;  // stage s: Q at 2 s tiles, dO at 2 s + 1
  float* stats = reinterpret_cast<float*>(rows + 4 * L::kTile);
  // stage s: lse at 3 kRows s, D at 3 kRows s + kRows, position (int) at
  // 3 kRows s + 2 kRows

  // the first key tiles are seen by the most rows: launched first
  const int g = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * kKeys;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int per = Hq / KV;
  const int n_rows = N * per;
  const int lo = kv_start != nullptr ? max(kv_start[b], 0) : 0;
  // rows at positions >= max(c0, lo) see a key of this tile, if any does
  const int j0 = max(c0, lo) * per;
  const int n_tiles =
      c0 + kKeys > lo && j0 < n_rows ? (n_rows - j0 + kRows - 1) / kRows : 0;
  const float scale_log2 = scale * kLog2e;

  auto load_tile = [&](int u, int stage) {
    const int jt = j0 + u * kRows;
    load_rows<DH>(rows + 2 * stage * L::kTile, q, b, jt, n_rows, N, Hq, g,
                  per, t);
    load_rows<DH>(rows + (2 * stage + 1) * L::kTile, dout, b, jt, n_rows, N,
                  Hq, g, per, t);
    if (t < kRows) {
      float* st = stats + 3 * kRows * stage;
      const int j = jt + t;
      if (j < n_rows) {
        const size_t at =
            (static_cast<size_t>(b) * Hq + g * per + j % per) * N + j / per;
        cp_async4(st + t, lse + at);
        cp_async4(st + kRows + t, dsum + at);
        reinterpret_cast<int*>(st + 2 * kRows)[t] = j / per;
      } else {  // no such row: nothing seen, nothing added
        st[t] = 0.f;
        st[kRows + t] = 0.f;
        reinterpret_cast<int*>(st + 2 * kRows)[t] = -1;
      }
    }
  };

  load_keys<DH>(ks, k, b, c0, 0, N, N, KV, g, t);
  load_keys<DH>(vs, v, b, c0, 0, N, N, KV, g, t);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 keys of K and V as A fragments
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a<DH>(ka, ks, warp, lane);
  load_a<DH>(va, vs, warp, lane);
  // this thread's two keys (accumulator rows lane / 4 and lane / 4 + 8)
  const int key_a = c0 + warp * 16 + (lane >> 2), key_b = key_a + 8;
  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[i][x] = dva[i][x] = 0.f;

  for (int u = 0; u < n_tiles; ++u) {
    const int stage = u & 1;
    if (u + 1 < n_tiles) {
      load_tile(u + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = rows + 2 * stage * L::kTile;
    const bf16* dos = qs + L::kTile;
    const float* st = stats + 3 * kRows * stage;
    const int* pos = reinterpret_cast<const int*>(st + 2 * kRows);

    // P^T = exp(scale K Q^T - lse): 16 keys x 64 rows per warp, 0 where the
    // row does not see the key
    float s[kRows / 8][4];
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_abt<DH>(s, ka, qs, lane);
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + (lane & 3) * 2 + (i & 1);
        const int c = i < 2 ? key_a : key_b;
        const bool seen = c >= lo && c <= pos[col];
        s[nt][i] = seen ? exp2f(fmaf(s[nt][i], scale_log2, -st[col] * kLog2e))
                        : 0.f;
      }
    }
    // dV += P^T dO
    mma_xb<DH>(dva, s, dos, lane);
    // dP^T = V dO^T, then dS^T = P^T o (dP^T - D)
    float dp[kRows / 8][4];
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i)
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    mma_abt<DH>(dp, va, dos, lane);
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + (lane & 3) * 2 + (i & 1);
        s[nt][i] = s[nt][i] * (dp[nt][i] - st[kRows + col]);
      }
    }
    // dK += dS^T Q (scaled at the store)
    mma_xb<DH>(dka, s, qs, lane);
    __syncthreads();  // this stage is free for the load two tiles on
  }

  const size_t kv_row = static_cast<size_t>(KV) * DH;
  const size_t base = (static_cast<size_t>(b) * N * KV + g) * DH;
  store_rows<DH>(dka, key_a < N ? dk + base + key_a * kv_row : nullptr,
                 key_b < N ? dk + base + key_b * kv_row : nullptr, scale,
                 lane);
  store_rows<DH>(dva, key_a < N ? dv + base + key_a * kv_row : nullptr,
                 key_b < N ? dv + base + key_b * kv_row : nullptr, 1.f, lane);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_bwd_bf16_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const int* __restrict__ kv_start, bf16* __restrict__ dq, int N, int Hq,
    int KV, float scale) {
  using L = BwdSmem<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::kTile;
  bf16* kvs = dos + L::kTile;  // stage s: K at 2 s tiles, V at 2 s + 1

  // the last row tiles see the most keys: launched first
  const int g = blockIdx.x, b = blockIdx.y, rt = gridDim.z - 1 - blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int per = Hq / KV;
  const int n_rows = N * per;
  const int r0 = rt * kRows;
  const int lo = kv_start != nullptr ? max(kv_start[b], 0) : 0;
  // keys any row of the block sees: [lo, last position + 1)
  const int block_hi = (min(r0 + kRows, n_rows) - 1) / per + 1;
  const int t0 = lo / kKeys;
  const int t1 = block_hi > lo ? (block_hi + kKeys - 1) / kKeys : t0;
  const float scale_log2 = scale * kLog2e;

  auto load_kv = [&](int tile, int stage) {
    bf16* ks = kvs + 2 * stage * L::kTile;
    load_keys<DH>(ks, k, b, tile * kKeys, lo, block_hi, N, KV, g, t);
    load_keys<DH>(ks + L::kTile, v, b, tile * kKeys, lo, block_hi, N, KV, g,
                  t);
  };
  load_rows<DH>(qs, q, b, r0, n_rows, N, Hq, g, per, t);
  load_rows<DH>(dos, dout, b, r0, n_rows, N, Hq, g, per, t);
  if (t0 < t1) load_kv(t0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a<DH>(qa, qs, warp, lane);
  load_a<DH>(da, dos, warp, lane);
  // this thread's two rows: position (-1 past the end), lse in log2 units, D
  int pos[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = r0 + warp * 16 + (lane >> 2) + 8 * x;
    pos[x] = -1;
    lse2[x] = dd[x] = 0.f;
    if (j < n_rows) {
      const size_t at =
          (static_cast<size_t>(b) * Hq + g * per + j % per) * N + j / per;
      pos[x] = j / per;
      lse2[x] = lse[at] * kLog2e;
      dd[x] = dsum[at];
    }
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = t0; kt < t1; ++kt) {
    const int stage = (kt - t0) & 1;
    if (kt + 1 < t1) {
      load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kvs + 2 * stage * L::kTile;
    const bf16* vs = ks + L::kTile;

    // P = exp(scale Q K^T - lse), 0 at keys the row does not see
    float s[kKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_abt<DH>(s, qa, ks, lane);
    const int c0 = kt * kKeys;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + nt * 8 + (lane & 3) * 2 + (i & 1);
        const int x = i >> 1;
        s[nt][i] = c >= lo && c <= pos[x]
                       ? exp2f(fmaf(s[nt][i], scale_log2, -lse2[x]))
                       : 0.f;
      }
    }
    // dP = dO V^T, then dS = P o (dP - D)
    float dp[kKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    mma_abt<DH>(dp, da, vs, lane);
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[nt][i] = s[nt][i] * (dp[nt][i] - dd[i >> 1]);
    // dQ += dS K (scaled at the store)
    mma_xb<DH>(acc, s, ks, lane);
    __syncthreads();  // this stage is free for the load two tiles on
  }

  bf16* out[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = r0 + warp * 16 + (lane >> 2) + 8 * x;
    out[x] = j < n_rows
                 ? dq + ((static_cast<size_t>(b) * N + j / per) * Hq +
                         g * per + j % per) * DH
                 : nullptr;
  }
  store_rows<DH>(acc, out[0], out[1], scale, lane);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* kv_start,
           void* dsum, void* dq, void* dk, void* dv, int B, int N, int Hq,
           int KV, float scale, cudaStream_t stream) {
  static size_t raised_dkdv = 0, raised_dq = 0;
  constexpr size_t kBytes = BwdSmem<DH>::kBytes;
  cudaError_t err = allow_smem(flash_prefill_bwd_bf16_dkdv_kernel<DH>,
                               kBytes, &raised_dkdv);
  if (err == cudaSuccess)
    err = allow_smem(flash_prefill_bwd_bf16_dq_kernel<DH>, kBytes,
                     &raised_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  float* dsf = static_cast<float*>(dsum);
  const int* start = static_cast<const int*>(kv_start);

  const long long rows = static_cast<long long>(B) * N * Hq;
  const long long threads = rows * (DH / 8);
  flash_prefill_bwd_bf16_dot_kernel<DH>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
          static_cast<const bf16*>(o), dob, dsf, N, Hq, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_bwd_bf16_dkdv_kernel<DH>
      <<<dim3(KV, B, (N + kKeys - 1) / kKeys), kThreads, kBytes, stream>>>(
          qb, kb, vb, dob, lsef, dsf, start, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), N, Hq, KV, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_bwd_bf16_dq_kernel<DH>
      <<<dim3(KV, B, (N * (Hq / KV) + kRows - 1) / kRows), kThreads, kBytes,
         stream>>>(qb, kb, vb, dob, lsef, dsf, start, static_cast<bf16*>(dq),
                   N, Hq, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [B, N, Hq, Dh] and k, v, dk, dv [B, N, KV, Dh], bf16
// contiguous and 16-byte aligned, KV dividing Hq, Dh in {16, 64}; lse [B,
// Hq, N] fp32 as flash_prefill_bf16 writes it; kv_start [B] int32 or null
// (0): query row i of batch row b sees keys [kv_start[b], i + 1); dsum [B,
// Hq, N] fp32 scratch. Three launches on `stream`: D, then dK and dV, then
// dQ.
extern "C" int flash_prefill_bwd_bf16(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      const void* kv_start, void* dsum,
                                      void* dq, void* dk, void* dv, int B,
                                      int N, int Hq, int KV, int Dh,
                                      float scale, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || B > 65535 || KV > 65535 ||
      static_cast<long long>(N) * (Hq / KV) > 65535LL * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 16)
    return launch<16>(q, k, v, o, dout, lse, kv_start, dsum, dq, dk, dv, B,
                      N, Hq, KV, scale, st);
  if (Dh == 64)
    return launch<64>(q, k, v, o, dout, lse, kv_start, dsum, dq, dk, dv, B,
                      N, Hq, KV, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
