// RWKV6's WKV recurrence on Hopper, fp32 state: for every step t, per head,
//   y[t] = r[t] . (s + (u (*) k[t]) (outer) v[t]),   s = s (*) w[t] + k[t] (outer) v[t]
// (s [dh, dh] indexed [d, e], w and u scaling its rows d), over a whole
// sequence in one launch, the final state written beside y.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `jax.lax.scan` (src/repro/models/ssm.py:234, `_wkv_sequential`), which
// XLA keeps on the device. In the port a Python loop would issue about
// eight launches a token a layer, and the recurrent families re-prefill the
// whole batch at every admission, so the scan is a kernel on the serve
// path. (`_wkv_chunked`, the reference's chunked form for `rwkv_chunk` >
// 0, stays tensor code: no shipped config sets it.)
//
// Bound. Decode (S = 1): the state's bytes, read once and written once: at
// RWKV6-1.6B's widths (32 heads of dh 64) and B = 4, 2 MiB a layer, ~1.3 us
// at 3.35 TB/s. Prefill: operations. Each (d, e, t) costs 7 fp32
// operations (k v, u k v, the sum with s, r times it summed into y, s w
// plus k v): at B = 4, S = 512 that is 1.9 GFLOP, ~28 us on the CUDA cores
// (67 TFLOP/s), against ~55 MB of inputs and outputs (~16 us).
//
// Two forms behind one entry point, chosen by S.
//
// Sequential (S < kChunkMin: decode, short prefills). Columns e of the
// state are independent (the known RWKV CUDA layout gives one thread a
// column). Here four lanes share a column, each holding 16 of its dh rows
// in registers, so a block of 256 threads covers one (head, batch row) and
// the card holds four times the warps; y[e] is each lane's partial sum,
// then two shuffles. The steps are staged 32 at a time through shared
// memory (r, k, w and v of the head, read coalesced and converted from
// bf16 there; u once); r, k and w are read back as float4 broadcasts, lane
// q of a column taking d = 16j + 4q + c so the four lanes hit distinct
// banks. The 32 steps' y are staged and stored coalesced. The state update
// and u k v are rounded products and sums in the plain version's order (no
// fused multiply-add), so the final state is bitwise the plain version's;
// y differs from it only in the order of its dh-term sum. The steps are a
// dependent chain, and B x H = 128 blocks are fewer than the SMs: this
// form is latency-bound.
//
// Chunked (S >= kChunkMin: the serve's re-prefill). The sequence runs kC =
// 64 steps at a time in sub-chunks of kSub = 16; with S0 the state at the
// chunk's start, A[t, s] = r_t . (k_s (*) prod_{s<u<t} w_u) for s < t and
// A[t, t] = r_t . (u (*) k_t) (the bonus, as it is written),
//   y_t   = sum_{s<=t} A[t, s] v_s + (r_t (*) prod_{u<t} w_u) . S0
//   S_end = prod_u w_u (*) S0 + sum_s (k_s (*) prod_{s<u} w_u) v_s^T.
// The decay sits inside A's sum over channels d, so no rank-one scaling
// of A carries it; and dividing by a cumulative product (the reference's
// `_wkv_chunked`, ssm.py:267) breaks once w = exp(-exp(w_raw)) underflows,
// which it does for w_raw above ~4.6. So every factor is a running product
// of decays, each <= 1. A sub-chunk's diagonal block is taken on the CUDA
// cores with running products from each key on: a thread two keys, p and
// 15 - p (15 steps a thread), on 4 channels, its 16 rows' partial sums then
// summed over the key's 16 lanes by halving (15 shuffles for 16 sums). A
// block of query sub-chunk i against an earlier key sub-chunk j is the
// product (r_t (*) prod_{ref<=u<t} w_u) . (k_s (*) prod_{s<u<ref} w_u) with
// ref the first step of i: r~ = r (*) the product from i's start to t
// (excl), kq = k (*) the product after s to j's end, times those of the
// sub-chunks strictly between. y is then [A | r~ (*) before] [v ; S0], and
// the state one product of depth 64; all products on the tensor cores in
// 3xTF32 (scan_mma.cuh: about 2^-21 a product; one TF32 pass keeps 2^-11,
// which the fp32 tier never uses; on the H100 mma.sync TF32 runs at ~310
// TFLOP/s, tools/mma_rate.py, so 3xTF32 ~100 fp32 TFLOP/s against ~54 for
// FMAs).
//
// A block of 512 threads owns one (head, batch row) for the whole
// sequence, one block an SM (128 blocks at RWKV6-1.6B's B 4), not two
// blocks each a half of the state's columns e (a column needs only v[e]):
// both would repeat A, whose diagonal blocks take a third of a chunk's
// time (tools/scan_phases.py). The state stays on chip, fp32, in
// registers (each warp a 16 x 16 tile, the state product's accumulator)
// with a copy in shared memory that the next chunk's y reads, and is
// written once at the end. The next chunk's r, k, v and w fly by cp.async
// into staging rows as soon as this chunk's are in their tiles. y's row
// blocks are paired {0, 3}, {1, 2} so the block triangle splits evenly,
// S0's fragments shared by both. Shared tiles are padded to strides of 68
// or 72 floats so fragment reads hit distinct banks (the state product's
// read of kq down its columns excepted: two-way). dh under 64 is padded
// with zeros inside the kernel; steps past the end carry w = 1 and r, k, v
// 0.
//
// The chunk's sums run in another order than the plain loop's, so the
// final state is no longer bitwise the plain version's: it and y agree
// within 1e-5 of max(1, max|plain|). No atomics: two launches are bitwise
// equal. kChunkMin = 48: the first length at which one chunk took less
// than the sequential form's steps (B 4 at full width on the H100: 15.19
// against 19.72 us at S 48, 14.64 against 13.44 at S 32; tools/scan_ab.py
// with kChunkMin lowered, PERF.md).
#include <cuda_bf16.h>

#include "cp_async.cuh"
#include "scan_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerCol = 4;
constexpr int kMaxDh = kWarps * 32 / kLanesPerCol;  // 64 columns a block
constexpr int kPerLane = kMaxDh / kLanesPerCol;     // 16 rows a lane
constexpr int kChunk = 32;                          // steps staged at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// r, k, v [B, S, H, dh] (T: bf16 or fp32); w [B, S, H, dh] fp32; u [H, dh]; s0, s_out
// [B, H, dh, dh]; y [B, S, H, dh]; all contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_f32_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out, int S,
                int H, int dh) {
  __shared__ __align__(16) float rs[kChunk][kMaxDh];
  __shared__ __align__(16) float ks[kChunk][kMaxDh];
  __shared__ __align__(16) float ws[kChunk][kMaxDh];
  __shared__ float vs[kChunk][kMaxDh];
  __shared__ float ys[kChunk][kMaxDh];
  __shared__ __align__(16) float us[kMaxDh];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, q = lane % kLanesPerCol;
  const int e = (threadIdx.x / 32) * (32 / kLanesPerCol) + lane / kLanesPerCol;
  const bool col_ok = e < dh;
  const size_t sbase = ((size_t)b * H + h) * dh * dh;

  if (threadIdx.x < kMaxDh)
    us[threadIdx.x] = threadIdx.x < dh ? u[(size_t)h * dh + threadIdx.x] : 0.f;
  float st[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = 16 * (i / 4) + 4 * q + i % 4;
    st[i] = (col_ok && d < dh) ? s0[sbase + (size_t)d * dh + e] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < kChunk * kMaxDh; i += kThreads) {
      const int t = i / kMaxDh, j = i % kMaxDh;
      const bool ok = t < steps && j < dh;
      const size_t o = (((size_t)b * S + t0 + t) * H + h) * dh + j;
      rs[t][j] = ok ? to_f32(r[o]) : 0.f;
      ks[t][j] = ok ? to_f32(k[o]) : 0.f;
      vs[t][j] = ok ? to_f32(v[o]) : 0.f;
      ws[t][j] = ok ? w[o] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float ve = vs[t][col_ok ? e : 0];
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane / 4; ++j) {
        const int d0 = 16 * j + 4 * q;
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][d0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][d0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][d0]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[d0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& s = st[4 * j + c];
          const float kv = __fmul_rn(kk[c], ve);
          part = fmaf(rr[c], __fadd_rn(s, __fmul_rn(uu[c], kv)), part);
          s = __fadd_rn(__fmul_rn(s, ww[c]), kv);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0 && col_ok) ys[t][e] = part;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * dh; i += kThreads) {
      const int t = i / dh, j = i % dh;
      y[(((size_t)b * S + t0 + t) * H + h) * dh + j] = ys[t][j];
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = 16 * (i / 4) + 4 * q + i % 4;
    if (d < dh) s_out[sbase + (size_t)d * dh + e] = st[i];
  }
}

// ---------------------------------------------------------------------------
// Chunked form
// ---------------------------------------------------------------------------
constexpr int kChunkMin = 48;  // steps from which the chunked form runs
constexpr int kC = 64;         // steps a chunk
constexpr int kSub = 16;       // steps a sub-chunk
constexpr int kNSub = kC / kSub;
constexpr int kW = 64;         // dh, padded
constexpr int kLd4 = kW + 4;   // stride of tiles whose rows feed fragments
constexpr int kLd8 = kW + 8;   // stride of tiles read down their columns
constexpr int kCWarps = 16;    // warps of a chunked block, one block an SM
constexpr int kCThreads = 32 * kCWarps;

// a chunk's inputs as they lie in memory, rows of dh values
template <typename T>
struct Stage {
  T r[kC * kW];
  T k[kC * kW];
  T v[kC * kW];
  float w[kC * kW];
};

template <typename T>
struct ChunkSmem {
  Stage<T> in;        // the next chunk, in flight while this one runs
  float r[kC][kLd4];  // r_t [t][d]; then r~ = r_t (*) prod_{ref<=u<t} w_u
  float k[kC][kLd4];  // k_s [s][d]; then kq = k_s (*) prod_{s<u<=end} w_u
  float w[kC][kLd4];  // w_t [t][d]
  float a[kC][kLd4];  // A [t][s], lower block triangle
  float v[kC][kLd8];  // v_s [s][e]
  float s[kW][kLd8];  // the state at the chunk's start [d][e]
  float u[kW];
  float before[kNSub][kW];      // the product of the sub-chunks before i
  float after[kNSub][kW];       // of those after j
  float btw[kNSub][kNSub][kW];  // [j][i]: of those strictly between
  float all[kW];
};

// start the copies of chunk t0 of (head h, batch row b) into `st`, and
// commit them (an empty group past the sequence's end)
template <typename T>
__device__ __forceinline__ void fetch(Stage<T>& st, const T* r, const T* k,
                                      const T* v, const float* w, int b,
                                      int h, int t0, int S, int H, int dh) {
  if (t0 < S) {
    using scan_mma::copy_rows;
    const int steps = min(kC, S - t0);
    const size_t o = (((size_t)b * S + t0) * H + h) * dh;
    const int rb = dh * (int)sizeof(T);
    const size_t stride = (size_t)H * rb;
    copy_rows(st.r, rb, r + o, stride, steps, rb);
    copy_rows(st.k, rb, k + o, stride, steps, rb);
    copy_rows(st.v, rb, v + o, stride, steps, rb);
    copy_rows(st.w, dh * 4, w + o, (size_t)H * dh * 4, steps, dh * 4);
  }
  cp_async_commit();
}

// one halving step of a sum over 16 lanes of 16 values: the lanes O apart
// swap the halves their bit O does not keep, and each keeps the sums of its
// half in part[0, O)
template <int O>
__device__ __forceinline__ void halve(float (&part)[kSub], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float keep = up ? part[j + O] : part[j];
    const float send = up ? part[j] : part[j + O];
    part[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCThreads, 1)
wkv6_f32_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ s0, float* __restrict__ y,
                        float* __restrict__ s_out, int S, int H, int dh) {
  using namespace scan_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<T>& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t sbase = ((size_t)b * H + h) * dh * dh;
  const int kd = (dh + 7) / 8;  // k-steps over the channels d

  fetch(sm.in, r, k, v, w, b, h, 0, S, H, dh);
  // the state: each warp a 16 x 16 tile, the accumulator of its product
  const int sr0 = 16 * (warp % 4), sc0 = 16 * (warp / 4);
  float st[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = acc_row(sr0, e), ec = acc_col(sc0 + 8 * nt, e);
      st[nt][e] = (d < dh && ec < dh) ? s0[sbase + (size_t)d * dh + ec] : 0.f;
    }
  for (int i = tid; i < kW * kW; i += kCThreads) {
    const int d = i / kW, ec = i % kW;
    sm.s[d][ec] = (d < dh && ec < dh) ? s0[sbase + (size_t)d * dh + ec] : 0.f;
  }
  if (tid < kW) sm.u[tid] = tid < dh ? u[(size_t)h * dh + tid] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kC) {
    const int steps = min(kC, S - t0);
    cp_async_wait<0>();
    __syncthreads();
    // 1. the chunk into padded tiles: zero past the sequence's end and the
    // width, w 1
    for (int i = tid; i < kC * kW; i += kCThreads) {
      const int t = i / kW, j = i % kW;
      const bool live = t < steps && j < dh;
      sm.r[t][j] = live ? to_f32(sm.in.r[t * dh + j]) : 0.f;
      sm.k[t][j] = live ? to_f32(sm.in.k[t * dh + j]) : 0.f;
      sm.v[t][j] = live ? to_f32(sm.in.v[t * dh + j]) : 0.f;
      sm.w[t][j] = live ? sm.in.w[t * dh + j] : 1.f;
    }
    __syncthreads();
    // the staging rows are read: the next chunk flies from here on
    fetch(sm.in, r, k, v, w, b, h, t0 + kC, S, H, dh);

    // 2. A's diagonal blocks on the CUDA cores, by running products of
    // decays from each key on: thread (sub-chunk i, keys p and 15 - p, so
    // every thread runs 15 steps, channels 4 dg .. 4 dg + 3), one key after
    // the other, each thread's partial sums of all 16 rows t kept, then
    // summed over the key's 16 lanes by halving (each step keeps the half
    // its lane's bit selects), lane dg ending with row t = dg
    {
      const int i = tid / 128, p = (tid / 16) % 8, dg = tid % 16;
      const int base = kSub * i, d0 = 4 * dg;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int key = q == 0 ? p : kSub - 1 - p, sk = base + key;
        float kk[4], cw[4], part[kSub];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          kk[cc] = sm.k[sk][d0 + cc];
          cw[cc] = 1.f;
        }
#pragma unroll
        for (int tl = 0; tl < kSub; ++tl) {
          part[tl] = 0.f;
          if (tl == key) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              part[tl] += (sm.r[sk][d0 + cc] * sm.u[d0 + cc]) * kk[cc];
          } else if (tl > key) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              part[tl] += sm.r[base + tl][d0 + cc] * (kk[cc] * cw[cc]);
              cw[cc] *= sm.w[base + tl][d0 + cc];
            }
          }
        }
        halve<8>(part, dg);
        halve<4>(part, dg);
        halve<2>(part, dg);
        halve<1>(part, dg);
        sm.a[base + dg][sk] = part[0];  // 0 above the diagonal
      }
    }
    __syncthreads();

    // 3. thread (sub-chunk i, channel d) of the first 256: r~ and kq of
    // sub-chunk i in place, and the products across sub-chunks from the
    // four sub-chunks' own products, which each thread takes itself
    if (tid < kNSub * kW) {
      const int i = tid / kW, d = tid % kW, base = kSub * i;
      float total[kNSub];
#pragma unroll
      for (int m = 0; m < kNSub; ++m) {
        float run = 1.f;
#pragma unroll
        for (int l = 0; l < kSub; ++l) run *= sm.w[kSub * m + l][d];
        total[m] = run;
      }
      float run = 1.f;
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        const float wt = sm.w[base + l][d];
        sm.r[base + l][d] *= run;
        run *= wt;
      }
      run = 1.f;
#pragma unroll
      for (int l = kSub - 1; l >= 0; --l) {
        sm.k[base + l][d] *= run;
        run *= sm.w[base + l][d];
      }
      float before = 1.f, after = 1.f;
#pragma unroll
      for (int m = 0; m < kNSub; ++m)
        if (m < i) before *= total[m];
#pragma unroll
      for (int m = kNSub - 1; m >= 0; --m)
        if (m > i) after *= total[m];
      sm.before[i][d] = before;
      sm.after[i][d] = after;
      if (i == 0) {
        float all = 1.f;
#pragma unroll
        for (int m = 0; m < kNSub; ++m) all *= total[m];
        sm.all[d] = all;
#pragma unroll
        for (int i2 = 2; i2 < kNSub; ++i2) {
          float btw = 1.f;
#pragma unroll
          for (int j = i2 - 2; j >= 0; --j) {
            btw *= total[j + 1];
            sm.btw[j][i2][d] = btw;
          }
        }
      }
    }
    __syncthreads();

    // 4. A below the diagonal blocks: query sub-chunk i against key
    // sub-chunk j < i, r~ (kq (*) between)^T, 6 pairs x 2 key tiles of 8:
    // warps 0-11 one tile each
    if (warp < 12) {
      const int p = warp / 2, half = warp % 2;
      const int i = p < 1 ? 1 : p < 3 ? 2 : 3;
      const int j = p - i * (i - 1) / 2;
      float acc[4] = {};
#pragma unroll 2
      for (int ks = 0; ks < kd; ++ks)
        mma3(acc,
             frag_a([&](int rr, int cc) { return sm.r[rr][cc]; }, kSub * i,
                    8 * ks),
             frag_b([&](int k2, int cc) {
               return j < i - 1 ? sm.k[cc][k2] * sm.btw[j][i][k2]
                                : sm.k[cc][k2];
             }, 8 * ks, kSub * j + 8 * half));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.a[acc_row(kSub * i, e)][acc_col(kSub * j + 8 * half, e)] = acc[e];
    }
    __syncthreads();

    // 5. y = [A | r~ (*) before] [v ; S0]: each warp 8 columns e of two
    // row blocks, {0, 3} or {1, 2}, so the block triangle splits evenly;
    // S0's fragments feed both
    {
      const int q = warp % 8, pair = warp / 8;
      if (8 * q < dh) {
        float acc[2][4] = {};
#pragma unroll 2
        for (int ks = 0; ks < kd; ++ks) {
          const Split<2> fb =
              frag_b([&](int k2, int cc) { return sm.s[k2][cc]; }, 8 * ks,
                     8 * q);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = pair == 0 ? 3 * half : 1 + half;
            mma3(acc[half],
                 frag_a([&](int rr, int cc) {
                   return sm.r[rr][cc] * sm.before[i][cc];
                 }, kSub * i, 8 * ks),
                 fb);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = pair == 0 ? 3 * half : 1 + half;
#pragma unroll 2
          for (int ks = 0; ks < 2 * (i + 1); ++ks)
            mma3(acc[half],
                 frag_a([&](int rr, int cc) { return sm.a[rr][cc]; },
                        kSub * i, 8 * ks),
                 frag_b([&](int k2, int cc) { return sm.v[k2][cc]; }, 8 * ks,
                        8 * q));
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int t = acc_row(kSub * i, e), ec = acc_col(8 * q, e);
            float* out = y + (((size_t)b * S + t0 + t) * H + h) * dh + ec;
            if (t >= steps || ec >= dh) continue;
            if (ec + 1 < dh && dh % 2 == 0)
              *reinterpret_cast<float2*>(out) =
                  make_float2(acc[half][e], acc[half][e + 1]);
            else
              for (int k2 = 0; k2 < 2 && ec + k2 < dh; ++k2)
                out[k2] = acc[half][e + k2];
          }
        }
      }
      // the state: S_end = prod w (*) S0 + (kq (*) after)^T v
      if (sr0 < dh && sc0 < dh) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] *= sm.all[acc_row(sr0, e)];
#pragma unroll 2
        for (int ks = 0; ks < (steps + 7) / 8; ++ks) {
          const int j = ks / 2;  // the key sub-chunk of these 8 steps
          const Split<4> fa = frag_a(
              [&](int rr, int cc) { return sm.k[cc][rr] * sm.after[j][rr]; },
              sr0, 8 * ks);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(st[nt], fa,
                 frag_b([&](int k2, int cc) { return sm.v[k2][cc]; }, 8 * ks,
                        sc0 + 8 * nt));
        }
      }
    }
    __syncthreads();
    // 6. the new state, for the next chunk's y
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.s[acc_row(sr0, e)][acc_col(sc0 + 8 * nt, e)] = st[nt][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = acc_row(sr0, e), ec = acc_col(sc0 + 8 * nt, e);
      if (d < dh && ec < dh) s_out[sbase + (size_t)d * dh + ec] = st[nt][e];
    }
}

template <typename T>
cudaError_t launch(const T* r, const T* k, const T* v, const float* w,
                   const float* u, const float* s0, float* y, float* s_out,
                   int B, int S, int H, int dh, cudaStream_t s) {
  if (S < kChunkMin) {
    wkv6_f32_kernel<<<dim3(H, B), kThreads, 0, s>>>(r, k, v, w, u, s0, y,
                                                    s_out, S, H, dh);
    return cudaGetLastError();
  }
  static size_t raised = 0;
  const cudaError_t err =
      allow_smem(wkv6_f32_chunked_kernel<T>, sizeof(ChunkSmem<T>), &raised);
  if (err != cudaSuccess) return err;
  wkv6_f32_chunked_kernel<<<dim3(H, B), kCThreads, sizeof(ChunkSmem<T>),
                            s>>>(r, k, v, w, u, s0, y, s_out, S, H, dh);
  return cudaGetLastError();
}

}  // namespace

// in_bf16: r, k and v hold bf16 values (else fp32). dh at most 64; the
// wrapper (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity.
// One launch: the sequential form below kChunkMin steps, else the chunked.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_out, int in_bf16, int B, int S,
                        int H, int dh, void* stream) {
  if (dh < 1 || dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  if (in_bf16)
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(k),
                                   static_cast<const __nv_bfloat16*>(v), wf,
                                   uf, sf, yf, so, B, S, H, dh, s));
  return static_cast<int>(launch(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), wf, uf, sf, yf, so, B, S, H, dh, s));
}
