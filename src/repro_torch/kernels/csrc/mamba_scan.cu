// Mamba2's selective scan on Hopper, fp32 state: for every step t,
//   h = h * decay[t] + (dt[t] * x[t]) (outer) B[t],   y[t] = h . C[t],
// over a whole sequence in one launch, the final state written beside y.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `jax.lax.scan` (src/repro/models/ssm.py:116, the `step` of
// `mamba_block`), which XLA keeps on the device. In the port a Python loop
// would issue about eight launches a token a layer, and the recurrent
// families re-prefill the whole batch at every admission, so the scan is a
// kernel on the serve path. Per head h of batch row b the state is
// [dh, N] (Zamba2-1.2B: 64 heads of dh 64, N = ssm_state 64).
//
// Bound. Decode (S = 1): the state's bytes, read once and written once: at
// Zamba2's widths and B = 4, 4 MiB a layer, ~2.5 us at 3.35 TB/s. Prefill:
// operations. Each (d, n, t) costs two products and a sum for the state and
// a product and a sum for y, 5 fp32 operations: at B = 4, S = 512 that is
// 2.7 GFLOP, ~40 us on the CUDA cores (67 TFLOP/s), against ~60 MB of
// inputs and outputs (~18 us).
//
// Two forms behind one entry point, chosen by S.
//
// Sequential (S < kChunkMin: decode, short prefills). One block of 256
// threads per (head, batch row), so the grid is B x H blocks whatever S
// is. Rows of the state are independent (row d needs only x[d]), so each
// row belongs to four lanes of one warp, each lane holding 16 of its N
// values in registers: a lane never reads or writes the state in memory
// between the first step and the last. The steps are staged 32 at a time
// through shared memory (x of the head, B, C, dt and decay, read coalesced
// and converted from bf16 there); B and C are read back as float4
// broadcasts, lane q of a row taking n = 16k + 4q + c so the four lanes hit
// distinct banks. y[d] is each lane's partial sum over its 16 values, then
// two shuffles; the 32 steps' y are staged and stored coalesced. The state
// update is two rounded products and a rounded sum in the plain version's
// order (no fused multiply-add), so the final state is bitwise the plain
// version's; y differs from it only in the order of its N-term sum. The S
// steps are a dependent chain, each a few rounded operations a lane: no
// form of it reaches the tensor cores, and at B x H = 256 blocks the card
// holds about 16 warps an SM, so this form is latency-bound.
//
// Chunked (S >= kChunkMin: the serve's re-prefill). The sequence runs kC =
// 64 steps at a time; within a chunk, with seg(s->t) the product of the
// decays after s up to t (<= 1) and h the state at the chunk's start,
//   y_t   = sum_{s<=t} seg(s->t) (C_t . B_s) dt_s x_s + seg(start->t) C_t h
//   h_end = seg(start->end) h + sum_s seg(s->end) dt_s x_s B_s^T,
// four [64 x 64 x 64] products a (head, batch row, chunk): G = C B^T on
// its lower block triangle (y needs s <= t), M = G (*) seg; y = M (dt x) +
// seg(start->t) (C h^T), the last scaled row by row; and the state. No
// factor divides by a cumulative product and none takes a log (a decay of
// 0, which Zamba2's heads reach once dt |A| passes ~104, would make either
// a NaN): the chunk is cut into sub-chunks of kSub = 16, and every factor
// is a running product of decays, each <= 1: within a sub-chunk from its
// start to t (incl), from after s to its end (suffix), seg(s->t) itself
// (lin); across sub-chunks the products of those before, after and
// strictly between. seg(s->t) for s in an earlier sub-chunk j is incl[t] *
// between(j, i) * suffix[s].
//
// The products run on the tensor cores in 3xTF32 (scan_mma.cuh: about
// 2^-21 a product; one TF32 pass keeps 2^-11, which the fp32 tier never
// uses). Measured on the H100 (tools/mma_rate.py), mma.sync m16n8k8 TF32
// runs at ~310 TFLOP/s, so 3xTF32 at ~100 fp32 TFLOP/s against ~54 for
// FMAs on the CUDA cores: the products' 5.1 M instructions at B 4 x S 512
// are ~34 us of that rate, the same products as FMAs ~65 us.
//
// A block of 256 threads owns one (head, batch row) for the whole
// sequence, two blocks an SM (B x H = 256 blocks at Zamba2's B 4, one
// wave). Its state stays on chip, fp32, in registers (each warp a 16 x 32
// tile, the state product's accumulator) with a copy in shared memory that
// the next chunk's y reads, and is written once at the end. Copies run
// ahead by cp.async: the next chunk's x, dt and decays into staging rows
// as soon as this chunk's are in their tiles; its B into B's tile once the
// state and G have read it, its C once y's C h^T has. (Staging B and C a
// whole chunk ahead would take a second pair of tiles, 35 KB, and the
// second block off the SM.) Each phase splits the work so that one
// fragment feeds several products: G's 20 tiles two or three of a row
// block a warp; y's row blocks paired {0, 3}, {1, 2} so the block triangle
// splits evenly, C h^T's fragments of h shared by both. Shared tiles are
// padded to strides of 68 or 72 floats so the fragment reads hit distinct
// banks (the state product's read of B down its columns excepted:
// two-way). dh and N under 64 are padded with zeros inside the kernel;
// steps past the sequence's end carry decay 1 and x 0.
//
// The chunk's sums run in another order than the plain loop's, so the
// final state is no longer bitwise the plain version's: it and y agree
// within 1e-5 of max(1, max|plain|). No atomics: two launches are bitwise
// equal. kChunkMin = 32: the first length at which one chunk took less
// than the sequential form's steps (B 4 at full width on the H100: 18.38
// against 19.20 us at S 32, 16.64 against 13.53 at S 16; tools/scan_ab.py
// with kChunkMin lowered, PERF.md).
#include <cuda_bf16.h>

#include "cp_async.cuh"
#include "scan_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerRow = 4;
constexpr int kMaxDh = kWarps * 32 / kLanesPerRow;  // 64 rows a block
constexpr int kPerLane = 16;                         // state values a lane
constexpr int kMaxN = kLanesPerRow * kPerLane;       // 64
constexpr int kChunk = 32;                           // steps staged at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x [B, S, H, dh]; dt, decay [B, S, H]; Bm, Cm [B, S, N]; h0, h_out
// [B, H, dh, N]; y [B, S, H, dh]; all contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_f32_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ decay,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int H, int dh,
                      int N) {
  __shared__ float xs[kChunk][kMaxDh];
  __shared__ __align__(16) float bs[kChunk][kMaxN];
  __shared__ __align__(16) float cs[kChunk][kMaxN];
  __shared__ float ys[kChunk][kMaxDh];
  __shared__ float dts[kChunk], decs[kChunk];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, q = lane % kLanesPerRow;
  const int d = (threadIdx.x / 32) * (32 / kLanesPerRow) + lane / kLanesPerRow;
  const bool row_ok = d < dh;
  const size_t hbase = ((size_t)b * H + h) * dh * N;

  float st[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = 16 * (i / 4) + 4 * q + i % 4;
    st[i] = (row_ok && n < N) ? h0[hbase + (size_t)d * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < kChunk * kMaxDh; i += kThreads) {
      const int t = i / kMaxDh, j = i % kMaxDh;
      xs[t][j] = (t < steps && j < dh)
          ? to_f32(x[(((size_t)b * S + t0 + t) * H + h) * dh + j]) : 0.f;
    }
    for (int i = threadIdx.x; i < kChunk * kMaxN; i += kThreads) {
      const int t = i / kMaxN, n = i % kMaxN;
      const size_t o = ((size_t)b * S + t0 + t) * N + n;
      const bool ok = t < steps && n < N;
      bs[t][n] = ok ? Bm[o] : 0.f;
      cs[t][n] = ok ? Cm[o] : 0.f;
    }
    if (threadIdx.x < steps) {
      const size_t o = ((size_t)b * S + t0 + threadIdx.x) * H + h;
      dts[threadIdx.x] = dt[o];
      decs[threadIdx.x] = decay[o];
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dec = decs[t];
      const float dx = __fmul_rn(dts[t], xs[t][row_ok ? d : 0]);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane / 4; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(&bs[t][16 * k + 4 * q]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[t][16 * k + 4 * q]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& s = st[4 * k + c];
          s = __fadd_rn(__fmul_rn(s, dec), __fmul_rn(dx, bb[c]));
          part = fmaf(s, cc[c], part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0 && row_ok) ys[t][d] = part;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * dh; i += kThreads) {
      const int t = i / dh, j = i % dh;
      y[(((size_t)b * S + t0 + t) * H + h) * dh + j] = ys[t][j];
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = 16 * (i / 4) + 4 * q + i % 4;
    if (n < N) h_out[hbase + (size_t)d * N + n] = st[i];
  }
}

// ---------------------------------------------------------------------------
// Chunked form
// ---------------------------------------------------------------------------
constexpr int kChunkMin = 32;  // steps from which the chunked form runs
constexpr int kC = 64;         // steps a chunk
constexpr int kSub = 16;       // steps a sub-chunk
constexpr int kNSub = kC / kSub;
constexpr int kW = 64;         // dh and N, padded
constexpr int kLd4 = kW + 4;   // stride of tiles whose rows feed fragments
constexpr int kLd8 = kW + 8;   // stride of tiles read down their columns

template <typename T>
struct ChunkSmem {
  // the next chunk's x, dt and decays as they lie in memory (rows of dh
  // values), in flight while this chunk's products run
  T x_in[kC * kW];
  float dt_in[kC];
  float dec_in[kC];
  float c[kC][kLd4];             // C_t [t][n]
  float b[kC][kLd4];             // B_s [s][n]
  float x[kC][kLd8];             // dt_s x_s [s][d]
  float m[kC][kLd4];             // (C B^T) (*) seg [t][s], lower blocks
  float h[kW][kLd4];             // the state at the chunk's start [d][n]
  float lin[kNSub][kSub][kSub];  // seg(s->t) within sub-chunk i [i][t][s]
  float incl[kC];    // the sub-chunk's decays from its start up to t
  float suffix[kC];  // after s up to the sub-chunk's end
  float a[kC];       // seg(start->t)
  float e[kC];       // seg(s->end)
  float btw[kNSub][kNSub];  // [j][i]: the sub-chunks strictly between
  float all;                // seg(start->end)
};

// start copying chunk t0's x, dt and decays of (head h, batch row b) into
// the staging rows, and commit (an empty group past the sequence's end)
template <typename T>
__device__ __forceinline__ void fetch_x(ChunkSmem<T>& sm, const T* x,
                                        const float* dt, const float* decay,
                                        int b, int h, int t0, int S, int H,
                                        int dh) {
  if (t0 < S) {
    const int steps = min(kC, S - t0);
    const size_t row = (size_t)b * S + t0;
    const int rb = dh * (int)sizeof(T);
    scan_mma::copy_rows(sm.x_in, rb, x + (row * H + h) * dh, (size_t)H * rb,
                        steps, rb);
    scan_mma::copy_rows(sm.dt_in, 4, dt + row * H + h, (size_t)H * 4, steps,
                        4);
    scan_mma::copy_rows(sm.dec_in, 4, decay + row * H + h, (size_t)H * 4,
                        steps, 4);
  }
  cp_async_commit();
}

// start copying chunk t0's rows of `src` (B or C, rows of N) into the
// padded tile `dst`, and commit
__device__ __forceinline__ void fetch_rows(float (*dst)[kLd4],
                                           const float* src, int b, int t0,
                                           int S, int N) {
  if (t0 < S)
    scan_mma::copy_rows(dst, kLd4 * 4, src + ((size_t)b * S + t0) * N,
                        (size_t)N * 4, min(kC, S - t0), N * 4);
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_f32_chunked_kernel(const T* __restrict__ x,
                              const float* __restrict__ dt,
                              const float* __restrict__ decay,
                              const float* __restrict__ Bm,
                              const float* __restrict__ Cm,
                              const float* __restrict__ h0,
                              float* __restrict__ y,
                              float* __restrict__ h_out, int S, int H,
                              int dh, int N) {
  using namespace scan_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<T>& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t hbase = ((size_t)b * H + h) * dh * N;
  const int kn = (N + 7) / 8;  // k-steps over the state's columns

  // B and C past N stay 0: the copies write the first N of a row
  for (int i = tid; i < kC * kW; i += kThreads) {
    sm.b[i / kW][i % kW] = 0.f;
    sm.c[i / kW][i % kW] = 0.f;
  }
  __syncthreads();
  fetch_x(sm, x, dt, decay, b, h, 0, S, H, dh);
  fetch_rows(sm.b, Bm, b, 0, S, N);
  fetch_rows(sm.c, Cm, b, 0, S, N);
  // the state: each warp a 16 x 32 tile, the accumulator of its product
  const int sr0 = 16 * (warp % 4), sc0 = 32 * (warp / 4);
  float st[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = acc_row(sr0, e), n = acc_col(sc0 + 8 * nt, e);
      st[nt][e] = (d < dh && n < N) ? h0[hbase + (size_t)d * N + n] : 0.f;
    }
  for (int i = tid; i < kW * kW; i += kThreads) {
    const int d = i / kW, n = i % kW;
    sm.h[d][n] = (d < dh && n < N) ? h0[hbase + (size_t)d * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kC) {
    const int steps = min(kC, S - t0);
    cp_async_wait<0>();
    __syncthreads();

    // 1. dt x into its tile, zero past the sequence's end and dh; B and C
    // zero past the end; the decay factors, all running products of
    // decays <= 1 (each of the first 81 threads takes the sub-chunks'
    // products itself)
    for (int i = tid; i < kC * kW; i += kThreads) {
      const int t = i / kW, j = i % kW;
      sm.x[t][j] = (t < steps && j < dh)
          ? __fmul_rn(sm.dt_in[t], to_f32(sm.x_in[t * dh + j])) : 0.f;
      if (t >= steps) {
        sm.b[t][j] = 0.f;
        sm.c[t][j] = 0.f;
      }
    }
    if (tid <= kC + kNSub * kNSub) {
      float total[kNSub];
#pragma unroll
      for (int m = 0; m < kNSub; ++m) {
        float run = 1.f;
#pragma unroll
        for (int u = kSub * m; u < kSub * (m + 1); ++u)
          if (u < steps) run *= sm.dec_in[u];
        total[m] = run;
      }
      if (tid < kC) {  // step t = tid of sub-chunk i
        const int i = tid / kSub, l = tid % kSub, base = kSub * i;
        float incl = 1.f, suffix = 1.f, before = 1.f, after = 1.f;
        float dsub[kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          dsub[u] = base + u < steps ? sm.dec_in[base + u] : 1.f;
          if (u <= l) incl *= dsub[u];
        }
#pragma unroll
        for (int u = kSub - 1; u >= 0; --u)
          if (u > l) suffix *= dsub[u];
        float run = 1.f;  // seg(s->t) with s = l, down the column
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          if (t > l) run *= dsub[t];
          sm.lin[i][t][l] = t >= l ? run : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kNSub; ++m)
          if (m < i) before *= total[m];
#pragma unroll
        for (int m = kNSub - 1; m >= 0; --m)
          if (m > i) after *= total[m];
        sm.incl[tid] = incl;
        sm.suffix[tid] = suffix;
        sm.a[tid] = before * incl;
        sm.e[tid] = suffix * after;
      } else if (tid < kC + kNSub * kNSub) {
        const int j = (tid - kC) / kNSub, i = (tid - kC) % kNSub;
        float run = 1.f;
#pragma unroll
        for (int m = kNSub - 1; m >= 0; --m)
          if (m < i && m > j) run *= total[m];
        sm.btw[j][i] = run;
      } else {
        float run = 1.f;
#pragma unroll
        for (int m = 0; m < kNSub; ++m) run *= total[m];
        sm.all = run;
      }
    }
    __syncthreads();
    // the staging rows are read: the next chunk's x flies from here on
    fetch_x(sm, x, dt, decay, b, h, t0 + kC, S, H, dh);

    // 2. the state, h_end = seg(start->end) h + (e (*) dt x)^T B, in the
    // warps' registers; M = (C B^T) (*) seg on the lower block triangle, 20
    // tiles of 16 x 8 (row block i, key tile nt < 2 (i + 1)), each warp two
    // or three tiles of one row block on one A fragment; and y's share of
    // the state at the chunk's start, (a C) h^T: each warp 16 columns d of
    // two row blocks, {0, 3} or {1, 2}, so the block triangle of step 3
    // splits evenly
    if (sr0 < dh) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= sm.all;
#pragma unroll
      for (int ks = 0; ks < kC / 8; ++ks) {
        if (8 * ks >= steps) break;
        const Split<4> fa = frag_a(
            [&](int r, int cc) { return sm.e[cc] * sm.x[cc][r]; }, sr0,
            8 * ks);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (sc0 + 8 * nt < N)
            mma3(st[nt], fa,
                 frag_b([&](int k2, int cc) { return sm.b[k2][cc]; }, 8 * ks,
                        sc0 + 8 * nt));
      }
    }
    {
      const int i = warp < 3 ? 3 : warp < 5 ? 2 : warp < 7 ? 1 : 0;
      const int nt0 = warp < 3 ? 3 * warp : warp < 5 ? 3 * (warp - 3)
                    : warp < 7 ? 2 * (warp - 5) : 0;
      const int cnt = (warp == 2 || warp >= 5) ? 2 : 3;
      float acc[3][4] = {};
#pragma unroll
      for (int ks = 0; ks < kW / 8; ++ks) {
        if (ks >= kn) break;
        const Split<4> fa = frag_a(
            [&](int r, int cc) { return sm.c[r][cc]; }, kSub * i, 8 * ks);
#pragma unroll
        for (int n = 0; n < 3; ++n)
          if (n < cnt)
            mma3(acc[n], fa,
                 frag_b([&](int k2, int cc) { return sm.b[cc][k2]; }, 8 * ks,
                        8 * (nt0 + n)));
      }
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        if (n >= cnt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = acc_row(kSub * i, e), s = acc_col(8 * (nt0 + n), e);
          const int j = s / kSub;
          float L;
          if (j == i) {
            L = sm.lin[i][t % kSub][s % kSub];
          } else {
            L = sm.incl[t];
            if (j < i - 1) L *= sm.btw[j][i];
            L *= sm.suffix[s];
          }
          sm.m[t][s] = acc[n][e] * L;
        }
      }
    }
    const int q = warp % 4, pair = warp / 4;
    float yacc[2][2][4] = {};  // [row block of the pair][column tile]
    if (16 * q < dh) {
#pragma unroll
      for (int ks = 0; ks < kW / 8; ++ks) {
        if (ks >= kn) break;
        Split<2> fb[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          fb[nt] = frag_b([&](int k2, int cc) { return sm.h[cc][k2]; },
                          8 * ks, 16 * q + 8 * nt);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = pair == 0 ? 3 * half : 1 + half;
          const Split<4> fa = frag_a(
              [&](int r, int cc) { return sm.c[r][cc]; }, kSub * i, 8 * ks);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma3(yacc[half][nt], fa, fb[nt]);
        }
      }
      // (C h^T) scaled by seg(start->t) row by row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = pair == 0 ? 3 * half : 1 + half;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            yacc[half][nt][e] *= sm.a[acc_row(kSub * i, e)];
      }
    }
    __syncthreads();
    // B, C and h are read: the next chunk's B and C fly from here on, and
    // the new state goes to shared memory for the next chunk's y (the
    // barrier at the loop's top orders this step before the next chunk's)
    fetch_rows(sm.b, Bm, b, t0 + kC, S, N);
    fetch_rows(sm.c, Cm, b, t0 + kC, S, N);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.h[acc_row(sr0, e)][acc_col(sc0 + 8 * nt, e)] = st[nt][e];

    // 3. y += M dt x, and y to memory, two columns a store
    if (16 * q < dh) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = pair == 0 ? 3 * half : 1 + half;
#pragma unroll
        for (int ks = 0; ks < kC / 8; ++ks) {
          if (ks >= 2 * (i + 1)) break;
          const Split<4> fa = frag_a(
              [&](int r, int cc) { return sm.m[r][cc]; }, kSub * i, 8 * ks);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(yacc[half][nt], fa,
                 frag_b([&](int k2, int cc) { return sm.x[k2][cc]; }, 8 * ks,
                        16 * q + 8 * nt));
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int t = acc_row(kSub * i, e);
            const int d = acc_col(16 * q + 8 * nt, e);
            float* out = y + (((size_t)b * S + t0 + t) * H + h) * dh + d;
            if (t >= steps || d >= dh) continue;
            if (d + 1 < dh && dh % 2 == 0)
              *reinterpret_cast<float2*>(out) =
                  make_float2(yacc[half][nt][e], yacc[half][nt][e + 1]);
            else
              for (int k2 = 0; k2 < 2 && d + k2 < dh; ++k2)
                out[k2] = yacc[half][nt][e + k2];
          }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = acc_row(sr0, e), n = acc_col(sc0 + 8 * nt, e);
      if (d < dh && n < N) h_out[hbase + (size_t)d * N + n] = st[nt][e];
    }
}

template <typename T>
cudaError_t launch(const T* x, const float* const* f, float* y, float* h_out,
                   int B, int S, int H, int dh, int N, cudaStream_t s) {
  const dim3 grid(H, B);
  if (S < kChunkMin) {
    mamba_scan_f32_kernel<<<grid, kThreads, 0, s>>>(
        x, f[0], f[1], f[2], f[3], f[4], y, h_out, S, H, dh, N);
    return cudaGetLastError();
  }
  static size_t raised = 0;
  const cudaError_t err = allow_smem(mamba_scan_f32_chunked_kernel<T>,
                                     sizeof(ChunkSmem<T>), &raised);
  if (err != cudaSuccess) return err;
  mamba_scan_f32_chunked_kernel<<<grid, kThreads, sizeof(ChunkSmem<T>), s>>>(
      x, f[0], f[1], f[2], f[3], f[4], y, h_out, S, H, dh, N);
  return cudaGetLastError();
}

}  // namespace

// x_bf16: x holds bf16 values (else fp32). dh and N at most 64; the
// wrapper (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity.
// One launch: the sequential form below kChunkMin steps, else the chunked.
extern "C" int mamba_scan_f32(const void* x, const void* dt,
                              const void* decay, const void* Bm,
                              const void* Cm, const void* h0, void* y,
                              void* h_out, int x_bf16, int B, int S, int H,
                              int dh, int N, void* stream) {
  if (dh < 1 || dh > kMaxDh || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt),
                      static_cast<const float*>(decay),
                      static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm),
                      static_cast<const float*>(h0)};
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  return static_cast<int>(
      x_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), f, yf, hf, B, S,
                      H, dh, N, s)
             : launch(static_cast<const float*>(x), f, yf, hf, B, S, H, dh,
                      N, s));
}
