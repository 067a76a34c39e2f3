// The gradient of Mamba2's selective scan (mamba_scan.cu) on Hopper, fp32:
// for the forward h_t = decay_t h_{t-1} + (dt_t x_t) (outer) B_t, y_t =
// h_t . C_t over a whole sequence, given dy and the gradient of the final
// state, the adjoint
//   g_t = dy_t (outer) C_t + decay_{t+1} g_{t+1}   (g_S = d h_final)
// gives, per (batch row, step, head),
//   dx_t = dt_t (g_t B_t),        d dt_t = sum g_t (*) (x_t (outer) B_t),
//   d decay_t = sum g_t (*) h_{t-1},
// and, summed over heads, dB_t = sum_h dt_t g_t^T x_t, dC_t = sum_h h_t^T
// dy_t; d h0 = decay_0 g_0.
//
// Replaces no Pallas kernel: it is the gradient JAX takes of the reference's
// `jax.lax.scan` (src/repro/models/ssm.py:116) when the hybrid family
// trains. Launched by `MambaScan.backward` (kernels/ssm_scan/ops.py) once a
// Mamba2 layer a training step.
//
// Bound. Each (d, n, t) needs at least 14 fp32 operations: 3 to recompute
// the state once, 3 for g, 8 for the four sums (dx, dB, dC, d decay; d dt
// is a sum over dx's): at Zamba2-1.2B's training step (B 8, S 512, 64 heads
// of dh 64, N 64) that is 15 GFLOP, 0.22 ms on the CUDA cores (67
// TFLOP/s), against ~0.2 GB of inputs and outputs (~0.06 ms).
//
// Two forms behind one entry point, chosen by S; dB and dC are written per
// head and a last kernel adds the heads in order either way: no atomics, so
// two launches are bitwise equal.
//
// Sequential (S < kBwdChunkMin: short sequences). A persistent block of 256
// threads takes one (head, batch row) item at a time (scan_bwd.cuh); each
// thread owns a 4 x 4 tile of the 64 x 64 state in registers. Never is
// h_{t-1} recovered from h_t by dividing by a decay (decays reach exactly 0
// once dt |A| passes ~104): pass 1 runs the forward and keeps h every kCk =
// 32 steps in the block's scratch; pass 2 walks the intervals in reverse,
// recomputes each from its checkpoint keeping the state at every kW = 4th
// step, then each window of 4 steps into shared memory, and walks the
// window back with g in registers. The recomputed states are the forward's
// rounded products and sums in its order, bitwise the sequential forward's.
// Sums over a row (dx) take four shuffles among 16 lanes; over a column
// (dB, dC) one shuffle and then the 8 warps' partials, added in warp order.
// The walk is a dependent chain of S steps an item: latency-bound.
//
// Chunked (S >= kBwdChunkMin: the training step). The forward's chunked
// form (mamba_scan.cu) in reverse, chunks of kC = 64 steps in sub-chunks of
// kSub = 16, every decay factor a running product of decays <= 1 formed as
// the forward forms it (no division, no log), in three phases:
//   1, 2 (scan_bwd_chunk.cuh) each chunk's start state h (forward from h0)
//     and end adjoint g (backward from d h_final, the last being d h0),
//     one [64 x 64 x 64] product a chunk each, into scratch;
//   3 (mamba_scan_bwd_f32_chunk_kernel, one block a (head, chunk, batch
//     row): 4,096 blocks at the training step) the chunk's gradients from h
//     and g alone. With L[t][s] = seg(s->t), a = seg(start->t), e =
//     seg(s->end), G = C B^T, D = dy x^T:
//       dx = dt (M^T dy + e (B g^T)),  M = G (*) L;  d dt = x . (dx / dt)
//       dB = dt ((D (*) L)^T C + e (x g)),  dC = (D (*) L) (dt B) + a (dy h)
//     and d decay_v, a sum over the rectangle s < v <= t of W[t][s] = (dy_t
//     . dt_s x_s) (C_t . B_s) times the decays from s to t with v left out
//     (a prefix s..v-1 times a suffix v+1..t, each <= 1), as (W Pre) (*) L
//     summed over t with Pre[s][v] = L[v-1][s]: one more product, no
//     division, plus the terms of the rectangle's edges against h and g
//     (matrix-vector sums and <h, g>). Nine products a chunk, each warp a
//     16 x 16 tile of each, 3xTF32 mma.sync (scan_mma.cuh: about 2^-21 a
//     product; no single-pass TF32); the start state and end adjoint
//     arrive by cp.async while the chunk's decay factors and the first two
//     products run. Row and column sums are partials by warp, added in a
//     fixed order. mamba_scan_bwd_chunked_plain (kernels/ssm_scan/ops.py)
//     is this algorithm as tensor code, held to the plain backward by
//     tests/test_torch_scan_bwd_chunked.py.
// The form is bound by instruction issue, not by the tensor cores: each
// fragment element of 3xTF32 costs a shared load and a split into two TF32
// halves, and one block of 512 threads fills an SM (the tiles take ~200
// KB). kBwdChunkMin = 32, wkv6_bwd.cu's: at B 8 the chunked form took 114
// against the walk's 124 us at S 24 and 110 against 89 at S 16 on the
// H100 (tools/scan_bwd_probe.py with the threshold lowered, PERF.md), so
// Mamba2's crossing lies near 20; one threshold serves both kernels.
#include "cp_async.cuh"
#include "scan_bwd.cuh"
#include "scan_bwd_chunk.cuh"
#include "scan_mma.cuh"

namespace {

using namespace scan_bwd;

struct Smem {
  float ws[kW + 1][kState];  // the window's states before and after each step
  __align__(16) float xs[kW][kMax];
  __align__(16) float dys[kW][kMax];
  __align__(16) float bs[kW][kMax];
  __align__(16) float cs[kW][kMax];
  float dts[kW], decs[kW];
  float colw[kW][kWarps][2][kMax];  // dB (before dt), dC: a warp's partials
  float sclw[kW][kWarps][2];        // d decay, d dt: a warp's partials
};

struct Args {
  const void* x;
  const float *dt, *decay, *Bm, *Cm, *h0, *dy, *dh;
  float *dx, *ddt, *ddecay, *dBh, *dCh, *dB_out, *dC_out, *dh0, *scratch;
  int B, S, H, dh_, N;
};

// Stage steps t0 .. t0 + n - 1 of head h, batch row b (x, B, dt, decay;
// with `bwd` also dy and C); steps past n read x 0 and decay 1.
template <typename T>
__device__ void stage(const Args& a, Smem& sm, int b, int h, int t0, int n,
                      bool bwd) {
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < kW * kMax; i += kThreads) {
    const int j = i / kMax, c = i % kMax;
    const bool ok = j < n;
    const size_t row = (size_t)b * a.S + t0 + j;
    const size_t xo = (row * a.H + h) * a.dh_ + c;
    sm.xs[j][c] = (ok && c < a.dh_) ? to_f32(x[xo]) : 0.f;
    sm.bs[j][c] = (ok && c < a.N) ? a.Bm[row * a.N + c] : 0.f;
    if (bwd) {
      sm.dys[j][c] = (ok && c < a.dh_) ? a.dy[xo] : 0.f;
      sm.cs[j][c] = (ok && c < a.N) ? a.Cm[row * a.N + c] : 0.f;
    }
  }
  if (threadIdx.x < kW) {
    const int j = threadIdx.x;
    const bool ok = j < n;
    const size_t o = ((size_t)b * a.S + t0 + j) * a.H + h;
    sm.dts[j] = ok ? a.dt[o] : 0.f;
    sm.decs[j] = ok ? a.decay[o] : 1.f;
  }
}

// one forward step, the plain version's rounded operations in its order
__device__ __forceinline__ void fwd_step(float (&st)[kVals], const Smem& sm,
                                         int j, const Tile& tl) {
  const float dt = sm.dts[j], dec = sm.decs[j];
  float xx[4], bb[4];
  read4(xx, &sm.xs[j][4 * tl.rt]);
  read4(bb, &sm.bs[j][4 * tl.ct]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = __fmul_rn(dt, xx[i]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st[4 * i + k] = __fadd_rn(__fmul_rn(st[4 * i + k], dec),
                                __fmul_rn(dx, bb[k]));
  }
}

// Step j of the window backward: g (d L / d h_t from later steps, times
// decay_{t+1}) becomes g_t, its sums are taken, and g becomes decay_t g_t.
__device__ __forceinline__ void bwd_step(float (&g)[kVals], Smem& sm, int j,
                                         const Tile& tl, const Args& a,
                                         size_t dx_row) {
  const float dt = sm.dts[j], dec = sm.decs[j];
  float xx[4], dyy[4], bb[4], cc[4];
  read4(xx, &sm.xs[j][4 * tl.rt]);
  read4(dyy, &sm.dys[j][4 * tl.rt]);
  read4(bb, &sm.bs[j][4 * tl.ct]);
  read4(cc, &sm.cs[j][4 * tl.ct]);
  const float* hp = sm.ws[j];      // h_{t-1}
  const float* hc = sm.ws[j + 1];  // h_t
  float rowB[4] = {0.f, 0.f, 0.f, 0.f}, colX[4] = {0.f, 0.f, 0.f, 0.f},
        colC[4] = {0.f, 0.f, 0.f, 0.f}, dd = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = 4 * i + k;
      const float gv = fmaf(dyy[i], cc[k], g[v]);
      rowB[i] = fmaf(gv, bb[k], rowB[i]);
      colX[k] = fmaf(gv, xx[i], colX[k]);
      colC[k] = fmaf(hc[own(v)], dyy[i], colC[k]);
      dd = fmaf(gv, hp[own(v)], dd);
      g[v] = gv * dec;
    }
  }
  float ddt = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rowB[i] = sum16(rowB[i]);  // sum_n g_t[d, n] B_t[n], row d = 4 rt + i
    ddt = fmaf(xx[i], rowB[i], ddt);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    colX[k] += __shfl_xor_sync(0xffffffffu, colX[k], 16);
    colC[k] += __shfl_xor_sync(0xffffffffu, colC[k], 16);
  }
  dd = sum32(dd);
  ddt += __shfl_xor_sync(0xffffffffu, ddt, 16);
  if (tl.lane == 0) {
    sm.sclw[j][tl.warp][0] = dd;
    sm.sclw[j][tl.warp][1] = ddt;
  }
  if (tl.lane < 16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm.colw[j][tl.warp][0][4 * tl.ct + k] = colX[k];
      sm.colw[j][tl.warp][1][4 * tl.ct + k] = colC[k];
    }
  }
  if (tl.ct == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * tl.rt + i;
      if (d < a.dh_) a.dx[dx_row + d] = dt * rowB[i];
    }
  }
}

// the window's partials, added over the warps in order, into dB and dC per
// head and d dt, d decay
__device__ void window_sums(const Args& a, const Smem& sm, int b, int h,
                            int t0, int n) {
  for (int i = threadIdx.x; i < n * 2 * kMax; i += kThreads) {
    const int j = i / (2 * kMax), q = (i / kMax) % 2, c = i % kMax;
    if (c >= a.N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm.colw[j][w][q][c];
    const size_t o = (((size_t)b * a.S + t0 + j) * a.H + h) * a.N + c;
    if (q == 0)
      a.dBh[o] = sm.dts[j] * s;
    else
      a.dCh[o] = s;
  }
  if (threadIdx.x < n) {
    const int j = threadIdx.x;
    float dd = 0.f, ddt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      dd += sm.sclw[j][w][0];
      ddt += sm.sclw[j][w][1];
    }
    const size_t o = ((size_t)b * a.S + t0 + j) * a.H + h;
    a.ddecay[o] = dd;
    a.ddt[o] = ddt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_bwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const Tile tl;
  const int S = a.S, nC = (S + kCk - 1) / kCk;
  float* ck = a.scratch + (size_t)blockIdx.x * slot_floats(S);
  float* snap = ck + (size_t)nC * kState;
  float st[kVals], g[kVals];

  for (int item = blockIdx.x; item < a.B * a.H; item += gridDim.x) {
    const int h = item % a.H, b = item / a.H;
    const size_t sbase = ((size_t)b * a.H + h) * a.dh_ * a.N;

    // pass 1: the forward, a checkpoint every kCk steps (the first is h0)
    load_state(st, a.h0 + sbase, tl, a.dh_, a.N);
    for (int t0 = 0; t0 < S; t0 += kW) {
      const int n = min(kW, S - t0);
      __syncthreads();
      stage<T>(a, sm, b, h, t0, n, false);
      __syncthreads();
      for (int j = 0; j < n; ++j) fwd_step(st, sm, j, tl);
      if ((t0 + n) % kCk == 0 && t0 + n < S)
        store_own(ck + (size_t)((t0 + n) / kCk) * kState, st);
    }

    // pass 2: the intervals in reverse
    load_state(g, a.dh + sbase, tl, a.dh_, a.N);
    for (int c = nC - 1; c >= 0; --c) {
      const int tc = c * kCk, nw = (min(kCk, S - tc) + kW - 1) / kW;
      if (c == 0)
        load_state(st, a.h0 + sbase, tl, a.dh_, a.N);
      else
        load_own(st, ck + (size_t)c * kState);
      for (int w = 0; w < nw; ++w) {  // the interval's window starts
        store_own(snap + (size_t)w * kState, st);
        if (w == nw - 1) break;
        __syncthreads();
        stage<T>(a, sm, b, h, tc + w * kW, kW, false);
        __syncthreads();
        for (int j = 0; j < kW; ++j) fwd_step(st, sm, j, tl);
      }
      for (int w = nw - 1; w >= 0; --w) {
        const int t0 = tc + w * kW, n = min(kW, S - t0);
        __syncthreads();
        stage<T>(a, sm, b, h, t0, n, true);
        load_own(st, snap + (size_t)w * kState);
        __syncthreads();
        store_own(sm.ws[0], st);
        for (int j = 0; j < n; ++j) {
          fwd_step(st, sm, j, tl);
          store_own(sm.ws[j + 1], st);
        }
        for (int j = n - 1; j >= 0; --j)
          bwd_step(g, sm, j, tl, a,
                   (((size_t)b * S + t0 + j) * a.H + h) * a.dh_);
        __syncthreads();
        window_sums(a, sm, b, h, t0, n);
      }
    }
    store_state(a.dh0 + sbase, g, tl, a.dh_, a.N);
  }
}

// dB and dC: the per-head sums added over the heads in order
__global__ void mamba_scan_bwd_f32_heads_sum_kernel(
    const float* __restrict__ dBh, const float* __restrict__ dCh,
    float* __restrict__ dB, float* __restrict__ dC, int rows, int H, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * N) return;
  const size_t r = i / N, n = i % N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dBh[(r * H + h) * N + n];
    sc += dCh[(r * H + h) * N + n];
  }
  dB[i] = sb;
  dC[i] = sc;
}

// ---------------------------------------------------------------------------
// Chunked form
// ---------------------------------------------------------------------------
constexpr int kBwdChunkMin = 32;  // steps from which the chunked form runs
namespace ck = scan_bwd_chunk;
constexpr int kC = ck::kC, kSub = ck::kSub, kNSub = ck::kNSub;
constexpr int kLd4 = kMax + 4;  // stride of tiles whose rows feed fragments
constexpr int kLd8 = kMax + 8;  // stride of tiles read down their columns
constexpr int kCWarps = 16;
constexpr int kCThreads = 32 * kCWarps;

template <typename T>
struct ChunkSmem {
  float x[kC][kLd4];    // x_s [s][d] (not scaled by dt); first its raw rows
  float dy[kC][kLd4];   // dy_t [t][d]
  float b[kC][kLd4];    // B_s [s][n]
  float c[kC][kLd4];    // C_t [t][n]
  float hs[kMax][kLd8];  // the state at the chunk's start [d][n]
  float ge[kMax][kLd4];  // the adjoint at its end [d][n]
  float L[kC][kLd4];    // seg(j->i) [i][j], 0 above the diagonal
  float m[kC][kLd8];    // (C B^T) (*) L [i][j]
  float dl[kC][kLd4];   // (dy x^T) (*) L [i][j]
  float w[kC][kLd4];    // (dy_i . dt_j x_j) (C_i . B_j) for j < i, else 0
  T x_in[kC * kMax];    // x as it lies in memory
  float lin[kNSub][kSub][kSub];  // seg(s->t) within sub-chunk i
  float dt[kC], dec[kC];
  float incl[kC];    // the sub-chunk's decays from its start up to t
  float suffix[kC];  // after s up to the sub-chunk's end
  float a[kC];       // seg(start->t)
  float ap[kC];      // seg(start->t-1), 1 at the chunk's first step
  float e[kC];       // seg(s->end)
  float btw[kNSub][kNSub];  // [j][i]: the sub-chunks strictly between
  float red[4][4][kC];  // per column block: ddt, V, U; per row block: R
  float vec[2][kC];     // U, V
  float hg[kCWarps];    // <h, g> by warp
};

// sum over the four lanes of a quad (one accumulator row's columns)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Phase 3: one block a (head, chunk, batch row), from the chunk's start
// state and end adjoint (phases 1 and 2, `bounds`)
template <typename T>
__global__ void __launch_bounds__(kCThreads, 1)
mamba_scan_bwd_f32_chunk_kernel(Args a, const float* __restrict__ bounds) {
  using namespace scan_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<T>& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int S = a.S, H = a.H, dh = a.dh_, N = a.N, nC = ck::chunks(S);
  const int t0 = c * kC, steps = min(kC, S - t0);
  const size_t item = (size_t)b * H + h, row = (size_t)b * S + t0;
  const int kn = (N + 7) / 8, kd = (dh + 7) / 8;  // k-steps over n and d
  const T* x = static_cast<const T*>(a.x);

  // 0. zeros where the copies write nothing (past the end and the widths);
  // steps past the end carry dt 0 and decay 1
  for (int i = tid; i < kC * kMax; i += kCThreads) {
    const int t = i / kMax, j = i % kMax;
    sm.dy[t][j] = 0.f;
    sm.b[t][j] = 0.f;
    sm.c[t][j] = 0.f;
  }
  if (tid < kC) {
    sm.dt[tid] = 0.f;
    sm.dec[tid] = 1.f;
  }
  __syncthreads();
  {
    using scan_mma::copy_rows;
    const int xb = dh * (int)sizeof(T);
    copy_rows(sm.x_in, xb, x + (row * H + h) * dh, (size_t)H * xb, steps, xb);
    copy_rows(sm.dy, kLd4 * 4, a.dy + (row * H + h) * dh, (size_t)H * dh * 4,
              steps, dh * 4);
    copy_rows(sm.b, kLd4 * 4, a.Bm + row * N, (size_t)N * 4, steps, N * 4);
    copy_rows(sm.c, kLd4 * 4, a.Cm + row * N, (size_t)N * 4, steps, N * 4);
    copy_rows(sm.dt, 4, a.dt + row * H + h, (size_t)H * 4, steps, 4);
    copy_rows(sm.dec, 4, a.decay + row * H + h, (size_t)H * 4, steps, 4);
    cp_async_commit();
    // the start state and end adjoint, first needed after step 2
    const float* hs = bounds + (item * nC + c) * ck::kState;
    const float* ge = hs + (size_t)a.B * H * nC * ck::kState;
    copy_rows(sm.hs, kLd8 * 4, hs, kMax * 4, kMax, kMax * 4);
    copy_rows(sm.ge, kLd4 * 4, ge, kMax * 4, kMax, kMax * 4);
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();
  using ck::tile_mma;

  // 1. x into its tile; the decay factors, all running products of decays
  // <= 1 (mamba_scan.cu's)
  for (int i = tid; i < kC * kMax; i += kCThreads) {
    const int t = i / kMax, j = i % kMax;
    sm.x[t][j] = (t < steps && j < dh) ? to_f32(sm.x_in[t * dh + j]) : 0.f;
  }
  if (tid < kC + kNSub * kNSub) {
    float total[kNSub];
#pragma unroll
    for (int m = 0; m < kNSub; ++m) {
      float run = 1.f;
#pragma unroll
      for (int u = kSub * m; u < kSub * (m + 1); ++u) run *= sm.dec[u];
      total[m] = run;
    }
    if (tid < kC) {  // step t = tid of sub-chunk i
      const int i = tid / kSub, l = tid % kSub, base = kSub * i;
      float incl = 1.f, excl = 1.f, suffix = 1.f, before = 1.f, after = 1.f;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (u < l) excl *= sm.dec[base + u];
        if (u <= l) incl *= sm.dec[base + u];
      }
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u)
        if (u > l) suffix *= sm.dec[base + u];
      float run = 1.f;  // seg(s->t) with s = l, down the column
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        if (t > l) run *= sm.dec[base + t];
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
      sm.ap[tid] = before * excl;
      sm.e[tid] = suffix * after;
    } else {
      const int j = (tid - kC) / kNSub, i = (tid - kC) % kNSub;
      float run = 1.f;
#pragma unroll
      for (int m = kNSub - 1; m >= 0; --m)
        if (m < i && m > j) run *= total[m];
      sm.btw[j][i] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < kC * kC; i += kCThreads) {
    const int t = i / kC, s = i % kC, ti = t / kSub, sj = s / kSub;
    float L = 0.f;
    if (s <= t) {
      if (sj == ti) {
        L = sm.lin[ti][t % kSub][s % kSub];
      } else {
        L = sm.incl[t];
        if (sj < ti - 1) L *= sm.btw[sj][ti];
        L *= sm.suffix[s];
      }
    }
    sm.L[t][s] = L;
  }
  __syncthreads();

  // each warp a 16 x 16 tile of every 64 x 64 product: row block rb,
  // column block cb
  const int rb = warp % 4, cb = warp / 4, r0 = 16 * rb, q0 = 16 * cb;
  const int lg = (tid & 31) >> 2, lq = tid & 3;

  // 2. G = C B^T and D = dy x^T on the lower block triangle ([i][j], i the
  // later step); M = G (*) L, DL = D (*) L, W = D (*) G dt_j below the
  // diagonal
  {
    float g[2][4] = {}, d[2][4] = {};
    if (cb <= rb) {
      tile_mma(g, [&](int r, int k) { return sm.c[r][k]; },
               [&](int k, int cc) { return sm.b[cc][k]; }, r0, q0, 0, kn);
      tile_mma(d, [&](int r, int k) { return sm.dy[r][k]; },
               [&](int k, int cc) { return sm.x[cc][k]; }, r0, q0, 0, kd);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = acc_row(r0, e), j = acc_col(q0 + 8 * nt, e);
        const float L = sm.L[i][j];
        sm.m[i][j] = g[nt][e] * L;
        sm.dl[i][j] = d[nt][e] * L;
        sm.w[i][j] = j < i ? d[nt][e] * g[nt][e] * sm.dt[j] : 0.f;
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  {  // <h, g> by warp
    float part = 0.f;
    for (int i = tid; i < kMax * kMax; i += kCThreads)
      part += sm.hs[i / kMax][i % kMax] * sm.ge[i / kMax][i % kMax];
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (tid % 32 == 0) sm.hg[warp] = part;
  }
  const int ksteps = (steps + 7) / 8;  // k-steps over the chunk's steps

  // 3. dx = dt (M^T dy + e (B g^T)) [t][d], then d dt = x . (dx / dt) and
  // V = dt x . (B g^T) row by row (the column blocks' partials)
  {
    float acc[2][4] = {}, pd[2] = {0.f, 0.f}, pv[2] = {0.f, 0.f};
    tile_mma(acc, [&](int r, int k) { return sm.b[r][k]; },
             [&](int k, int cc) { return sm.ge[cc][k]; }, r0, q0, 0, kn);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), d = acc_col(q0 + 8 * nt, e);
        pv[e >> 1] = fmaf(sm.x[t][d], acc[nt][e], pv[e >> 1]);
        acc[nt][e] *= sm.e[t];
      }
    tile_mma(acc, [&](int r, int k) { return sm.m[k][r]; },
             [&](int k, int cc) { return sm.dy[k][cc]; }, r0, q0, 2 * rb,
             ksteps);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), d = acc_col(q0 + 8 * nt, e);
        pd[e >> 1] = fmaf(sm.x[t][d], acc[nt][e], pd[e >> 1]);
        if (t < steps && d < dh)
          a.dx[(row + t) * H * dh + (size_t)h * dh + d] = sm.dt[t] * acc[nt][e];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      pd[hi] = quad_sum(pd[hi]);
      pv[hi] = quad_sum(pv[hi]);
      if (lq == 0) {
        const int t = r0 + lg + 8 * hi;
        sm.red[0][cb][t] = pd[hi];
        sm.red[1][cb][t] = sm.dt[t] * pv[hi];
      }
    }
  }

  // 4. dB (this head's) = dt ((DL)^T C + e (x g)) [t][n]
  if (q0 < N) {
    float acc[2][4] = {};
    tile_mma(acc, [&](int r, int k) { return sm.x[r][k]; },
             [&](int k, int cc) { return sm.ge[k][cc]; }, r0, q0, 0, kd);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= sm.e[acc_row(r0, e)];
    tile_mma(acc, [&](int r, int k) { return sm.dl[k][r]; },
             [&](int k, int cc) { return sm.c[k][cc]; }, r0, q0, 2 * rb,
             ksteps);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), n = acc_col(q0 + 8 * nt, e);
        if (t < steps && n < N)
          a.dBh[((row + t) * H + h) * N + n] = sm.dt[t] * acc[nt][e];
      }
  }

  // 5. dC (this head's) = DL (dt B) + a (dy h) [t][n], and U = (dy h) . C
  // row by row
  {
    float acc[2][4] = {}, pu[2] = {0.f, 0.f};
    if (q0 < N)
      tile_mma(acc, [&](int r, int k) { return sm.dy[r][k]; },
               [&](int k, int cc) { return sm.hs[k][cc]; }, r0, q0, 0, kd);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), n = acc_col(q0 + 8 * nt, e);
        pu[e >> 1] = fmaf(acc[nt][e], sm.c[t][n], pu[e >> 1]);
        acc[nt][e] *= sm.a[t];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      pu[hi] = quad_sum(pu[hi]);
      if (lq == 0) sm.red[2][cb][r0 + lg + 8 * hi] = pu[hi];
    }
    if (q0 < N) {
      tile_mma(acc, [&](int r, int k) { return sm.dl[r][k]; },
               [&](int k, int cc) { return sm.dt[k] * sm.b[k][cc]; }, r0, q0,
               0, min(2 * rb + 2, ksteps));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = acc_row(r0, e), n = acc_col(q0 + 8 * nt, e);
          if (t < steps && n < N)
            a.dCh[((row + t) * H + h) * N + n] = acc[nt][e];
        }
    }
  }

  // 6. the decay's gradient over the rectangle s < v <= t: Z = W Pre with
  // Pre[s][v] = L[v-1][s] (the decays after s up to v, v left out), then R_v
  // = sum_t Z[t][v] L[t][v] (after v up to t): the row blocks' partials
  {
    float z[2][4] = {};
    // s < t and s < v
    tile_mma(z, [&](int r, int k) { return sm.w[r][k]; },
             [&](int k, int cc) { return cc > 0 ? sm.L[cc - 1][k] : 0.f; },
             r0, q0, 0, min(min(2 * rb, 2 * cb) + 2, ksteps));
    float pr[2][2] = {};  // [column tile][column parity]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), v = acc_col(q0 + 8 * nt, e);
        pr[nt][e & 1] = fmaf(z[nt][e], sm.L[t][v], pr[nt][e & 1]);
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v = pr[nt][p];
#pragma unroll
        for (int o = 4; o < 32; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lg == 0) sm.red[3][rb][q0 + 8 * nt + 2 * lq + p] = v;
      }
  }
  __syncthreads();

  // 7. the partials summed in order; d decay_v = R_v + seg(start->v-1)
  // sum_{t>=v} seg(v->t) U_t + seg(v->end) sum_{s<v} seg(s->v-1) V_s +
  // seg(start->v-1) seg(v->end) <h, g>
  float R = 0.f;
  if (tid < kC) {
    const int v = tid;
    float ddt = 0.f, V = 0.f, U = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ddt += sm.red[0][k][v];
      V += sm.red[1][k][v];
      U += sm.red[2][k][v];
      R += sm.red[3][k][v];
    }
    sm.vec[0][v] = U;
    sm.vec[1][v] = V;
    if (v < steps) a.ddt[(row + v) * H + h] = ddt;
  }
  __syncthreads();
  if (tid < kC) {
    const int v = tid;
    float th = 0.f, tg = 0.f, hg = 0.f;
    for (int t = v; t < kC; ++t) th = fmaf(sm.L[t][v], sm.vec[0][t], th);
    for (int s = 0; s < v; ++s) tg = fmaf(sm.L[v - 1][s], sm.vec[1][s], tg);
#pragma unroll
    for (int k = 0; k < kCWarps; ++k) hg += sm.hg[k];
    const float ap = sm.ap[v], e = sm.e[v];
    if (v < steps)
      a.ddecay[(row + v) * H + h] = R + ap * th + e * tg + ap * e * hg;
  }
}

// Phases 1 and 2 of the chunked form (scan_bwd_chunk.cuh): the state from
// dt x and B, one decay a step; the adjoint from dy and C, its factors
// taking each step's own decay
template <typename T>
__global__ void __launch_bounds__(ck::kBThreads, 2)
mamba_scan_bwd_f32_bounds_kernel(ck::BoundsArgs a) {
  ck::bounds_body<ck::Walk<T, float, false, true, false, false>,
                  ck::Walk<float, float, false, false, true, true>>(a);
}

template <typename T>
cudaError_t launch(const Args& a, int slots, cudaStream_t s) {
  cudaError_t err;
  if (a.S < kBwdChunkMin) {
    static size_t raised = 0;
    auto kernel = mamba_scan_bwd_f32_kernel<T>;
    err = allow_smem(kernel, sizeof(Smem), &raised);
    if (err != cudaSuccess) return err;
    kernel<<<slots, kThreads, sizeof(Smem), s>>>(a);
  } else {
    // phases 1 and 2: the chunks' start states (x, dt, B from h0) and end
    // adjoints (dy, C from d h_final, in reverse; the last is d h0)
    const int nC = ck::chunks(a.S);
    const long long sh = (long long)a.S * a.H;
    ck::BoundsArgs ba;
    const ck::Operand dec{a.decay, sh, 1, a.H, 1};
    ba.side[0] = {{a.x, sh * a.dh_, a.dh_, (long long)a.H * a.dh_, a.dh_},
                  {a.Bm, (long long)a.S * a.N, 0, a.N, a.N},
                  dec,
                  {a.dt, sh, 1, a.H, 1},
                  a.h0, a.scratch, nullptr};
    ba.side[1] = {{a.dy, sh * a.dh_, a.dh_, (long long)a.H * a.dh_, a.dh_},
                  {a.Cm, (long long)a.S * a.N, 0, a.N, a.N},
                  dec,
                  {nullptr, 0, 0, 0, 1},
                  a.dh,
                  a.scratch + (size_t)a.B * a.H * nC * ck::kState,
                  a.dh0};
    ba.S = a.S;
    ba.H = a.H;
    ba.rows = a.dh_;
    ba.cols = a.N;
    static size_t raised_b = 0, raised_c = 0;
    auto bounds = mamba_scan_bwd_f32_bounds_kernel<T>;
    err = allow_smem(bounds, sizeof(ck::BoundsSmem), &raised_b);
    if (err != cudaSuccess) return err;
    bounds<<<dim3(2, a.H, a.B), ck::kBThreads, sizeof(ck::BoundsSmem), s>>>(
        ba);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // phase 3: each chunk's gradients
    auto kernel = mamba_scan_bwd_f32_chunk_kernel<T>;
    err = allow_smem(kernel, sizeof(ChunkSmem<T>), &raised_c);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.H, nC, a.B), kCThreads, sizeof(ChunkSmem<T>), s>>>(
        a, a.scratch);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = a.B * a.S, threads = 256;
  const int blocks = (int)(((size_t)rows * a.N + threads - 1) / threads);
  mamba_scan_bwd_f32_heads_sum_kernel<<<blocks, threads, 0, s>>>(
      a.dBh, a.dCh, a.dB_out, a.dC_out, rows, a.H, a.N);
  return cudaGetLastError();
}

}  // namespace

// Inputs as mamba_scan_f32 takes them (x_bf16: x holds bf16 values), dy
// [B, S, H, dh] and dh [B, H, dh, N] fp32. Outputs, all fp32: dx [B, S, H,
// dh], ddt, ddecay [B, S, H], dB, dC [B, S, N], dh0 [B, H, dh, N]; dBh, dCh
// [B, S, H, N] the per-head sums and `scratch`, both scratch: below
// kBwdChunkMin steps `slots` x slot_floats(S) floats and `slots` blocks,
// each taking (head, batch row) items in turn; from it 2 x B x H x
// ceil(S / 64) x 64 x 64 floats (each chunk's start state, then each end
// adjoint) and `slots` unused. dh and N at most 64; the wrapper
// (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity. One
// launch of the entry point: the walk, or phases 1-2 and 3; then the
// heads' sum.
extern "C" int mamba_scan_bwd_f32(
    const void* x, const void* dt, const void* decay, const void* Bm,
    const void* Cm, const void* h0, const void* dy, const void* dh, void* dx,
    void* ddt, void* ddecay, void* dB, void* dC, void* dh0, void* dBh,
    void* dCh, void* scratch, int x_bf16, int B, int S, int H, int dh_,
    int N, int slots, void* stream) {
  if (dh_ < 1 || dh_ > kMax || N < 1 || N > kMax || S < 1 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.decay = static_cast<const float*>(decay);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.h0 = static_cast<const float*>(h0);
  a.dy = static_cast<const float*>(dy);
  a.dh = static_cast<const float*>(dh);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.ddecay = static_cast<float*>(ddecay);
  a.dBh = static_cast<float*>(dBh);
  a.dCh = static_cast<float*>(dCh);
  a.dB_out = static_cast<float*>(dB);
  a.dC_out = static_cast<float*>(dC);
  a.dh0 = static_cast<float*>(dh0);
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.S = S;
  a.H = H;
  a.dh_ = dh_;
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16 ? launch<__nv_bfloat16>(a, slots, s)
                                 : launch<float>(a, slots, s));
}
