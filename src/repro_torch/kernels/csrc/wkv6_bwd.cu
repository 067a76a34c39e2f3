// The gradient of RWKV6's WKV recurrence (wkv6.cu) on Hopper, fp32: for the
// forward y_t = r_t . (S_{t-1} + (u (*) k_t) (outer) v_t), S_t = w_t (*)
// S_{t-1} + k_t (outer) v_t (S [dh, dh] indexed [d, e], w and u scaling its
// rows d) over a whole sequence, given dy and the gradient of the final
// state, with G = d L / d S_t (G = d s_final after the last step) and
// p_t = dy_t . v_t:
//   dr_t = S_{t-1} dy_t + u (*) k_t p_t,   dw_t = rowsum(G (*) S_{t-1}),
//   dk_t = G v_t + r_t (*) u p_t,
//   dv_t = G^T k_t + (r_t . (u (*) k_t)) dy_t,   du += r_t (*) k_t p_t,
// then G = w_t (*) G + r_t (outer) dy_t,
// and d s0 = G after the first step. du is summed over batch rows too.
//
// Replaces no Pallas kernel: it is the gradient JAX takes of the reference's
// `jax.lax.scan` in `_wkv_sequential` (src/repro/models/ssm.py:234) when
// the SSM family trains. Launched by `WKV6.backward`
// (kernels/ssm_scan/ops.py) once an RWKV6 layer a training step.
//
// Bound. Each (d, e, t) needs at least 14 fp32 operations: 3 to recompute
// the state once, 3 for G, 8 for the four sums (dr, dw, dk, dv): at
// RWKV6-1.6B's training step (B 8, S 512, 32 heads of dh 64) that is 7.5
// GFLOP, 0.11 ms on the CUDA cores (67 TFLOP/s), against ~0.3 GB of inputs
// and outputs (~0.09 ms).
//
// Two forms behind one entry point, chosen by S; du is written per (batch
// row, head), or per (batch row, chunk, head), and a last kernel adds the
// parts in order either way: no atomics, so two launches are bitwise equal.
//
// Sequential (S < kBwdChunkMin): mamba_scan_bwd.cu's walk (scan_bwd.cuh): a
// persistent block of 256 threads per (head, batch row) item, a 4 x 4 tile
// of the state and of G a thread in registers; the state before each step
// recomputed forward from a checkpoint every kCk = 32 steps and a window
// start every kW = 4, never by dividing by w (w = exp(-exp(w_raw))
// underflows to 0 for w_raw above ~4.6); the recomputed states bitwise the
// plain loop's. Sums over a row (dr, dw, dk) take four shuffles among 16
// lanes, the one over a column (dv) one shuffle and the 8 warps' partials
// added in order.
//
// Chunked (S >= kBwdChunkMin: the training step). The forward's chunked
// form (wkv6.cu) in reverse, in GLA form: chunks of kC = 64 steps in
// sub-chunks of kSub = 16, the per-channel decays folded into r and k by
// the forward's factors (r~ = r (*) the product from the query sub-chunk's
// start up to t, kq = k (*) the product after s to the key sub-chunk's end,
// times those of the sub-chunks strictly between), all running products
// of decays <= 1 (no division, no log; the reference's `_wkv_chunked`
// divides k by a cumulative product), in three phases:
//   1, 2 (scan_bwd_chunk.cuh) each chunk's start state S0 and end adjoint
//     Ge, one [64 x 64 x 64] product a chunk each, into scratch;
//   3 (wkv6_bwd_f32_chunk_kernel, one block a (head, chunk, batch row):
//     2,048 blocks at the training step) the chunk's gradients from S0 and
//     Ge alone. With P = dy v^T (p_t its diagonal), Hs = dy S0^T, Gv = v
//     Ge^T and A the forward's (diagonal blocks on the CUDA cores as the
//     forward takes them, the bonus r . (u (*) k) on the diagonal):
//       dv = (kq (*) after) Ge + A^T dy
//       Yr = before (*) Hs + sum_{j<i} P_ij (kq_j (*) between)
//       Yk = after (*) Gv + sum_{i>j} P_ij^T (r~_i (*) between)
//       dr = excl (*) Yr + (P's diagonal blocks, walked) + u k p
//       dk = suffix (*) Yk + (P's diagonal blocks, walked) + r u p
//     on the tensor cores in 3xTF32 (scan_mma.cuh), each warp a 16 x 16
//     tile. dw_v[d] is a sum over s < v < t of P[t][s] k_s[d] r_t[d] times
//     the decays from s to t with v left out: per channel, so no single
//     product carries it. It is split by where s and t lie against v's
//     sub-chunk m: both outside (the sums X of whole sub-chunks' pairs,
//     S0 and Ge standing in as a step before the chunk and one after it,
//     times the sub-chunk products between), s before m (Yr, walked back
//     through m), t after m (Yk, walked forward), both inside (walked per
//     key). Each is a running product of decays: no division. The walks
//     run per (sub-chunk, channel) on the CUDA cores, dr / dk on one half
//     of the block and dw on the other. wkv6_bwd_chunked_plain
//     (kernels/ssm_scan/ops.py) is this algorithm as tensor code, held to
//     the plain backward and to jax.vjp of the reference by
//     tests/test_torch_scan_bwd_chunked.py.
// Bound by instruction issue at one block of 512 threads an SM (~205 KB of
// tiles): the 3xTF32 fragments' splits, then the walks. kBwdChunkMin = 32:
// at B 8 the chunked form took 74 against the walk's 77 us at S 32 and 72
// against 59 at S 24 on the H100 (tools/scan_bwd_probe.py with the
// threshold lowered, PERF.md).
#include "cp_async.cuh"
#include "scan_bwd.cuh"
#include "scan_bwd_chunk.cuh"
#include "scan_mma.cuh"

namespace {

using namespace scan_bwd;

struct Smem {
  float ws[kW + 1][kState];  // the window's states before and after each step
  __align__(16) float rs[kW][kMax];
  __align__(16) float ks[kW][kMax];
  __align__(16) float wts[kW][kMax];
  __align__(16) float vs[kW][kMax];
  __align__(16) float dys[kW][kMax];
  __align__(16) float us[kMax];
  float dots[kW], ruk[kW];          // dy_t . v_t and r_t . (u (*) k_t)
  float colw[kW][kWarps][kMax];     // dv's first term: a warp's partials
};

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *s0, *dy, *ds;
  float *dr, *dk, *dv, *dw, *du_part, *du, *ds0, *scratch;
  int B, S, H, dh;
};

// Stage steps t0 .. t0 + n - 1 of head h, batch row b (r, k, w, v; with
// `bwd` also dy); steps past n read k 0 and w 1.
template <typename T>
__device__ void stage(const Args& a, Smem& sm, int b, int h, int t0, int n,
                      bool bwd) {
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < kW * kMax; i += kThreads) {
    const int j = i / kMax, c = i % kMax;
    const bool ok = j < n && c < a.dh;
    const size_t o = (((size_t)b * a.S + t0 + j) * a.H + h) * a.dh + c;
    sm.ks[j][c] = ok ? to_f32(k[o]) : 0.f;
    sm.vs[j][c] = ok ? to_f32(v[o]) : 0.f;
    sm.wts[j][c] = ok ? a.w[o] : 1.f;
    if (bwd) {
      sm.rs[j][c] = ok ? to_f32(r[o]) : 0.f;
      sm.dys[j][c] = ok ? a.dy[o] : 0.f;
    }
  }
}

// p_t = dy_t . v_t and r_t . (u (*) k_t), warp j taking step j
__device__ void step_dots(Smem& sm, int n, const Tile& tl) {
  if (tl.warp >= n) return;
  const int j = tl.warp, l = tl.lane;
  float p = sm.dys[j][l] * sm.vs[j][l] + sm.dys[j][l + 32] * sm.vs[j][l + 32];
  float q = sm.rs[j][l] * (sm.us[l] * sm.ks[j][l]) +
            sm.rs[j][l + 32] * (sm.us[l + 32] * sm.ks[j][l + 32]);
  p = sum32(p);
  q = sum32(q);
  if (l == 0) {
    sm.dots[j] = p;
    sm.ruk[j] = q;
  }
}

// one forward step, the plain version's rounded operations in its order
__device__ __forceinline__ void fwd_step(float (&st)[kVals], const Smem& sm,
                                         int j, const Tile& tl) {
  float kk[4], ww[4], vv[4];
  read4(kk, &sm.ks[j][4 * tl.rt]);
  read4(ww, &sm.wts[j][4 * tl.rt]);
  read4(vv, &sm.vs[j][4 * tl.ct]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st[4 * i + c] = __fadd_rn(__fmul_rn(st[4 * i + c], ww[i]),
                                __fmul_rn(kk[i], vv[c]));
}

// Step j of the window backward: G is d L / d S_t on entry and d L / d
// S_{t-1} on exit; du accumulates this thread's rows' terms.
__device__ __forceinline__ void bwd_step(float (&G)[kVals], float (&du)[4],
                                         Smem& sm, int j, const Tile& tl,
                                         const Args& a, size_t row) {
  float rr[4], kk[4], ww[4], uu[4], vv[4], dyy[4];
  read4(rr, &sm.rs[j][4 * tl.rt]);
  read4(kk, &sm.ks[j][4 * tl.rt]);
  read4(ww, &sm.wts[j][4 * tl.rt]);
  read4(uu, &sm.us[4 * tl.rt]);
  read4(vv, &sm.vs[j][4 * tl.ct]);
  read4(dyy, &sm.dys[j][4 * tl.ct]);
  const float* sp = sm.ws[j];  // S_{t-1}
  float ar[4] = {0.f, 0.f, 0.f, 0.f}, aw[4] = {0.f, 0.f, 0.f, 0.f},
        ak[4] = {0.f, 0.f, 0.f, 0.f}, cv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = 4 * i + c;
      const float s = sp[own(v)];
      ar[i] = fmaf(dyy[c], s, ar[i]);
      aw[i] = fmaf(G[v], s, aw[i]);
      ak[i] = fmaf(G[v], vv[c], ak[i]);
      cv[c] = fmaf(G[v], kk[i], cv[c]);
      G[v] = fmaf(G[v], ww[i], rr[i] * dyy[c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ar[i] = sum16(ar[i]);
    aw[i] = sum16(aw[i]);
    ak[i] = sum16(ak[i]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    cv[c] += __shfl_xor_sync(0xffffffffu, cv[c], 16);
  if (tl.lane < 16) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sm.colw[j][tl.warp][4 * tl.ct + c] = cv[c];
  }
  if (tl.ct == 0) {
    const float p = sm.dots[j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * tl.rt + i;
      if (d >= a.dh) continue;
      a.dr[row + d] = fmaf(uu[i] * kk[i], p, ar[i]);
      a.dk[row + d] = fmaf(rr[i] * uu[i], p, ak[i]);
      a.dw[row + d] = aw[i];
      du[i] = fmaf(rr[i] * kk[i], p, du[i]);
    }
  }
}

// dv of the window: the warps' partials added in order, plus the bonus term
__device__ void window_sums(const Args& a, const Smem& sm, int b, int h,
                            int t0, int n) {
  for (int i = threadIdx.x; i < n * kMax; i += kThreads) {
    const int j = i / kMax, e = i % kMax;
    if (e >= a.dh) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm.colw[j][w][e];
    a.dv[(((size_t)b * a.S + t0 + j) * a.H + h) * a.dh + e] =
        fmaf(sm.ruk[j], sm.dys[j][e], s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const Tile tl;
  const int S = a.S, nC = (S + kCk - 1) / kCk;
  float* ck = a.scratch + (size_t)blockIdx.x * slot_floats(S);
  float* snap = ck + (size_t)nC * kState;
  float st[kVals], G[kVals], du[4];

  for (int item = blockIdx.x; item < a.B * a.H; item += gridDim.x) {
    const int h = item % a.H, b = item / a.H;
    const size_t sbase = ((size_t)b * a.H + h) * a.dh * a.dh;
    __syncthreads();
    if (threadIdx.x < kMax)
      sm.us[threadIdx.x] =
          threadIdx.x < a.dh ? a.u[(size_t)h * a.dh + threadIdx.x] : 0.f;

    // pass 1: the forward, a checkpoint every kCk steps (the first is s0)
    load_state(st, a.s0 + sbase, tl, a.dh, a.dh);
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
    load_state(G, a.ds + sbase, tl, a.dh, a.dh);
#pragma unroll
    for (int i = 0; i < 4; ++i) du[i] = 0.f;
    for (int c = nC - 1; c >= 0; --c) {
      const int tc = c * kCk, nw = (min(kCk, S - tc) + kW - 1) / kW;
      if (c == 0)
        load_state(st, a.s0 + sbase, tl, a.dh, a.dh);
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
        step_dots(sm, n, tl);
        store_own(sm.ws[0], st);
        for (int j = 0; j < n; ++j) {
          fwd_step(st, sm, j, tl);
          store_own(sm.ws[j + 1], st);
        }
        __syncthreads();
        for (int j = n - 1; j >= 0; --j)
          bwd_step(G, du, sm, j, tl, a,
                   (((size_t)b * S + t0 + j) * a.H + h) * a.dh);
        __syncthreads();
        window_sums(a, sm, b, h, t0, n);
      }
    }
    store_state(a.ds0 + sbase, G, tl, a.dh, a.dh);
    if (tl.ct == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * tl.rt + i;
        if (d < a.dh) a.du_part[((size_t)b * a.H + h) * a.dh + d] = du[i];
      }
    }
  }
}

// du: the per-(batch row, head) sums added over the batch rows in order
__global__ void wkv6_bwd_f32_du_sum_kernel(const float* __restrict__ du_part,
                                   float* __restrict__ du, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[(size_t)b * n + i];
  du[i] = s;
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

struct ChunkSmem {
  float r[kC][kLd4];    // r_t [t][d]
  float k[kC][kLd4];    // k_s [s][d]
  float w[kC][kLd4];    // w_t [t][d]
  float dy[kC][kLd4];   // dy_t [t][e]
  float v[kC][kLd4];    // v_s [s][e]; then r~ = r (*) excl [t][d]
  float s0[kMax][kLd4];  // the chunk's start state [d][e]; then kq = k (*)
                         // suffix [s][d]
  float ge[kMax][kLd8];  // its end adjoint [d][e]
  float p[kC][kLd4];    // P = dy v^T [t][s]; first r's raw rows
  float hs[kC][kLd4];   // dy S0^T [t][d], then Yr; first k's raw rows
  float gv[kC][kLd4];   // v Ge^T [s][d], then Yk; first v's raw rows
  float a[kC][kLd8];    // A [t][s] (the forward's, the bonus on the diagonal)
  float u[kMax];
  float before[kNSub][kMax];  // the product of the sub-chunks before i
  float after[kNSub][kMax];   // of those after i
  float btw[kNSub][kNSub][kMax];  // [j][i]: of those strictly between
  float x[kNSub][kNSub][kMax];    // [j + 1][i - 1]: whole sub-chunks' sums
  float du[kNSub][kMax];
};

// one halving step of a sum over 16 lanes of 16 values (wkv6.cu's)
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

// Phase 3: one block a (head, chunk, batch row), from the chunk's start
// state and end adjoint (phases 1 and 2, `bounds`)
template <typename T>
__global__ void __launch_bounds__(kCThreads, 1)
wkv6_bwd_f32_chunk_kernel(Args a, const float* __restrict__ bounds) {
  using namespace scan_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int S = a.S, H = a.H, dh = a.dh, nC = ck::chunks(S);
  const int t0 = c * kC, steps = min(kC, S - t0);
  const size_t item = (size_t)b * H + h;
  const size_t base = (((size_t)b * S + t0) * H + h) * dh;  // (t0, h, 0)
  const size_t tstride = (size_t)H * dh;
  const int kd = (dh + 7) / 8;  // k-steps over the channels
  using ck::tile_mma;
  using ck::tile_mma2;
  T* raw[3] = {reinterpret_cast<T*>(&sm.p[0][0]),
               reinterpret_cast<T*>(&sm.hs[0][0]),
               reinterpret_cast<T*>(&sm.gv[0][0])};

  // 0. dy 0 and w 1 where the copies write nothing (past the end and dh)
  for (int i = tid; i < kC * kMax; i += kCThreads) {
    sm.dy[i / kMax][i % kMax] = 0.f;
    sm.w[i / kMax][i % kMax] = 1.f;
  }
  __syncthreads();
  {
    using scan_mma::copy_rows;
    const T* src[3] = {static_cast<const T*>(a.r), static_cast<const T*>(a.k),
                       static_cast<const T*>(a.v)};
    const int rb = dh * (int)sizeof(T);
    for (int q = 0; q < 3; ++q)
      copy_rows(raw[q], rb, src[q] + base, tstride * sizeof(T), steps, rb);
    copy_rows(sm.w, kLd4 * 4, a.w + base, tstride * 4, steps, dh * 4);
    copy_rows(sm.dy, kLd4 * 4, a.dy + base, tstride * 4, steps, dh * 4);
    cp_async_commit();
    // the start state and end adjoint, first needed by step 1's products
    const float* s0 = bounds + (item * nC + c) * ck::kState;
    const float* ge = s0 + (size_t)a.B * H * nC * ck::kState;
    copy_rows(sm.s0, kLd4 * 4, s0, kMax * 4, kMax, kMax * 4);
    copy_rows(sm.ge, kLd8 * 4, ge, kMax * 4, kMax, kMax * 4);
    cp_async_commit();
    if (tid < kMax) sm.u[tid] = tid < dh ? a.u[(size_t)h * dh + tid] : 0.f;
    cp_async_wait<1>();
  }
  __syncthreads();
  for (int i = tid; i < kC * kMax; i += kCThreads) {
    const int t = i / kMax, j = i % kMax;
    const bool live = t < steps && j < dh;
    sm.r[t][j] = live ? to_f32(raw[0][t * dh + j]) : 0.f;
    sm.k[t][j] = live ? to_f32(raw[1][t * dh + j]) : 0.f;
    sm.v[t][j] = live ? to_f32(raw[2][t * dh + j]) : 0.f;
  }
  __syncthreads();

  // each warp a 16 x 16 tile of every 64 x 64 product
  const int rb = warp % 4, cb = warp / 4, r0 = 16 * rb, q0 = 16 * cb;

  // 1. A's diagonal blocks on the CUDA cores (wkv6.cu's) and the decay
  // factors across sub-chunks; then, with the start state and end adjoint
  // in, P = dy v^T, Hs = dy S0^T, Gv = v Ge^T and <Ge, S0> per row
  {
    const int i = tid / 128, p = (tid / 16) % 8, dg = tid % 16;
    const int sb = kSub * i, d0 = 4 * dg;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int key = q == 0 ? p : kSub - 1 - p, sk = sb + key;
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
            part[tl] += sm.r[sb + tl][d0 + cc] * (kk[cc] * cw[cc]);
            cw[cc] *= sm.w[sb + tl][d0 + cc];
          }
        }
      }
      halve<8>(part, dg);
      halve<4>(part, dg);
      halve<2>(part, dg);
      halve<1>(part, dg);
      sm.a[sb + dg][sk] = part[0];  // 0 above the diagonal
    }
  }
  if (tid < kNSub * kMax) {
    const int i = tid / kMax, d = tid % kMax;
    float total[kNSub];
#pragma unroll
    for (int m = 0; m < kNSub; ++m) {
      float run = 1.f;
#pragma unroll
      for (int l = 0; l < kSub; ++l) run *= sm.w[kSub * m + l][d];
      total[m] = run;
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
  cp_async_wait<0>();
  __syncthreads();

  {
    // the raw rows are read (the barriers above): each tile takes its product
    const auto put = [&](float (*dst)[kLd4], const float (&acc)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[acc_row(r0, e)][acc_col(q0 + 8 * nt, e)] = acc[nt][e];
    };
    float acc[2][4] = {}, acc2[2][4] = {};
    tile_mma2(acc, acc2, [&](int r, int k) { return sm.dy[r][k]; },
              [&](int k, int cc) { return sm.v[cc][k]; },
              [&](int k, int cc) { return sm.s0[cc][k]; }, r0, q0, 0, kd);
    put(sm.p, acc);
    put(sm.hs, acc2);
    float acc3[2][4] = {};
    tile_mma(acc3, [&](int r, int k) { return sm.v[r][k]; },
             [&](int k, int cc) { return sm.ge[cc][k]; }, r0, q0, 0, kd);
    put(sm.gv, acc3);
  }
  if (tid < kMax) {
    float gs = 0.f;
    for (int e = 0; e < kMax; ++e) gs = fmaf(sm.ge[tid][e], sm.s0[tid][e], gs);
    sm.x[0][kNSub - 1][tid] = gs;  // X(-1, end)
  }
  __syncthreads();

  // 2. thread (sub-chunk i, channel d): r~ = r (*) prod_{ref<=u<t} w_u into
  // v's tile, kq = k (*) prod_{s<u<=end of i} w_u into S0's
  if (tid < kNSub * kMax) {
    const int i = tid / kMax, d = tid % kMax, sb = kSub * i;
    float run = 1.f;
#pragma unroll
    for (int l = 0; l < kSub; ++l) {
      sm.v[sb + l][d] = sm.r[sb + l][d] * run;
      run *= sm.w[sb + l][d];
    }
    run = 1.f;
#pragma unroll
    for (int l = kSub - 1; l >= 0; --l) {
      sm.s0[sb + l][d] = sm.k[sb + l][d] * run;
      run *= sm.w[sb + l][d];
    }
  }
  __syncthreads();
  const auto rt = [&](int t, int d) { return sm.v[t][d]; };
  const auto kq = [&](int s, int d) { return sm.s0[s][d]; };
  const auto btw = [&](int j, int i, int d) {
    return j < i - 1 ? sm.btw[j][i][d] : 1.f;
  };

  // 3. A below the diagonal blocks, r~ (kq (*) between)^T: warps 0-5 a
  // block (query sub-chunk i, key sub-chunk j < i) each; the whole
  // sub-chunks' sums X by (sum, channel): warps 6-11 the three of a pair of
  // sub-chunks (16 x 16 terms each), warps 12-15 the six against S0 or Ge
  if (warp < 6) {
    const int i = warp < 1 ? 1 : warp < 3 ? 2 : 3;
    const int j = warp - i * (i - 1) / 2;
    float acc[2][4] = {};
    tile_mma(acc, rt,
             [&](int k2, int cc) { return kq(cc, k2) * btw(j, i, k2); },
             kSub * i, kSub * j, 0, kd);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.a[acc_row(kSub * i, e)][acc_col(kSub * j + 8 * nt, e)] =
            acc[nt][e];
  } else {
    const int d = tid % kMax;
    for (int task = warp < 12 ? (warp - 6) / 2 : 3 + (warp - 12) / 2;
         task < (warp < 12 ? 3 : 9); task += warp < 12 ? 3 : 2) {
      float x = 0.f;
      if (task < 3) {  // (j, i) = (0, 2), (0, 3), (1, 3): r~_i . (P_ij kq_j)
        const int j = task == 2 ? 1 : 0, i = task == 0 ? 2 : 3;
        for (int t = kSub * i; t < kSub * (i + 1); ++t) {
          float in = 0.f;
#pragma unroll
          for (int l = 0; l < kSub; ++l)
            in = fmaf(sm.p[t][kSub * j + l], kq(kSub * j + l, d), in);
          x = fmaf(rt(t, d), in, x);
        }
        sm.x[j + 1][i - 1][d] = x;
      } else if (task < 6) {  // (-1, i), i = 1..3: r~_i . Hs_i
        const int i = task - 2;
        for (int t = kSub * i; t < kSub * (i + 1); ++t)
          x = fmaf(rt(t, d), sm.hs[t][d], x);
        sm.x[0][i - 1][d] = x;
      } else {  // (j, end), j = 0..2: kq_j . Gv_j
        const int j = task - 6;
        for (int s = kSub * j; s < kSub * (j + 1); ++s)
          x = fmaf(kq(s, d), sm.gv[s][d], x);
        sm.x[j + 1][kNSub - 1][d] = x;
      }
    }
  }
  __syncthreads();

  // 4. dv = (kq (*) after) Ge + A^T dy [t][e]; Yr = before (*) Hs + sum_{j<i}
  // P_ij (kq_j (*) between) and Yk = after (*) Gv + sum_{i>j} P_ij^T (r~_i
  // (*) between), each into its own tile in place
  const int ksteps = (steps + 7) / 8;  // k-steps over the chunk's steps
  {
    float acc[2][4] = {};
    tile_mma(acc, [&](int r, int k) { return kq(r, k) * sm.after[rb][k]; },
             [&](int k, int cc) { return sm.ge[k][cc]; }, r0, q0, 0, kd);
    tile_mma(acc, [&](int r, int k) { return sm.a[k][r]; },
             [&](int k, int cc) { return sm.dy[k][cc]; }, r0, q0, 2 * rb,
             ksteps);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = acc_row(r0, e), ec = acc_col(q0 + 8 * nt, e);
        if (t >= steps || ec >= dh) continue;
        float* out = a.dv + base + t * tstride + ec;
        if (ec + 1 < dh && dh % 2 == 0)
          *reinterpret_cast<float2*>(out) =
              make_float2(acc[nt][e], acc[nt][e + 1]);
        else
          for (int k2 = 0; k2 < 2 && ec + k2 < dh; ++k2)
            out[k2] = acc[nt][e + k2];
      }
  }
  {
    float yr[2][4], yk[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), d = acc_col(q0 + 8 * nt, e);
        yr[nt][e] = sm.before[rb][d] * sm.hs[t][d];
        yk[nt][e] = sm.after[rb][d] * sm.gv[t][d];
      }
    // keys of the sub-chunks before rb; queries of those after it
    tile_mma(yr, [&](int r, int k) { return sm.p[r][k]; },
             [&](int k, int cc) { return kq(k, cc) * btw(k / kSub, rb, cc); },
             r0, q0, 0, 2 * rb);
    tile_mma(yk, [&](int r, int k) { return sm.p[k][r]; },
             [&](int k, int cc) { return rt(k, cc) * btw(rb, k / kSub, cc); },
             r0, q0, 2 * rb + 2, ksteps);
    __syncthreads();  // every warp's reads of Hs and Gv are done
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(r0, e), d = acc_col(q0 + 8 * nt, e);
        sm.hs[t][d] = yr[nt][e];
        sm.gv[t][d] = yk[nt][e];
      }
  }
  __syncthreads();

  // 5. thread (sub-chunk m, channel d, role), a walk over the sub-chunk's
  // steps. Role 0: dr = excl Yr + (the diagonal block) + u k p, dk =
  // suffix Yk + (the diagonal block) + r u p, and du's partial. Role 1:
  // dw_v, the sum over s < v < t of P[t][s] k_s r_t times the decays from s
  // to t with v left out, by where s and t lie against m (both outside: the
  // X sums; s before m: Yr; t after m: Yk; both inside: walked here), no
  // division
  {
    const int role = tid / (kNSub * kMax), m = (tid / kMax) % kNSub;
    const int d = tid % kMax, sb = kSub * m;
    const auto w = [&](int l) { return sm.w[sb + l][d]; };
    float acc[kSub];
#pragma unroll
    for (int l = 0; l < kSub; ++l) acc[l] = 0.f;
    if (role == 0) {
      const float ud = sm.u[d];
      float du = 0.f;
      // dr's diagonal block: sum_{s<t} P[t][s] prod_{s<u<t} w_u k_s
#pragma unroll
      for (int s = 0; s < kSub - 1; ++s) {
        float run = sm.k[sb + s][d];
#pragma unroll
        for (int t = s + 1; t < kSub; ++t) {
          acc[t] = fmaf(sm.p[sb + t][sb + s], run, acc[t]);
          run *= w(t);
        }
      }
      float excl = 1.f;  // prod_{start of m<=u<t} w_u
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        const int t = sb + l;
        const float p = sm.p[t][t], kt = sm.k[t][d];
        du = fmaf(sm.r[t][d] * kt, p, du);
        if (t < steps && d < dh)
          a.dr[base + t * tstride + d] =
              fmaf(ud * kt, p, fmaf(excl, sm.hs[t][d], acc[l]));
        excl *= w(l);
      }
      // dk's: sum_{t>s} P[t][s] prod_{s<u<t} w_u r_t
#pragma unroll
      for (int s = 0; s < kSub - 1; ++s) {
        float run = 1.f, sum = 0.f;
#pragma unroll
        for (int t = s + 1; t < kSub; ++t) {
          sum = fmaf(sm.p[sb + t][sb + s] * run, sm.r[sb + t][d], sum);
          run *= w(t);
        }
        acc[s] = sum;
      }
      acc[kSub - 1] = 0.f;
      float suffix = 1.f;  // prod_{s<u<=end of m} w_u
#pragma unroll
      for (int l = kSub - 1; l >= 0; --l) {
        const int t = sb + l;
        if (t < steps && d < dh)
          a.dk[base + t * tstride + d] =
              fmaf(sm.r[t][d] * ud, sm.p[t][t],
                   fmaf(suffix, sm.gv[t][d], acc[l]));
        suffix *= w(l);
      }
      sm.du[m][d] = du;
    } else {
      // both inside: for each s, the sums over t > v walked back, then v
      // walked forward
#pragma unroll
      for (int s = 0; s < kSub - 2; ++s) {
        float cv[kSub];
        float run = 0.f;
#pragma unroll
        for (int v = kSub - 1; v > s; --v) {
          cv[v] = run;
          run = fmaf(sm.r[sb + v][d], sm.p[sb + v][sb + s], w(v) * run);
        }
        float pre = sm.k[sb + s][d];
#pragma unroll
        for (int v = s + 1; v < kSub; ++v) {
          acc[v] = fmaf(pre, cv[v], acc[v]);
          pre *= w(v);
        }
      }
      // both outside: s in sub-chunk j < m (j = -1: S0), t in i > m (i =
      // kNSub: Ge)
      float out = 0.f;
      for (int j = -1; j < m; ++j) {
        const float lead = j < 0 ? sm.before[m][d] : btw(j, m, d);
        for (int i = m + 1; i <= kNSub; ++i) {
          const float trail = i == kNSub ? sm.after[m][d] : btw(m, i, d);
          out = fmaf(lead * trail, sm.x[j + 1][i - 1][d], out);
        }
      }
      // s before m (Yr), walked back, scaled by excl_v; t after m (Yk),
      // walked forward, scaled by suffix_v; both outside scaled by both
      float excl[kSub], suffix[kSub];
      {
        float run = 1.f;
#pragma unroll
        for (int l = 0; l < kSub; ++l) {
          excl[l] = run;
          run *= w(l);
        }
        run = 1.f;
#pragma unroll
        for (int l = kSub - 1; l >= 0; --l) {
          suffix[l] = run;
          run *= w(l);
        }
      }
      float run = 0.f;
#pragma unroll
      for (int v = kSub - 1; v >= 0; --v) {
        acc[v] = fmaf(excl[v], run, acc[v]);
        run = fmaf(sm.r[sb + v][d], sm.hs[sb + v][d], w(v) * run);
      }
      run = 0.f;
#pragma unroll
      for (int v = 0; v < kSub; ++v) {
        acc[v] = fmaf(suffix[v], run, acc[v]);
        run = fmaf(sm.k[sb + v][d], sm.gv[sb + v][d], w(v) * run);
      }
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        const int t = sb + l;
        if (t < steps && d < dh)
          a.dw[base + t * tstride + d] =
              fmaf(excl[l] * suffix[l], out, acc[l]);
      }
    }
  }
  __syncthreads();
  if (tid < dh)
    a.du_part[(((size_t)b * nC + c) * H + h) * dh + tid] =
        ((sm.du[0][tid] + sm.du[1][tid]) + sm.du[2][tid]) + sm.du[3][tid];
}

// Phases 1 and 2 of the chunked form (scan_bwd_chunk.cuh): the state from
// k and v, the adjoint from r and dy, decays per row
template <typename T>
__global__ void __launch_bounds__(ck::kBThreads, 2)
wkv6_bwd_f32_bounds_kernel(ck::BoundsArgs a) {
  ck::bounds_body<ck::Walk<T, T, true, false, false, false>,
                  ck::Walk<T, float, true, false, true, false>>(a);
}

template <typename T>
cudaError_t launch(const Args& a, int slots, cudaStream_t s) {
  cudaError_t err;
  int parts = a.B;  // du's partials: one a batch row, or a (row, chunk)
  if (a.S < kBwdChunkMin) {
    static size_t raised = 0;
    auto kernel = wkv6_bwd_f32_kernel<T>;
    err = allow_smem(kernel, sizeof(Smem), &raised);
    if (err != cudaSuccess) return err;
    kernel<<<slots, kThreads, sizeof(Smem), s>>>(a);
  } else {
    // phases 1 and 2: the chunks' start states (k, v, w from s0) and end
    // adjoints (r, dy, w from d s_final, in reverse; the last is d s0)
    const int nC = ck::chunks(a.S);
    parts = a.B * nC;
    const long long rs = (long long)a.H * a.dh, sh = rs * a.S;
    const ck::Operand w{a.w, sh, a.dh, rs, a.dh};
    ck::BoundsArgs ba;
    ba.side[0] = {{a.k, sh, a.dh, rs, a.dh}, {a.v, sh, a.dh, rs, a.dh}, w,
                  {nullptr, 0, 0, 0, 1}, a.s0, a.scratch, nullptr};
    ba.side[1] = {{a.r, sh, a.dh, rs, a.dh}, {a.dy, sh, a.dh, rs, a.dh}, w,
                  {nullptr, 0, 0, 0, 1}, a.ds,
                  a.scratch + (size_t)a.B * a.H * nC * ck::kState, a.ds0};
    ba.S = a.S;
    ba.H = a.H;
    ba.rows = a.dh;
    ba.cols = a.dh;
    static size_t raised_b = 0, raised_c = 0;
    auto bounds = wkv6_bwd_f32_bounds_kernel<T>;
    err = allow_smem(bounds, sizeof(ck::BoundsSmem), &raised_b);
    if (err != cudaSuccess) return err;
    bounds<<<dim3(2, a.H, a.B), ck::kBThreads, sizeof(ck::BoundsSmem), s>>>(
        ba);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // phase 3: each chunk's gradients
    auto kernel = wkv6_bwd_f32_chunk_kernel<T>;
    err = allow_smem(kernel, sizeof(ChunkSmem), &raised_c);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.H, nC, a.B), kCThreads, sizeof(ChunkSmem), s>>>(
        a, a.scratch);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.H * a.dh;
  wkv6_bwd_f32_du_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(a.du_part,
                                                              a.du, parts, n);
  return cudaGetLastError();
}

}  // namespace

// Inputs as wkv6_f32 takes them (in_bf16: r, k and v hold bf16 values), dy
// [B, S, H, dh] and ds [B, H, dh, dh] fp32. Outputs, all fp32: dr, dk, dv,
// dw [B, S, H, dh], du [H, dh], ds0 [B, H, dh, dh]; du_part and `scratch`,
// both scratch: below kBwdChunkMin steps du_part [B, H, dh], `scratch`
// `slots` x slot_floats(S) floats and `slots` blocks, each taking (head,
// batch row) items in turn; from it du_part [B, ceil(S / 64), H, dh],
// `scratch` 2 x B x H x ceil(S / 64) x 64 x 64 floats (each chunk's start
// state, then each end adjoint) and `slots` unused. dh at most 64; the
// wrapper (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity.
// One launch of the entry point: the walk, or phases 1-2 and 3; then du's
// sum.
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            const void* dy, const void* ds, void* dr,
                            void* dk, void* dv, void* dw, void* du,
                            void* ds0, void* du_part, void* scratch,
                            int in_bf16, int B, int S, int H, int dh,
                            int slots, void* stream) {
  if (dh < 1 || dh > kMax || S < 1 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dy = static_cast<const float*>(dy);
  a.ds = static_cast<const float*>(ds);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dw = static_cast<float*>(dw);
  a.du = static_cast<float*>(du);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.S = S;
  a.H = H;
  a.dh = dh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(in_bf16 ? launch<__nv_bfloat16>(a, slots, s)
                                  : launch<float>(a, slots, s));
}
