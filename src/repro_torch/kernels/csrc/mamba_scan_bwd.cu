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
// TFLOP/s), against ~0.2 GB of inputs and outputs (~0.06 ms). The kernel
// recomputes the state twice more (once per checkpoint interval, once per
// window). The walk is a dependent chain of S steps a (batch row, head), so
// it is latency-bound like the sequential forward.
//
// Design (shared with wkv6_bwd.cu through scan_bwd.cuh). A persistent
// block of 256 threads takes one (head, batch row) item at a time; each
// thread owns a 4 x 4 tile of the 64 x 64 state in registers. Never is
// h_{t-1} recovered from h_t by dividing by a decay (decays reach exactly
// 0 once dt |A| passes ~104): pass 1 runs the forward and keeps h every
// kCk = 32 steps in the block's scratch; pass 2 walks the intervals in
// reverse, recomputes each from its checkpoint keeping the state at every
// kW = 4th step, then each window of 4 steps into shared memory (5 states,
// each thread its own values), and walks the window back with g in
// registers. The recomputed states are the forward's rounded products and
// sums in its order, bitwise the sequential form's. Sums over a row (dx)
// take four shuffles among 16 lanes; over a column (dB, dC) one shuffle and
// then the 8 warps' partials in shared memory, added in warp order at the
// window's end; d dt and d decay the same way. dB and dC are written per
// head and a second kernel adds the heads in order: no atomics, so two
// launches are bitwise equal.
#include "scan_bwd.cuh"

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

template <typename T>
cudaError_t launch(const Args& a, int slots, cudaStream_t s) {
  static size_t raised = 0;
  auto kernel = mamba_scan_bwd_f32_kernel<T>;
  if (sizeof(Smem) > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return err;
    raised = sizeof(Smem);
  }
  kernel<<<slots, kThreads, sizeof(Smem), s>>>(a);
  cudaError_t err = cudaGetLastError();
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
// [B, S, H, N] the per-head sums and `scratch` slots x slot_floats(S)
// floats, both scratch. `slots` blocks, each taking (head, batch row) items
// in turn. dh and N at most 64; the wrapper (kernels/ssm_scan/ops.py)
// checks shapes, dtypes and contiguity. One launch of the entry point: the
// walk, then the heads' sum.
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
