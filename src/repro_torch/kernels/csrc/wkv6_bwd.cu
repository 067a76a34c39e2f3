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
// and outputs (~0.09 ms). The kernel recomputes the state twice more. The
// walk is a dependent chain of S steps a (batch row, head): latency-bound,
// like the sequential forward.
//
// Design: mamba_scan_bwd.cu's (scan_bwd.cuh): a persistent block of 256
// threads per (head, batch row) item, a 4 x 4 tile of the state and of G a
// thread in registers; the state before each step recomputed forward from a
// checkpoint every kCk = 32 steps and a window start every kW = 4, never by
// dividing by w (w = exp(-exp(w_raw)) underflows to 0 for w_raw above
// ~4.6); the recomputed states bitwise the plain loop's. Three sums over a
// row (dr, dw, dk) take four shuffles each among 16 lanes, the one over a
// column (dv) one shuffle and the 8 warps' partials added in order at the
// window's end; p_t and r_t . (u (*) k_t) are taken once a step by one warp
// as the window is staged. du is written per (batch row, head) and a second
// kernel adds the batch rows in order: no atomics, so two launches are
// bitwise equal.
#include "scan_bwd.cuh"

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

template <typename T>
cudaError_t launch(const Args& a, int slots, cudaStream_t s) {
  static size_t raised = 0;
  auto kernel = wkv6_bwd_f32_kernel<T>;
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
  const int n = a.H * a.dh;
  wkv6_bwd_f32_du_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(a.du_part,
                                                              a.du, a.B, n);
  return cudaGetLastError();
}

}  // namespace

// Inputs as wkv6_f32 takes them (in_bf16: r, k and v hold bf16 values), dy
// [B, S, H, dh] and ds [B, H, dh, dh] fp32. Outputs, all fp32: dr, dk, dv,
// dw [B, S, H, dh], du [H, dh], ds0 [B, H, dh, dh]; du_part [B, H, dh] and
// `scratch` slots x slot_floats(S) floats, both scratch. `slots` blocks,
// each taking (head, batch row) items in turn. dh at most 64; the wrapper
// (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity. One
// launch of the entry point: the walk, then du's sum over batch rows.
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
