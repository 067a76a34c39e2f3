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
// (67 TFLOP/s), against ~55 MB of inputs and outputs (~16 us); the S steps
// are a dependent chain, the latency floor.
//
// Design. Columns e of the state are independent (the known RWKV CUDA
// layout gives one thread a column). Here four lanes share a column, each
// holding 16 of its dh rows in registers, so a block of 256 threads covers
// one (head, batch row) and the card holds four times the warps; y[e] is
// each lane's partial sum, then two shuffles. The steps are staged 32 at a
// time through shared memory (r, k, w and v of the head, read coalesced
// and converted from bf16 there; u once); r, k and w are read back as
// float4 broadcasts, lane q of a column taking d = 16j + 4q + c so the
// four lanes hit distinct banks. The 32 steps' y are staged and stored
// coalesced. The state update and u k v are rounded products and sums in
// the plain version's order (no fused multiply-add), so the final state is
// bitwise the plain version's; y differs from it only in the order of its
// dh-term sum. No atomics: two launches are bitwise equal.
#include <cuda_bf16.h>

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

}  // namespace

// in_bf16: r, k and v hold bf16 values (else fp32). dh at most 64; the
// wrapper (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_out, int in_bf16, int B, int S,
                        int H, int dh, void* stream) {
  if (dh < 1 || dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  if (in_bf16)
    wkv6_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), wf, uf, sf,
        static_cast<float*>(y), static_cast<float*>(s_out), S, H, dh);
  else
    wkv6_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), wf, uf, sf, static_cast<float*>(y),
        static_cast<float*>(s_out), S, H, dh);
  return static_cast<int>(cudaGetLastError());
}
