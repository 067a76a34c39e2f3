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
// inputs and outputs (~18 us); the S steps are a dependent chain, the
// latency floor.
//
// Design. One block of 256 threads per (head, batch row), so the grid is
// B x H blocks whatever S is. Rows of the state are independent (row d
// needs only x[d]), so each row belongs to four lanes of one warp, each
// lane holding 16 of its N values in registers: a lane never reads or
// writes the state in memory between the first step and the last. The
// steps are staged 32 at a time through shared memory (x of the head, B,
// C, dt and decay, read coalesced and converted from bf16 there); B and C
// are read back as float4 broadcasts, lane q of a row taking n = 16k + 4q
// + c so the four lanes hit distinct banks. y[d] is each lane's partial
// sum over its 16 values, then two shuffles; the 32 steps' y are staged
// and stored coalesced. The state update is two rounded products and a
// rounded sum in the plain version's order (no fused multiply-add), so the
// final state is bitwise the plain version's; y differs from it only in
// the order of its N-term sum. No atomics: two launches are bitwise equal.
#include <cuda_bf16.h>

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

}  // namespace

// x_bf16: x holds bf16 values (else fp32). dh and N at most 64; the
// wrapper (kernels/ssm_scan/ops.py) checks shapes, dtypes and contiguity.
extern "C" int mamba_scan_f32(const void* x, const void* dt,
                              const void* decay, const void* Bm,
                              const void* Cm, const void* h0, void* y,
                              void* h_out, int x_bf16, int B, int S, int H,
                              int dh, int N, void* stream) {
  if (dh < 1 || dh > kMaxDh || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt),
                      static_cast<const float*>(decay),
                      static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm),
                      static_cast<const float*>(h0)};
  if (x_bf16)
    mamba_scan_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), f[0], f[1], f[2], f[3], f[4],
        static_cast<float*>(y), static_cast<float*>(h_out), S, H, dh, N);
  else
    mamba_scan_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), f[0], f[1], f[2], f[3], f[4],
        static_cast<float*>(y), static_cast<float*>(h_out), S, H, dh, N);
  return static_cast<int>(cudaGetLastError());
}
