// Flash attention on Hopper CUDA cores, in the two forms the port's serving
// paths need. Replaces the Pallas kernel `_flash_kernel` /
// `flash_attention_pallas` (src/repro/kernels/flash_attention/
// flash_attention.py), which the reference paths compute in jnp.
//
// 1. The packed ViT: non-causal, a per-row key count kv_len[b], and the
//    CLS row's attention probabilities as a by-product (the TDM scores).
//    Two entry points over the operand type: `flash_attention_f32` (fp32
//    q, k, v and output) and `flash_attention_f16` (fp16 q, k, v, fp16
//    output) for the fp16 tier. There the reference calls
//    `flash_attention_jnp(..., kv_len=)` plus `attention_probs_row(q[:, 0],
//    k, kv_len=)` (core/packed_runner.py). Both compute in fp32 from the
//    operands as given; the output comes back in the operands' type
//    (`flash_attention_jnp` returns q.dtype), so the fp16 entry point
//    rounds o to fp16 on its store, and the probabilities are fp32 in
//    both.
//
//    One thread block per (q tile of 32 rows, head, batch row), 128
//    threads: four threads own one query row. The block loops over key
//    tiles of 32 with an online softmax (running max m, denominator l and
//    the [32, Dh] output accumulator, all fp32 in registers). Keys at or
//    past kv_len[b] score -inf, and tiles wholly past kv_len[b] are never
//    loaded - padded tokens cost nothing and carry zero probability mass.
//    Operands are converted to fp32 as they are staged in shared memory,
//    so the arithmetic below is the same for both entry points.
//
//    The block that holds query row 0 then recomputes row 0's scores with
//    the identical fma order and writes probs[b, h, j] = exp(s_0j - m) / l
//    with the FINAL m and l, and exactly 0 at masked keys. The head mean is
//    left to the caller, so no atomics and no order dependence.
//
//    Bound on the H100: at the main path's shapes (B <= 4, H = 6, N <= 197,
//    Dh = 64) the call does ~2e8 fp32 operations on ~5 MB (~2.5 MB with
//    fp16 operands) - bound by the fp32 CUDA-core rate. Q, K and V tiles
//    are staged in shared memory (each K/V tile read once per q tile) and
//    the [N, N] score matrix never leaves the chip. Tensor cores are
//    deliberately unused: the fp32 tier must not round through TF32, and
//    the fp16 tier's reference keeps its products and sums in fp32.
//
// 2. The dense LMs: `flash_attention_causal_bf16`, the Pallas kernel's
//    causal mode with its GQA head repeat, widened to per-row windows. It
//    computes `flash_attention_jnp(q, k, v, causal=True, q_offset, kv_len,
//    kv_start)` (models/attention.py), as `attention_block` calls it on a
//    per-slot KV cache: bf16 q [B, Nq, Hq, Dh] against bf16 k, v
//    [B, S, KV, Dh], query row i of batch row b seeing keys
//    [kv_start[b], min(kv_len[b], q_offset[b] + i + 1)). Arithmetic fp32,
//    output bf16 rounded to nearest even (`astype(q.dtype)`).
//
//    GQA without a repeated K/V: a block owns one KV head g and 32 (query
//    position, head-in-group) pairs, flattened position-major, so query
//    head h reads KV head h / (Hq / KV) in place and each K/V tile is
//    staged once for every query head of the group (decode: the group's
//    heads share one block; prefill: ~32 / per positions of all of them).
//    The key loop runs only over the tiles of the block's window
//    [kv_start, min(kv_len, q_offset + last position + 1)) - the Pallas
//    `bounded` loop per row - and masks per row inside a tile. Masked
//    scores are -inf and a row's running max stays -inf until it meets a
//    valid key (p and the correction are guarded), so a row with no valid
//    key (a left-pad row of a bucket-padded prompt) ends with l = 0 and
//    writes 0 / max(l, 1e-30) = 0: finite, where the reference's finite
//    NEG_INF averages V instead. Such rows never reach a real token.
//
//    Decode by-product: with Nq == 1 and `probs` set, the kernel also
//    writes the row's per-head probabilities probs[b, h, c] in fp32 with
//    the final m and l, exactly 0 at masked keys (the caller takes the
//    head mean: `attention_probs_row(...).mean(1)`, the KV attention
//    mass). Each lane parks its raw scores in `probs` during the loop and
//    normalizes its own entries at the end, so K is read once.
//
//    Bound on the H100: decode reads the whole valid cache window once
//    (B x window x KV x Dh x 2 x 2 bytes) for ~4 x per operations per K/V
//    element pair - bound by bytes. Prefill over a 512-token bucket does
//    ~2 x 512^2 x Hq x Dh causal operations on a few MB - bound by the
//    fp32 CUDA-core rate. The tiles at Dh = 128 take 52 KB of shared
//    memory, above the 48 KB static limit, so they are dynamic shared
//    memory with the limit raised once per instantiation. Tensor cores
//    (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTQ = 32;
constexpr int kTK = 32;
constexpr int kThreads = 128;  // 4 threads per query row

// operand loads as fp32, and the output store in the operands' type
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__half* p, float v) { *p = __float2half_rn(v); }

template <typename T, int DH>
__device__ __forceinline__ void flash_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ o,
    float* __restrict__ probs, int N, int H, float scale) {
  constexpr int kDPT = DH / 4;   // output dims per thread
  constexpr int kKPT = kTK / 4;  // keys per thread per tile
  __shared__ float qs[kTQ][DH + 1];
  __shared__ float ks[kTK][DH + 1];
  __shared__ float vs[kTK][DH];
  __shared__ float ps[kTQ][kTK + 1];
  __shared__ float row0_m, row0_l;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int row = t >> 2;
  const int quad = t & 3;
  // never read past the row's N tokens; no kv_len = every key is valid
  const int L = kv_len != nullptr ? min(kv_len[b], N) : N;
  const size_t ldt = static_cast<size_t>(H) * DH;  // token stride
  const size_t base = static_cast<size_t>(b) * N * ldt + h * DH;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int e = t; e < kTQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, n = qt * kTQ + r;
    qs[r][d] = n < N ? ld(qb + n * ldt + d) : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;

  const int n_tiles = (L + kTK - 1) / kTK;  // every tile holds a valid key
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < kTK * DH; e += kThreads) {
      const int r = e / DH, d = e % DH, n = kt * kTK + r;
      const bool ok = n < L;
      ks[r][d] = ok ? ld(kb + n * ldt + d) : 0.f;
      vs[r][d] = ok ? ld(vb + n * ldt + d) : 0.f;
    }
    __syncthreads();

    float s[kKPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKPT; ++jj) {
      const int c = quad + 4 * jj;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a = fmaf(qs[row][d], ks[c][d], a);
      a *= scale;
      if (kt * kTK + c >= L) a = -INFINITY;
      s[jj] = a;
      tmax = fmaxf(tmax, a);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);  // finite: the tile has a valid key
    const float corr = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKPT; ++jj) {
      const float p = expf(s[jj] - m_new);  // exactly 0 at masked keys
      ps[row][quad + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) acc[i] *= corr;
    __syncwarp();  // the row's probabilities come from lanes of this warp
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float p = ps[row][kk];
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] = fmaf(p, vs[kk][quad + 4 * i], acc[i]);
    }
  }

  const int n = qt * kTQ + row;
  if (n < N) {
    T* ob = o + base + n * ldt;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) st(ob + quad + 4 * i, acc[i] / l);
  }

  if (probs != nullptr && qt == 0) {
    if (t == 0) {
      row0_m = m;
      row0_l = l;
    }
    __syncthreads();
    float* pb = probs + (static_cast<size_t>(b) * H + h) * N;
    for (int j = t; j < N; j += kThreads) {
      float p = 0.f;
      if (j < L) {
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) a = fmaf(qs[0][d], ld(kb + j * ldt + d), a);
        a *= scale;
        p = expf(a - row0_m) / row0_l;
      }
      pb[j] = p;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ kv_len,
                           float* __restrict__ o, float* __restrict__ probs,
                           int N, int H, float scale) {
  flash_body<float, DH>(q, k, v, kv_len, o, probs, N, H, scale);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f16_kernel(const __half* __restrict__ q,
                           const __half* __restrict__ k,
                           const __half* __restrict__ v,
                           const int* __restrict__ kv_len,
                           __half* __restrict__ o, float* __restrict__ probs,
                           int N, int H, float scale) {
  flash_body<__half, DH>(q, k, v, kv_len, o, probs, N, H, scale);
}

template <typename T>
using FlashKernel = void (*)(const T*, const T*, const T*, const int*, T*,
                             float*, int, int, float);

template <typename T>
int launch(FlashKernel<T> k16, FlashKernel<T> k64, const void* q,
           const void* k, const void* v, const void* kv_len, void* o,
           void* probs, int B, int N, int H, int Dh, float scale,
           void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  FlashKernel<T> kernel = Dh == 16 ? k16 : Dh == 64 ? k64 : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kTQ - 1) / kTQ, H, B);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(o), static_cast<float*>(probs), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Causal grouped-query attention over a per-slot KV cache (bf16)
// ---------------------------------------------------------------------------
constexpr int kCRows = 32;  // (query position, head-in-group) pairs a block

template <int DH>
struct CausalTiles {  // dynamic shared memory, in floats
  static constexpr int kQ = kCRows * (DH + 1);
  static constexpr int kK = kTK * (DH + 1);
  static constexpr int kV = kTK * DH;
  static constexpr int kP = kCRows * (kTK + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_causal_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, const int* __restrict__ kv_start,
    __nv_bfloat16* __restrict__ o, float* __restrict__ probs, int Nq, int S,
    int Hq, int KV, float scale) {
  using T = CausalTiles<DH>;
  constexpr int kDPT = DH / 4;   // output dims per thread
  constexpr int kKPT = kTK / 4;  // keys per thread per tile
  extern __shared__ float smem[];
  auto qs = reinterpret_cast<float (*)[DH + 1]>(smem);
  auto ks = reinterpret_cast<float (*)[DH + 1]>(smem + T::kQ);
  auto vs = reinterpret_cast<float (*)[DH]>(smem + T::kQ + T::kK);
  auto ps = reinterpret_cast<float (*)[kTK + 1]>(smem + T::kQ + T::kK + T::kV);

  const int rt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int row = t >> 2;
  const int quad = t & 3;
  const int per = Hq / KV;
  const int n_pairs = Nq * per;
  const int j0 = rt * kCRows;
  const int j = j0 + row;  // this row's pair: position j / per, head j % per
  const bool live = j < n_pairs;
  const int pos = live ? j / per : 0;
  const int h = g * per + (live ? j % per : 0);

  const int off = q_offset != nullptr ? q_offset[b] : 0;
  const int len = min(kv_len != nullptr ? kv_len[b] : S, S);
  const int lo = max(kv_start != nullptr ? kv_start[b] : 0, 0);
  // this row sees keys [lo, hi); the block's window ends at its last
  // (largest) position's bound
  const int hi = live ? min(len, off + pos + 1) : lo;
  const int block_hi = min(len, off + (min(j0 + kCRows, n_pairs) - 1) / per + 1);
  const int t0 = lo / kTK;
  const int t1 = block_hi > lo ? (block_hi + kTK - 1) / kTK : t0;

  const size_t q_tok = static_cast<size_t>(Hq) * DH;  // q token stride
  const size_t kv_tok = static_cast<size_t>(KV) * DH;  // cache slot stride
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * kv_tok + g * DH;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * kv_tok + g * DH;

  for (int e = 2 * t; e < kCRows * DH; e += 2 * kThreads) {
    const int r = e / DH, d = e % DH, jr = j0 + r;
    float2 x = make_float2(0.f, 0.f);
    if (jr < n_pairs) {
      const size_t at = (static_cast<size_t>(b) * Nq + jr / per) * q_tok +
                        static_cast<size_t>(g * per + jr % per) * DH + d;
      x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + at));
    }
    qs[r][d] = x.x;
    qs[r][d + 1] = x.y;
  }

  // the decode row's probabilities: raw masked scores parked here during
  // the loop, normalized at the end by the lane that wrote them
  float* prow = (probs != nullptr && live)
                    ? probs + (static_cast<size_t>(b) * Hq + h) * S : nullptr;

  float m = -INFINITY, l = 0.f;
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;

  for (int kt = t0; kt < t1; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = 2 * t; e < kTK * DH; e += 2 * kThreads) {
      const int r = e / DH, d = e % DH, c = kt * kTK + r;
      float2 kx = make_float2(0.f, 0.f), vx = kx;
      if (c < S) {
        const size_t at = c * kv_tok + d;
        kx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kb + at));
        vx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vb + at));
      }
      ks[r][d] = kx.x;
      ks[r][d + 1] = kx.y;
      vs[r][d] = vx.x;
      vs[r][d + 1] = vx.y;
    }
    __syncthreads();

    float s[kKPT];
#pragma unroll
    for (int jj = 0; jj < kKPT; ++jj) s[jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qd = qs[row][d];
#pragma unroll
      for (int jj = 0; jj < kKPT; ++jj) s[jj] = fmaf(qd, ks[quad + 4 * jj][d], s[jj]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKPT; ++jj) {
      const int c = kt * kTK + quad + 4 * jj;
      float a = s[jj] * scale;
      if (c < lo || c >= hi) a = -INFINITY;
      if (prow != nullptr && c < S) prow[c] = a;
      s[jj] = a;
      tmax = fmaxf(tmax, a);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    // m stays -inf until the row meets a valid key: guard p and corr
    const float m_new = fmaxf(m, tmax);
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKPT; ++jj) {
      const float p = s[jj] == -INFINITY ? 0.f : expf(s[jj] - m_new);
      ps[row][quad + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) acc[i] *= corr;
    __syncwarp();  // the row's probabilities come from lanes of this warp
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float p = ps[row][kk];
#pragma unroll
      for (int i = 0; i < kDPT; ++i) acc[i] = fmaf(p, vs[kk][quad + 4 * i], acc[i]);
    }
  }

  if (live) {
    __nv_bfloat16* ob = o + (static_cast<size_t>(b) * Nq + pos) * q_tok +
                        static_cast<size_t>(h) * DH;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPT; ++i)
      ob[quad + 4 * i] = __float2bfloat16_rn(acc[i] / den);
  }
  if (prow != nullptr) {
    // keys of the loaded tiles hold this lane's raw scores (-inf where
    // masked; a valid key means l > 0); every other key is masked
    for (int c = quad; c < S; c += 4) {
      float p = 0.f;
      if (c >= t0 * kTK && c < t1 * kTK) {
        const float a = prow[c];
        if (a != -INFINITY) p = expf(a - m) / l;
      }
      prow[c] = p;
    }
  }
}

template <int DH>
int launch_causal(const void* q, const void* k, const void* v,
                  const void* q_offset, const void* kv_len,
                  const void* kv_start, void* o, void* probs, int B, int Nq,
                  int S, int Hq, int KV, float scale, cudaStream_t stream) {
  constexpr size_t kBytes = CausalTiles<DH>::kBytes;
  static bool smem_raised = false;  // the attribute is set once
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_causal_bf16_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised = true;
  }
  const int per = Hq / KV;
  dim3 grid((Nq * per + kCRows - 1) / kCRows, KV, B);
  flash_attention_causal_bf16_kernel<DH><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<const int*>(kv_start),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(probs), Nq, S, Hq,
      KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o [B, N, H, Dh] fp32 contiguous, Dh in {16, 64}; kv_len [B]
// int32 in [1, N] (larger values act as N; every row needs a key) or
// null (all N keys);
// probs [B, H, N] fp32 or null (then no CLS-row probabilities).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, void* probs,
                                   int B, int N, int H, int Dh, float scale,
                                   void* stream) {
  return launch<float>(flash_attention_f32_kernel<16>,
                       flash_attention_f32_kernel<64>, q, k, v, kv_len, o,
                       probs, B, N, H, Dh, scale, stream);
}

// As flash_attention_f32 with q, k, v and o fp16 (o rounded to nearest);
// probs stay fp32.
extern "C" int flash_attention_f16(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, void* probs,
                                   int B, int N, int H, int Dh, float scale,
                                   void* stream) {
  return launch<__half>(flash_attention_f16_kernel<16>,
                        flash_attention_f16_kernel<64>, q, k, v, kv_len, o,
                        probs, B, N, H, Dh, scale, stream);
}

// q, o [B, Nq, Hq, Dh] and k, v [B, S, KV, Dh], bf16 contiguous, KV
// dividing Hq, Dh in {16, 128}; q_offset, kv_len, kv_start [B] int32 or
// null (0, S and 0): query row i of batch row b sees keys
// [kv_start[b], min(kv_len[b], q_offset[b] + i + 1)) (kv_len past S acts
// as S); a row with no such key writes 0. probs [B, Hq, S] fp32 or null,
// only with Nq == 1: the row's probabilities, 0 at masked keys.
extern "C" int flash_attention_causal_bf16(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* kv_len, const void* kv_start, void* o, void* probs, int B,
    int Nq, int S, int Hq, int KV, int Dh, float scale, void* stream) {
  if (B <= 0 || Nq <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || KV > 65535 || B > 65535 ||
      (probs != nullptr && Nq != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 16)
    return launch_causal<16>(q, k, v, q_offset, kv_len, kv_start, o, probs, B,
                             Nq, S, Hq, KV, scale, st);
  if (Dh == 128)
    return launch_causal<128>(q, k, v, q_offset, kv_len, kv_start, o, probs, B,
                              Nq, S, Hq, KV, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
