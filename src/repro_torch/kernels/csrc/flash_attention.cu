// Flash attention for the packed ViT on Hopper CUDA cores, fp32:
// non-causal, a per-row key count kv_len[b], and the CLS row's attention
// probabilities as a by-product (the TDM scores).
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py) in the form the
// reference main path needs: there, `flash_attention_jnp(..., kv_len=)`
// plus `attention_probs_row(q[:, 0], k, kv_len=)` (core/packed_runner.py).
//
// One thread block per (q tile of 32 rows, head, batch row), 128 threads:
// four threads own one query row. The block loops over key tiles of 32
// with an online softmax (running max m, denominator l and the [32, Dh]
// output accumulator, all fp32 in registers). Keys at or past kv_len[b]
// score -inf, and tiles wholly past kv_len[b] are never loaded — padded
// tokens cost nothing and carry zero probability mass.
//
// The block that holds query row 0 then recomputes row 0's scores with
// the identical fma order and writes probs[b, h, j] = exp(s_0j - m) / l
// with the FINAL m and l, and exactly 0 at masked keys. The head mean is
// left to the caller, so no atomics and no order dependence.
//
// Bound on the H100: at the main path's shapes (B <= 4, H = 6, N <= 197,
// Dh = 64) the call does ~2e8 fp32 operations on ~5 MB — bound by the fp32
// CUDA-core rate. Q, K and V tiles are staged in shared memory (each K/V
// tile read once per q tile) and the [N, N] score matrix never leaves the
// chip. Tensor cores are deliberately unused: the fp32 tier must not round
// through TF32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTQ = 32;
constexpr int kTK = 32;
constexpr int kThreads = 128;  // 4 threads per query row

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ kv_len,
             float* __restrict__ o, float* __restrict__ probs, int N, int H,
             float scale) {
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
  const size_t ld = static_cast<size_t>(H) * DH;  // token stride
  const size_t base = static_cast<size_t>(b) * N * ld + h * DH;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int e = t; e < kTQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, n = qt * kTQ + r;
    qs[r][d] = n < N ? qb[n * ld + d] : 0.f;
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
      ks[r][d] = ok ? kb[n * ld + d] : 0.f;
      vs[r][d] = ok ? vb[n * ld + d] : 0.f;
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
    float* ob = o + base + n * ld;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) ob[quad + 4 * i] = acc[i] / l;
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
        for (int d = 0; d < DH; ++d) a = fmaf(qs[0][d], kb[j * ld + d], a);
        a *= scale;
        p = expf(a - row0_m) / row0_l;
      }
      pb[j] = p;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, void* probs, int B, int N, int H, float scale,
           cudaStream_t stream) {
  dim3 grid((N + kTQ - 1) / kTQ, H, B);
  flash_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(kv_len),
      static_cast<float*>(o), static_cast<float*>(probs), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o [B, N, H, Dh] fp32 contiguous; kv_len [B] int32 in [1, N]
// (larger values act as N; a row with no key comes out NaN, as in the
// plain version) or null (all N keys);
// probs [B, H, N] fp32 or null (then no CLS-row probabilities).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, void* probs,
                                   int B, int N, int H, int Dh, float scale,
                                   void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch<16>(q, k, v, kv_len, o, probs, B, N, H, scale, st);
    case 64: return launch<64>(q, k, v, kv_len, o, probs, B, N, H, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
