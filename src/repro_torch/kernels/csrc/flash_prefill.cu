// Causal GQA attention of a prompt (Nq > 1 query rows per batch row) over a
// per-slot bf16 KV cache, with Q.K^T and P.V on the tensor cores.
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/
// flash_attention/flash_attention.py:25) in its causal mode with the GQA
// head repeat, where `attention_block` (models/attention.py) calls it for a
// prefill: `flash_attention_jnp(q, k, v, causal=True, q_offset, kv_len,
// kv_start)` on bf16 q [B, Nq, Hq, Dh] against the cache k, v [B, S, KV,
// Dh]. Query row i of batch row b sees keys [kv_start[b], min(kv_len[b],
// q_offset[b] + i + 1)); query head h reads KV head h / (Hq / KV) in place.
// The reference takes Q.K^T of bf16 values in fp32 (exact products) and
// P.V with fp32 P; the output is rounded to bf16 (nearest even). A row with
// no valid key (a left-pad row of a bucket-padded prompt) writes 0.
//
// Bound on the H100: a per-slot prefill of a 512-token bucket at
// Minitron-4B (24 query over 8 KV heads, Dh 128) has ~3.0e6 (row, head,
// key) pairs, 4 Dh operations each (Q.K^T and P.V): ~1.5 GFLOP on ~8.3 MB
// (q and o 3.1 MB each, the K/V window 2 MB). On fp32 CUDA cores (67
// TFLOP/s) the products take ~23 us; on the bf16 tensor cores (989
// TFLOP/s, P.V counted twice for the split below) ~2.3 us, under the 2.5
// us of bytes: with the products on the tensor cores it is bound by bytes.
//
// Design: a block of four warps owns 64 (query position, head-in-group)
// rows of one KV head g, flattened position-major, so each staged K/V tile
// serves every query head of the group (GQA read in place); each warp owns
// 16 rows. Key tiles of 64 stay bf16 in shared memory (rows padded by 16
// bytes, so ldmatrix is conflict-free), double-buffered with 16-byte
// cp.async: the next tile's copy runs under this tile's products.
// Fragments come by ldmatrix (V transposed by ldmatrix.trans) into
// mma.sync.m16n8k16 bf16 with fp32 accumulation (the helpers are
// mma16.cuh's, shared with flash_attention.cu): Q.K^T is exact in its
// products as in the reference. P is fp32 and the tensor cores take bf16,
// so P is split into hi = bf16(P) and lo = bf16(P - hi) and P.V issues two
// MMAs into the fp32 accumulator: P is kept to ~2^-16 relative, far below
// the output's bf16 rounding. The online softmax (running max and sum per
// row, fp32, in base 2) lives in the MMA accumulator's registers. Only the
// tiles of a block's window [kv_start, min(kv_len, q_offset + last
// position + 1)) are visited, and the heaviest row tiles of every KV head
// are launched first; only tiles crossing kv_start, the causal diagonal or
// kv_len are masked. Masked scores are -inf and a row's running max stays
// -inf until it meets a valid key (p and the correction are guarded), so a
// row with no key ends with l = 0 and writes 0 rather than NaN.
//
// mma.sync rather than wgmma: its fragments map one to one onto the online
// softmax's registers, which made it the one to get right first. What
// holds the kernel back is latency, not the tensor cores' rate: the
// heaviest row tile walks all its key tiles with one warp on each of its
// SM's four schedulers, and each tile's barriers, Q.K^T, softmax and P.V
// run one after another.
#include <math.h>
#include <stdint.h>

#include "causal_tile.cuh"
#include "mma16.cuh"

namespace {

using causal::bf16;
using mma16::ldmatrix_x4;
using mma16::ldmatrix_x4_trans;
using mma16::mma;
using mma16::split_hi_lo;

constexpr int kBr = 64;  // (position, head-in-group) rows per block
constexpr int kBc = 64;  // keys per tile
constexpr int kThreads = 128;  // four warps of 16 rows

template <int DH>
struct PrefillSmem {
  static constexpr int kLd = DH + 8;  // bf16 row stride
  static constexpr int kTile = kBc * kLd;
  // Q, then two stages of (K, V)
  static constexpr size_t kBytes = sizeof(bf16) * (kBr * kLd + 4 * kTile);
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ q_offset,
                          const int* __restrict__ kv_len,
                          const int* __restrict__ kv_start,
                          bf16* __restrict__ o, int Nq, int S, int Hq, int KV,
                          float scale) {
  using L = PrefillSmem<DH>;
  constexpr int kLd = L::kLd;
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = qs + kBr * kLd;  // stage s: K at 2 s tiles, V at 2 s + 1

  // the last row tiles see the most keys: launch them first, for every
  // (KV head, batch row) before any lighter tile
  const int g = blockIdx.x, b = blockIdx.y, rt = gridDim.z - 1 - blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int per = Hq / KV;
  const int n_rows = Nq * per;
  const int r0 = rt * kBr;
  const causal::Window w(q_offset, kv_len, kv_start, b, S);
  const int lo = w.lo;
  // keys every row of the block sees from lo on, and keys any row sees
  const int all_hi = w.hi(r0 / per);
  const int block_hi = w.hi((min(r0 + kBr, n_rows) - 1) / per);
  const int t0 = lo / kBc;
  const int t1 = block_hi > lo ? (block_hi + kBc - 1) / kBc : t0;
  // softmax in base 2: exp(s - m) = exp2(s log2(e) - m log2(e))
  const float scale_log2 = scale * 1.4426950408889634f;

  const size_t slot = static_cast<size_t>(KV) * DH;  // cache slot stride
  const bf16* kb = k + (static_cast<size_t>(b) * S * KV + g) * DH;
  const bf16* vb = v + (static_cast<size_t>(b) * S * KV + g) * DH;
  auto load_kv = [&](int tile, int stage) {
    bf16* ks = kvs + 2 * stage * L::kTile;
    bf16* vs = ks + L::kTile;
    for (int e = t; e < kBc * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks, c = tile * kBc + r;
      const bool ok = c >= lo && c < block_hi;
      const size_t at = ok ? c * slot + ch * 8 : 0;
      cp_async16(ks + r * kLd + ch * 8, kb + at, ok);
      cp_async16(vs + r * kLd + ch * 8, vb + at, ok);
    }
  };

  for (int e = t; e < kBr * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks, j = r0 + r;
    const bool ok = j < n_rows;
    const size_t at =
        ok ? ((static_cast<size_t>(b) * Nq + j / per) * Hq + g * per + j % per) *
                     DH + ch * 8
           : 0;
    cp_async16(qs + r * kLd + ch * 8, q + at, ok);
  }
  if (t0 < t1) load_kv(t0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 Q rows as A fragments, all of Dh
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(qa[ks], qs + (warp * 16 + (lane & 15)) * kLd + ks * 16 +
                            (lane >> 4) * 8);

  // this thread's two rows (accumulator rows lane / 4 and lane / 4 + 8)
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int hi_a = ra < n_rows ? w.hi(ra / per) : lo;
  const int hi_b = rb < n_rows ? w.hi(rb / per) : lo;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = t0; kt < t1; ++kt) {
    const int stage = (kt - t0) & 1;
    if (kt + 1 < t1) {
      load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kvs + 2 * stage * L::kTile;
    const bf16* vs = ks + L::kTile;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kBc / 8][4];
#pragma unroll
    for (int i = 0; i < kBc / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
#pragma unroll
      for (int np = 0; np < kBc / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                            kd * 16 + ((lane >> 3) & 1) * 8);
        mma<bf16>(s[2 * np], qa[kd], kf[0], kf[1]);
        mma<bf16>(s[2 * np + 1], qa[kd], kf[2], kf[3]);
      }
    }

    // scale (to log2 units); mask only tiles crossing kv_start, the
    // diagonal or kv_len
    const int c0 = kt * kBc;
    const bool edge = c0 < lo || c0 + kBc > all_hi;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale_log2;
        if (edge) {
          const int c = c0 + nt * 8 + (lane & 3) * 2 + (i & 1);
          if (c < lo || c >= (i < 2 ? hi_a : hi_b)) x = -INFINITY;
        }
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      // m stays -inf until the row meets a valid key: guard p and corr
      corr[x] = mx[x] == -INFINITY ? 1.f : exp2f(m[x] - mx[x]);
      m[x] = mx[x];
    }
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mm = m[i >> 1];
        const float p = mm == -INFINITY ? 0.f : exp2f(s[nt][i] - mm);
        s[nt][i] = p;
        psum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + psum[x];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V, P as hi + lo bf16 halves; the accumulator of key columns
    // 16 kk .. 16 kk + 15 is the A fragment of that k-step
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_hi_lo<bf16>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_hi_lo<bf16>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_hi_lo<bf16>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_hi_lo<bf16>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kLd +
                                  dp * 16 + (lane >> 4) * 8);
        mma<bf16>(acc[2 * dp], ph, vf[0], vf[1]);
        mma<bf16>(acc[2 * dp], pl, vf[0], vf[1]);
        mma<bf16>(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma<bf16>(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = x == 0 ? ra : rb;
    if (j >= n_rows) continue;
    bf16* orow = o + ((static_cast<size_t>(b) * Nq + j / per) * Hq + g * per +
                      j % per) * DH;
    const float den = fmaxf(l[x], 1e-30f);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + col) =
          __floats2bfloat162_rn(acc[i][2 * x] / den, acc[i][2 * x + 1] / den);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_len, const void* kv_start, void* o, int B, int Nq,
           int S, int Hq, int KV, float scale, cudaStream_t stream) {
  static size_t raised = 0;
  constexpr size_t kBytes = PrefillSmem<DH>::kBytes;
  const cudaError_t err =
      allow_smem(flash_prefill_bf16_kernel<DH>, kBytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KV, B, (Nq * (Hq / KV) + kBr - 1) / kBr);
  flash_prefill_bf16_kernel<DH><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<const int*>(kv_start),
      static_cast<bf16*>(o), Nq, S, Hq, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o [B, Nq, Hq, Dh] and k, v [B, S, KV, Dh], bf16 contiguous, KV
// dividing Hq, Dh in {16, 128}; q_offset, kv_len, kv_start [B] int32 or
// null (0, S and 0): query row i of batch row b sees keys [kv_start[b],
// min(kv_len[b], q_offset[b] + i + 1)) (kv_len past S acts as S); a row
// with no such key writes 0.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* q_offset, const void* kv_len,
                                  const void* kv_start, void* o, int B,
                                  int Nq, int S, int Hq, int KV, int Dh,
                                  float scale, void* stream) {
  if (B <= 0 || Nq <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || B > 65535 ||
      static_cast<long long>(Nq) * (Hq / KV) > 65535LL * kBr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 16)
    return launch<16>(q, k, v, q_offset, kv_len, kv_start, o, B, Nq, S, Hq,
                      KV, scale, st);
  if (Dh == 128)
    return launch<128>(q, k, v, q_offset, kv_len, kv_start, o, B, Nq, S, Hq,
                       KV, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
