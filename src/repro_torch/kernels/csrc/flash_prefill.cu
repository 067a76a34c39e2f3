// GQA attention of a prompt (Nq > 1 query rows per batch row) with Q.K^T
// and P.V on the tensor cores: causal over a per-slot bf16 KV cache (the
// LMs' self-attention; mma.sync) or not, over any Nk keys (cross-attention,
// an encoder's self-attention; wgmma fed by TMA).
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
// Training (`CausalAttention` in kernels/flash_attention/ops.py) also asks
// for each row's natural log-sum-exp of its scaled scores, fp32 lse [B, Hq,
// Nq], which the backward (flash_prefill_bwd.cu) recomputes P from; a row
// with no valid key writes -inf there. With a null lse the kernel stores
// nothing more and its output is the serve's, bit for bit.
// The non-causal form (`causal` 0; cross-attention, an encoder's self-
// attention) is a kernel of its own, designed for its shapes:
// flash_prefill_bf16_noncausal_kernel, after this one.
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
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "causal_tile.cuh"
#include "mma16.cuh"
#include "wgmma_tile.cuh"

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
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int Nq, int S, int Hq, int KV, float scale) {
  using L = PrefillSmem<DH>;
  constexpr int kLd = L::kLd;
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = qs + kBr * kLd;  // stage s: K at 2 s tiles, V at 2 s + 1

  // the last row tiles see the most keys: launch them first,
  // for every (KV head, batch row) before any lighter tile
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
    // m is in log2 units: lse = m ln 2 + ln l (the four lanes of a row agree)
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<size_t>(b) * Hq + g * per + j % per) * Nq + j / per] =
          l[x] > 0.f ? m[x] * 0.6931471805599453f + logf(l[x]) : -INFINITY;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_len, const void* kv_start, void* o, void* lse, int B,
           int Nq, int S, int Hq, int KV, float scale, cudaStream_t stream) {
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
      static_cast<bf16*>(o), static_cast<float*>(lse), Nq, S, Hq, KV, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The non-causal form
// ---------------------------------------------------------------------------
// The Pallas kernel's `causal=False` form, where the reference calls
// `flash_attention_jnp(q, k, v, causal=False)` on bf16 activations with Nq
// and Nk free and the GQA repeat: the decoders' cross-attention
// (`kv_override` in `attention_block`: Whisper's decoder over 1500 audio
// frames, Llama-3.2-Vision's gated cross layers over 1601 vision tokens) and
// Whisper's encoder self-attention (1500 x 1500). Every query row sees all
// Nk keys. q, o [B, Nq, Hq, Dh], k, v [B, Nk, KV, Dh]; output bf16 rounded
// to nearest even.
//
// Bound on the H100: Whisper's encoder, [4, 1500, 8, 64], has 7.2e7
// (row, head, key) pairs; Q.K^T and P.V take 128 operations each per pair
// and this design issues P.V twice (P's hi and lo halves): 2.8e10 tensor-
// core operations, 28 us at 989 TFLOP/s, and 7.2e7 exp2 on the SFUs (16 a
// clock an SM: ~19 us), under ~10 us of softmax arithmetic on the CUDA
// cores: bound by operations, with the SFU and the tensor cores able to
// run at once. The cross prefills (32 or 64 query rows against 1500 or
// 1601 keys) are bound by the bytes of K and V (12.3 / 13.1 MB: 3.7 / 3.9
// us), and what they need is the whole card streaming them.
//
// Design: a warpgroup owns 64 (query position, head-in-group) rows of one
// KV head g, flattened position-major as in the causal kernel, so each
// staged K/V tile serves every query head of the group. S = Q K^T is
// wgmma.m64n64k16 with Q and K from shared memory, K-major; the online
// softmax runs in fp32 in the accumulator's registers, in base 2; P.V is
// two wgmma per 16 keys with P's bf16 hi and lo halves (split_p: hi cut,
// lo rounded) as register A operands and V read MN-major through a
// transposed descriptor, as the backward feeds dS (wgmma_tile.cuh, shared
// with it), so P keeps ~2^-16 of its fp32 value. Each tile's P.V overlaps
// the next tile's softmax (its Q.K^T issued just before), and the two
// warpgroups of a block take turns to issue their products (FA3's
// pingpong), so one's softmax also runs under the other's products. K and
// V tiles of 64 keys arrive by TMA (swizzled, zero-filled past Nk) into a
// ring of stages under full mbarriers; the first warp of the last
// warpgroup done with a stage (a shared counter) issues its refill, so no
// warpgroup waits on another for it (no producer warp:
// flash_prefill_bwd.cu says why). Q is staged once per block by cp.async
// into the same swizzled layout (any group size: a TMA box of 64
// flattened rows would need Hq / KV to divide 64), then fenced for the
// async proxy. Only the last key tile, where Nk is not a multiple of 64,
// is masked; every tile holds a valid key, so each row's running max is
// finite from the first tile on and no guard is needed.
// Work: where rows are many (Whisper's encoder: 1500 a (b, g)), a block is
// two warpgroups, 128 rows, on the same K/V tiles, walking every key tile
// (n_chunk 1) and writing o. Where row items are too few to fill the card
// (Whisper's cross prefill: 32 rows a (b, g), 32 items; Llama-Vision's: 64
// items of 128 rows over 26 key tiles), the host (`noncausal_prefill_plan`
// in kernels/flash_attention/ops.py) splits the key range into n_chunk
// chunks of whole tiles, none empty, at most 8 (the portable cluster
// size): the chunks of a row tile are one thread block cluster. Each block writes its rows' fp32 partials
// (m in log2 units, l, unnormalised o) into its own shared memory; after a
// cluster barrier the cluster's threads sum every chunk's partials in
// chunk order, reading them from the blocks' shared memory (distributed
// shared memory), and write o. No scratch in device memory, no atomic, no
// fence: one launch, every sum in a fixed order, two launches bitwise
// equal. Training (`NonCausalGQAAttention` in ops.py) also asks for each
// row's natural log-sum-exp, lse [B, Hq, Nq] = M ln 2 + ln L from the
// row's (M, L) as written (whole keys) or as the combine merges them (a
// cluster's chunks); o is the serve's, bit for bit, lse or not.
namespace nc {

using namespace wgt;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxChunks = 8;  // a row tile's chunks: a cluster's blocks

namespace cg = cooperative_groups;
using causal::ex2;

// P [64 x 64] fp32 accumulator -> register A operands of its four k-steps
// (wgmma_tile.cuh's to_a), each value as bf16 hi + lo halves: hi is P cut
// to its upper 16 bits (one byte permute a pair), lo = bf16(P - hi) rounded
// to nearest (exact before rounding), so P keeps ~2^-16 of itself with one
// conversion a pair where split_hi_lo takes two
__device__ __forceinline__ void split_p(const float (&x)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t u0 = __float_as_uint(x[8 * kk + 2 * r]);
      const uint32_t u1 = __float_as_uint(x[8 * kk + 2 * r + 1]);
      hi[kk][r] = __byte_perm(u0, u1, 0x7632);  // the lower column low
      __nv_bfloat162 l = __floats2bfloat162_rn(
          x[8 * kk + 2 * r] - __uint_as_float(u0 & 0xffff0000u),
          x[8 * kk + 2 * r + 1] - __uint_as_float(u1 & 0xffff0000u));
      lo[kk][r] = *reinterpret_cast<uint32_t*>(&l);
    }
}

// Shared memory: the block's NWG Q tiles, a ring of kStages stages of a K
// and a V tile, then the stages' full barriers; a chunk's partial rows
// reuse the tiles. The base is rounded up to 1024 bytes.
template <int DH, int NWG>
struct Layout {
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kRows = 64 * NWG;
  static constexpr int kStages = 3;
  static constexpr int kTileBytes = TileFmt<DH>::kTileBytes;
  static constexpr int kRing = NWG * kTileBytes;
  static constexpr int kBars = kRing + 2 * kStages * kTileBytes;
  static constexpr size_t kBytes = 1024 + kBars + 8 * kStages;
  static_assert(kRows * (DH + 4) * 4 <= kBars,
                "a chunk's partial rows fit in the tiles");
};

template <int DH, int NWG>
__global__ void __launch_bounds__(128 * NWG)
flash_prefill_bf16_noncausal_kernel(const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const bf16* __restrict__ q,
                                    bf16* __restrict__ o,
                                    float* __restrict__ lse, int Nq,
                                    int Nk, int Hq, int KV, int n_chunk,
                                    float scale) {
  using L = Layout<DH, NWG>;
  using F = TileFmt<DH>;
  constexpr int kRows = L::kRows, kStages = L::kStages;
  // a partial row: o[DH], m, l, two floats of padding (16-byte rows)
  constexpr int kPart = DH + 4;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int released[kStages];  // warpgroups done with each stage
  const Base sm(smem_raw);
  const uint32_t bars = sm.addr + L::kBars;  // full[kStages]
  // a row tile's chunks are one cluster
  const int chunk = blockIdx.x, rb = blockIdx.y, bg = blockIdx.z;
  const int b = bg / KV, g = bg % KV;
  const int t = threadIdx.x, wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int per = Hq / KV, n_rows = Nq * per, r0 = rb * kRows;
  const int n_kt = (Nk + kTile - 1) / kTile;
  const int per_chunk = (n_kt + n_chunk - 1) / n_chunk;
  const int kt0 = chunk * per_chunk, n_t = min(per_chunk, n_kt - kt0);
  auto ring = [&](int s, int x) {
    return sm.addr + L::kRing + (2 * s + x) * L::kTileBytes;
  };
  // the chunk's i-th key tile into stage i % kStages (its last reader is
  // done with it)
  auto feed = [&](int i) {
    const int s = i % kStages;
    bar_expect_tx(bars + 8 * s, 2 * L::kTileBytes);
    const int c0 = (kt0 + i) * kTile;
    tma_tile<DH>(ring(s, 0), &tk, bars + 8 * s, g, c0, b);
    tma_tile<DH>(ring(s, 1), &tv, bars + 8 * s, g, c0, b);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(bars + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0)
    for (int i = 0; i < min(n_t, kStages); ++i) feed(i);

  // the block's rows (row j: position j / per, head g per + j % per) into
  // its Q tiles; rows past n_rows zero
  for (int e = t; e < kRows * (DH / 8); e += L::kThreads) {
    const int r = e / (DH / 8), ch = e % (DH / 8), j = r0 + r;
    const bool ok = j < n_rows;
    const size_t at =
        ok ? ((static_cast<size_t>(b) * Nq + j / per) * Hq + g * per +
              j % per) * DH + ch * 8
           : 0;
    cp_async16(sm.at(sm.addr + (r / kTile) * L::kTileBytes +
                     F::chunk(r % kTile, ch)),
               q + at, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's rows ra and ra + 8 of its warpgroup's tile
  const uint32_t qs = sm.addr + wg * L::kTileBytes;
  const int ra = 16 * warp + (lane >> 2), q4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float sc[32], corr[2], psum[2];
  uint32_t ph[4][4], pl[4][4];
  // S = Q K^T of the chunk's i-th tile into sc (waits for its stage)
  auto scores = [&](int i) {
    bar_wait(bars + 8 * (i % kStages), (i / kStages) & 1);
    wg_fence();
    mma_abt<DH>(sc, qs, ring(i % kStages, 0));
    wg_commit();
  };
  // sc -> P = 2^(s scale log2(e) - m) in place (one FFMA and one ex2 a
  // score), with the new running max m in log2 units, the old terms'
  // correction corr and P's row sums psum; keys past Nk (the last tile
  // only) are -inf
  auto softmax = [&](int i) {
    const int c0 = (kt0 + i) * kTile;
    if (c0 + kTile > Nk) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * jj + 2 * q4 + (e & 1) >= Nk) sc[4 * jj + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      mx[x] = fmaxf(m[x], mx[x] * scale_log2);  // scale > 0 keeps the max
      corr[x] = ex2(m[x] - mx[x]);  // 0 at the first tile (m -inf)
      m[x] = mx[x];
      psum[x] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = ex2(fmaf(sc[e], scale_log2, -m[(e >> 1) & 1]));
      sc[e] = p;
      psum[(e >> 1) & 1] += p;
    }
  };
  // fold the correction into l and o, and P into A operands
  auto fold = [&]() {
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + psum[x];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
    split_p(sc, ph, pl);
  };

  // Two warpgroups take turns to issue their products (FA3's pingpong):
  // each issues a batch (a tile's P.V and the next tile's Q.K^T) only
  // once the other has issued its, so one's softmax runs under the other's
  // products. Named barriers 1 and 2 hold the turns; the second warpgroup
  // hands the first its first turn and keeps its last, so each barrier
  // sees as many arrivals as waits.
  int batch = 0;
  auto turn = [&]() {
    if constexpr (NWG == 2)
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto pass = [&]() {
    if constexpr (NWG == 2)
      if (wg == 0 || batch < n_t)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    ++batch;
  };
  if constexpr (NWG == 2)
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

  // Each tile's P.V runs on the tensor cores while the next tile's
  // softmax runs on the CUDA cores and SFUs: the next Q.K^T is issued
  // first, then this tile's P.V, and the softmax waits for the former
  // only. The last tile is peeled, so that every commit group of the loop
  // is unconditional and ptxas keeps the wgmma pipelined.
  turn();
  scores(0);
  pass();
  wg_wait<0>();
  keep(sc);
  softmax(0);
  fold();
  for (int i = 0; i + 1 < n_t; ++i) {
    const int s = i % kStages;
    turn();
    scores(i + 1);
    wg_fence();
    mma_xb<DH>(acc, ph, pl, ring(s, 1));  // O += P V, P as hi + lo halves
    wg_commit();
    pass();
    wg_wait<1>();
    keep(sc);
    softmax(i + 1);
    wg_wait<0>();
    keep(acc);
    keep(ph);
    keep(pl);
    // this warpgroup is done with stage s: the last of the block's to be
    // done refills it, and no thread waits on another warpgroup
    if ((t & 127) == 0 && i + kStages < n_t &&
        (NWG == 1 || atomicAdd(&released[s], 1) % NWG == NWG - 1))
      feed(i + kStages);
    __syncwarp();
    fold();
  }
  turn();
  wg_fence();
  mma_xb<DH>(acc, ph, pl, ring((n_t - 1) % kStages, 1));
  wg_commit();
  pass();
  wg_wait<0>();
  keep(acc);

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  const int col = q4 * 2;
  auto out_row = [&](int j) {
    return o + ((static_cast<size_t>(b) * Nq + j / per) * Hq + g * per +
                j % per) * DH;
  };
  // row j's log-sum-exp (training): m in log2 units, lse = m ln 2 + ln l
  auto store_lse = [&](int j, float mm, float ll) {
    lse[(static_cast<size_t>(b) * Hq + g * per + j % per) * Nq + j / per] =
        mm * 0.6931471805599453f + logf(ll);
  };
  if (n_chunk == 1) {  // the whole key range: o
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = r0 + wg * kTile + ra + 8 * x;
      if (j >= n_rows) continue;
      bf16* row = out_row(j);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * x] / l[x],
                                  acc[4 * i + 2 * x + 1] / l[x]);
      if (lse != nullptr && q4 == 0) store_lse(j, m[x], l[x]);
    }
    return;
  }

  // A chunk: its partial rows (m in log2 units, l, unnormalised o) into
  // this block's shared memory over the tiles, [kRows][kPart]. Once every
  // chunk's are in, the cluster's threads take the row tile's runs of 4
  // elements (row, 4 c .. 4 c + 3) in turn, each reading every chunk's m,
  // l and run from that block's shared memory at once and summing them in
  // chunk order: M = max_j m_j, w_j = 2^(m_j - M), o = sum_j w_j o_j /
  // sum_j w_j l_j.
  __syncthreads();  // every warpgroup is done with the tiles
  float* sp = reinterpret_cast<float*>(sm.ptr);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float* pr = sp + (wg * kTile + ra + 8 * x) * kPart;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(pr + 8 * i + col) =
          make_float2(acc[4 * i + 2 * x], acc[4 * i + 2 * x + 1]);
    if (q4 == 0) {
      pr[DH] = m[x];
      pr[DH + 1] = l[x];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_here = min(kRows, n_rows - r0);
  for (int u = chunk * L::kThreads + t; u < n_here * (DH / 4);
       u += n_chunk * L::kThreads) {
    const int r = u / (DH / 4), c = u - r * (DH / 4);
    float mj[kMaxChunks], lj[kMaxChunks];
    float4 xj[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      if (j >= n_chunk) break;
      const float* rp = cluster.map_shared_rank(sp, j) + r * kPart;
      mj[j] = rp[DH];
      lj[j] = rp[DH + 1];
      xj[j] = *reinterpret_cast<const float4*>(rp + 4 * c);
    }
    float M = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j)
      if (j < n_chunk) M = fmaxf(M, mj[j]);
    float Ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j)
      if (j < n_chunk) {
        const float w = ex2(mj[j] - M);
        Ls = fmaf(lj[j], w, Ls);
        a.x = fmaf(xj[j].x, w, a.x);
        a.y = fmaf(xj[j].y, w, a.y);
        a.z = fmaf(xj[j].z, w, a.z);
        a.w = fmaf(xj[j].w, w, a.w);
      }
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>(out_row(r0 + r) + 4 * c);
    out[0] = __floats2bfloat162_rn(a.x / Ls, a.y / Ls);
    out[1] = __floats2bfloat162_rn(a.z / Ls, a.w / Ls);
    if (lse != nullptr && c == 0) store_lse(r0 + r, M, Ls);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}
// -- end of the non-causal kernel

template <int DH, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Nq, int Nk, int Hq, int KV, int n_chunk, float scale,
           cudaStream_t stream) {
  using L = Layout<DH, NWG>;
  static size_t raised = 0;
  const cudaError_t err = allow_smem(
      flash_prefill_bf16_noncausal_kernel<DH, NWG>, L::kBytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (encode_fn() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tk, tv;
  if (!rows_map<DH>(&tk, k, B, Nk, KV) || !rows_map<DH>(&tv, v, B, Nk, KV))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(n_chunk, (Nq * (Hq / KV) + L::kRows - 1) / L::kRows, B * KV);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_chunk;  // a row tile's chunks
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_prefill_bf16_noncausal_kernel<DH, NWG>, tk, tv,
      static_cast<const bf16*>(q), static_cast<bf16*>(o),
      static_cast<float*>(lse), Nq, Nk, Hq, KV, n_chunk, scale));
}

template <int DH>
int launch_wgs(int wgs, const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Nq, int Nk, int Hq, int KV, int n_chunk,
               float scale, cudaStream_t stream) {
  return wgs == 2 ? launch<DH, 2>(q, k, v, o, lse, B, Nq, Nk, Hq, KV,
                                  n_chunk, scale, stream)
                  : launch<DH, 1>(q, k, v, o, lse, B, Nq, Nk, Hq, KV,
                                  n_chunk, scale, stream);
}

}  // namespace nc

}  // namespace

// q, o [B, Nq, Hq, Dh] and k, v [B, S, KV, Dh], bf16 contiguous (16-byte
// aligned), KV dividing Hq, Dh in {16, 64, 128}. With causal != 0: query
// row i of batch row b sees keys [kv_start[b], min(kv_len[b], q_offset[b] +
// i + 1)) (q_offset, kv_len, kv_start [B] int32 or null: 0, S and 0); a row
// with no such key writes 0; lse [B, Hq, Nq] fp32 or null: each row's
// natural log-sum-exp of its scaled scores (-inf for a row with no key);
// wgs and n_chunk unused. With causal == 0: every row sees all S keys (the
// bounds must be null; lse, if given, is each row's natural log-sum-exp,
// for training); wgs (1 or 2) warpgroups a block and the key range in
// n_chunk chunks of ceil(ceil(S / 64) / n_chunk) tiles, none empty (1 <=
// n_chunk <= 8), a cluster of blocks.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* q_offset, const void* kv_len,
                                  const void* kv_start, void* o, void* lse,
                                  int B, int Nq, int S, int Hq, int KV,
                                  int Dh, int causal, int wgs, int n_chunk,
                                  float scale, void* stream) {
  if (B <= 0 || Nq <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || B > 65535 ||
      static_cast<long long>(Nq) * (Hq / KV) > 65535LL * kBr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal != 0) {
    if (Dh == 16)
      return launch<16>(q, k, v, q_offset, kv_len, kv_start, o, lse, B, Nq, S,
                        Hq, KV, scale, st);
    if (Dh == 64)
      return launch<64>(q, k, v, q_offset, kv_len, kv_start, o, lse, B, Nq, S,
                        Hq, KV, scale, st);
    if (Dh == 128)
      return launch<128>(q, k, v, q_offset, kv_len, kv_start, o, lse, B, Nq,
                         S, Hq, KV, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_kt = (S + kBc - 1) / kBc;
  if (q_offset != nullptr || kv_len != nullptr || kv_start != nullptr ||
      (wgs != 1 && wgs != 2) || n_chunk < 1 ||
      n_chunk > nc::kMaxChunks ||
      n_chunk != (n_kt + (n_kt + n_chunk - 1) / n_chunk - 1) /
                     ((n_kt + n_chunk - 1) / n_chunk) ||
      static_cast<long long>(B) * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 16)
    return nc::launch_wgs<16>(wgs, q, k, v, o, lse, B, Nq, S, Hq, KV,
                              n_chunk, scale, st);
  if (Dh == 64)
    return nc::launch_wgs<64>(wgs, q, k, v, o, lse, B, Nq, S, Hq, KV,
                              n_chunk, scale, st);
  if (Dh == 128)
    return nc::launch_wgs<128>(wgs, q, k, v, o, lse, B, Nq, S, Hq, KV,
                               n_chunk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
