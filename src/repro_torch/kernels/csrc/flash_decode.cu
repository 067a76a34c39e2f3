// GQA attention of one decode row per batch row, split over the key range
// (flash-decoding): causal over a per-slot bf16 KV cache (the LMs' self-
// attention; CUDA cores) or not, over any Nk keys (a decoder's cross-
// attention; mma.sync tensor cores).
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/
// flash_attention/flash_attention.py:25) in its causal mode with the GQA
// head repeat, where `attention_block` (models/attention.py) calls it with
// one query row: `flash_attention_jnp(q, k, v, causal=True, q_offset,
// kv_len, kv_start)` on bf16 q [B, 1, Hq, Dh] against the cache k, v
// [B, S, KV, Dh], plus the row's probabilities `attention_probs_row(q[:, 0],
// k, kv_len, kv_start)`. Row b sees keys [kv_start[b], min(kv_len[b],
// q_offset[b] + 1)); query head h reads KV head h / (Hq / KV) in place.
// Arithmetic fp32, output bf16 rounded to nearest even; probabilities fp32,
// exactly 0 at masked keys; a row with no valid key writes 0 for both.
// The non-causal form (`causal` 0; a decoder's cross-attention) is a
// kernel of its own, designed for its shapes:
// flash_decode_bf16_noncausal_kernel, after this one.
//
// Bound on the H100: the launch must read the valid window of the cache
// once (B x window x KV x Dh x 2 tensors x 2 bytes: ~5.4 MB at Minitron-4B
// with B = 4 and windows of 98-559 keys, 1.7 us at 3.35 TB/s) and does ~4
// operations per (query head, key, dim): bound by bytes, far below the
// tensor cores' break-even. What it needs is the whole card streaming K
// and V at once, where one block per (batch row, KV head) walking the
// window serially fills 32 of 132 SMs.
//
// Design: the grid is (split, KV head g, batch row b). A block of 256
// threads owns 64 keys of one (b, g) and serves every query head of the
// group from one staged K/V tile; splits wholly outside the row's window
// exit at once (192 live blocks of 288 at the serve's decode shape). K and
// V arrive by 16-byte cp.async (neighbouring threads on neighbouring
// addresses) in two commit groups, so the scores are computed while V is
// still in flight. Scores, softmax
// and P.V run in fp32 on CUDA cores (the bf16 x bf16 products are exact in
// fp32). Each block writes its partial (max m, sum l, unnormalized acc[Dh])
// per query head to fp32 scratch and parks exp(s - m) of its keys in
// `probs`; the last block of a (b, g) to arrive, counted in `arrivals`
// (reset by that block, so it is zero again for the next launch), merges
// the partials in split order, normalizes and rounds o, and scales each
// split's parked values by exp(m_j - m) / l with the final m and l,
// writing 0 at masked keys. The atomic counter only elects the combining
// block: every sum is taken in a fixed order, so the result is bitwise
// repeatable. The combining block reads what other blocks wrote from L2,
// in batches of loads that are all in flight at once.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "causal_tile.cuh"
#include "mma16.cuh"

namespace {

using causal::bf16;

constexpr int kSplit = 64;  // keys per block
constexpr int kThreads = 256;

template <int DH>
struct DecodeSmem {
  static constexpr int kLd = DH + 8;  // bf16 row stride: 16-byte aligned,
                                      // 16-byte loads conflict-free
  // key groups of the P.V sum: thread t owns dim t % DH of group t / DH
  static constexpr int kGroups = kThreads / DH > 1 ? kThreads / DH : 1;
  static size_t bytes(int per, int n_split) {
    return sizeof(bf16) * 2 * kSplit * kLd +
           sizeof(float) * (per * DH + per * kSplit + 2 * per +
                            (kGroups > 1 ? kGroups * per * DH : 0) +
                            3 * per * n_split);
  }
};

constexpr int kInFlight = 16;  // L2 loads a combining thread keeps in flight

// A load that bypasses L1 (another block wrote the line), issued where it
// stands: the compiler may not sink it to its first use, so a batch of
// them, made unconditionally into registers, is in flight together.
__device__ __forceinline__ float ld_l2(const float* p) {
  float x;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(x) : "l"(p));
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ q_offset,
                         const int* __restrict__ kv_len,
                         const int* __restrict__ kv_start,
                         bf16* __restrict__ o, float* __restrict__ probs,
                         float* __restrict__ part, int* __restrict__ arrivals,
                         int S, int Hq, int KV, float scale) {
  using L = DecodeSmem<DH>;
  constexpr int kLd = L::kLd;
  constexpr int kGroups = L::kGroups;
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a cache row
  constexpr int kPart = DH + 2;    // a partial: acc[DH], m, l
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool combine;

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int per = Hq / KV;
  const causal::Window w(q_offset, kv_len, kv_start, b, S);
  const int lo = w.lo, hi = w.hi(0);
  const int first = lo / kSplit;
  const int n_live = hi > lo ? (hi - 1) / kSplit - first + 1 : 0;
  bf16* ob = o + (static_cast<size_t>(b) * Hq + g * per) * DH;
  float* pb = probs != nullptr
                  ? probs + (static_cast<size_t>(b) * Hq + g * per) * S
                  : nullptr;

  if (n_live == 0) {  // no valid key: split 0 writes the zeros
    if (split == 0) {
      for (int e = t; e < per * DH; e += kThreads)
        ob[e] = __float2bfloat16_rn(0.f);
      if (pb != nullptr)
        for (int e = t; e < per * S; e += kThreads) pb[e] = 0.f;
    }
    return;
  }
  if (split < first || split >= first + n_live) return;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kSplit * kLd;
  float* qf = reinterpret_cast<float*>(vs + kSplit * kLd);  // [per][DH]
  float* sc = qf + per * DH;     // [per][kSplit]: scores, then exp(s - m)
  float* ml = sc + per * kSplit; // [2][per]: m, l
  float* red = ml + 2 * per;     // [kGroups][per][DH] when kGroups > 1
  // the combine's [per][n_live] partial maxima, sums (then the
  // probabilities' scales w_j / l) and weights w_j
  float* cm = red + (kGroups > 1 ? kGroups * per * DH : 0);
  float* cl = cm + per * gridDim.x;
  float* cw = cl + per * gridDim.x;

  // keys [c0, c0 + kSplit) of the window; the rest of the tile is zeroed
  const int c0 = split * kSplit;
  const size_t slot = static_cast<size_t>(KV) * DH;  // cache slot stride
  const bf16* kb = k + (static_cast<size_t>(b) * S * KV + g) * DH;
  const bf16* vb = v + (static_cast<size_t>(b) * S * KV + g) * DH;
  for (int e = t; e < kSplit * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks, c = c0 + r;
    const bool ok = c >= lo && c < hi;
    cp_async16(ks + r * kLd + ch * 8, ok ? kb + c * slot + ch * 8 : kb,
                       ok);
  }
  cp_async_commit();
  for (int e = t; e < kSplit * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks, c = c0 + r;
    const bool ok = c >= lo && c < hi;
    cp_async16(vs + r * kLd + ch * 8, ok ? vb + c * slot + ch * 8 : vb,
                       ok);
  }
  cp_async_commit();
  const bf16* qb = q + (static_cast<size_t>(b) * Hq + g * per) * DH;
  for (int e = t; e < per * DH; e += kThreads) qf[e] = __bfloat162float(qb[e]);
  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // scores: one (head, key) pair per thread at a time, K read 16 bytes at
  // a time
  for (int e = t; e < per * kSplit; e += kThreads) {
    const int h = e / kSplit, r = e % kSplit, c = c0 + r;
    float a = -INFINITY;
    if (c >= lo && c < hi) {
      const float* qh = qf + h * DH;
      const bf16* kr = ks + r * kLd;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, summed in order
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 q0 = *reinterpret_cast<const float4*>(qh + d);
        const float4 q1 = *reinterpret_cast<const float4*>(qh + d + 4);
        const float qd[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 kf = __bfloat1622float2(k2[i]);
          acc[i] = fmaf(qd[2 * i], kf.x, acc[i]);
          acc[i] = fmaf(qd[2 * i + 1], kf.y, acc[i]);
        }
      }
      a = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * scale;
    }
    sc[h * kSplit + r] = a;
  }
  __syncthreads();

  // this split's max and sum per head, one warp per head; the split holds
  // a valid key, so m is finite and exp gives exactly 0 at masked keys.
  // exp(s - m) of the valid keys is parked in probs.
  const int warp = t >> 5, lane = t & 31;
  for (int h = warp; h < per; h += kThreads / 32) {
    float* s = sc + h * kSplit;
    float x[kSplit / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      x[i] = s[lane + 32 * i];
      m = fmaxf(m, x[i]);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, sh));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      x[i] = expf(x[i] - m);
      s[lane + 32 * i] = x[i];
      l += x[i];
      const int c = c0 + lane + 32 * i;
      if (pb != nullptr && c >= lo && c < hi)
        pb[static_cast<size_t>(h) * S + c] = x[i];
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, sh);
    if (lane == 0) {
      ml[h] = m;
      ml[per + h] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partial: acc[d] = sum_r p[r] v[r][d], keys split over kGroups
  // groups summed in group order
  float* pall = part + static_cast<size_t>(b * KV + g) * gridDim.x * per * kPart;
  float* mine = pall + static_cast<size_t>(split) * per * kPart;
  const int d = t % DH, grp = t / DH;
  for (int h0 = 0; h0 < per; h0 += 4) {  // four heads per pass over V
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = grp; r < kSplit; r += kGroups) {
      const float vr = __bfloat162float(vs[r * kLd + d]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (h0 + u < per) acc[u] = fmaf(sc[(h0 + u) * kSplit + r], vr, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int h = h0 + u;
      if (h >= per) break;
      if (kGroups > 1)
        red[(grp * per + h) * DH + d] = acc[u];
      else
        mine[h * kPart + d] = acc[u];
    }
  }
  if (kGroups > 1) {
    __syncthreads();
    for (int e = t; e < per * DH; e += kThreads) {
      float acc = 0.f;
      for (int gg = 0; gg < kGroups; ++gg) acc += red[gg * per * DH + e];
      mine[(e / DH) * kPart + e % DH] = acc;
    }
  }
  if (t < per) {
    mine[t * kPart + DH] = ml[t];
    mine[t * kPart + DH + 1] = ml[per + t];
  }

  // the last block of (b, g) to arrive combines
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* count = arrivals + b * KV + g;
    combine = atomicAdd(count, 1) == n_live - 1;
    if (combine) *count = 0;  // every live block has arrived
  }
  __syncthreads();
  if (!combine) return;
  __threadfence();

  // every live split's m and l into shared memory; then one warp per head
  // takes the final m, each split's weight w_j = exp(m_j - m) and the final
  // l = sum_j l_j w_j (a fixed shuffle tree over the splits in lane order)
  for (int e = t; e < per * n_live; e += kThreads) {
    const int h = e / n_live, j = e % n_live;
    const float* pj = pall + ((first + j) * per + h) * kPart + DH;
    cm[e] = ld_l2(pj);
    cl[e] = ld_l2(pj + 1);
  }
  __syncthreads();
  float* fin = sc;  // [2][per]: final m, l
  for (int h = warp; h < per; h += kThreads / 32) {
    const float* mh = cm + h * n_live;
    float M = -INFINITY;
    for (int j = lane; j < n_live; j += 32) M = fmaxf(M, mh[j]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, sh));
    float Lsum = 0.f;
    for (int j = lane; j < n_live; j += 32) {
      const float wj = expf(mh[j] - M);
      cw[h * n_live + j] = wj;
      Lsum = fmaf(cl[h * n_live + j], wj, Lsum);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      Lsum += __shfl_xor_sync(0xffffffffu, Lsum, sh);
    // a split's probabilities scale by w_j / l
    for (int j = lane; j < n_live; j += 32)
      cl[h * n_live + j] = cw[h * n_live + j] / Lsum;
    if (lane == 0) {
      fin[h] = M;
      fin[per + h] = Lsum;
    }
  }
  __syncthreads();

  // o: each element's weighted partials summed over the splits in order,
  // kInFlight splits' partials requested at once (past the last split,
  // the last again)
  for (int e = t; e < per * DH; e += kThreads) {
    const int h = e / DH;
    const float* pe = pall + (first * per + h) * kPart + e % DH;
    float acc = 0.f;
    for (int j0 = 0; j0 < n_live; j0 += kInFlight) {
      float x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        x[u] = ld_l2(pe + min(j0 + u, n_live - 1) * per * kPart);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (j0 + u < n_live) acc = fmaf(x[u], cw[h * n_live + j0 + u], acc);
    }
    ob[e] = __float2bfloat16_rn(acc / fin[per + h]);
  }
  if (pb != nullptr) {
    // exp(s - m_j) parked by split j, times w_j / l; kInFlight of this
    // thread's entries requested at once
    const int n = per * S;
    for (int e0 = t; e0 < n; e0 += kInFlight * kThreads) {
      float x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        x[u] = ld_l2(pb + min(e0 + u * kThreads, n - 1));
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = e0 + u * kThreads, h = e / S, c = e - h * S;
        if (e < n)
          pb[e] = c >= lo && c < hi
                      ? x[u] * cl[h * n_live + c / kSplit - first] : 0.f;
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_len, const void* kv_start, void* o, void* probs,
           void* part, void* arrivals, int B, int S, int Hq, int KV,
           float scale, cudaStream_t stream) {
  static size_t raised = 0;
  const int n_split = (S + kSplit - 1) / kSplit;
  const size_t bytes = DecodeSmem<DH>::bytes(Hq / KV, n_split);
  const cudaError_t err =
      allow_smem(flash_decode_bf16_kernel<DH>, bytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_split, KV, B);
  flash_decode_bf16_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<const int*>(kv_start),
      static_cast<bf16*>(o), static_cast<float*>(probs),
      static_cast<float*>(part), static_cast<int*>(arrivals), S, Hq, KV,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The non-causal form
// ---------------------------------------------------------------------------
// The Pallas kernel's `causal=False` form with one query row, where the
// reference calls `flash_attention_jnp(q, k, v, causal=False)` from
// `attention_block`'s `kv_override` branch at each decode step: Whisper's
// decoder (8 MHA heads of Dh 64 over 1500 audio frames) and
// Llama-3.2-Vision's gated cross layers (64 query heads over 8 KV heads of
// Dh 128, GQA 8:1, over 1601 vision tokens). q, o [B, 1, Hq, Dh], k, v [B,
// Nk, KV, Dh]; every key valid; no probabilities.
//
// Bound on the H100: K and V are read once (12.3 / 13.1 MB at the two
// models' shapes, 3.7 / 3.9 us at 3.35 TB/s); the products are 2 Dh
// operations per (head, key) each way, far below the tensor cores' break-
// even. What the kernel needs is the whole card streaming K and V at once
// and little else on its path: one (b, g) is 1500 x 64 x 2 x 2 bytes of
// keys and values, so a split over the keys is what fills the card.
//
// Design: the grid is (split, (KV head g, head tile), batch row b). The
// host (`noncausal_decode_plan` in kernels/flash_attention/ops.py) picks
// n_split from B KV, the key count and the SM count: about one wave of
// blocks, each walking ceil(ceil(Nk / 64) / n_split) key tiles of 64, none
// empty. A block of four warps keeps up to three tiles' K and V in flight
// by 16-byte cp.async (a ring of kStages), so the next tiles' copies run
// under this one's products, and serves a head tile: up to 16 query heads
// of the group, the rows of an mma.sync.m16n8k16 A fragment (at GQA 8:1
// the 8 heads fill half of them; at one head per group, one row). Warp w
// owns keys 16 w .. 16 w + 15 of every tile and runs its own online
// softmax over them: Q.K^T as bf16 MMAs with fp32 accumulation (the
// products exact, as in the reference), the scores scaled to log2 units
// in the accumulator's registers, P.V as two MMAs per 16 keys with P's
// bf16 hi and lo halves (mma16.cuh's split: P kept to ~2^-16 relative)
// against V transposed by ldmatrix. No barrier but the stages': the four
// warps merge once, after the last tile, in warp order in shared memory
// into the split's partial (m in log2 units, l, unnormalised o per head).
// The n_split blocks of a (b, g, head tile) are one thread block cluster
// (at most 8, the portable size): after a cluster barrier every thread of
// the cluster takes runs of four (head, dim) elements in turn and reads
// each split's m, l and run from that block's shared memory (distributed
// shared memory, all loads in flight together), summing them in split
// order. No scratch in device memory, no atomic, no fence: one launch,
// every sum in a fixed order, two launches bitwise equal.
namespace nc {

using bf16 = __nv_bfloat16;
using mma16::ldmatrix_x4;
using mma16::ldmatrix_x4_trans;
using mma16::mma;
using mma16::split_hi_lo;

constexpr int kTile = 64;       // keys per tile
constexpr int kThreads = 128;   // four warps of 16 keys a tile
constexpr int kRows = 16;       // query heads a block serves (a head tile)
constexpr int kStages = 3;      // key tiles a block has in flight
constexpr int kMaxSplits = 8;   // a cluster's blocks (the portable most)
constexpr float kLog2e = 1.4426950408889634f;

namespace cg = cooperative_groups;
using causal::ex2;

// Shared memory: n_st stages of a K and a V tile (at least two), then Q's
// rows; the warps' partials and the split's reuse the stages.
template <int DH>
struct Smem {
  static constexpr int kLd = DH + 8;  // bf16 row stride: 16-byte aligned,
                                      // ldmatrix conflict-free
  static constexpr int kTileElems = kTile * kLd;
  static constexpr size_t kStage = sizeof(bf16) * 2 * kTileElems;
  static size_t bytes(int n_st) {
    return (n_st > 2 ? n_st : 2) * kStage + sizeof(bf16) * kRows * kLd;
  }
  static_assert((5 * kRows * (DH + 4) + 4 * kRows) * 4 <= 2 * kStage,
                "the warps' partials and the split's fit in the stages");
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_bf16_noncausal_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   bf16* __restrict__ o, int Nk, int Hq,
                                   int KV, float scale) {
  using L = Smem<DH>;
  constexpr int kLd = L::kLd;
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a row
  // a partial row: o[DH], m, l, two floats of padding (16-byte rows)
  constexpr int kPart = DH + 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, n_split = gridDim.x;  // a cluster's blocks
  const int per = Hq / KV, n_ht = (per + kRows - 1) / kRows;
  const int g = blockIdx.y / n_ht, ht = blockIdx.y % n_ht, b = blockIdx.z;
  const int h0 = ht * kRows, n_h = min(kRows, per - h0);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int n_kt = (Nk + kTile - 1) / kTile;
  const int per_split = (n_kt + n_split - 1) / n_split;
  const int kt0 = split * per_split, n_t = min(per_split, n_kt - kt0);

  // a ring of n_st stages (one where the split is one tile)
  const int n_st = min(per_split, kStages);
  bf16* kvs = reinterpret_cast<bf16*>(smem);  // stage s: K, V at 2 s, 2 s + 1
  bf16* qs = kvs + 2 * max(n_st, 2) * L::kTileElems;
  const size_t slot = static_cast<size_t>(KV) * DH;  // key stride
  const bf16* kb = k + (static_cast<size_t>(b) * Nk * KV + g) * DH;
  const bf16* vb = v + (static_cast<size_t>(b) * Nk * KV + g) * DH;
  auto load = [&](int i) {  // key tile kt0 + i into its stage; past Nk zero
    bf16* ks = kvs + 2 * (i % n_st) * L::kTileElems;
    bf16* vs = ks + L::kTileElems;
    for (int e = t; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks, c = (kt0 + i) * kTile + r;
      const bool ok = c < Nk;
      const size_t at = ok ? c * slot + ch * 8 : 0;
      cp_async16(ks + r * kLd + ch * 8, kb + at, ok);
      cp_async16(vs + r * kLd + ch * 8, vb + at, ok);
    }
    cp_async_commit();
  };
  // the head tile's query rows (heads past the group's, zero), with tile 0
  const bf16* qb = q + (static_cast<size_t>(b) * Hq + g * per + h0) * DH;
  for (int e = t; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const bool ok = r < n_h;
    cp_async16(qs + r * kLd + ch * 8, ok ? qb + r * DH + ch * 8 : qb, ok);
  }
  for (int i = 0; i < min(n_t, n_st); ++i) load(i);

  const float scale_log2 = scale * kLog2e;
  uint32_t qa[DH / 16][4];
  // this thread's rows (heads h0 + lane / 4, + 8) over this warp's keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int i = 0; i < n_t; ++i) {
    // tile i's copy group has landed once at most the groups committed
    // after it are in flight
    switch (min(n_st - 1, n_t - 1 - i)) {
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        ldmatrix_x4(qa[kd], qs + (lane & 15) * kLd + kd * 16 + (lane >> 4) * 8);
    }
    const bf16* ks = kvs + 2 * (i % n_st) * L::kTileElems;
    const bf16* vs = ks + L::kTileElems;

    // S = Q K^T over this warp's 16 keys: two n-tiles of 8, each summed
    // over Dh in two chains (even and odd k-steps) added at the end, so
    // the dependent products are half as many
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                          kd * 16 + ((lane >> 3) & 1) * 8);
      mma<bf16>(kd & 1 ? s2[0] : s[0], qa[kd], kf[0], kf[1]);
      mma<bf16>(kd & 1 ? s2[1] : s[1], qa[kd], kf[2], kf[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];

    // scale to log2 units; keys past Nk are -inf. A warp may meet no valid
    // key in a split (its slice of a last tile of one key): its running max
    // stays -inf and p and the correction are guarded.
    const int c0 = (kt0 + i) * kTile + warp * 16;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (c0 + nt * 8 + (lane & 3) * 2 + (e & 1) >= Nk) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      corr[x] = mx[x] == -INFINITY ? 1.f : ex2(m[x] - mx[x]);
      m[x] = mx[x];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mm = m[e >> 1];
        const float p = mm == -INFINITY ? 0.f : ex2(s[nt][e] - mm);
        s[nt][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + psum[x];
#pragma unroll
    for (int i2 = 0; i2 < DH / 8; ++i2) {
      acc[i2][0] *= corr[0];
      acc[i2][1] *= corr[0];
      acc[i2][2] *= corr[1];
      acc[i2][3] *= corr[1];
    }

    // O += P V over the warp's 16 keys (one k-step), P as hi + lo halves
    uint32_t ph[4], pl[4];
    split_hi_lo<bf16>(s[0][0], s[0][1], ph[0], pl[0]);
    split_hi_lo<bf16>(s[0][2], s[0][3], ph[1], pl[1]);
    split_hi_lo<bf16>(s[1][0], s[1][1], ph[2], pl[2]);
    split_hi_lo<bf16>(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + (warp * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * kLd +
                                dp * 16 + (lane >> 4) * 8);
      mma<bf16>(acc[2 * dp], ph, vf[0], vf[1]);
      mma<bf16>(acc[2 * dp], pl, vf[0], vf[1]);
      mma<bf16>(acc[2 * dp + 1], ph, vf[2], vf[3]);
      mma<bf16>(acc[2 * dp + 1], pl, vf[2], vf[3]);
    }
    if (i + n_st < n_t) {  // a ring: this stage takes the tile n_st on
      __syncthreads();
      load(i + n_st);
    }
  }
  __syncthreads();  // every warp is done with the stages

  // the warps' partials into shared memory, [warp][row][kPart]
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  float* wm = reinterpret_cast<float*>(smem);
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float* w = wm + (warp * kRows + (lane >> 2) + 8 * x) * kPart;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      w[8 * i + col] = acc[i][2 * x];
      w[8 * i + col + 1] = acc[i][2 * x + 1];
    }
    if ((lane & 3) == 0) {
      w[DH] = m[x];
      w[DH + 1] = l[x];
    }
  }
  __syncthreads();
  // the split's partial after the warps' [kRows][kPart]: per head, M = max
  // over the warps and each warp's weight 2^(m_w - M) (a split holds a
  // valid key, so M is finite), then every element's terms weighted and
  // summed in warp order
  float* sp = wm + 4 * kRows * kPart;
  float* wt = sp + kRows * kPart;  // [kRows][4]
  if (t < n_h * 4) {
    const int r = t >> 2;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wm[(w * kRows + r) * kPart + DH]);
    wt[t] = ex2(wm[((t & 3) * kRows + r) * kPart + DH] - M);
    if ((t & 3) == 0) sp[r * kPart + DH] = M;
  }
  __syncthreads();
  // o's elements four at a time, then each head's l
  for (int u = t; u < n_h * (DH / 4) + n_h; u += kThreads) {
    if (u < n_h * (DH / 4)) {
      const int r = u / (DH / 4), c = 4 * (u % (DH / 4));
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 x =
            *reinterpret_cast<const float4*>(wm + (w * kRows + r) * kPart + c);
        const float f = wt[r * 4 + w];
        a.x = fmaf(x.x, f, a.x);
        a.y = fmaf(x.y, f, a.y);
        a.z = fmaf(x.z, f, a.z);
        a.w = fmaf(x.w, f, a.w);
      }
      *reinterpret_cast<float4*>(sp + r * kPart + c) = a;
    } else {
      const int r = u - n_h * (DH / 4);
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        a = fmaf(wm[(w * kRows + r) * kPart + DH + 1], wt[r * 4 + w], a);
      sp[r * kPart + DH + 1] = a;
    }
  }

  // The splits of (b, g, head tile) are one cluster: once every block's
  // partial is in its shared memory, the cluster's threads take the head
  // tile's runs of 4 elements (head, 4 c .. 4 c + 3) in turn, each reading
  // every split's m, l and run from that block's shared memory at once and
  // summing them in split order: M = max_j m_j, w_j = 2^(m_j - M), o =
  // sum_j w_j o_j / sum_j w_j l_j.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  bf16* ob = o + (static_cast<size_t>(b) * Hq + g * per + h0) * DH;
  for (int u = split * kThreads + t; u < n_h * (DH / 4);
       u += n_split * kThreads) {
    const int r = u / (DH / 4), c = u - r * (DH / 4);
    float mj[kMaxSplits], lj[kMaxSplits];
    float4 xj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j >= n_split) break;
      const float* rp = cluster.map_shared_rank(sp, j) + r * kPart;
      mj[j] = rp[DH];
      lj[j] = rp[DH + 1];
      xj[j] = *reinterpret_cast<const float4*>(rp + 4 * c);
    }
    float M = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < n_split) M = fmaxf(M, mj[j]);
    float L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < n_split) {
        const float w = ex2(mj[j] - M);
        L = fmaf(lj[j], w, L);
        a.x = fmaf(xj[j].x, w, a.x);
        a.y = fmaf(xj[j].y, w, a.y);
        a.z = fmaf(xj[j].z, w, a.z);
        a.w = fmaf(xj[j].w, w, a.w);
      }
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>(ob + r * DH + 4 * c);
    out[0] = __floats2bfloat162_rn(a.x / L, a.y / L);
    out[1] = __floats2bfloat162_rn(a.z / L, a.w / L);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}
// -- end of the non-causal kernel

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Nk, int Hq, int KV, int n_split, float scale,
           cudaStream_t stream) {
  static size_t raised = 0;
  const int n_kt = (Nk + kTile - 1) / kTile;
  const size_t bytes =
      Smem<DH>::bytes(min((n_kt + n_split - 1) / n_split, kStages));
  const cudaError_t err = allow_smem(flash_decode_bf16_noncausal_kernel<DH>,
                                     bytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV * ((Hq / KV + kRows - 1) / kRows), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;  // a (b, g, head tile)'s splits
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_decode_bf16_noncausal_kernel<DH>,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Nk, Hq, KV,
      scale));
}

}  // namespace nc

}  // namespace

// q, o [B, 1, Hq, Dh] and k, v [B, S, KV, Dh], bf16 contiguous (16-byte
// aligned), KV dividing Hq, Dh in {16, 64, 128}. With causal != 0: row b
// sees keys [kv_start[b], min(kv_len[b], q_offset[b] + 1)) (q_offset,
// kv_len, kv_start [B] int32 or null: 0, S and 0); a row with no such key
// writes 0; probs [B, Hq, S] fp32 or null: the row's probabilities, 0 at
// masked keys; part [B, KV, n_split, Hq / KV, Dh + 2] fp32 scratch with
// n_split = ceil(S / 64) (any contents); arrivals [B * KV] int32 counters,
// zero before the launch and zero again after it. With causal == 0: every
// row sees all S keys; the key range in n_split splits of ceil(ceil(S /
// 64) / n_split) tiles of 64, none empty (1 <= n_split <= 8), a cluster
// of blocks; the bounds, probs, part and arrivals must be null.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* q_offset, const void* kv_len,
                                 const void* kv_start, void* o, void* probs,
                                 void* part, void* arrivals, int B, int S,
                                 int Hq, int KV, int Dh, int n_split,
                                 int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal != 0) {
    if (n_split != (S + kSplit - 1) / kSplit)
      return static_cast<int>(cudaErrorInvalidValue);
    if (Dh == 16)
      return launch<16>(q, k, v, q_offset, kv_len, kv_start, o, probs, part,
                        arrivals, B, S, Hq, KV, scale, st);
    if (Dh == 64)
      return launch<64>(q, k, v, q_offset, kv_len, kv_start, o, probs, part,
                        arrivals, B, S, Hq, KV, scale, st);
    if (Dh == 128)
      return launch<128>(q, k, v, q_offset, kv_len, kv_start, o, probs, part,
                         arrivals, B, S, Hq, KV, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_kt = (S + nc::kTile - 1) / nc::kTile;
  const int per_split = n_split > 0 ? (n_kt + n_split - 1) / n_split : 0;
  if (q_offset != nullptr || kv_len != nullptr || kv_start != nullptr ||
      probs != nullptr || part != nullptr || arrivals != nullptr ||
      n_split < 1 || n_split > nc::kMaxSplits ||
      n_split != (n_kt + per_split - 1) / per_split ||
      static_cast<long long>(KV) * ((Hq / KV + nc::kRows - 1) / nc::kRows) >
          65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 16)
    return nc::launch<16>(q, k, v, o, B, S, Hq, KV, n_split, scale, st);
  if (Dh == 64)
    return nc::launch<64>(q, k, v, o, B, S, Hq, KV, n_split, scale, st);
  if (Dh == 128)
    return nc::launch<128>(q, k, v, o, B, S, Hq, KV, n_split, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
