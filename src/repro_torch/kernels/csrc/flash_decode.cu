// GQA attention of one decode row per batch row over a per-slot bf16 KV
// cache, split over the key window (flash-decoding): causal (the LMs' self-
// attention) or not (a decoder's cross-attention).
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
//// Non-causal mode (`causal` 0): the Pallas kernel's `causal=False` form
// with one query row, where the reference calls `flash_attention_jnp(q, k,
// v, causal=False)` from `attention_block`'s `kv_override` branch at each
// decode step (Whisper's decoder, Llama-3.2-Vision's gated cross layers:
// q [B, 1, Hq, Dh] against the encoder's or the vision tokens' K, V [B, Nk,
// KV, Dh]). Row b sees keys [kv_start[b], kv_len[b]) (the wrapper passes
// neither: all Nk keys) and no probabilities are asked for. The mode is a
// template parameter (causal::Window<false>::hi): nothing else changes.
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
#include <math.h>

#include "causal_tile.cuh"

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

template <int DH, bool CAUSAL>
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
  const causal::Window<CAUSAL> w(q_offset, kv_len, kv_start, b, S);
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

template <int DH, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_len, const void* kv_start, void* o, void* probs,
           void* part, void* arrivals, int B, int S, int Hq, int KV,
           float scale, cudaStream_t stream) {
  static size_t raised = 0;
  const int n_split = (S + kSplit - 1) / kSplit;
  const size_t bytes = DecodeSmem<DH>::bytes(Hq / KV, n_split);
  const cudaError_t err =
      allow_smem(flash_decode_bf16_kernel<DH, CAUSAL>, bytes, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_split, KV, B);
  flash_decode_bf16_kernel<DH, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<const int*>(kv_start),
      static_cast<bf16*>(o), static_cast<float*>(probs),
      static_cast<float*>(part), static_cast<int*>(arrivals), S, Hq, KV,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_mode(bool causal, const void* q, const void* k, const void* v,
                const void* q_offset, const void* kv_len, const void* kv_start,
                void* o, void* probs, void* part, void* arrivals, int B, int S,
                int Hq, int KV, float scale, cudaStream_t stream) {
  return causal ? launch<DH, true>(q, k, v, q_offset, kv_len, kv_start, o,
                                   probs, part, arrivals, B, S, Hq, KV, scale,
                                   stream)
                : launch<DH, false>(q, k, v, q_offset, kv_len, kv_start, o,
                                    probs, part, arrivals, B, S, Hq, KV, scale,
                                    stream);
}

}  // namespace

// q, o [B, 1, Hq, Dh] and k, v [B, S, KV, Dh], bf16 contiguous, KV dividing
// Hq, Dh in {16, 64, 128}; q_offset, kv_len, kv_start [B] int32 or null (0, S
// and 0): with causal != 0 row b sees keys [kv_start[b], min(kv_len[b],
// q_offset[b] + 1)), with causal == 0 keys [kv_start[b], kv_len[b]) (kv_len
// past S acts as S); a row with no such key writes 0. probs [B, Hq, S] fp32
// or null: the row's probabilities, 0 at masked keys. Scratch: part [B, KV,
// n_split, Hq / KV, Dh + 2] fp32 with n_split = ceil(S / 64) (any
// contents), arrivals [B * KV] int32, zero before the launch and zero again
// after it.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* q_offset, const void* kv_len,
                                 const void* kv_start, void* o, void* probs,
                                 void* part, void* arrivals, int B, int S,
                                 int Hq, int KV, int Dh, int n_split,
                                 int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || KV > 65535 || B > 65535 ||
      n_split != (S + kSplit - 1) / kSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (Dh == 16)
    return launch_mode<16>(c, q, k, v, q_offset, kv_len, kv_start, o, probs,
                           part, arrivals, B, S, Hq, KV, scale, st);
  if (Dh == 64)
    return launch_mode<64>(c, q, k, v, q_offset, kv_len, kv_start, o, probs,
                           part, arrivals, B, S, Hq, KV, scale, st);
  if (Dh == 128)
    return launch_mode<128>(c, q, k, v, q_offset, kv_len, kv_start, o, probs,
                            part, arrivals, B, S, Hq, KV, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
