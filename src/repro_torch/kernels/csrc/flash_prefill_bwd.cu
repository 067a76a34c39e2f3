// The gradient of GQA attention over whole sequences (training): dQ, dK and
// dV of o = softmax(scale Q K^T + mask) V, with the five products Q.K^T,
// dO.V^T, dS.K, K.Q^T / V.dO^T and P^T.dO / dS^T.Q on Hopper's warpgroup
// tensor cores (wgmma), their operands staged by the Tensor Memory
// Accelerator (TMA) under mbarriers. Two forms, one entry point:
//
// * causal (`causal` != 0): the LMs' self-attention. Replaces the gradient
//   that JAX takes of the reference's train-mode attention,
//   `flash_attention_jnp(q, k, v, causal=True, kv_start)`
//   (src/repro/models/attention.py:311-313), whose forward is the Pallas
//   kernel `_flash_kernel` (src/repro/kernels/flash_attention/
//   flash_attention.py:25) in its causal mode with the GQA head repeat. The
//   forward on the card is flash_prefill.cu's causal kernel, which also
//   writes each row's log-sum-exp; `CausalAttention`
//   (kernels/flash_attention/ops.py) pairs the two as an autograd function.
//   Inputs: bf16 q, o, dO [B, N, Hq, Dh] and k, v [B, N, KV, Dh], fp32 lse
//   [B, Hq, N], optional kv_start [B]: query row i sees keys [kv_start[b],
//   i + 1).
// * non-causal (`causal` 0): the same kernel's `causal=False` form, where
//   the reference trains it on bf16 with Nq and Nk free and the GQA repeat:
//   Whisper's encoder self-attention, its decoder's cross-attention over the
//   audio frames and the VLM's gated cross layers over the vision tokens
//   (src/repro/models/model.py:346-349, 366-370, 385-389). q, o, dO [B, Nq,
//   Hq, Dh] against k, v [B, Nk, KV, Dh], every row seeing all Nk keys; lse
//   [B, Hq, Nq] from flash_prefill.cu's non-causal kernel.
//   `NonCausalGQAAttention` (ops.py) pairs the two. Its kernels are their
//   own instantiations (`*_noncausal_dq_kernel`, `*_noncausal_dkdv_kernel`)
//   of the same bodies, so a profile tells the forms apart.
// Query head h reads KV head h / (Hq / KV) in place. Outputs bf16 dq and dk,
// dv; each dk / dv row is the fp32 sum over its group's query heads, rounded
// once.
//
// Maths (FlashAttention-2's backward): D = rowsum(dO o O) in fp32; per
// (row, key) P = exp2(s scale log2e - lse log2e), recomputed from exact
// bf16 products summed in fp32; dV += P^T dO; dP = dO V^T; dS = P o (dP -
// D); dK += scale dS^T Q; dQ += scale dS K. A masked (row, key) pair has P
// = 0 exactly; a row without a valid key (a pad row, only where kv_start is
// given; lse -inf) has P = 0 at every key: it adds nothing to dK, dV and
// gets dQ = 0 (its forward wrote 0). In the non-causal form only the ragged
// edges are masked: keys past Nk (TMA's zero fill) in dQ's walk, rows past
// Nq in dK/dV's.
//
// Bound on the H100, full-width StableLM-1.6B at batch 8, seq 512 (32
// heads, Dh 64): 3.4e7 causal (row, head, key) pairs, 10 Dh products each
// (2.1e10 FLOP). q, k, v, o, dO are read and dq, dk, dv written once: 134
// MB, 40 us at 3.35 TB/s; the products at the bf16 tensor-core rate take
// 22 us (35 us as this design runs them, P and dS split in two bf16 halves,
// 16 Dh per pair): bound by bytes. The non-causal training shapes: Whisper's
// encoder [8, 1500, 8, 64] has 1.4e8 pairs, 92 GFLOP, 93 us at 989 TFLOP/s
// (bound by operations); its cross-attention (q [8, 64, 8, 64] over 1500)
// 15 GFLOP, bound by the bytes of K, V, dK and dV; Llama-3.2-Vision's cross
// layers (q [8, 512, 64, 128] over [8, 1601, 8, 128]) 537 GFLOP, 0.54 ms,
// and its causal self-attention at Dh 128 86 GFLOP: bound by operations.
//
// Design: two kernels, one launch each, no atomics, every sum in a fixed
// order (two launches are bitwise equal). Tiles are 64 positions of one
// head: TMA boxes of the 4-D [B, N, H, Dh] view (two boxes of 64 columns at
// Dh 128), so MHA and any GQA ratio tile alike, and TMA's zero fill covers
// rows past the last tile.
//   (1) `dq` runs first. A work item is 64 query positions of one query
//   head. The block forms D = rowsum(dO o O) of its rows from the staged dO
//   and O tiles (four lanes per row; at Dh 128 O is read from device memory
//   instead), writes lse log2e and D to a [2, B, Hq, Np] scratch (Np = Nq
//   rounded up to 64), then walks the key tiles its rows see: S = Q K^T and
//   dP = dO V^T (wgmma, both operands from shared memory, K-major), P and
//   dS in registers, dQ += dS K (dS as the register A operand in hi and lo
//   bf16 halves, K read MN-major through a transposed descriptor).
//   (2) `dkdv`: a work item is 64 keys of one KV head (K and V staged
//   once) and all their dK / dV columns; it walks every (query tile, query
//   head of the group) that sees them, keys as rows: S^T = K Q^T and dP^T =
//   V dO^T, then dV += P^T dO and dK += dS^T Q (P^T and dS^T as register A
//   operands, hi and lo halves; dO and Q MN-major). The group's query heads
//   are iterations like any other, so their sum stays in the fp32
//   accumulators. Per-row lse log2e and D arrive by TMA from the scratch.
//   At Dh 16 and 64 one warpgroup runs all four products, the last two in
//   flight together.
// Dh 128: the two fp32 accumulators of a whole row would be 128 registers
// a thread on top of the products' operands, so a dkdv block is two
// warpgroups (dkdv128_body), each holding one 64-register accumulator:
// warpgroup 0 computes S^T and dV += P^T dO, warpgroup 1 dP^T and dK +=
// dS^T Q, and P^T (masked zeros included) passes from 0 to 1 in fp32
// through a double-buffered shared-memory slot under mbarriers (no
// block-wide barrier per tile). S^T and dP^T are computed once per (key
// tile, query tile, head): 768 FLOP a pair for each warpgroup, 1,536 in
// all (P and dS in two halves), where items of one 64-column half each
// recomputed them (2,048). K and V move into registers once an item, as
// the A operands of S^T and dP^T, so those products read only Q or dO
// from shared memory and the item's slot is free for the next item at
// once; the warpgroups share each ring stage, and each issues the next
// tile's first product with this tile's second, so its exponentials or
// dS run under its own products and the other warpgroup's. 195 KB of
// shared memory (one fixed slot, 4 ring stages, 32 KB of hand-off) and
// 252-254 registers a thread: one block an SM. The dq kernel at Dh 128
// stages Q and dO and reads its rows of O from device memory for D, with
// two K/V stages: two blocks of 98 KB an SM, each a warpgroup of 64
// accumulator registers, so one block's softmax runs under the other's
// products.
// Both kernels are persistent: as many blocks as the SMs hold at once,
// each taking every gridDim-th work item of a fixed list, heavy first (the
// last query tiles see the most keys, the first key tiles the most rows).
// One thread of a block issues every cp.async.bulk.tensor (thread 0; at
// Dh 128's dkdv the first of warpgroup 1, the last to release a stage),
// each under a full and an empty mbarrier, and there is no block-wide
// barrier per tile: an item's fixed tiles go into a slot of their own
// (dkdv at Dh 16 and 64: one of two, so the next item's arrive while this
// one runs; at Dh 128 one, free once its tiles are in registers), the
// streamed tiles into a ring of stages, refilled as each is released. The
// wgmma descriptors read the swizzled layout TMA wrote: 128-byte rows and
// the 128-byte swizzle at Dh 64 and 128, 32-byte ones at Dh 16. The
// barrier, TMA and wgmma helpers, the descriptors and the tensor maps'
// encoding are wgmma_tile.cuh's, shared with the non-causal prefill
// (flash_prefill.cu).
// Why no producer warp: the H100 splits an SM's registers over its four
// sub-partitions, a warp's on one, and ptxas budgets a kernel for the
// sub-partition with the most warps: 168 registers a thread once a block
// of five warps runs twice per SM (or one of 10 warps once), under the
// 204 the Dh-64 dkdv warpgroup takes. Handing the producer's registers over
// with setmaxnreg did not help: ptxas kept the consumers at the entry
// budget (spilling), and with a lone producer warp the launch hung on the
// H100. Blocks of one warpgroup leave 255 at two per SM, 168 at three; the
// Dh-128 dkdv block of two warpgroups 255 at one.
#include <math.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using namespace wgt;

constexpr int kThreads = 128;  // a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Per head width: each kernel's fixed tiles, ring depth, fixed slots,
// warpgroups and blocks an SM. At Dh 16 and 64 the dkdv kernel takes 204
// registers a thread, so two blocks an SM; the dq kernel (141) fits three
// with one slot for its fixed tiles (three blocks of 75 KB fill shared
// memory), 68.70 us a launch against 80.75 at two blocks of two slots
// (H100, [8, 512, 32, 64]). Dh 128: see the design note above; its
// times are below Cfg<128>.
template <int DH>
struct Cfg {
  static constexpr int kDqFixed = 3;  // Q, dO, O
  static constexpr int kDqStages = 3, kDqSlots = 1, kDqMinBlocks = 3;
  static constexpr int kDkdvStages = 3, kDkdvSlots = 2, kDkdvMinBlocks = 2;
  static constexpr int kDkdvWarpgroups = 1, kDkdvHand = 0;
};
// Dh 128 (NVIDIA H100 80GB HBM3, 700.00 W; tools/causal_ab.py, device us
// a launch): Llama-3.2-Vision-90B's cross backward, q [8, 512, 64/8, 128]
// over 1601 keys, 2,218-2,220 (dK/dV 1,399-1,401, dQ 819-820) against
// 3,306-3,320 (1,983-1,998, 1,322-1,324) when each dkdv item owned one
// 64-column half and the dq kernel held three fixed tiles and three stages
// (one block an SM); its causal self backward [8, 512, 64/8, 128] 478
// (275, 203) against 711-725 (418-428, 294-296); the ragged [2, 130,
// 16/2, 128] 55.4-56.2 against 60.9-61.5.
template <>
struct Cfg<128> {
  static constexpr int kDqFixed = 2;  // Q, dO; O read from device memory
  static constexpr int kDqStages = 2, kDqSlots = 1, kDqMinBlocks = 2;
  static constexpr int kDkdvStages = 4, kDkdvSlots = 1, kDkdvMinBlocks = 1;
  // two hand-off buffers of P^T: 32 fp32 a thread of a warpgroup each
  static constexpr int kDkdvWarpgroups = 2, kDkdvHand = 2 * 32 * 4 * 128;
};

// Shared memory of a kernel: kSlots slots of kFixed tiles that stay for a
// work item (dq: Q, dO and, below Dh 128, O; dkdv: K, V); a ring of
// kStages stages of two streamed tiles (dq: K, V; dkdv: Q, dO) and kStages
// stages of per-row stats (dkdv: lse log2e and D, 64 fp32 each); kHand
// bytes of hand-off buffers (Dh 128's dkdv: P^T, warpgroup 0 to 1); then
// the barriers. The base is rounded up to 1024 bytes, the 128-byte
// swizzle's period.
template <int DH, int kFixed, int kSlots, int kStages, int kHand = 0>
struct Smem {
  static constexpr int kTileBytes = TileFmt<DH>::kTileBytes;
  static constexpr int kStatBytes = 2 * kTile * 4;
  static constexpr int kRing = kSlots * kFixed * kTileBytes;
  static constexpr int kStats = kRing + 2 * kStages * kTileBytes;
  static constexpr int kHands = kStats + kStages * kStatBytes;
  static constexpr int kBars = kHands + kHand;
  static constexpr size_t kBytes =
      1024 + kBars + 8 * (4 + 2 * kStages) + (kHand > 0 ? 32 : 0);
  static __device__ __forceinline__ uint32_t fixed(uint32_t base, int f,
                                                   int x) {
    return base + (f * kFixed + x) * kTileBytes;
  }
  static __device__ __forceinline__ uint32_t ring(uint32_t base, int s,
                                                  int x) {
    return base + kRing + (2 * s + x) * kTileBytes;
  }
  static __device__ __forceinline__ uint32_t stat(uint32_t base, int s) {
    return base + kStats + s * kStatBytes;
  }
  static __device__ __forceinline__ uint32_t hand(uint32_t base, int x) {
    return base + kHands + x * (kHand / 2);
  }
};

// the barriers: full and empty for each fixed slot (two at most) and each
// of kStages ring stages (full: the feeding thread's arrival plus TMA's
// bytes; empty: every one of the block's kArrive threads); where a block
// hands P^T from one warpgroup to the other, full and empty for each of
// the two hand-off buffers (128 arrivals each: the writing warpgroup's,
// the reading one's)
template <int kStages, int kArrive = kThreads>
struct Bars {
  uint32_t base;
  __device__ __forceinline__ uint32_t fixed_full(int f) const {
    return base + 8 * f;
  }
  __device__ __forceinline__ uint32_t fixed_empty(int f) const {
    return base + 16 + 8 * f;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + 32 + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + 32 + 8 * kStages + 8 * s;
  }
  __device__ __forceinline__ uint32_t hand_full(int x) const {
    return base + 32 + 16 * kStages + 8 * x;
  }
  __device__ __forceinline__ uint32_t hand_empty(int x) const {
    return base + 48 + 16 * kStages + 8 * x;
  }
  __device__ __forceinline__ void init(bool hands = false) const {
    for (int f = 0; f < 2; ++f) {
      bar_init(fixed_full(f), 1);
      bar_init(fixed_empty(f), kArrive);
    }
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kArrive);
    }
    if (hands)
      for (int x = 0; x < 2; ++x) {
        bar_init(hand_full(x), kThreads);
        bar_init(hand_empty(x), kThreads);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// d += the fp32 dot product of two pairs of bf16, and of two runs of 8
__device__ __forceinline__ void dot2(float& d, uint32_t x, uint32_t y) {
  const float2 u = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 v = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&y));
  d = fmaf(u.x, v.x, d);
  d = fmaf(u.y, v.y, d);
}
__device__ __forceinline__ void dot8(float& d, uint4 x, uint4 y) {
  dot2(d, x.x, y.x);
  dot2(d, x.y, y.y);
  dot2(d, x.z, y.z);
  dot2(d, x.w, y.w);
}

// sum over this lane's quarter of row r of two swizzled tiles a and b of
// the elementwise products, in fp32
template <int DH>
__device__ __forceinline__ float row_dot(const unsigned char* a,
                                         const unsigned char* b, int r,
                                         int q4) {
  using F = TileFmt<DH>;
  float d = 0.f;
  if constexpr (DH >= 64) {  // chunks kPer q4 .. kPer q4 + kPer - 1
    constexpr int kPer = DH / 32;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int off = F::chunk(r, kPer * q4 + c);
      dot8(d, *reinterpret_cast<const uint4*>(a + off),
           *reinterpret_cast<const uint4*>(b + off));
    }
  } else {  // half q4 % 2 of chunk q4 / 2
    const int off = F::chunk(r, q4 >> 1) + (q4 & 1) * 8;
    const uint2 x = *reinterpret_cast<const uint2*>(a + off);
    const uint2 y = *reinterpret_cast<const uint2*>(b + off);
    dot2(d, x.x, y.x);
    dot2(d, x.y, y.y);
  }
  return d;
}

// A dq work item: 64 query positions from r0 of query head h, batch row b,
// the last position tiles first (causal: they see the most keys), the
// heads and batch rows of one tile together; its key tiles t0 .. t0 + n_kt
// - 1 hold every key its rows see: causal [lo, min(r0 + 64, N)), else all
// Nk.
template <bool CAUSAL>
struct DqItem {
  int r0, h, b, g, lo, t0, n_kt;
  DqItem() = default;
  __device__ __forceinline__ DqItem(int w, int n_qt, int B, int Hq, int per,
                                    int Nq, int Nk, const int* kv_start) {
    const int hb = Hq * B, rem = w % hb;
    r0 = (n_qt - 1 - w / hb) * kTile;
    h = rem % Hq;
    b = rem / Hq;
    g = h / per;
    if constexpr (CAUSAL) {
      lo = kv_start != nullptr ? max(kv_start[b], 0) : 0;
      const int hi = min(r0 + kTile, Nq);
      t0 = lo / kTile;
      n_kt = hi > lo ? (hi - 1) / kTile - t0 + 1 : 0;
    } else {
      lo = t0 = 0;
      n_kt = (Nk + kTile - 1) / kTile;
    }
  }
};

// A dkdv work item: 64 keys from c0 of KV head g, batch row b, all their
// dK and dV columns, the first key tiles first (causal: the most rows see
// them); it walks the query tiles from q_first on, each for the group's
// query heads (n_it iterations). Causal: rows at positions >= max(c0, lo)
// see a key of the tile, if any does.
template <bool CAUSAL>
struct KvItem {
  int c0, g, b, lo, q_first, n_it;
  KvItem() = default;
  __device__ __forceinline__ KvItem(int w, int n_qt, int B, int KV, int per,
                                    int Nq, const int* kv_start) {
    const int gb = KV * B, rem = w % gb;
    c0 = (w / gb) * kTile;
    g = rem % KV;
    b = rem / KV;
    if constexpr (CAUSAL) {
      lo = kv_start != nullptr ? max(kv_start[b], 0) : 0;
      const int first = max(c0, lo);
      q_first = first / kTile;
      n_it = c0 + kTile > lo && first < Nq ? (n_qt - q_first) * per : 0;
    } else {
      lo = q_first = 0;
      n_it = n_qt * per;
    }
  }
};

template <int DH, bool CAUSAL>
__device__ __forceinline__ void dq_body(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* to,
    const CUtensorMap* tk, const CUtensorMap* tv, const float* lse,
    const int* kv_start, float* stats, bf16* dq, int B, int Nq, int Nk,
    int Hq, int KV, float scale, const bf16* o) {
  using C = Cfg<DH>;
  constexpr int kStages = C::kDqStages, kSlots = C::kDqSlots;
  constexpr int kFixed = C::kDqFixed;
  using L = Smem<DH, kFixed, kSlots, kStages>;
  using Item = DqItem<CAUSAL>;
  extern __shared__ unsigned char smem_raw[];
  const Base sm(smem_raw);
  const Bars<kStages> bars{sm.addr + L::kBars};
  const int n_qt = (Nq + kTile - 1) / kTile, Np = n_qt * kTile;
  const int n_items = n_qt * Hq * B, per = Hq / KV;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) bars.init();
  __syncthreads();

  // Thread 0 also feeds the stages: the fixed tiles of the block's j-th
  // item into slot j % kSlots once the item kSlots before has released it,
  // and the ring's loads in order, each once its stage is free (cursor:
  // item fw, its key tile fi, ring position fpos).
  auto feed_fixed = [&](int j) {
    const int w = blockIdx.x + j * gridDim.x;
    if (w >= n_items) return;
    const Item y(w, n_qt, B, Hq, per, Nq, Nk, kv_start);
    const int f = j % kSlots;
    bar_wait(bars.fixed_empty(f), ((j / kSlots) & 1) ^ 1);
    bar_expect_tx(bars.fixed_full(f), kFixed * L::kTileBytes);
    tma_tile<DH>(L::fixed(sm.addr, f, 0), tq, bars.fixed_full(f), y.h, y.r0,
                 y.b);
    tma_tile<DH>(L::fixed(sm.addr, f, 1), tdo, bars.fixed_full(f), y.h,
                 y.r0, y.b);
    if constexpr (kFixed == 3)
      tma_tile<DH>(L::fixed(sm.addr, f, 2), to, bars.fixed_full(f), y.h,
                   y.r0, y.b);
  };
  int fw = blockIdx.x, fi = 0, fpos = 0;
  Item fx;
  if (fw < n_items) fx = Item(fw, n_qt, B, Hq, per, Nq, Nk, kv_start);
  auto feed_ring = [&](int upto) {
    while (fpos < upto && fw < n_items) {
      if (fi == fx.n_kt) {
        fw += gridDim.x;
        fi = 0;
        if (fw < n_items) fx = Item(fw, n_qt, B, Hq, per, Nq, Nk, kv_start);
        continue;
      }
      const int s = fpos % kStages;
      bar_wait(bars.empty(s), ((fpos / kStages) & 1) ^ 1);
      bar_expect_tx(bars.full(s), 2 * L::kTileBytes);
      const int c0 = (fx.t0 + fi) * kTile;
      tma_tile<DH>(L::ring(sm.addr, s, 0), tk, bars.full(s), fx.g, c0, fx.b);
      tma_tile<DH>(L::ring(sm.addr, s, 1), tv, bars.full(s), fx.g, c0, fx.b);
      ++fi;
      ++fpos;
    }
  };
  if (t == 0) {
    for (int j = 0; j < kSlots; ++j) feed_fixed(j);
    feed_ring(kStages);
  }
  __syncwarp();

  // this thread's rows ra and ra + 8 of each item's tile; four lanes share
  // a row
  const int ra = 16 * warp + (lane >> 2), q4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  int it = 0;  // ring position
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const Item x(w, n_qt, B, Hq, per, Nq, Nk, kv_start);
    const int f = j % kSlots;
    const uint32_t qs = L::fixed(sm.addr, f, 0);
    const uint32_t dos = L::fixed(sm.addr, f, 1);
    int pos[2];
    float lse2[2], dd[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      pos[y] = x.r0 + ra + 8 * y;
      lse2[y] = pos[y] < Nq ? lse[(static_cast<size_t>(x.b) * Hq + x.h) * Nq +
                                  pos[y]] * kLog2e
                            : 0.f;
    }
    // Dh 128: this lane's quarter of each of its rows of O (columns 32 q4
    // .. 32 q4 + 31, 0 past Nq), read from device memory once an item
    constexpr int kOv = kFixed == 3 ? 1 : DH / 32;
    uint4 ov[2][kOv];
    if constexpr (kFixed == 2) {
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const uint4* row = reinterpret_cast<const uint4*>(
            o + ((static_cast<size_t>(x.b) * Nq + pos[y]) * Hq + x.h) * DH);
#pragma unroll
        for (int c = 0; c < kOv; ++c)
          ov[y][c] =
              pos[y] < Nq ? row[kOv * q4 + c] : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    bar_wait(bars.fixed_full(f), (j / kSlots) & 1);
    // D = rowsum(dO o O) from the staged tiles (0 past Nq: TMA's zero
    // fill); lse log2e and D to the stats for the dkdv pass
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      float d = 0.f;
      if constexpr (kFixed == 3) {
        d = row_dot<DH>(sm.at(dos), sm.at(L::fixed(sm.addr, f, 2)),
                        ra + 8 * y, q4);
      } else {  // in row_dot's order
#pragma unroll
        for (int c = 0; c < kOv; ++c) {
          const int off = TileFmt<DH>::chunk(ra + 8 * y, kOv * q4 + c);
          dot8(d, *reinterpret_cast<const uint4*>(sm.at(dos) + off),
               ov[y][c]);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dd[y] = d;
      if (q4 == 0) {
        const size_t at =
            (static_cast<size_t>(x.b) * Hq + x.h) * Np + pos[y];
        stats[at] = lse2[y];
        stats[static_cast<size_t>(B) * Hq * Np + at] = d;
      }
    }
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float sc[32], dp[32];
    uint32_t ah[4][4], al[4][4];
    for (int i = 0; i < x.n_kt; ++i, ++it) {
      const int s = it % kStages;
      const int c0 = (x.t0 + i) * kTile;
      const uint32_t kt = L::ring(sm.addr, s, 0);
      // S = Q K^T, dP = dO V^T
      bar_wait(bars.full(s), (it / kStages) & 1);
      wg_fence();
      mma_abt<DH>(sc, qs, kt);
      wg_commit();
      mma_abt<DH>(dp, dos, L::ring(sm.addr, s, 1));
      wg_commit();
      wg_wait<1>();
      keep(sc);
      // P = exp2(s scale log2e - lse log2e), 0 at keys the row does not
      // see (a tile wholly inside every row's window needs no mask)
      const bool edge = CAUSAL ? c0 < x.lo || c0 + kTile - 1 > x.r0
                               : c0 + kTile > Nk;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = e >> 1, c = c0 + 8 * jj + 2 * q4 + (e & 1);
          const float p = exp2f(fmaf(sc[4 * jj + e], scale_log2, -lse2[y]));
          const bool seen = CAUSAL ? c >= x.lo && c <= pos[y] : c < Nk;
          sc[4 * jj + e] = !edge || seen ? p : 0.f;
        }
      wg_wait<0>();
      keep(dp);
      // dS = P o (dP - D), then dQ += dS K (scaled at the store)
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = sc[e] * (dp[e] - dd[(e >> 1) & 1]);
      to_a(sc, ah, al);
      wg_fence();
      mma_xb<DH>(acc, ah, al, kt);
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(ah);
      keep(al);
      bar_arrive(bars.empty(s));
      if (t == 0) feed_ring(it + 1 + kStages);
      __syncwarp();
    }
    bar_arrive(bars.fixed_empty(f));
    if (t == 0) feed_fixed(j + kSlots);
    __syncwarp();

    bf16* out[2];
#pragma unroll
    for (int y = 0; y < 2; ++y)
      out[y] = pos[y] < Nq ? dq + ((static_cast<size_t>(x.b) * Nq + pos[y]) *
                                       Hq + x.h) * DH
                           : nullptr;
    store_rows<DH>(acc, out[0], out[1], scale, lane);
  }
}

template <int DH, bool CAUSAL>
__device__ __forceinline__ void dkdv_body(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tlse, const CUtensorMap* td,
    const int* kv_start, bf16* dk, bf16* dv, int B, int Nq, int Nk, int Hq,
    int KV, float scale) {
  using C = Cfg<DH>;
  constexpr int kStages = C::kDkdvStages, kSlots = C::kDkdvSlots;
  using L = Smem<DH, 2, kSlots, kStages>;
  using Item = KvItem<CAUSAL>;
  extern __shared__ unsigned char smem_raw[];
  const Base sm(smem_raw);
  const Bars<kStages> bars{sm.addr + L::kBars};
  const int n_qt = (Nq + kTile - 1) / kTile;
  const int n_items = (Nk + kTile - 1) / kTile * KV * B;
  const int per = Hq / KV;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) bars.init();
  __syncthreads();

  // thread 0 feeds the stages, as in the dq kernel (cursor: item fw, its
  // iteration fi, ring position fpos)
  auto feed_fixed = [&](int j) {
    const int w = blockIdx.x + j * gridDim.x;
    if (w >= n_items) return;
    const Item y(w, n_qt, B, KV, per, Nq, kv_start);
    const int f = j % kSlots;
    bar_wait(bars.fixed_empty(f), ((j / kSlots) & 1) ^ 1);
    bar_expect_tx(bars.fixed_full(f), 2 * L::kTileBytes);
    tma_tile<DH>(L::fixed(sm.addr, f, 0), tk, bars.fixed_full(f), y.g, y.c0,
                 y.b);
    tma_tile<DH>(L::fixed(sm.addr, f, 1), tv, bars.fixed_full(f), y.g, y.c0,
                 y.b);
  };
  int fw = blockIdx.x, fi = 0, fpos = 0;
  Item fx;
  if (fw < n_items) fx = Item(fw, n_qt, B, KV, per, Nq, kv_start);
  auto feed_ring = [&](int upto) {
    while (fpos < upto && fw < n_items) {
      if (fi == fx.n_it) {
        fw += gridDim.x;
        fi = 0;
        if (fw < n_items) fx = Item(fw, n_qt, B, KV, per, Nq, kv_start);
        continue;
      }
      const int s = fpos % kStages;
      bar_wait(bars.empty(s), ((fpos / kStages) & 1) ^ 1);
      bar_expect_tx(bars.full(s), 2 * L::kTileBytes + L::kStatBytes);
      const int r0 = (fx.q_first + fi / per) * kTile;
      const int h = fx.g * per + fi % per;
      tma_tile<DH>(L::ring(sm.addr, s, 0), tq, bars.full(s), h, r0, fx.b);
      tma_tile<DH>(L::ring(sm.addr, s, 1), tdo, bars.full(s), h, r0, fx.b);
      tma_3d(L::stat(sm.addr, s), tlse, bars.full(s), r0, h, fx.b);
      tma_3d(L::stat(sm.addr, s) + kTile * 4, td, bars.full(s), r0, h,
             fx.b);
      ++fi;
      ++fpos;
    }
  };
  if (t == 0) {
    for (int j = 0; j < kSlots; ++j) feed_fixed(j);
    feed_ring(kStages);
  }
  __syncwarp();

  const int q4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  int it = 0;  // ring position
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const Item x(w, n_qt, B, KV, per, Nq, kv_start);
    const int f = j % kSlots;
    const uint32_t kt = L::fixed(sm.addr, f, 0);
    const uint32_t vt = L::fixed(sm.addr, f, 1);
    // this thread's keys (accumulator rows ra and ra + 8)
    const int key_a = x.c0 + 16 * warp + (lane >> 2), key_b = key_a + 8;
    float dka[DH / 2], dva[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
    bar_wait(bars.fixed_full(f), (j / kSlots) & 1);

    for (int i = 0; i < x.n_it; ++i, ++it) {
      const int s = it % kStages;
      bar_wait(bars.full(s), (it / kStages) & 1);
      const int r0 = (x.q_first + i / per) * kTile;
      const uint32_t qt = L::ring(sm.addr, s, 0);
      const uint32_t dot = L::ring(sm.addr, s, 1);
      const float* lse2 =
          reinterpret_cast<const float*>(sm.at(L::stat(sm.addr, s)));
      const float* dd = lse2 + kTile;
      // S^T = K Q^T, dP^T = V dO^T
      float sc[32], dp[32];
      wg_fence();
      mma_abt<DH>(sc, kt, qt);
      wg_commit();
      mma_abt<DH>(dp, vt, dot);
      wg_commit();
      wg_wait<1>();
      keep(sc);
      // P^T = exp2(s scale log2e - lse log2e), 0 where the row does not see
      // the key or lies past Nq (a tile pair wholly inside needs no mask)
      const bool edge = CAUSAL ? x.c0 < x.lo || x.c0 + kTile - 1 > r0 ||
                                     r0 + kTile > Nq
                               : r0 + kTile > Nq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * q4 + (e & 1), row = r0 + col;
          const int c = e < 2 ? key_a : key_b;
          const float p =
              exp2f(fmaf(sc[4 * jj + e], scale_log2, -lse2[col]));
          const bool seen =
              CAUSAL ? c >= x.lo && c <= row && row < Nq : row < Nq;
          sc[4 * jj + e] = !edge || seen ? p : 0.f;
        }
      // dS^T = P^T o (dP^T - D), into dp
      wg_wait<0>();
      keep(dp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * jj + e] = sc[4 * jj + e] *
                           (dp[4 * jj + e] - dd[8 * jj + 2 * q4 + (e & 1)]);
      // dV += P^T dO and dK += dS^T Q (scaled at the store), in flight
      // together; P^T and dS^T live on only as the products' A operands
      uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
      to_a(sc, ph, pl);
      to_a(dp, sh, sl);
      wg_fence();
      mma_xb<DH>(dva, ph, pl, dot);
      mma_xb<DH>(dka, sh, sl, qt);
      wg_commit();
      wg_wait<0>();
      keep(dva);
      keep(dka);
      keep(ph);
      keep(pl);
      keep(sh);
      keep(sl);
      bar_arrive(bars.empty(s));
      if (t == 0) feed_ring(it + 1 + kStages);
      __syncwarp();
    }
    bar_arrive(bars.fixed_empty(f));
    if (t == 0) feed_fixed(j + kSlots);
    __syncwarp();

    const size_t kv_row = static_cast<size_t>(KV) * DH;
    const size_t base = (static_cast<size_t>(x.b) * Nk * KV + x.g) * DH;
    store_rows<DH>(dka, key_a < Nk ? dk + base + key_a * kv_row : nullptr,
                   key_b < Nk ? dk + base + key_b * kv_row : nullptr, scale,
                   lane);
    store_rows<DH>(dva, key_a < Nk ? dv + base + key_a * kv_row : nullptr,
                   key_b < Nk ? dv + base + key_b * kv_row : nullptr, 1.f,
                   lane);
  }
}

// Dh 128's dkdv: a block of two warpgroups per item, all 128 columns of
// dK and dV, each (key tile, query tile, head) computing S^T and dP^T once.
// Both warpgroups run the same two products on other operands: warpgroup 0
// S^T = K Q^T, then dV += P^T dO; warpgroup 1 dP^T = V dO^T, then dK +=
// dS^T Q, each accumulator 64 registers a thread. The item's K (warpgroup
// 0) or V (1) moves into registers as the first product's A operands, so
// its slot is free for the next item at once and the first product reads
// only its B tile from shared memory. Warpgroup 0 forms P^T (masked zeros
// included) and hands it to warpgroup 1 in fp32 through one of two
// shared-memory buffers under mbarriers, so it may run up to two
// iterations ahead; warpgroup 1 forms dS^T = P^T o (dP^T - D). Each
// warpgroup issues the next iteration's first product together with this
// one's second and runs the next elementwise step while the second is on
// the tensor cores (its last iteration peeled, so every commit group of
// the loop is unconditional). The first thread of warpgroup 1, the one
// that releases each stage last, feeds the stages.
template <bool CAUSAL>
__device__ __forceinline__ void dkdv128_body(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tlse, const CUtensorMap* td,
    const int* kv_start, bf16* dk, bf16* dv, int B, int Nq, int Nk, int Hq,
    int KV, float scale) {
  constexpr int DH = 128;
  using C = Cfg<DH>;
  constexpr int kStages = C::kDkdvStages, kSlots = C::kDkdvSlots;
  constexpr int kBlock = C::kDkdvWarpgroups * kThreads, kFeeder = kThreads;
  using L = Smem<DH, 2, kSlots, kStages, C::kDkdvHand>;
  using Item = KvItem<CAUSAL>;
  extern __shared__ unsigned char smem_raw[];
  const Base sm(smem_raw);
  const Bars<kStages, kBlock> bars{sm.addr + L::kBars};
  const int n_qt = (Nq + kTile - 1) / kTile;
  const int n_items = (Nk + kTile - 1) / kTile * KV * B;
  const int per = Hq / KV;
  const int t = threadIdx.x, wg = t / kThreads, tw = t % kThreads;
  const int warp = tw >> 5, lane = t & 31;
  if (t == 0) bars.init(true);
  __syncthreads();

  // the feeder fills the stages, as in dkdv_body (cursor: item fw, its
  // iteration fi, ring position fpos)
  auto feed_fixed = [&](int j) {
    const int w = blockIdx.x + j * gridDim.x;
    if (w >= n_items) return;
    const Item y(w, n_qt, B, KV, per, Nq, kv_start);
    const int f = j % kSlots;
    bar_wait(bars.fixed_empty(f), ((j / kSlots) & 1) ^ 1);
    bar_expect_tx(bars.fixed_full(f), 2 * L::kTileBytes);
    tma_tile<DH>(L::fixed(sm.addr, f, 0), tk, bars.fixed_full(f), y.g, y.c0,
                 y.b);
    tma_tile<DH>(L::fixed(sm.addr, f, 1), tv, bars.fixed_full(f), y.g, y.c0,
                 y.b);
  };
  int fw = blockIdx.x, fi = 0, fpos = 0;
  Item fx;
  if (fw < n_items) fx = Item(fw, n_qt, B, KV, per, Nq, kv_start);
  auto feed_ring = [&](int upto) {
    while (fpos < upto && fw < n_items) {
      if (fi == fx.n_it) {
        fw += gridDim.x;
        fi = 0;
        if (fw < n_items) fx = Item(fw, n_qt, B, KV, per, Nq, kv_start);
        continue;
      }
      const int s = fpos % kStages;
      bar_wait(bars.empty(s), ((fpos / kStages) & 1) ^ 1);
      bar_expect_tx(bars.full(s), 2 * L::kTileBytes + L::kStatBytes);
      const int r0 = (fx.q_first + fi / per) * kTile;
      const int h = fx.g * per + fi % per;
      tma_tile<DH>(L::ring(sm.addr, s, 0), tq, bars.full(s), h, r0, fx.b);
      tma_tile<DH>(L::ring(sm.addr, s, 1), tdo, bars.full(s), h, r0, fx.b);
      tma_3d(L::stat(sm.addr, s), tlse, bars.full(s), r0, h, fx.b);
      tma_3d(L::stat(sm.addr, s) + kTile * 4, td, bars.full(s), r0, h,
             fx.b);
      ++fi;
      ++fpos;
    }
  };
  if (t == kFeeder) {
    for (int j = 0; j < kSlots; ++j) feed_fixed(j);
    feed_ring(kStages);
  }
  __syncwarp();

  // this thread's rows ra and ra + 8 of its warpgroup's accumulators (keys)
  const int ra = 16 * warp + (lane >> 2), q4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  int it = 0;  // ring position
  for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
    const Item x(w, n_qt, B, KV, per, Nq, kv_start);
    const int f = j % kSlots;
    const int key_a = x.c0 + ra, key_b = key_a + 8;
    // K (warpgroup 0) or V (1) into registers; the slot goes to the next
    // item at once
    uint32_t fa[DH / 16][4];
    bar_wait(bars.fixed_full(f), (j / kSlots) & 1);
    tile_a<DH>(sm.at(L::fixed(sm.addr, f, wg)), ra, q4, fa);
    bar_arrive(bars.fixed_empty(f));
    if (t == kFeeder) feed_fixed(j + kSlots);
    __syncwarp();
    float acc[DH / 2];  // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float sc[32];
    uint32_t ah[4][4], al[4][4];

    // iteration i's elementwise step on the first product, in sc, at ring
    // position pos: P^T, handed over (warpgroup 0), or dS^T (1)
    auto step = [&](int i, int pos) {
      const int s = pos % kStages, hb = pos & 1;
      const int r0 = (x.q_first + i / per) * kTile;
      const float* lse2 =
          reinterpret_cast<const float*>(sm.at(L::stat(sm.addr, s)));
      const float* dd = lse2 + kTile;
      // P^T in fp32, this thread's 32 values as 8 float4 at stride 128
      float4* hand = reinterpret_cast<float4*>(sm.at(L::hand(sm.addr, hb))) +
                     tw;
      if (wg == 0) {
        // P^T = exp2(s scale log2e - lse log2e), 0 where the row does not
        // see the key or lies past Nq (a tile pair wholly inside needs no
        // mask)
        const bool edge = CAUSAL ? x.c0 < x.lo || x.c0 + kTile - 1 > r0 ||
                                       r0 + kTile > Nq
                                 : r0 + kTile > Nq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + 2 * q4 + (e & 1), row = r0 + col;
            const int c = e < 2 ? key_a : key_b;
            const float p =
                exp2f(fmaf(sc[4 * jj + e], scale_log2, -lse2[col]));
            const bool seen =
                CAUSAL ? c >= x.lo && c <= row && row < Nq : row < Nq;
            sc[4 * jj + e] = !edge || seen ? p : 0.f;
          }
        bar_wait(bars.hand_empty(hb), ((pos >> 1) & 1) ^ 1);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          hand[jj * kThreads] = make_float4(sc[4 * jj], sc[4 * jj + 1],
                                            sc[4 * jj + 2], sc[4 * jj + 3]);
        bar_arrive(bars.hand_full(hb));
      } else {
        // dS^T = P^T o (dP^T - D)
        bar_wait(bars.hand_full(hb), (pos >> 1) & 1);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 p = hand[jj * kThreads];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * jj + e] =
                pv[e] * (sc[4 * jj + e] - dd[8 * jj + 2 * q4 + (e & 1)]);
        }
        bar_arrive(bars.hand_empty(hb));
      }
    };
    // this warpgroup's second product's B tile (dO or Q) at ring position
    // pos, and its release after the product
    auto second = [&](int pos) {
      return L::ring(sm.addr, pos % kStages, 1 - wg);
    };
    auto release = [&](int pos) {
      bar_arrive(bars.empty(pos % kStages));
      if (t == kFeeder) feed_ring(pos + 1 + kStages);
      __syncwarp();
    };

    if (x.n_it > 0) {
      // the first product of iteration 0: S^T = K Q^T or dP^T = V dO^T
      bar_wait(bars.full(it % kStages), (it / kStages) & 1);
      wg_fence();
      mma_at<DH>(sc, fa, L::ring(sm.addr, it % kStages, wg));
      wg_commit();
      wg_wait<0>();
      keep(sc);
      step(0, it);
      to_a(sc, ah, al);
      for (int i = 0; i + 1 < x.n_it; ++i, ++it) {
        // iteration i + 1's first product and i's second (dV += P^T dO or
        // dK += dS^T Q, scaled at the store) in flight together; i + 1's
        // step under the second
        const int nx = it + 1;
        bar_wait(bars.full(nx % kStages), (nx / kStages) & 1);
        wg_fence();
        mma_at<DH>(sc, fa, L::ring(sm.addr, nx % kStages, wg));
        wg_commit();
        mma_xb<DH>(acc, ah, al, second(it));
        wg_commit();
        wg_wait<1>();
        keep(sc);
        step(i + 1, nx);
        wg_wait<0>();
        keep(acc);
        keep(ah);
        keep(al);
        release(it);
        to_a(sc, ah, al);
      }
      wg_fence();
      mma_xb<DH>(acc, ah, al, second(it));
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(ah);
      keep(al);
      release(it);
      ++it;
    }

    const size_t kv_row = static_cast<size_t>(KV) * DH;
    bf16* out = (wg == 0 ? dv : dk) +
                (static_cast<size_t>(x.b) * Nk * KV + x.g) * DH;
    store_rows<DH>(acc, key_a < Nk ? out + key_a * kv_row : nullptr,
                   key_b < Nk ? out + key_b * kv_row : nullptr,
                   wg == 0 ? 1.f : scale, lane);
  }
}

// the kernels: the causal form's and the non-causal form's, each a body
// instantiated for its form under a name of its own
#define DQ_ARGS                                                             \
  const __grid_constant__ CUtensorMap tq,                                   \
      const __grid_constant__ CUtensorMap tdo,                              \
      const __grid_constant__ CUtensorMap to,                               \
      const __grid_constant__ CUtensorMap tk,                               \
      const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse, \
      const int* __restrict__ kv_start, float* __restrict__ stats,          \
      bf16* __restrict__ dq, int B, int Nq, int Nk, int Hq, int KV,         \
      float scale, const bf16* __restrict__ o
#define DKDV_ARGS                                                           \
  const __grid_constant__ CUtensorMap tq,                                   \
      const __grid_constant__ CUtensorMap tdo,                              \
      const __grid_constant__ CUtensorMap tk,                               \
      const __grid_constant__ CUtensorMap tv,                               \
      const __grid_constant__ CUtensorMap tlse,                             \
      const __grid_constant__ CUtensorMap td,                               \
      const int* __restrict__ kv_start, bf16* __restrict__ dk,              \
      bf16* __restrict__ dv, int B, int Nq, int Nk, int Hq, int KV,         \
      float scale

template <int DH>
__global__ void __launch_bounds__(kThreads, Cfg<DH>::kDqMinBlocks)
flash_prefill_bwd_bf16_dq_kernel(DQ_ARGS) {
  dq_body<DH, true>(&tq, &tdo, &to, &tk, &tv, lse, kv_start, stats, dq, B,
                    Nq, Nk, Hq, KV, scale, o);
}
template <int DH>
__global__ void __launch_bounds__(kThreads, Cfg<DH>::kDqMinBlocks)
flash_prefill_bwd_bf16_noncausal_dq_kernel(DQ_ARGS) {
  dq_body<DH, false>(&tq, &tdo, &to, &tk, &tv, lse, kv_start, stats, dq, B,
                     Nq, Nk, Hq, KV, scale, o);
}
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::kDkdvWarpgroups * kThreads,
                                  Cfg<DH>::kDkdvMinBlocks)
flash_prefill_bwd_bf16_dkdv_kernel(DKDV_ARGS) {
  if constexpr (DH == 128)
    dkdv128_body<true>(&tq, &tdo, &tk, &tv, &tlse, &td, kv_start, dk, dv, B,
                       Nq, Nk, Hq, KV, scale);
  else
    dkdv_body<DH, true>(&tq, &tdo, &tk, &tv, &tlse, &td, kv_start, dk, dv, B,
                        Nq, Nk, Hq, KV, scale);
}
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::kDkdvWarpgroups * kThreads,
                                  Cfg<DH>::kDkdvMinBlocks)
flash_prefill_bwd_bf16_noncausal_dkdv_kernel(DKDV_ARGS) {
  if constexpr (DH == 128)
    dkdv128_body<false>(&tq, &tdo, &tk, &tv, &tlse, &td, kv_start, dk, dv,
                        B, Nq, Nk, Hq, KV, scale);
  else
    dkdv_body<DH, false>(&tq, &tdo, &tk, &tv, &tlse, &td, kv_start, dk, dv,
                         B, Nq, Nk, Hq, KV, scale);
}
#undef DQ_ARGS
#undef DKDV_ARGS

// ---------------------------------------------------------------------------
// host side: tensor maps, launch
// ---------------------------------------------------------------------------
// one plane of the [2, B, Hq, Np] fp32 stats, boxes of 64 positions
bool stats_map(CUtensorMap* map, const float* ptr, int B, int Hq, int Np) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Np),
                              static_cast<cuuint64_t>(Hq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Np) * 4,
                                 static_cast<cuuint64_t>(Hq) * Np * 4};
  const cuuint32_t box[3] = {kTile, 1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                     const_cast<float*>(ptr), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per kernel: raise its shared memory limit and find how many of its
// blocks of `threads` an SM holds; returns the persistent grid for n_items
// work items (that many blocks on every SM, at most one per item), 0 on an
// error.
template <typename Kernel>
int grid_for(Kernel kernel, int threads, size_t bytes, int* per_sm,
             int n_items) {
  if (*per_sm == 0) {
    int dev = 0, sms = 0, occ = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      bytes) != cudaSuccess ||
        occ == 0)
      return 0;
    *per_sm = occ * sms;
  }
  return *per_sm < n_items ? *per_sm : n_items;
}

template <int DH, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* kv_start,
           void* stats, void* dq, void* dk, void* dv, int B, int Nq, int Nk,
           int Hq, int KV, float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  static int dq_slots = 0, dkdv_slots = 0;  // resident blocks on the card
  constexpr int kDkdvThreads = C::kDkdvWarpgroups * kThreads;
  constexpr size_t kDqBytes =
      Smem<DH, C::kDqFixed, C::kDqSlots, C::kDqStages>::kBytes;
  constexpr size_t kDkdvBytes =
      Smem<DH, 2, C::kDkdvSlots, C::kDkdvStages, C::kDkdvHand>::kBytes;
  const auto dq_kernel = CAUSAL ? flash_prefill_bwd_bf16_dq_kernel<DH>
                                : flash_prefill_bwd_bf16_noncausal_dq_kernel<DH>;
  const auto dkdv_kernel =
      CAUSAL ? flash_prefill_bwd_bf16_dkdv_kernel<DH>
             : flash_prefill_bwd_bf16_noncausal_dkdv_kernel<DH>;
  const int n_qt = (Nq + kTile - 1) / kTile, Np = n_qt * kTile;
  const int n_kt = (Nk + kTile - 1) / kTile;
  const int dq_grid =
      grid_for(dq_kernel, kThreads, kDqBytes, &dq_slots, n_qt * Hq * B);
  const int dkdv_grid = grid_for(dkdv_kernel, kDkdvThreads, kDkdvBytes,
                                 &dkdv_slots, n_kt * KV * B);
  if (dq_grid == 0 || dkdv_grid == 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (encode_fn() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  float* st = static_cast<float*>(stats);
  CUtensorMap tq, tdo, to, tk, tv, tlse, td;
  if (!rows_map<DH>(&tq, q, B, Nq, Hq) ||
      !rows_map<DH>(&tdo, dout, B, Nq, Hq) ||
      !rows_map<DH>(&to, o, B, Nq, Hq) || !rows_map<DH>(&tk, k, B, Nk, KV) ||
      !rows_map<DH>(&tv, v, B, Nk, KV) || !stats_map(&tlse, st, B, Hq, Np) ||
      !stats_map(&td, st + static_cast<size_t>(B) * Hq * Np, B, Hq, Np))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* start = static_cast<const int*>(kv_start);

  dq_kernel<<<dq_grid, kThreads, kDqBytes, stream>>>(
      tq, tdo, to, tk, tv, static_cast<const float*>(lse), start, st,
      static_cast<bf16*>(dq), B, Nq, Nk, Hq, KV, scale,
      static_cast<const bf16*>(o));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dkdv_grid, kDkdvThreads, kDkdvBytes, stream>>>(
      tq, tdo, tk, tv, tlse, td, start, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, Nq, Nk, Hq, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAUSAL>
int launch_dh(int Dh, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const void* lse,
              const void* kv_start, void* dsum, void* dq, void* dk, void* dv,
              int B, int Nq, int Nk, int Hq, int KV, float scale,
              cudaStream_t st) {
  if (Dh == 16)
    return launch<16, CAUSAL>(q, k, v, o, dout, lse, kv_start, dsum, dq, dk,
                              dv, B, Nq, Nk, Hq, KV, scale, st);
  if (Dh == 64)
    return launch<64, CAUSAL>(q, k, v, o, dout, lse, kv_start, dsum, dq, dk,
                              dv, B, Nq, Nk, Hq, KV, scale, st);
  if (Dh == 128)
    return launch<128, CAUSAL>(q, k, v, o, dout, lse, kv_start, dsum, dq, dk,
                               dv, B, Nq, Nk, Hq, KV, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq [B, Nq, Hq, Dh] and k, v, dk, dv [B, Nk, KV, Dh], bf16
// contiguous and 16-byte aligned, KV dividing Hq, Dh in {16, 64, 128}; lse
// [B, Hq, Nq] fp32 as flash_prefill_bf16 writes it (in the same form);
// dsum [2, B, Hq, Np] fp32 scratch, Np = Nq rounded up to 64 (the dq kernel
// writes each row's lse log2e and D there for the dkdv kernel). With causal
// != 0 (Nq == Nk): kv_start [B] int32 or null (0), query row i of batch row
// b sees keys [kv_start[b], i + 1). With causal == 0: every row sees all Nk
// keys, kv_start must be null. Two launches on `stream`: dQ (with D), then
// dK and dV.
extern "C" int flash_prefill_bwd_bf16(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      const void* kv_start, void* dsum,
                                      void* dq, void* dk, void* dv, int B,
                                      int Nq, int Nk, int Hq, int KV, int Dh,
                                      int causal, float scale, void* stream) {
  if (B <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || Hq % KV != 0 || (causal != 0 && Nq != Nk) ||
      (causal == 0 && kv_start != nullptr) ||
      static_cast<long long>((Nq + kTile - 1) / kTile) * Hq * B > INT32_MAX ||
      static_cast<long long>((Nk + kTile - 1) / kTile) * KV * B > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return causal != 0
             ? launch_dh<true>(Dh, q, k, v, o, dout, lse, kv_start, dsum, dq,
                               dk, dv, B, Nq, Nk, Hq, KV, scale, st)
             : launch_dh<false>(Dh, q, k, v, o, dout, lse, kv_start, dsum,
                                dq, dk, dv, B, Nq, Nk, Hq, KV, scale, st);
}
