// The chunked form of the scans' backward kernels (mamba_scan_bwd.cu,
// wkv6_bwd.cu), the part both share: phases 1 and 2, the walk over chunk
// boundaries.
//
// A scan's state X (rows d, columns c; Mamba2's h [dh, N], the WKV's S
// [dh, dh]) and its adjoint follow, one chunk of kC steps at a time,
//   X <- all (*) X + (f (*) P)^T Q,
// all[d] the product of the chunk's decays (per row d for the WKV; one
// for all rows for Mamba2), P a [steps, rows] operand scaled by per-step
// factors f (and, for Mamba2's state, by dt), Q a [steps, columns] operand:
//   Mamba2 state   P = dt x,  Q = B,  f_s = prod_{s<u<=end} decay_u
//   Mamba2 adjoint P = dy,    Q = C,  f_t = prod_{start<=u<=t} decay_u
//   WKV state      P = k,     Q = v,  f_s = prod_{s<u<=end} w_u
//   WKV adjoint    P = r,     Q = dy, f_t = prod_{start<=u<t} w_u
// The state walks forward from h0 / s0 and the adjoint backward from the
// final state's gradient; each writes its value at every chunk boundary (the
// state at a chunk's start, the adjoint at its end) to scratch, where
// phase 3 reads it, and the adjoint's last value is d h0 / d s0. One block
// of kBThreads (16 warps) a (side, head, batch row), two blocks an SM: the
// WKV's 2 x 8 x 32 blocks at the training step fill the card in under two
// rounds (blocks of half the columns would take three). Each chunk: its
// rows arrive by cp.async while the previous chunk's product runs; the
// factors are running products of decays <= 1 (thread (sub-chunk m, row d)
// over its kSub steps, then across the sub-chunks' products), never a
// division or a log; the product is 3xTF32 mma.sync (scan_mma.cuh), each
// warp a 16 x 16 tile of the 64 x 64 bound, in registers from the first
// chunk to the last.
#pragma once

#include <cuda_bf16.h>

#include "cp_async.cuh"
#include "scan_mma.cuh"

namespace scan_bwd_chunk {

constexpr int kC = 64;        // steps a chunk
constexpr int kSub = 16;      // steps a sub-chunk
constexpr int kNSub = kC / kSub;
constexpr int kW = 64;        // widths, padded
constexpr int kState = kW * kW;
constexpr int kBThreads = 512;

// Rows of one (batch row, head) item of a [B, S, ...] tensor: element (b,
// h, t, c) at ptr + b * batch + h * head + t * row + c
struct Operand {
  const void* ptr;
  long long batch, head, row;
  int width;
};

struct Side {
  Operand p, q, dec, scale;  // scale: Mamba2's state only
  const float* init;         // [B, H, rows, columns]
  float* bounds;             // [B * H, chunks, kW, kW]
  float* last;               // [B, H, rows, columns] or null
};

struct BoundsArgs {
  Side side[2];  // the state, the adjoint
  int S, H, rows, cols;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ const E* at(const Operand& o, int b, int h,
                                       int t) {
  return static_cast<const E*>(o.ptr) + b * o.batch + h * o.head +
         t * o.row;
}

// acc (a warp's 16 x 16 tile at rows r0, columns c0) += the sum over the
// k-steps [ks0, ks1) of A B in 3xTF32, A and B read through the callables
// as scan_mma's loaders take them; tile_mma2 also adds A B2 into acc2 on
// the same A fragments
template <class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4], const FA& fa,
                                         const FB& fb, int r0, int c0,
                                         int ks0, int ks1) {
  using namespace scan_mma;
  for (int ks = ks0; ks < ks1; ++ks) {
    const Split<4> a = frag_a(fa, r0, 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma3(acc[nt], a, frag_b(fb, 8 * ks, c0 + 8 * nt));
  }
}

template <class FA, class FB, class FB2>
__device__ __forceinline__ void tile_mma2(float (&acc)[2][4],
                                          float (&acc2)[2][4], const FA& fa,
                                          const FB& fb, const FB2& fb2,
                                          int r0, int c0, int ks0, int ks1) {
  using namespace scan_mma;
  for (int ks = ks0; ks < ks1; ++ks) {
    const Split<4> a = frag_a(fa, r0, 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma3(acc[nt], a, frag_b(fb, 8 * ks, c0 + 8 * nt));
      mma3(acc2[nt], a, frag_b(fb2, 8 * ks, c0 + 8 * nt));
    }
  }
}

struct BoundsSmem {
  // the next chunk as it lies in memory, in flight while this one runs
  float p_in[kC * kW];  // rows of P (fp32 or bf16)
  float q_in[kC * kW];  // rows of Q
  float dec_in[kC * kW];
  float scale_in[kC];
  float p[kC][kW + 8];  // f (*) P [s][d], read down its columns
  float q[kC][kW + 8];  // Q [s][c]
  float tot[kNSub][kW];  // each sub-chunk's product, per row
};

// One side of the walk: P's and Q's element types, decays per row (the
// WKV) or one a step (Mamba2), P scaled by `scale` (Mamba2's dt), the
// adjoint (chunks last to first, prefix factors; else the state, suffix
// factors), f_t taking decay_t itself
template <typename TP, typename TQ, bool kRowDecay, bool kScale,
          bool kReverse, bool kInclusive>
struct Walk {
  // start copying chunk t0 of side `sd` for (b, h), and commit (an empty
  // group past the sequence's end)
  static __device__ __forceinline__ void fetch(BoundsSmem& sm, const Side& sd,
                                               int b, int h, int t0, int S) {
    if (t0 >= 0 && t0 < S) {
      using scan_mma::copy_rows;
      const int steps = min(kC, S - t0);
      const int pb = sd.p.width * (int)sizeof(TP);
      copy_rows(sm.p_in, pb, at<TP>(sd.p, b, h, t0), sd.p.row * sizeof(TP),
                steps, pb);
      const int qb = sd.q.width * (int)sizeof(TQ);
      copy_rows(sm.q_in, qb, at<TQ>(sd.q, b, h, t0), sd.q.row * sizeof(TQ),
                steps, qb);
      copy_rows(sm.dec_in, sd.dec.width * 4, at<float>(sd.dec, b, h, t0),
                sd.dec.row * 4, steps, sd.dec.width * 4);
      if (kScale)
        copy_rows(sm.scale_in, 4, at<float>(sd.scale, b, h, t0),
                  sd.scale.row * 4, steps, 4);
    }
    cp_async_commit();
  }

  // phases 1 and 2: the kernel body (each .cu file names its own kernel)
  static __device__ __forceinline__ void run(const BoundsArgs& a,
                                             const Side& sd) {
    using namespace scan_mma;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    BoundsSmem& sm = *reinterpret_cast<BoundsSmem*>(smem_raw);
    const int h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32;
    const int S = a.S, nC = (S + kC - 1) / kC;
    const size_t item = (size_t)b * a.H + h;
    const int r0 = 16 * (warp % 4), c0 = 16 * (warp / 4);
    const TP* p_in = reinterpret_cast<const TP*>(sm.p_in);
    const TQ* q_in = reinterpret_cast<const TQ*>(sm.q_in);

    float acc[2][4];
    const float* init = sd.init + item * a.rows * a.cols;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = acc_row(r0, e), c = acc_col(c0 + 8 * nt, e);
        acc[nt][e] = (d < a.rows && c < a.cols) ? init[d * a.cols + c] : 0.f;
      }
    fetch(sm, sd, b, h, (kReverse ? nC - 1 : 0) * kC, S);

    for (int it = 0; it < nC; ++it) {
      const int c = kReverse ? nC - 1 - it : it;
      const int t0 = c * kC, steps = min(kC, S - t0);
      // the bound before this chunk: the state at its start, the adjoint at
      // its end
      float* out = sd.bounds + (item * nC + c) * kState;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int d = acc_row(r0, e), cc = acc_col(c0 + 8 * nt, e);
          *reinterpret_cast<float2*>(out + d * kW + cc) =
              make_float2(acc[nt][e], acc[nt][e + 1]);
        }
      cp_async_wait<0>();
      __syncthreads();

      // 1. Q into its tile; thread (sub-chunk m, row d) of the first
      // kNSub x kW: P's rows of sub-chunk m, each scaled by its factor
      // within the sub-chunk, a running product of decays (steps past the
      // end: decay 1, P 0; rows past the width: decay 1, P 0)
      for (int i = tid; i < kC * kW; i += kBThreads) {
        const int s = i / kW, j = i % kW;
        sm.q[s][j] = (s < steps && j < a.cols) ? to_f32(q_in[s * a.cols + j])
                                               : 0.f;
      }
      if (tid < kNSub * kW) {
        const int m = tid / kW, d = tid % kW, base = kSub * m;
        const bool row_ok = d < a.rows;
        float run = 1.f;
#pragma unroll
        for (int l = 0; l < kSub; ++l) {
          const int s = kReverse ? base + l : base + kSub - 1 - l;
          const bool live = s < steps && (row_ok || !kRowDecay);
          const float dec =
              live ? sm.dec_in[kRowDecay ? s * a.rows + d : s] : 1.f;
          float pv = (live && row_ok) ? to_f32(p_in[s * a.rows + d]) : 0.f;
          if (kScale) pv = __fmul_rn(live ? sm.scale_in[s] : 0.f, pv);
          if (kInclusive) run *= dec;
          sm.p[s][d] = pv * run;
          if (!kInclusive) run *= dec;
        }
        sm.tot[m][d] = run;
      }
      __syncthreads();
      // the staging rows are read: the next chunk flies from here on
      fetch(sm, sd, b, h, (kReverse ? c - 1 : c + 1) * kC, S);

      // 2. the factors across sub-chunks: those before m (the adjoint) or
      // after it (the state)
      if (tid < kNSub * kW) {
        const int m = tid / kW, d = tid % kW, base = kSub * m;
        float cross = 1.f;
#pragma unroll
        for (int m2 = 0; m2 < kNSub; ++m2)
          if (kReverse ? m2 < m : m2 > m) cross *= sm.tot[m2][d];
#pragma unroll
        for (int l = 0; l < kSub; ++l) sm.p[base + l][d] *= cross;
      }
      __syncthreads();

      // 3. X <- all (*) X + (f P)^T Q on the tensor cores
      {
        float all[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int d = r0 + ((tid & 31) >> 2) + 8 * hi;
          float r = 1.f;
#pragma unroll
          for (int m = 0; m < kNSub; ++m) r *= sm.tot[m][d];
          all[hi] = r;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= all[e >> 1];
        tile_mma(acc, [&](int r, int cc) { return sm.p[cc][r]; },
                 [&](int k2, int cc) { return sm.q[k2][cc]; }, r0, c0, 0,
                 (steps + 7) / 8);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    if (sd.last == nullptr) return;
    float* last = sd.last + item * a.rows * a.cols;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = acc_row(r0, e), cc = acc_col(c0 + 8 * nt, e);
        if (d < a.rows && cc < a.cols) last[d * a.cols + cc] = acc[nt][e];
      }
  }
};

// the kernel's body: blockIdx.x the side
template <class State, class Adjoint>
__device__ __forceinline__ void bounds_body(const BoundsArgs& a) {
  if (blockIdx.x == 0)
    State::run(a, a.side[0]);
  else
    Adjoint::run(a, a.side[1]);
}

__host__ __device__ inline int chunks(int S) { return (S + kC - 1) / kC; }

}  // namespace scan_bwd_chunk
