// Rel-bias attention of LayoutLMv3 for Hopper, training: forward with
// in-kernel attention dropout, and its backward with the bias gradient.
//
// Replaces the Pallas TPU kernels `_fwd_train_kernel` (forward) and
// `_bwd_train_kernel` (backward) of peneo_tpu/ops/bias_attention.py
// (`bias_attention_train`, custom VJP). Per (batch b, head h):
//
//   s   = q·kᵀ·scale + rel_bias[b, h] + key_mask[b]      fp32
//   p   = softmax(s)
//   p1  = keep ? p/(1−r) : 0                              one mask
//   ctx = p1·v  (d = 64)
//
// backward, with dc = ∂/∂ctx:
//
//   dP    = keep·(dc·vᵀ)/(1−r)
//   D     = rowsum(dP ⊙ p)                                fp32
//   dS    = p ⊙ (dP − D)
//   dbias = dS                                            fp32 (B, nh, L, L)
//   dq    = dS·k·scale,  dk = dSᵀ·q·scale,  dv = p1ᵀ·dc
//
// The bias is trained (it is gathered from the model's relative-position
// bucket tables), so unlike the BiACM pair the backward writes dS out; the
// key mask gets no gradient.
//
// D is summed as the TPU kernel sums it, from the recomputed p and dP in
// fp32, not by FlashAttention-2's shortcut rowsum(dc ⊙ ctx): ctx is the
// forward's bf16 output, and with nearly collinear keys dq = Σ_j dS_ij·k_j
// is a small difference of large terms (see biacm_attention_train.cu). For
// the same reason dS enters the dq and dk products as two bf16 parts (hi +
// lo, biacm::pack_a_split) where the TPU kernel rounds it to bf16 once.
//
// Dropout mask. keep = bits < thr, thr = min(round((1−r)·2³²), 2³²−1), as
// on the TPU. A small kernel of its own, launched with the forward, draws
// it: four keys per Philox4x32-10 draw, the bits of (i, j) word j & 3 of
// the draw at the counter (j >> 2, i, h, b) under the key (seed_lo,
// seed_hi) (or it compares an explicit uint32 (B, nh, L, L) tensor). That
// is a pure function of (seed, b, h, i, j), so a checkpoint recompute
// rewrites the same mask; ops/biacm_attention.py:element_dropout_bits
// computes the same bits with torch integer ops. It writes the keep flags
// bit-packed, int32 (B, nh, L, ceil(L / 32)) (6.26 MB per layer at B=8,
// nh=12, L=709), which the forward and both backward kernels read tile by
// tile; none of them draws. (The first version drew word 0 of one draw per
// element inside the forward and again in both sweeps of dq and in dk/dv:
// ~0.3 ms per pass at the training shape, about 40 % of the pair's time.)
//
// What bounds it on the H100: bytes. At the training shape (B=8, nh=12,
// L=709) the forward reads 193 MB of bias against 35 MB of q/k/v/out and
// 6 MB of keep flags (~0.070 ms at 3.35 TB/s; its 12 GFLOP are ~0.012 ms).
// The backward must read the bias once and write dbias once (193 MB each)
// beside ~61 MB of q/k/v/dc/dq/dk/dv and the flags: ~0.136 ms, against
// 31 GFLOP of products (~0.031 ms; ~68 GFLOP with the recomputes and the
// hi + lo parts). This design reads the bias three times (both sweeps of
// the dq kernel, and the dk/dv kernel) and writes dbias once: reading it
// twice would need D without dq's first sweep, i.e. from the bf16 ctx
// (which gives up the exact cancellation Σ_j dS_ij = 0 the collinear case
// depends on) or dq accumulated across key-tile CTAs with atomics (which
// gives up determinism); the third read is ~0.06 ms of bytes. The (L, L)
// scores, probabilities and masks never reach device memory (the plain
// version writes several fp32 (B, nh, L, L) tensors), dk/dv accumulate in
// registers, every product runs on the tensor cores (mma.sync m16n8k16
// bf16 → fp32).
//
// Design (FlashAttention-2 layout; the TPU kernels hold a (b, h)'s full K/V
// rows and a (TQ, L) fp32 tile in VMEM, recompute whole rows instead of
// saving statistics, and build dk/dv across a sequential grid axis, none of
// which fits Hopper's unordered CTAs), every tile on the 2-stage cp.async
// ring of bias_common.cuh, fragments by ldmatrix:
// - forward: kernel #4's body (relbias::forward_tile of bias_common.cuh)
//   instantiated with the row statistics (max m, log of the sum l), fp32
//   (B, nh, L, 2), and with the mask on the un-normalised p unless the rate
//   is 0. The backward recomputes p = exp((s − m) − log l).
// - dq: one CTA per (64-query tile, h, b). The ring runs over the key
//   tiles twice without a break (K, V, the bias tile, the key mask and the
//   keep words): a first sweep recomputes p and dP and sums D; a second
//   forms dS, puts it in place of the staged bias tile, writes that tile to
//   dbias in 16-byte stores (the wrapper allocates dbias with rows of L
//   rounded up to a multiple of 4 floats), and accumulates dq, taking K
//   transposed from its row tile by ldmatrix .trans. Each dbias element is
//   written exactly once, by this kernel. It also writes D for the dk/dv
//   kernel.
// - dk/dv: one CTA per (64-key tile, h, b), each warp owning 16 keys; the
//   ring runs over the query tiles (Q and dO as rows, fetched once, the
//   bias tile at a key-major read stride, the rows' statistics, D and the
//   keep words); it recomputes pᵀ and accumulates dv and dk in fp32
//   registers (Q and dO transposed by ldmatrix .trans); written once, in
//   bf16. No atomics: both kernels are deterministic run to run.
// - The 16-row inner loops of dq and dk/dv are rolled (unrolled, the code
//   outgrows the instruction cache and ptxas hoists loads until it spills;
//   biacm_attention_train.cu measured it).
// - Any L ≥ 1: rows and keys past L are zero-filled and predicated (keys
//   get −inf, query rows past L get m = +inf, so their p is 0).
//
// Build: nvcc -O3 -std=c++17 -gencode=arch=compute_90a,code=sm_90a -shared
//        -Xcompiler -fPIC (peneo_tpu_torch/ops/cuda_build.py). Plain C ABI,
//        loaded with ctypes (peneo_tpu_torch/ops/bias_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bias_common.cuh"

namespace {

using biacm::kNoDropout;
using biacm::pack_a_split;
using relbias::cp_async;
using relbias::cp_async_commit;
using relbias::cp_async_wait;
using relbias::kD;
using relbias::keep_pair_mask;
using relbias::kKeepWords;
using relbias::kOffA;
using relbias::kOffB;
using relbias::kOffBias;
using relbias::kOffF;
using relbias::kOffKeep;
using relbias::kSmemBytes;
using relbias::kStageBytes;
using relbias::kStrB;
using relbias::kStrBT;
using relbias::kStrT;
using relbias::kThreads;
using relbias::kTile;
using relbias::ldsm_x4;
using relbias::ldsm_x4_t;
using relbias::load_bias_async;
using relbias::load_keep_async;
using relbias::load_rows_async;
using relbias::mma_16816;
using relbias::pack_a;
using relbias::rows;
using relbias::score;
using relbias::static_for;

// dk/dv's stage: Q, dO tiles, the bias tile (key-major read stride), the
// rows' (m, log l) pairs, D, the keep words
constexpr int kKvOffStats = kOffBias + kTile * kStrBT * 4;
constexpr int kKvOffDelta = kKvOffStats + kTile * 8;
constexpr int kKvOffKeep = kKvOffDelta + kTile * 4;
constexpr int kKvStageBytes = kKvOffKeep + kKeepWords * 4;
constexpr int kKvSmemBytes = 2 * kKvStageBytes;
// resident CTAs per SM the kernels are compiled for (the ring's shared
// memory allows 3 for each; register caps of 168: ptxas takes 168 / 138
// for the forward with / without dropout, 161 for dq, 162 for dk/dv)
constexpr int kFwdBlocks = 3, kDqBlocks = 3, kKvBlocks = 3;

// The backward's parameters: the forward's (inputs, bias, mask, row
// statistics, keep flags, dropout) plus the output gradient, D and the
// gradients.
struct BwdParams : relbias::FwdParams {
  const __nv_bfloat16* dout;             // dc
  int64_t dstride[3];
  __nv_bfloat16* grad[3];                // dq, dk, dv (B, L, nh, 64)
  float* dbias;                          // (B, nh, L, L), 16-byte rows
  int64_t dbias_stride[3];               // (batch, head, row) in elements
  float* delta;                          // (B, nh, L): D, from the dq kernel
};

__device__ __forceinline__ const __nv_bfloat16* drows(const BwdParams& p,
                                                      int b, int h) {
  return p.dout + b * p.dstride[0] + h * p.dstride[1];
}

__device__ __forceinline__ void store_grad(__nv_bfloat16* o,
                                           const BwdParams& p, int b, int h,
                                           int row0, int g, int t,
                                           const float (*acc)[4], float sc) {
  biacm::store_rows<kD>(o, p.nh, p.L, b, h, row0, g, t, acc, sc, sc);
}

// ------------------------------------------------------------- keep flags
// The dropout mask of one training forward, bit-packed: one thread per
// (query i, 32-key word) of a head makes the word's 8 draws (or compares
// the explicit bits) and writes the word. Grid (ceil(L·words / kThreads),
// nh, B).
__global__ void __launch_bounds__(kThreads)
bias_keep_mask_kernel(const relbias::FwdParams p) {
  const int L = p.L, words = (L + 31) / 32;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= L * words) return;
  const int i = e / words, w = e % words, h = blockIdx.y, b = blockIdx.z;
  const uint32_t thr = p.drop.thr;
  uint32_t k = 0u;
#pragma unroll 2
  for (int m = 0; m < 8; ++m) {
    const int j = w * 32 + 4 * m;  // keys j .. j + 3: one draw
    if (j >= L) break;
    uint4 r;
    if (p.drop.mode == biacm::kPhilox) {
      r = biacm::philox4x32_10(make_uint4(j >> 2, i, h, b), p.drop.seed_lo,
                               p.drop.seed_hi);
    } else {
      const uint32_t* row = p.drop.bits[0]
          + ((static_cast<int64_t>(b) * p.nh + h) * L + i) * L;
      r = make_uint4(row[j], j + 1 < L ? row[j + 1] : ~0u,
                     j + 2 < L ? row[j + 2] : ~0u,
                     j + 3 < L ? row[j + 3] : ~0u);
    }
    uint32_t f = uint32_t(r.x < thr) | uint32_t(r.y < thr) << 1
                 | uint32_t(r.z < thr) << 2 | uint32_t(r.w < thr) << 3;
    if (L - j < 4) f &= (1u << (L - j)) - 1u;  // keys past L keep nothing
    k |= f << (4 * m);
  }
  p.keep[(static_cast<int64_t>(b) * p.nh + h) * (static_cast<int64_t>(L)
                                                 * words) + e] = k;
}

// ---------------------------------------------------------------- forward
// kernel #5: the shared forward body (bias_common.cuh) with the row
// statistics, and with the dropout mask (read from the packed keep flags
// the mask kernel wrote just before) unless the rate is 0
template <bool kDropout>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
bias_train_fwd_kernel(const relbias::FwdParams p) {
  relbias::forward_tile<kDropout, true>(p);
}

// ------------------------------------------------------------- dk / dv
__global__ void __launch_bounds__(kThreads, kKvBlocks)
bias_train_dkdv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, +8
  const bool dropout = p.drop.mode != kNoDropout;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.nh + h) * L;
  const float* bias = relbias::bias_head(p, b, h);
  const int rs = static_cast<int>(p.bias_stride[2]);
  const uint32_t* keep = dropout ? relbias::keep_head(p, b, h) : nullptr;
  const int words = (L + 31) / 32;

  const uint32_t sbase = relbias::smem_u32(smem);
  // Q, dO (as rows), the bias tile, the rows' statistics, D and the keep
  // words of the query tile at q0 → stage `stage`; one group
  auto fetch_queries = [&](int q0, int stage) {
    const uint32_t s = sbase + stage * kKvStageBytes;
    load_rows_async<kD, kStrT>(s + kOffA, rows(p, 0, b, h, 0),
                               p.stride[0][2], q0, L);
    load_rows_async<kD, kStrT>(s + kOffB, drows(p, b, h), p.dstride[2], q0,
                               L);
    load_bias_async<kStrBT>(s + kOffBias, bias, rs, q0, k0, L, p.bias_vec);
    const int i = threadIdx.x;
    if (i < kTile) {
      const bool ok = q0 + i < L;
      if (ok)
        cp_async<8>(s + kKvOffStats + i * 8, p.stats + stat0 + q0 + i, true);
      else  // p = 0 for rows past L
        reinterpret_cast<float2*>(smem + stage * kKvStageBytes
                                  + kKvOffStats)[i] =
            make_float2(INFINITY, 0.f);
      cp_async<4>(s + kKvOffDelta + i * 4,
                  p.delta + stat0 + (ok ? q0 + i : 0), ok);
    }
    if (dropout) load_keep_async(s + kKvOffKeep, keep, words, q0, k0, L);
    cp_async_commit();
  };

  // K and V of this key tile → A fragments in registers, staged through
  // stage 1 (a group of its own) while query tile 0 travels to stage 0
  load_rows_async<kD, kStrT>(sbase + kKvStageBytes + kOffA,
                             rows(p, 1, b, h, 0), p.stride[1][2], k0, L);
  load_rows_async<kD, kStrT>(sbase + kKvStageBytes + kOffB,
                             rows(p, 2, b, h, 0), p.stride[2][2], k0, L);
  cp_async_commit();
  fetch_queries(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const uint32_t off_a = relbias::frag_off<kStrT>(lane);
  const uint32_t off_b = relbias::bfrag_off<kStrT>(lane);
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  {
    const uint32_t row = sbase + kKvStageBytes + warp * 16 * kStrT * 2
                         + off_a;
    static_for<kD / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      ldsm_x4<kOffA + kk * 32>(ka[kk], row);
      ldsm_x4<kOffB + kk * 32>(va[kk], row);
    });
  }
  const float* mask_row = p.mask + b * p.mask_stride;
  const bool key_ok[2] = {key_a < L, key_a + 8 < L};
  const float key_mask[2] = {key_ok[0] ? mask_row[key_a] : 0.f,
                             key_ok[1] ? mask_row[key_a + 8] : 0.f};
  // this thread's keys within their 32-key word of the keep flags
  const int key_bit = (warp & 1) * 16 + g;

  float dv[kD / 8][4], dk[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) dv[n][q] = dk[n][q] = 0.f;

  const int tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    // tile `it` has landed, and every warp is done with the other stage
    // (tile it − 1; before tile 0, the K/V fragments): refill that stage
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) fetch_queries((it + 1) * kTile, (it + 1) & 1);
    const unsigned char* sp = smem + (it & 1) * kKvStageBytes;
    const uint32_t st = sbase + (it & 1) * kKvStageBytes;
    const uint32_t st_a = st + off_a, st_b = st + off_b;
    const float* s_st = reinterpret_cast<const float*>(sp + kKvOffStats);
    const float* s_delta = reinterpret_cast<const float*>(sp + kKvOffDelta);
    const uint32_t* s_keep = reinterpret_cast<const uint32_t*>(
        sp + kKvOffKeep) + (warp >> 1) * kTile;  // this warp's word
    // this thread's key column of the (query, key) bias tile
    const float* s_bias = reinterpret_cast<const float*>(sp + kOffBias)
                          + warp * 16 + g;

    // 16 queries per step, a real loop (the offsets of a step are added to
    // the lane's addresses at run time)
#pragma unroll 1
    for (int nn = 0; nn < kTile / 16; ++nn) {
      const uint32_t q_off = nn * 16 * kStrT * 2;
      float ds[2][4], pe[2][4];  // dS, and p/(1−r) before the mask
      uint32_t m1[4];            // the bf16x2 keep masks
      static_for<2>([&](auto half_) {
        constexpr int half = decltype(half_)::value;
        const int qc = nn * 16 + half * 8;  // this n-tile's first query
        float sc[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
        static_for<kD / 32>([&](auto k2_) {  // two k16 steps per load
          constexpr int k2 = decltype(k2_)::value;
          constexpr int off = half * 8 * kStrT * 2 + k2 * 64;
          uint32_t f[4];
          ldsm_x4<kOffA + off>(f, st_b + q_off);
          mma_16816(sc, ka[2 * k2], f[0], f[1]);
          mma_16816(sc, ka[2 * k2 + 1], f[2], f[3]);
          ldsm_x4<kOffB + off>(f, st_b + q_off);
          mma_16816(g1, va[2 * k2], f[0], f[1]);
          mma_16816(g1, va[2 * k2 + 1], f[2], f[3]);
        });
        // queries qc + 2t, qc + 2t + 1: (m, log l) pairs, D, keep words
        const float4 ml =
            *reinterpret_cast<const float4*>(s_st + (qc + t * 2) * 2);
        const float2 dd =
            *reinterpret_cast<const float2*>(s_delta + qc + t * 2);
        uint2 w1 = make_uint2(~0u, ~0u);
        if (dropout)
          w1 = *reinterpret_cast<const uint2*>(s_keep + qc + t * 2);
        const float* bq = s_bias + (qc + t * 2) * kStrBT;
#pragma unroll
        for (int kr = 0; kr < 2; ++kr) {  // key row g or g+8
          // bit 0 / 1: the key's flag for query qc + 2t / qc + 2t + 1
          const int sh = key_bit + kr * 8;
          const uint32_t b1 = ((w1.x >> sh) & 1u) | ((w1.y >> sh) & 1u) << 1;
          m1[2 * half + kr] = keep_pair_mask(b1);
#pragma unroll
          for (int odd = 0; odd < 2; ++odd) {  // query qc + 2t + odd
            const int q = 2 * kr + odd;
            const float sv = score(sc[q], p.scale,
                                   bq[odd * kStrBT + kr * 8], key_mask[kr],
                                   key_ok[kr]);
            const float pv = __expf((sv - (odd ? ml.z : ml.x))
                                    - (odd ? ml.w : ml.y));
            const float dp = (b1 >> odd) & 1u ? g1[q] * p.drop.inv_keep
                                              : 0.f;
            pe[half][q] = pv * p.drop.inv_keep;
            ds[half][q] = pv * (dp - (odd ? dd.y : dd.x));
          }
        }
      });
      // pᵀ: p/(1−r) rounded to bf16, dropped elements zeroed (equal to
      // rounding keep ? p/(1−r) : 0)
      uint32_t pa[4], dsa[4], dsb[4];
      pack_a(pa, pe);
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] &= m1[i];
      pack_a_split(dsa, dsb, ds);
      // the (queries, d) tiles read transposed: B fragments of d columns
      // np*16 .. +15 over these 16 queries
      static_for<kD / 16>([&](auto np_) {
        constexpr int np = decltype(np_)::value;
        uint32_t f[4];
        ldsm_x4_t<kOffB + np * 32>(f, st_a + q_off);  // dO
        mma_16816(dv[2 * np], pa, f[0], f[1]);
        mma_16816(dv[2 * np + 1], pa, f[2], f[3]);
        ldsm_x4_t<kOffA + np * 32>(f, st_a + q_off);  // Q
        mma_16816(dk[2 * np], dsa, f[0], f[1]);
        mma_16816(dk[2 * np], dsb, f[0], f[1]);
        mma_16816(dk[2 * np + 1], dsa, f[2], f[3]);
        mma_16816(dk[2 * np + 1], dsb, f[2], f[3]);
      });
    }
  }

  const int r0 = k0 + warp * 16;
  store_grad(p.grad[1], p, b, h, r0, g, t, dk, p.scale);
  store_grad(p.grad[2], p, b, h, r0, g, t, dv, 1.f);
}

// ------------------------------------------------------------------ dq
// One CTA per (64-query tile, h, b), in two sweeps over the key tiles: the
// first sums D = rowsum(p ⊙ dP) in fp32 and writes it for the dk/dv
// kernel, the second forms dS = p ⊙ (dP − D), writes it to dbias and
// accumulates dq = dS·k. The tile ring runs through both sweeps: the
// second sweep's first tile is fetched under the first sweep's last.
__global__ void __launch_bounds__(kThreads, kDqBlocks)
bias_train_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;
  const bool dropout = p.drop.mode != kNoDropout;
  const float* mask_row = p.mask + b * p.mask_stride;
  const float* bias = relbias::bias_head(p, b, h);
  const int rs = static_cast<int>(p.bias_stride[2]);
  const uint32_t* keep = dropout ? relbias::keep_head(p, b, h) : nullptr;
  const int words = (L + 31) / 32;

  const uint32_t sbase = relbias::smem_u32(smem);
  // K, V (as rows), the bias tile, the key mask and the keep words of the
  // key tile at k0 → stage `stage`; one group
  auto fetch_keys = [&](int k0, int stage) {
    const uint32_t s = sbase + stage * kStageBytes;
    load_rows_async<kD, kStrT>(s + kOffA, rows(p, 1, b, h, 0),
                               p.stride[1][2], k0, L);
    load_rows_async<kD, kStrT>(s + kOffB, rows(p, 2, b, h, 0),
                               p.stride[2][2], k0, L);
    load_bias_async<kStrB>(s + kOffBias, bias, rs, q0, k0, L, p.bias_vec);
    biacm::load_key_bias_async(
        reinterpret_cast<float*>(smem + stage * kStageBytes + kOffF),
        s + kOffF, mask_row, k0, L);
    if (dropout) load_keep_async(s + kOffKeep, keep, words, q0, k0, L);
    cp_async_commit();
  };

  // q and dO of this query tile → A fragments, staged through stage 1 (a
  // group of its own) while key tile 0 travels to stage 0
  load_rows_async<kD, kStrT>(sbase + kStageBytes + kOffA, rows(p, 0, b, h, 0),
                             p.stride[0][2], q0, L);
  load_rows_async<kD, kStrT>(sbase + kStageBytes + kOffB, drows(p, b, h),
                             p.dstride[2], q0, L);
  cp_async_commit();
  fetch_keys(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const uint32_t off_a = relbias::frag_off<kStrT>(lane);
  const uint32_t off_b = relbias::bfrag_off<kStrT>(lane);
  uint32_t qa[kD / 16][4], da[kD / 16][4];
  {
    const uint32_t row = sbase + kStageBytes + warp * 16 * kStrT * 2 + off_a;
    static_for<kD / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      ldsm_x4<kOffA + kk * 32>(qa[kk], row);
      ldsm_x4<kOffB + kk * 32>(da[kk], row);
    });
  }

  const int64_t stat0 = (static_cast<int64_t>(b) * p.nh + h) * L;
  float row_m[2], row_lg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const bool ok = row < L;
    const float2 st = ok ? p.stats[stat0 + row] : make_float2(0.f, 0.f);
    row_m[r] = ok ? st.x : INFINITY;  // p = 0 for query rows past L
    row_lg[r] = st.y;
  }

  const int tiles = (L + kTile - 1) / kTile;
  // Step `it` of the 2·tiles-long sequence (sweep 1, then sweep 2): its
  // tile has landed and every warp is done with the other stage, which is
  // refilled with the next step's tile. Returns the stage to compute on.
  auto advance = [&](int it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < 2 * tiles)
      fetch_keys(((it + 1) % tiles) * kTile, (it + 1) & 1);
    return it & 1;
  };
  // p and dP of this warp's rows at keys kk*16 .. +15 of the tile at k0 in
  // `stage` (C fragments of the two 8-key halves); returns where this
  // thread's bias elements lie in the staged tile
  auto p_dp = [&](int stage, int k0, int kk, float (*pv)[4],
                  float (*dp)[4]) {
    unsigned char* sp = smem + stage * kStageBytes;
    const uint32_t k = sbase + stage * kStageBytes + off_b
                       + kk * 16 * kStrT * 2;
    float* s_bias = reinterpret_cast<float*>(sp + kOffBias)
                    + (warp * 16 + g) * kStrB + kk * 16 + t * 2;
    const float* s_mask = reinterpret_cast<const float*>(sp + kOffF)
                          + kk * 16 + t * 2;
    // kw[r]: the keep word of row r that holds these keys
    uint32_t kw[2] = {~0u, ~0u};
    if (dropout) {
      const uint32_t* s_keep = reinterpret_cast<const uint32_t*>(
          sp + kOffKeep) + (kk / 2) * kTile + warp * 16 + g;
      kw[0] = s_keep[0];
      kw[1] = s_keep[8];
    }
    const int kv = L - k0;
    static_for<2>([&](auto half_) {
      constexpr int half = decltype(half_)::value;
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
      static_for<kD / 32>([&](auto k2_) {  // two k16 steps per load
        constexpr int k2 = decltype(k2_)::value;
        constexpr int off = half * 8 * kStrT * 2 + k2 * 64;
        uint32_t f[4];
        ldsm_x4<kOffA + off>(f, k);
        mma_16816(sc, qa[2 * k2], f[0], f[1]);
        mma_16816(sc, qa[2 * k2 + 1], f[2], f[3]);
        ldsm_x4<kOffB + off>(f, k);
        mma_16816(g1, da[2 * k2], f[0], f[1]);
        mma_16816(g1, da[2 * k2 + 1], f[2], f[3]);
      });
      const float2 bb[2] = {
          *reinterpret_cast<const float2*>(s_bias + half * 8),
          *reinterpret_cast<const float2*>(s_bias + 8 * kStrB + half * 8)};
      const float2 m = *reinterpret_cast<const float2*>(s_mask + half * 8);
      const int c = kk * 16 + half * 8 + t * 2;  // key within the tile
      // keys c, c + 1: their bits in the word
      const int sh = ((2 * kk + half) % 4) * 8 + t * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q >> 1, o = q & 1;
        const float sv = score(sc[q], p.scale, o ? bb[r].y : bb[r].x,
                               o ? m.y : m.x, c + o < kv);
        pv[half][q] = __expf((sv - row_m[r]) - row_lg[r]);
        dp[half][q] = (kw[r] >> (sh + o)) & 1u ? g1[q] * p.drop.inv_keep
                                               : 0.f;
      }
    });
    return s_bias;
  };

  // sweep 1: D
  float row_d[2] = {0.f, 0.f};  // this thread's partial row sums
  for (int it = 0; it < tiles; ++it) {
    const int stage = advance(it);
#pragma unroll 1
    for (int kk = 0; kk < kTile / 16; ++kk) {
      float pv[2][4], dp[2][4];
      p_dp(stage, it * kTile, kk, pv, dp);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        row_d[0] += pv[half][0] * dp[half][0] + pv[half][1] * dp[half][1];
        row_d[1] += pv[half][2] * dp[half][2] + pv[half][3] * dp[half][3];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
    row_d[r] += __shfl_xor_sync(0xffffffffu, row_d[r], 1);
    row_d[r] += __shfl_xor_sync(0xffffffffu, row_d[r], 2);
    if (t == 0 && row_a + r * 8 < L)
      p.delta[stat0 + row_a + r * 8] = row_d[r];
  }

  // sweep 2: dS → dbias, dq
  float dq[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float* dbias = p.dbias + b * p.dbias_stride[0] + h * p.dbias_stride[1];
  const int drs = static_cast<int>(p.dbias_stride[2]);
  for (int it = tiles; it < 2 * tiles; ++it) {
    const int stage = advance(it);
    const int k0 = (it - tiles) * kTile;
    const uint32_t st_a = sbase + stage * kStageBytes + off_a;
#pragma unroll 1
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys per step
      float pv[2][4], dp[2][4], ds[2][4];
      float* s_bias = p_dp(stage, k0, kk, pv, dp);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ds[half][q] = pv[half][q] * (dp[half][q] - row_d[q >> 1]);
        // dS takes the place of the bias elements this thread just read
        *reinterpret_cast<float2*>(s_bias + half * 8) =
            make_float2(ds[half][0], ds[half][1]);
        *reinterpret_cast<float2*>(s_bias + 8 * kStrB + half * 8) =
            make_float2(ds[half][2], ds[half][3]);
      }
      uint32_t dsa[4], dsb[4];
      pack_a_split(dsa, dsb, ds);
      // the (keys, d) K tile read transposed: B fragments of d columns
      // np*16 .. +15 over these 16 keys
      const uint32_t k_t = st_a + kk * 16 * kStrT * 2;
      static_for<kD / 16>([&](auto np_) {
        constexpr int np = decltype(np_)::value;
        uint32_t f[4];
        ldsm_x4_t<kOffA + np * 32>(f, k_t);
        mma_16816(dq[2 * np], dsa, f[0], f[1]);
        mma_16816(dq[2 * np], dsb, f[0], f[1]);
        mma_16816(dq[2 * np + 1], dsa, f[2], f[3]);
        mma_16816(dq[2 * np + 1], dsb, f[2], f[3]);
      });
    }
    // the dS tile → dbias in 16-byte stores: 16 threads a row, each 8
    // consecutive rows; a group of 4 keys that starts below L is written
    // whole (rows of dbias are L rounded up to a multiple of 4 floats)
    __syncthreads();
    {
      constexpr int kGroups = kTile / 4, kRows = kTile * kGroups / kThreads;
      const int row = threadIdx.x / kGroups * kRows;
      const int col = (threadIdx.x % kGroups) * 4;
      const float* src = reinterpret_cast<const float*>(
          smem + stage * kStageBytes + kOffBias) + row * kStrB + col;
      float* out = dbias + (q0 + row) * drs + k0 + col;
      if (k0 + col < L) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (q0 + row + i < L)
            *reinterpret_cast<float4*>(out + i * drs) =
                *reinterpret_cast<const float4*>(src + i * kStrB);
      }
    }
  }
  store_grad(p.grad[0], p, b, h, q0 + warp * 16, g, t, dq, p.scale);
}

// The kernels of this library, in the order of bias_train_occupancy.
enum Which { kFwdDropout = 0, kFwdPlain = 1, kDq = 2, kDkDv = 3, kMask = 4 };

int shared_memory_of(int which) {
  return which == kMask ? 0 : which == kDkDv ? kKvSmemBytes : kSmemBytes;
}

// Allow kernel `which` its dynamic shared memory (once per device), or, with
// `blocks`, ask the runtime how many of its CTAs fit an SM.
cudaError_t configure(int which, int* blocks) {
  static bool done[5][64] = {};
  const int bytes = shared_memory_of(which);
  auto apply = [&](auto kernel) {
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kThreads, bytes);
    return bytes ? biacm::allow_shared_memory(kernel, bytes, done[which])
                 : cudaSuccess;
  };
  switch (which) {
    case kFwdDropout: return apply(bias_train_fwd_kernel<true>);
    case kFwdPlain: return apply(bias_train_fwd_kernel<false>);
    case kDq: return apply(bias_train_dq_kernel);
    case kDkDv: return apply(bias_train_dkdv_kernel);
    default: return apply(bias_keep_mask_kernel);
  }
}

}  // namespace

extern "C" {

// Launchers: on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets. `ptrs[0..8]` and `strides[0..12]` as
// relbias::make_params (bias_common.cuh) lays them out; ptrs[8] is the
// packed keep flags (written by the forward at rate > 0, read by both).
// Each returns the first nonzero cudaError_t of its launches (0 =
// launched).

// Forward: writes ctx (ptrs[7]) and the statistics (ptrs[6]); with
// dropout, the mask kernel first writes the keep flags the forward then
// reads.
int bias_train_fwd(const uint64_t* ptrs, const int64_t* strides, int B,
                   int nh, int L, float scale, int mode, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t thr, float inv_keep,
                   void* stream) {
  const relbias::FwdParams p = relbias::make_params(
      ptrs, strides, nh, L, scale, mode, seed_lo, seed_hi, thr, inv_keep);
  const bool plain = mode == kNoDropout;
  cudaError_t err = configure(plain ? kFwdPlain : kFwdDropout, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plain) {
    bias_train_fwd_kernel<false><<<grid, kThreads, kSmemBytes, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const int words = (L + 31) / 32;
  dim3 mask_grid((L * words + kThreads - 1) / kThreads, nh, B);
  bias_keep_mask_kernel<<<mask_grid, kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_train_fwd_kernel<true><<<grid, kThreads, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward (the dq kernel, which also writes D and dbias, then the dk/dv
// kernel): ptrs[5] and [7] are unused; [9] dc; [10] the fp32 (B, nh, L)
// scratch for D; [11..13] dq, dk, dv (B, L, nh, 64); [14] dbias (fp32 (B,
// nh, L, L), rows of L rounded up to a multiple of 4 floats, 16-byte
// aligned). strides[13..15]: (batch, head, seq) of dc; [16..18] (batch,
// head, row) of dbias. `mode`: only whether it is 0 (no dropout) is read.
int bias_train_bwd(const uint64_t* ptrs, const int64_t* strides, int B,
                   int nh, int L, float scale, int mode, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t thr, float inv_keep,
                   void* stream) {
  BwdParams p{};
  static_cast<relbias::FwdParams&>(p) = relbias::make_params(
      ptrs, strides, nh, L, scale, mode, seed_lo, seed_hi, thr, inv_keep);
  p.dout = reinterpret_cast<const __nv_bfloat16*>(ptrs[9]);
  for (int j = 0; j < 3; ++j) p.dstride[j] = strides[13 + j];
  p.delta = reinterpret_cast<float*>(ptrs[10]);
  for (int i = 0; i < 3; ++i)
    p.grad[i] = reinterpret_cast<__nv_bfloat16*>(ptrs[11 + i]);
  p.dbias = reinterpret_cast<float*>(ptrs[14]);
  for (int j = 0; j < 3; ++j) p.dbias_stride[j] = strides[16 + j];
  cudaError_t err = configure(kDq, nullptr);
  if (err == cudaSuccess) err = configure(kDkDv, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  bias_train_dq_kernel<<<grid, kThreads, kSmemBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_train_dkdv_kernel<<<grid, kThreads, kKvSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What cudaOccupancyMaxActiveBlocksPerMultiprocessor grants kernel `which`
// (0 the forward with dropout, 1 without, 2 dq, 3 dk/dv, 4 the mask
// kernel) on the current device: resident CTAs per SM, or minus the
// cudaError_t. `smem_bytes` receives the kernel's dynamic shared memory.
int bias_train_occupancy(int which, int* smem_bytes) {
  if (which < kFwdDropout || which > kMask) return -1;
  *smem_bytes = shared_memory_of(which);
  int blocks = 0;
  cudaError_t err = configure(which, nullptr);
  if (err == cudaSuccess) err = configure(which, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* bias_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
