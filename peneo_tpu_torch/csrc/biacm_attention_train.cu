// BiACM (dual-stream) attention of LiLT for Hopper, training: forward with
// in-kernel attention dropout, and its backward.
//
// Replaces the Pallas TPU kernels `_fwd_train_kernel` (forward) and
// `_bwd_train_kernel` (backward) of peneo_tpu/ops/biacm_attention.py
// (`biacm_attention_train`, custom VJP). Per (batch b, head h):
//
//   s     = q_t·k_tᵀ·scale_t + q_l·k_lᵀ·scale_l + bias[b]      fp32
//   p     = softmax(s)
//   p1    = keep1 ? p/(1−r) : 0,   p2 = keep2 ? p/(1−r) : 0    two masks
//   ctx_t = p1·v_t  (d = 64),      ctx_l = p2·v_l  (d = 16)
//
// backward, with dct = ∂/∂ctx_t, dcl = ∂/∂ctx_l:
//
//   dP    = keep1·(dct·v_tᵀ)/(1−r) + keep2·(dcl·v_lᵀ)/(1−r)
//   D     = rowsum(dP ⊙ p)                                     fp32
//   dS    = p ⊙ (dP − D)
//   dq_t  = dS·k_t·scale_t,  dk_t = dSᵀ·q_t·scale_t,  dv_t = p1ᵀ·dct
//   dq_l, dk_l, dv_l likewise; the bias (a padding mask) gets no gradient.
//
// D is computed as the TPU kernel computes it, from the recomputed p and
// dP in fp32. FlashAttention-2's shortcut D = rowsum(dct ⊙ ctx_t) +
// rowsum(dcl ⊙ ctx_l) is equal in real arithmetic, but ctx is the
// forward's bf16 output, and dq = Σ_j dS_ij·k_j is a small difference of
// large terms when a row's keys are nearly collinear (as in the last
// layers of LiLT-base): there the shortcut's rounding moved the q/k
// weight gradients of layer 11 by 8-9 % against the fp32 twin. For the
// same reason dS enters the dq and dk products as two bf16 parts (hi +
// lo, biacm::pack_a_split) where the TPU kernel rounds it to bf16 once: a
// single rounding shows in dq as 2^-9·|mean k| / |k − mean k|.
//
// Dropout masks. keep_s = bits_s < thr, thr = min(round((1−r)·2³²), 2³²−1),
// as on the TPU. A small kernel of its own, launched with the forward,
// draws them (Philox4x32-10, one draw per two adjacent keys and both
// streams: biacm_common.cuh, "dropout bits"; or compares two explicit
// uint32 (B, nh, L, L) tensors), a pure function of (seed, b, h, i, j,
// stream), so a checkpoint recompute rewrites the same masks. It writes
// the keep flags bit-packed, uint32 (2, B, nh, L, ceil(L / 32)), bit j % 32
// of word j / 32; the forward and the backward read them tile by tile,
// draw nothing, and have one mask path for both modes. An earlier version
// of this pair saved the seed and redrew the masks inside the forward and
// each backward sweep; a pass of draws over the (L, L) elements measured
// longer than the forward's products, the attention kernels made four,
// and the generator's registers cost them a resident CTA, so the masks
// are now drawn once, at full occupancy, and carried (L²/4 bytes per head
// for both streams: 6.3 MB per layer at B=8, nh=12, L=512, which stays in
// the 50 MB L2 between the mask kernel and the forward).
//
// What bounds it on the H100: at the training shape (B=8, nh=12, L=512)
// the forward does 4·B·nh·L²·80 = 8.1 GFLOP on ~38 MB (with the packed
// masks), so bytes (~11 µs) and tensor-core time (~8 µs) are close; the
// backward's 5·2·B·nh·L²·80 = 20 GFLOP (~20 µs) bound it by operations.
// Neither is what the kernels spend their time on: that is load latency,
// shared-memory instructions and the generator's integer rounds, and the
// dq kernel's first sweep, which recomputes the scores and dP once more to
// sum D. The design keeps the (L, L) scores and probabilities out of
// device memory entirely (the plain version writes several fp32 (B, nh, L,
// L) tensors), accumulates dk/dv in registers, runs every product on the
// tensor cores (mma.sync m16n8k16 bf16 → fp32), and
// - keeps every tile in shared memory once, as rows, read with ldmatrix
//   (.trans where a product needs the transpose: K in dS·k, Q and dO in
//   dSᵀ·q and pᵀ·dO), so no tile is read from device memory twice and no
//   transposed copy is written;
// - fetches the next tile with cp.async into the other stage of a 2-stage
//   ring while the warps compute on the current one (one barrier per tile);
// - draws each mask once, two keys per Philox draw, outside the attention
//   kernels.
// No TMA and no wgmma: at d = 80 and L = 512 the products are not what
// binds.
//
// Design (FlashAttention-2 layout; the TPU kernels hold a (b, h)'s full K/V
// rows and a (128, L) fp32 tile in VMEM, and build dk/dv across a
// sequential grid axis, neither of which fits Hopper):
// - forward: kernel #1's body (biacm::forward_tile of biacm_common.cuh:
//   one CTA of 4 warps per 64 query rows, key tiles of 64, online softmax)
//   instantiated with the two masks on the un-normalised p before each p·v
//   product (another instantiation without them serves rate 0); the final
//   division by the running sum is unchanged by dropout. It also writes
//   each row's softmax statistics as the pair (max m, log of the sum l),
//   fp32 (B, nh, L, 2): a fully padded row has scores ≈ finfo(f32).min/2,
//   where m + log l would round back to m, so the backward recomputes
//   p = exp((s − m) − log l) instead.
// - dq: one CTA per (64-query tile, h, b). The ring runs over the key
//   tiles twice without a break: a first sweep recomputes p from the
//   statistics and dP, and sums D; a second computes dS and accumulates
//   dq. It writes D for the dk/dv kernel.
// - dk/dv: one CTA per (64-key tile, h, b), each warp owning 16 keys; the
//   ring runs over the query tiles (Q, dO, their statistics, D and the
//   keep words), it recomputes pᵀ from the statistics and accumulates dv_t,
//   dv_l, dk_t, dk_l in fp32 registers; written once, in bf16. No atomics:
//   both kernels are deterministic run to run.
// - The keep words of a (64, 64) tile are staged in shared memory as
//   [stream][word][row], so the query-owned threads of dq and the
//   key-owned threads of dk/dv both pick their bits from whole words.
// - Residency: the forward and dq keep ≤ 168 registers for 3 CTAs per SM,
//   dk/dv (four fp32 accumulators) ≤ 255 for 2; with 768 CTAs on 132 SMs
//   that is 1.94, 1.94 and 2.9 waves, not the wave and a half of 4 CTAs
//   per SM, which also measured slower (biacm_train_occupancy reports what
//   the runtime grants).
// - Any L ≥ 1: rows and keys past L are zero-filled and predicated (keys
//   get bias −inf, query rows past L get m = +inf, so their p is 0).
// - q/k/v and the output gradients are read through (batch, head, seq)
//   strides with a contiguous last dim; outputs and gradients are written
//   (B, L, nh, d) contiguous.
//
// Build: nvcc -O3 -std=c++17 -gencode=arch=compute_90a,code=sm_90a -shared
//        -Xcompiler -fPIC (peneo_tpu_torch/ops/cuda_build.py). Plain C ABI,
//        loaded with ctypes (peneo_tpu_torch/ops/biacm_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "biacm_common.cuh"

namespace {

using biacm::cp_async;
using biacm::cp_async_commit;
using biacm::cp_async_wait;
using biacm::kDL;
using biacm::kDT;
using biacm::keep_pair_mask;
using biacm::kKeepWords;
using biacm::kNoDropout;
using biacm::kOffAL;
using biacm::kOffAT;
using biacm::kOffBL;
using biacm::kOffBT;
using biacm::kOffF;
using biacm::kOffKeep;
using biacm::kSmemBytes;
using biacm::kStageBytes;
using biacm::kStrL;
using biacm::kStrT;
using biacm::kThreads;
using biacm::kTile;
using biacm::ldsm_x4;
using biacm::ldsm_x4_t;
using biacm::load_keep_async;
using biacm::load_rows_async;
using biacm::mma_16816;
using biacm::pack_a;
using biacm::pack_a_split;
using biacm::rows;
using biacm::static_for;

// dk/dv's stage: Q, dO tiles, the rows' (m, log l) pairs, D, the keep words
constexpr int kKvOffDelta = kOffF + kTile * 8;
constexpr int kKvOffMask = kKvOffDelta + kTile * 4;
constexpr int kKvStageBytes = kKvOffMask + kKeepWords * 4;
constexpr int kKvSmemBytes = 2 * kKvStageBytes;
// resident CTAs per SM the kernels are compiled for (register caps of
// 168, 168 and 255 a thread)
constexpr int kFwdBlocks = 3, kDqBlocks = 3, kKvBlocks = 2;

// The backward's parameters: the forward's (inputs, bias, row statistics,
// keep flags, dropout) plus the output gradients, D and the six input
// gradients.
struct BwdParams : biacm::FwdParams {
  const __nv_bfloat16* dout[2];          // dct, dcl
  int64_t dstride[2][3];
  __nv_bfloat16* grad[6];                // dq_t, dk_t, dv_t, dq_l, dk_l,
                                         // dv_l (B, L, nh, d)
  float* delta;                          // (B, nh, L): D, from the dq kernel
};

__device__ __forceinline__ const __nv_bfloat16* drows(const BwdParams& p,
                                                      int which, int b, int h,
                                                      int r0) {
  return p.dout[which] + b * p.dstride[which][0] + h * p.dstride[which][1]
         + static_cast<int64_t>(r0) * p.dstride[which][2];
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* o,
                                           const BwdParams& p, int b, int h,
                                           int row0, int g, int t,
                                           const float (*acc)[4], float sc) {
  biacm::store_rows<D>(o, p.nh, p.L, b, h, row0, g, t, acc, sc, sc);
}

// ------------------------------------------------------------ keep flags
// The dropout masks of one training forward, bit-packed (biacm_common.cuh,
// "dropout bits"): one thread per (query i, 32-key word) of a head draws
// the word's 16 key pairs (or compares the explicit bits) and writes the
// word of both streams; a device key is read once per CTA. Grid
// (ceil(L·words / kThreads), nh, B).
__global__ void __launch_bounds__(kThreads)
biacm_keep_mask_kernel(const biacm::FwdParams p) {
  const biacm::Dropout drop = biacm::resolve_seed(p.drop);
  const int L = p.L, words = (L + 31) / 32;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= L * words) return;
  const int i = e / words, w = e % words, h = blockIdx.y, b = blockIdx.z;
  uint32_t k1 = 0u, k2 = 0u;
#pragma unroll 4
  for (int m = 0; m < 16; ++m) {
    bool f[4];
    biacm::keep_flags_pair(drop, p.nh, L, b, h, i, w * 32 + 2 * m, f);
    k1 |= (uint32_t(f[0]) | uint32_t(f[2]) << 1) << (2 * m);
    k2 |= (uint32_t(f[1]) | uint32_t(f[3]) << 1) << (2 * m);
  }
  p.keep[biacm::keep_head(p, 0, b, h) + e] = k1;
  p.keep[biacm::keep_head(p, 1, b, h) + e] = k2;
}

// ---------------------------------------------------------------- forward
// kernel #2: the shared forward body (biacm_common.cuh) with the row
// statistics, and with the dropout masks (read from the packed keep flags
// the mask kernel wrote just before) unless the rate is 0
template <bool kDropout>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
biacm_train_fwd_kernel(const biacm::FwdParams p) {
  biacm::forward_tile<kDropout, true>(p);
}

// ------------------------------------------------------------- dk / dv
__global__ void __launch_bounds__(kThreads, kKvBlocks)
biacm_train_dkdv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, +8
  const bool dropout = p.drop.mode != kNoDropout;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.nh + h) * L;

  const uint32_t sbase = biacm::smem_u32(smem);
  // Q, dO (as rows), the rows' statistics, D and the keep words of the
  // query tile at q0 → stage `stage`; one group
  auto fetch_queries = [&](int q0, int stage) {
    const uint32_t s = sbase + stage * kKvStageBytes;
    load_rows_async<kDT, kStrT>(s + kOffAT, rows(p, 0, b, h, 0),
                                p.stride[0][2], q0, L);
    load_rows_async<kDL, kStrL>(s + kOffAL, rows(p, 3, b, h, 0),
                                p.stride[3][2], q0, L);
    load_rows_async<kDT, kStrT>(s + kOffBT, drows(p, 0, b, h, 0),
                                p.dstride[0][2], q0, L);
    load_rows_async<kDL, kStrL>(s + kOffBL, drows(p, 1, b, h, 0),
                                p.dstride[1][2], q0, L);
    const int i = threadIdx.x;
    if (i < kTile) {
      const bool ok = q0 + i < L;
      if (ok)
        cp_async<8>(s + kOffF + i * 8, p.stats + stat0 + q0 + i, true);
      else  // p = 0 for rows past L
        reinterpret_cast<float2*>(smem + stage * kKvStageBytes + kOffF)[i] =
            make_float2(INFINITY, 0.f);
      cp_async<4>(s + kKvOffDelta + i * 4,
                  p.delta + stat0 + (ok ? q0 + i : 0), ok);
    }
    if (dropout) load_keep_async(s + kKvOffMask, p, b, h, q0, k0);
    cp_async_commit();
  };

  // K and V of this key tile → A fragments in registers, staged through
  // stage 1 (a group of its own) while query tile 0 travels to stage 0
  {
    const uint32_t s = sbase + kKvStageBytes;
    load_rows_async<kDT, kStrT>(s + kOffAT, rows(p, 1, b, h, 0),
                                p.stride[1][2], k0, L);
    load_rows_async<kDL, kStrL>(s + kOffAL, rows(p, 4, b, h, 0),
                                p.stride[4][2], k0, L);
    load_rows_async<kDT, kStrT>(s + kOffBT, rows(p, 2, b, h, 0),
                                p.stride[2][2], k0, L);
    load_rows_async<kDL, kStrL>(s + kOffBL, rows(p, 5, b, h, 0),
                                p.stride[5][2], k0, L);
    cp_async_commit();
  }
  fetch_queries(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const uint32_t off_a_t = biacm::frag_off<kStrT>(lane);
  const uint32_t off_a_l = biacm::frag_off<kStrL>(lane);
  const uint32_t off_b_t = biacm::bfrag_off<kStrT>(lane);
  const uint32_t off_b_l = biacm::bpair_off<kStrL>(lane);
  uint32_t ka_t[kDT / 16][4], ka_l[4], va_t[kDT / 16][4], va_l[4];
  {
    const uint32_t row_t = sbase + kKvStageBytes + warp * 16 * kStrT * 2
                           + off_a_t;
    const uint32_t row_l = sbase + kKvStageBytes + warp * 16 * kStrL * 2
                           + off_a_l;
    static_for<kDT / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      ldsm_x4<kOffAT + kk * 32>(ka_t[kk], row_t);
      ldsm_x4<kOffBT + kk * 32>(va_t[kk], row_t);
    });
    ldsm_x4<kOffAL>(ka_l, row_l);
    ldsm_x4<kOffBL>(va_l, row_l);
  }
  const float* bias_row = p.bias + b * p.bias_stride;
  const float key_bias[2] = {key_a < L ? bias_row[key_a] : -INFINITY,
                             key_a + 8 < L ? bias_row[key_a + 8] : -INFINITY};
  // this thread's keys within their 32-key word of the keep flags
  const int key_bit = (warp & 1) * 16 + g;

  float dv_t[kDT / 8][4], dv_l[kDL / 8][4], dk_t[kDT / 8][4],
      dk_l[kDL / 8][4];
#pragma unroll
  for (int n = 0; n < kDT / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) dv_t[n][q] = dk_t[n][q] = 0.f;
#pragma unroll
  for (int n = 0; n < kDL / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) dv_l[n][q] = dk_l[n][q] = 0.f;

  const int tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    // tile `it` has landed, and every warp is done with the other stage
    // (tile it − 1; before tile 0, the K/V fragments): refill that stage
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) fetch_queries((it + 1) * kTile, (it + 1) & 1);
    const unsigned char* sp = smem + (it & 1) * kKvStageBytes;
    // this lane's ldmatrix row addresses at the stage's origin, one per
    // address pattern and row stride
    const uint32_t st = sbase + (it & 1) * kKvStageBytes;
    const uint32_t st_a_t = st + off_a_t, st_a_l = st + off_a_l;
    const uint32_t st_b_t = st + off_b_t, st_b_l = st + off_b_l;
    const float* s_st = reinterpret_cast<const float*>(sp + kOffF);
    const float* s_delta = reinterpret_cast<const float*>(sp + kKvOffDelta);
    const uint32_t* s_keep = reinterpret_cast<const uint32_t*>(sp + kKvOffMask)
                             + (warp >> 1) * kTile;  // this warp's word

    // 16 queries per step. A real loop (the offsets of a step are added to
    // the lane's addresses at run time): unrolled, the kernel's code
    // outgrows the instruction cache and ptxas hoists loads until it spills.
#pragma unroll 1
    for (int nn = 0; nn < kTile / 16; ++nn) {
      const uint32_t q_t = nn * 16 * kStrT * 2, q_l = nn * 16 * kStrL * 2;
      float ds[2][4], pe[2][4];  // dS, and p/(1−r) before the masks
      uint32_t m1[4], m2[4];     // the two streams' bf16x2 keep masks
      uint32_t ql[4], dl[4];  // q_l, dO_l fragments of both 8-query halves
      ldsm_x4<kOffAL>(ql, st_b_l + q_l);
      ldsm_x4<kOffBL>(dl, st_b_l + q_l);
      static_for<2>([&](auto half_) {
        constexpr int half = decltype(half_)::value;
        const int qc = nn * 16 + half * 8;  // this n-tile's first query
        float sc_t[4] = {0.f, 0.f, 0.f, 0.f}, sc_l[4] = {0.f, 0.f, 0.f, 0.f};
        float g1[4] = {0.f, 0.f, 0.f, 0.f}, g2[4] = {0.f, 0.f, 0.f, 0.f};
        static_for<kDT / 32>([&](auto k2_) {  // two k16 steps per load
          constexpr int k2 = decltype(k2_)::value;
          constexpr int off = half * 8 * kStrT * 2 + k2 * 64;
          uint32_t f[4];
          ldsm_x4<kOffAT + off>(f, st_b_t + q_t);
          mma_16816(sc_t, ka_t[2 * k2], f[0], f[1]);
          mma_16816(sc_t, ka_t[2 * k2 + 1], f[2], f[3]);
          ldsm_x4<kOffBT + off>(f, st_b_t + q_t);
          mma_16816(g1, va_t[2 * k2], f[0], f[1]);
          mma_16816(g1, va_t[2 * k2 + 1], f[2], f[3]);
        });
        mma_16816(sc_l, ka_l, ql[2 * half], ql[2 * half + 1]);
        mma_16816(g2, va_l, dl[2 * half], dl[2 * half + 1]);
        // queries qc + 2t, qc + 2t + 1: (m, log l) pairs, D, keep words
        const float4 ml =
            *reinterpret_cast<const float4*>(s_st + (qc + t * 2) * 2);
        const float2 dd =
            *reinterpret_cast<const float2*>(s_delta + qc + t * 2);
        uint2 w1 = make_uint2(~0u, ~0u), w2 = make_uint2(~0u, ~0u);
        if (dropout) {
          w1 = *reinterpret_cast<const uint2*>(s_keep + qc + t * 2);
          w2 = *reinterpret_cast<const uint2*>(s_keep + 2 * kTile + qc
                                               + t * 2);
        }
#pragma unroll
        for (int kr = 0; kr < 2; ++kr) {  // key row g or g+8
          // bit 0 / 1: the key's flag for query qc + 2t / qc + 2t + 1
          const int sh = key_bit + kr * 8;
          const uint32_t b1 = ((w1.x >> sh) & 1u) | ((w1.y >> sh) & 1u) << 1;
          const uint32_t b2 = ((w2.x >> sh) & 1u) | ((w2.y >> sh) & 1u) << 1;
          m1[2 * half + kr] = keep_pair_mask(b1);
          m2[2 * half + kr] = keep_pair_mask(b2);
#pragma unroll
          for (int odd = 0; odd < 2; ++odd) {  // query qc + 2t + odd
            const int q = 2 * kr + odd;
            const float sv = sc_t[q] * p.scale_t + sc_l[q] * p.scale_l
                             + key_bias[kr];
            const float pv = __expf((sv - (odd ? ml.z : ml.x))
                                    - (odd ? ml.w : ml.y));
            const bool k1 = (b1 >> odd) & 1u, k2 = (b2 >> odd) & 1u;
            const float dp = (k1 ? g1[q] * p.drop.inv_keep : 0.f)
                             + (k2 ? g2[q] * p.drop.inv_keep : 0.f);
            pe[half][q] = pv * p.drop.inv_keep;
            ds[half][q] = pv * (dp - (odd ? dd.y : dd.x));
          }
        }
      });
      // pᵀ of both streams: p/(1−r) rounded to bf16, dropped elements
      // zeroed (equal to rounding keep ? p/(1−r) : 0)
      uint32_t pa1[4], pa2[4], dsa[4], dsb[4];
      pack_a(pa1, pe);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa2[i] = pa1[i] & m2[i];
        pa1[i] &= m1[i];
      }
      pack_a_split(dsa, dsb, ds);
      // the (queries, d) tiles read transposed: B fragments of d columns
      // np*16 .. +15 over these 16 queries
      static_for<kDT / 16>([&](auto np_) {
        constexpr int np = decltype(np_)::value;
        uint32_t f[4];
        ldsm_x4_t<kOffBT + np * 32>(f, st_a_t + q_t);  // dO
        mma_16816(dv_t[2 * np], pa1, f[0], f[1]);
        mma_16816(dv_t[2 * np + 1], pa1, f[2], f[3]);
        ldsm_x4_t<kOffAT + np * 32>(f, st_a_t + q_t);  // Q
        mma_16816(dk_t[2 * np], dsa, f[0], f[1]);
        mma_16816(dk_t[2 * np], dsb, f[0], f[1]);
        mma_16816(dk_t[2 * np + 1], dsa, f[2], f[3]);
        mma_16816(dk_t[2 * np + 1], dsb, f[2], f[3]);
      });
      uint32_t f[4];
      ldsm_x4_t<kOffBL>(f, st_a_l + q_l);  // dO_l
      mma_16816(dv_l[0], pa2, f[0], f[1]);
      mma_16816(dv_l[1], pa2, f[2], f[3]);
      ldsm_x4_t<kOffAL>(f, st_a_l + q_l);  // Q_l
      mma_16816(dk_l[0], dsa, f[0], f[1]);
      mma_16816(dk_l[0], dsb, f[0], f[1]);
      mma_16816(dk_l[1], dsa, f[2], f[3]);
      mma_16816(dk_l[1], dsb, f[2], f[3]);
    }
  }

  const int r0 = k0 + warp * 16;
  store_rows<kDT>(p.grad[1], p, b, h, r0, g, t, dk_t, p.scale_t);
  store_rows<kDT>(p.grad[2], p, b, h, r0, g, t, dv_t, 1.f);
  store_rows<kDL>(p.grad[4], p, b, h, r0, g, t, dk_l, p.scale_l);
  store_rows<kDL>(p.grad[5], p, b, h, r0, g, t, dv_l, 1.f);
}

// ------------------------------------------------------------------ dq
// One CTA per (64-query tile, h, b), in two sweeps over the key tiles: the
// first sums D = rowsum(p ⊙ dP) in fp32 and writes it for the dk/dv
// kernel, the second accumulates dq = dS·k with dS = p ⊙ (dP − D). The
// tile ring runs through both sweeps: the second sweep's first tile is
// fetched under the first sweep's last.
__global__ void __launch_bounds__(kThreads, kDqBlocks)
biacm_train_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;
  const bool dropout = p.drop.mode != kNoDropout;
  const float* bias_row = p.bias + b * p.bias_stride;

  const uint32_t sbase = biacm::smem_u32(smem);
  // K, V (as rows), the key bias and the keep words of the key tile at k0
  // → stage `stage`; one group
  auto fetch_keys = [&](int k0, int stage) {
    const uint32_t s = sbase + stage * kStageBytes;
    load_rows_async<kDT, kStrT>(s + kOffAT, rows(p, 1, b, h, 0),
                                p.stride[1][2], k0, L);
    load_rows_async<kDL, kStrL>(s + kOffAL, rows(p, 4, b, h, 0),
                                p.stride[4][2], k0, L);
    load_rows_async<kDT, kStrT>(s + kOffBT, rows(p, 2, b, h, 0),
                                p.stride[2][2], k0, L);
    load_rows_async<kDL, kStrL>(s + kOffBL, rows(p, 5, b, h, 0),
                                p.stride[5][2], k0, L);
    biacm::load_key_bias_async(
        reinterpret_cast<float*>(smem + stage * kStageBytes + kOffF),
        s + kOffF, bias_row, k0, L);
    if (dropout) load_keep_async(s + kOffKeep, p, b, h, q0, k0);
    cp_async_commit();
  };

  // q and dO of this query tile → A fragments, staged through stage 1 (a
  // group of its own) while key tile 0 travels to stage 0
  {
    const uint32_t s = sbase + kStageBytes;
    load_rows_async<kDT, kStrT>(s + kOffAT, rows(p, 0, b, h, 0),
                                p.stride[0][2], q0, L);
    load_rows_async<kDL, kStrL>(s + kOffAL, rows(p, 3, b, h, 0),
                                p.stride[3][2], q0, L);
    load_rows_async<kDT, kStrT>(s + kOffBT, drows(p, 0, b, h, 0),
                                p.dstride[0][2], q0, L);
    load_rows_async<kDL, kStrL>(s + kOffBL, drows(p, 1, b, h, 0),
                                p.dstride[1][2], q0, L);
    cp_async_commit();
  }
  fetch_keys(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const uint32_t off_a_t = biacm::frag_off<kStrT>(lane);
  const uint32_t off_a_l = biacm::frag_off<kStrL>(lane);
  const uint32_t off_b_t = biacm::bfrag_off<kStrT>(lane);
  const uint32_t off_b_l = biacm::bpair_off<kStrL>(lane);
  uint32_t qa_t[kDT / 16][4], qa_l[4], da_t[kDT / 16][4], da_l[4];
  {
    const uint32_t row_t = sbase + kStageBytes + warp * 16 * kStrT * 2
                           + off_a_t;
    const uint32_t row_l = sbase + kStageBytes + warp * 16 * kStrL * 2
                           + off_a_l;
    static_for<kDT / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      ldsm_x4<kOffAT + kk * 32>(qa_t[kk], row_t);
      ldsm_x4<kOffBT + kk * 32>(da_t[kk], row_t);
    });
    ldsm_x4<kOffAL>(qa_l, row_l);
    ldsm_x4<kOffBL>(da_l, row_l);
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
  // p and dP of this warp's rows at keys kk*16 .. +15 of the tile in
  // `stage` (C fragments of the two 8-key halves)
  auto p_dp = [&](int stage, int kk, float (*pv)[4], float (*dp)[4]) {
    const uint32_t st = sbase + stage * kStageBytes;
    const uint32_t k_t = st + off_b_t + kk * 16 * kStrT * 2;
    const uint32_t k_l = st + off_b_l + kk * 16 * kStrL * 2;
    const float* s_bias = reinterpret_cast<const float*>(
        smem + stage * kStageBytes + kOffF) + kk * 16 + t * 2;
    uint32_t kl[4], vl[4];  // k_l, v_l fragments of both 8-key halves
    ldsm_x4<kOffAL>(kl, k_l);
    ldsm_x4<kOffBL>(vl, k_l);
    // kw[s][r]: the keep word of stream s, row r that holds these keys
    uint32_t kw[2][2] = {{~0u, ~0u}, {~0u, ~0u}};
    if (dropout) {
      const uint32_t* s_keep = reinterpret_cast<const uint32_t*>(
          smem + stage * kStageBytes + kOffKeep)
          + (kk / 2) * kTile + warp * 16 + g;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          kw[s][r] = s_keep[s * 2 * kTile + r * 8];
    }
    static_for<2>([&](auto half_) {
      constexpr int half = decltype(half_)::value;
      float sc_t[4] = {0.f, 0.f, 0.f, 0.f}, sc_l[4] = {0.f, 0.f, 0.f, 0.f};
      float g1[4] = {0.f, 0.f, 0.f, 0.f}, g2[4] = {0.f, 0.f, 0.f, 0.f};
      static_for<kDT / 32>([&](auto k2_) {  // two k16 steps per load
        constexpr int k2 = decltype(k2_)::value;
        constexpr int off = half * 8 * kStrT * 2 + k2 * 64;
        uint32_t f[4];
        ldsm_x4<kOffAT + off>(f, k_t);
        mma_16816(sc_t, qa_t[2 * k2], f[0], f[1]);
        mma_16816(sc_t, qa_t[2 * k2 + 1], f[2], f[3]);
        ldsm_x4<kOffBT + off>(f, k_t);
        mma_16816(g1, da_t[2 * k2], f[0], f[1]);
        mma_16816(g1, da_t[2 * k2 + 1], f[2], f[3]);
      });
      mma_16816(sc_l, qa_l, kl[2 * half], kl[2 * half + 1]);
      mma_16816(g2, da_l, vl[2 * half], vl[2 * half + 1]);
      const float2 kb = *reinterpret_cast<const float2*>(s_bias + half * 8);
      // keys (2·kk + half)·8 + 2t, + 1 of the tile: their bits in the word
      const int sh = ((2 * kk + half) % 4) * 8 + t * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q >> 1;
        const float sv = sc_t[q] * p.scale_t + sc_l[q] * p.scale_l
                         + ((q & 1) ? kb.y : kb.x);
        pv[half][q] = __expf((sv - row_m[r]) - row_lg[r]);
        const bool k1 = (kw[0][r] >> (sh + (q & 1))) & 1u;
        const bool k2 = (kw[1][r] >> (sh + (q & 1))) & 1u;
        dp[half][q] = (k1 ? g1[q] * p.drop.inv_keep : 0.f)
                      + (k2 ? g2[q] * p.drop.inv_keep : 0.f);
      }
    });
  };

  // sweep 1: D
  float row_d[2] = {0.f, 0.f};  // this thread's partial row sums
  // (the 16-key steps are real loops, with their offsets added at run
  // time: unrolled, the kernel's code outgrows the instruction cache and
  // ptxas hoists loads until it spills)
  for (int it = 0; it < tiles; ++it) {
    const int stage = advance(it);
#pragma unroll 1
    for (int kk = 0; kk < kTile / 16; ++kk) {
      float pv[2][4], dp[2][4];
      p_dp(stage, kk, pv, dp);
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

  // sweep 2: dq
  float dq_t[kDT / 8][4], dq_l[kDL / 8][4];
#pragma unroll
  for (int n = 0; n < kDT / 8; ++n)
    dq_t[n][0] = dq_t[n][1] = dq_t[n][2] = dq_t[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kDL / 8; ++n)
    dq_l[n][0] = dq_l[n][1] = dq_l[n][2] = dq_l[n][3] = 0.f;
  for (int it = tiles; it < 2 * tiles; ++it) {
    const int stage = advance(it);
    const uint32_t st = sbase + stage * kStageBytes;
#pragma unroll 1
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys per step
      float pv[2][4], dp[2][4], ds[2][4];
      p_dp(stage, kk, pv, dp);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ds[half][q] = pv[half][q] * (dp[half][q] - row_d[q >> 1]);
      uint32_t dsa[4], dsb[4];
      pack_a_split(dsa, dsb, ds);
      // the (keys, d) K tiles read transposed: B fragments of d columns
      // np*16 .. +15 over these 16 keys
      const uint32_t k_t = st + off_a_t + kk * 16 * kStrT * 2;
      static_for<kDT / 16>([&](auto np_) {
        constexpr int np = decltype(np_)::value;
        uint32_t f[4];
        ldsm_x4_t<kOffAT + np * 32>(f, k_t);
        mma_16816(dq_t[2 * np], dsa, f[0], f[1]);
        mma_16816(dq_t[2 * np], dsb, f[0], f[1]);
        mma_16816(dq_t[2 * np + 1], dsa, f[2], f[3]);
        mma_16816(dq_t[2 * np + 1], dsb, f[2], f[3]);
      });
      uint32_t f[4];
      ldsm_x4_t<kOffAL>(f, st + off_a_l + kk * 16 * kStrL * 2);
      mma_16816(dq_l[0], dsa, f[0], f[1]);
      mma_16816(dq_l[0], dsb, f[0], f[1]);
      mma_16816(dq_l[1], dsa, f[2], f[3]);
      mma_16816(dq_l[1], dsb, f[2], f[3]);
    }
  }
  store_rows<kDT>(p.grad[0], p, b, h, q0 + warp * 16, g, t, dq_t, p.scale_t);
  store_rows<kDL>(p.grad[3], p, b, h, q0 + warp * 16, g, t, dq_l, p.scale_l);
}

biacm::FwdParams make_params(const uint64_t* ptrs, const int64_t* strides,
                             int nh, int L, float scale_t, float scale_l,
                             int mode, uint32_t seed_lo, uint32_t seed_hi,
                             uint32_t thr, float inv_keep) {
  biacm::FwdParams p = {};
  for (int i = 0; i < 6; ++i) {
    p.in[i] = reinterpret_cast<const __nv_bfloat16*>(ptrs[i]);
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.bias = reinterpret_cast<const float*>(ptrs[6]);
  p.bias_stride = strides[18];
  p.drop.bits[0] = reinterpret_cast<const uint32_t*>(ptrs[7]);
  p.drop.bits[1] = reinterpret_cast<const uint32_t*>(ptrs[8]);
  p.drop.seed = reinterpret_cast<const unsigned long long*>(ptrs[7]);
  p.stats = reinterpret_cast<float2*>(ptrs[9]);
  p.keep = reinterpret_cast<uint32_t*>(ptrs[10]);
  p.nh = nh;
  p.L = L;
  p.scale_t = scale_t;
  p.scale_l = scale_l;
  p.drop.mode = mode;
  p.drop.seed_lo = seed_lo;
  p.drop.seed_hi = seed_hi;
  p.drop.thr = thr;
  p.drop.inv_keep = inv_keep;
  return p;
}

// The kernels of this library, in the order of biacm_train_occupancy.
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
    case kFwdDropout: return apply(biacm_train_fwd_kernel<true>);
    case kFwdPlain: return apply(biacm_train_fwd_kernel<false>);
    case kDq: return apply(biacm_train_dq_kernel);
    case kDkDv: return apply(biacm_train_dkdv_kernel);
    default: return apply(biacm_keep_mask_kernel);
  }
}

}  // namespace

extern "C" {

// Launchers: on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets. Shared layout of `ptrs` (device pointers
// as uint64): [0..5] q_t, k_t, v_t, q_l, k_l, v_l (bf16), [6] bias (fp32
// (B, L)), [7..8] explicit bits (uint32 (B, nh, L, L) contiguous, or 0;
// the forward only; in mode 3 [7] is the int64 key), [9] the row statistics (fp32 (B, nh, L, 2)), [10] the
// packed keep flags (uint32 (2, B, nh, L, ceil(L / 32)), or 0 without
// dropout). `strides` (int64 elements): [0..17] (batch, head, seq) of the
// six inputs, [18] the batch stride of bias. `mode`: 0 no dropout, 1
// Philox bits from (seed_lo, seed_hi), 2 the explicit bits, 3 Philox bits
// from the int64 key at ptrs[7] (read on the card at launch time: a CUDA
// graph replays it with the key's current value); the backward reads only
// whether it is 0. Each returns the first nonzero cudaError_t
// of its calls (0 = launched).

// Forward: ptrs[11..12] = ct (B, L, nh, 64), cl (B, L, nh, 16), written
// with the statistics; with dropout, the mask kernel first writes the keep
// flags the forward then reads.
int biacm_train_fwd(const uint64_t* ptrs, const int64_t* strides, int B,
                    int nh, int L, float scale_t, float scale_l, int mode,
                    uint32_t seed_lo, uint32_t seed_hi, uint32_t thr,
                    float inv_keep, void* stream) {
  biacm::FwdParams p = make_params(ptrs, strides, nh, L, scale_t, scale_l,
                                   mode, seed_lo, seed_hi, thr, inv_keep);
  p.out[0] = reinterpret_cast<__nv_bfloat16*>(ptrs[11]);
  p.out[1] = reinterpret_cast<__nv_bfloat16*>(ptrs[12]);
  const bool plain = mode == biacm::kNoDropout;
  cudaError_t err = configure(plain ? kFwdPlain : kFwdDropout, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plain) {
    biacm_train_fwd_kernel<false><<<grid, kThreads, kSmemBytes, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const int words = (L + 31) / 32;
  dim3 mask_grid((L * words + kThreads - 1) / kThreads, nh, B);
  biacm_keep_mask_kernel<<<mask_grid, kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  biacm_train_fwd_kernel<true><<<grid, kThreads, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward (the dq kernel, which also writes D, then the dk/dv kernel):
// ptrs[11..12] dct, dcl; [13] the fp32 (B, nh, L) scratch for D;
// [14..19] dq_t, dk_t, dv_t, dq_l, dk_l, dv_l (B, L, nh, d).
// strides[19..24]: (batch, head, seq) of dct, dcl.
int biacm_train_bwd(const uint64_t* ptrs, const int64_t* strides, int B,
                    int nh, int L, float scale_t, float scale_l, int mode,
                    uint32_t seed_lo, uint32_t seed_hi, uint32_t thr,
                    float inv_keep, void* stream) {
  BwdParams p{};
  static_cast<biacm::FwdParams&>(p) = make_params(
      ptrs, strides, nh, L, scale_t, scale_l, mode, seed_lo, seed_hi, thr,
      inv_keep);
  for (int i = 0; i < 2; ++i) {
    p.dout[i] = reinterpret_cast<const __nv_bfloat16*>(ptrs[11 + i]);
    for (int j = 0; j < 3; ++j) p.dstride[i][j] = strides[19 + 3 * i + j];
  }
  p.delta = reinterpret_cast<float*>(ptrs[13]);
  for (int i = 0; i < 6; ++i)
    p.grad[i] = reinterpret_cast<__nv_bfloat16*>(ptrs[14 + i]);
  cudaError_t err = configure(kDq, nullptr);
  if (err == cudaSuccess) err = configure(kDkDv, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  biacm_train_dq_kernel<<<grid, kThreads, kSmemBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  biacm_train_dkdv_kernel<<<grid, kThreads, kKvSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What cudaOccupancyMaxActiveBlocksPerMultiprocessor grants kernel `which`
// (0 the forward with dropout, 1 without, 2 dq, 3 dk/dv, 4 the mask
// kernel) on the current device: resident CTAs per SM, or minus the
// cudaError_t. `smem_bytes` receives the kernel's dynamic shared memory.
int biacm_train_occupancy(int which, int* smem_bytes) {
  if (which < kFwdDropout || which > kMask) return -1;
  *smem_bytes = shared_memory_of(which);
  int blocks = 0;
  cudaError_t err = configure(which, nullptr);
  if (err == cudaSuccess) err = configure(which, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* biacm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
