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
// Dropout bits. keep_s = bits_s < thr, thr = min(round((1−r)·2³²), 2³²−1),
// as on the TPU. In-kernel, the bits are Philox4x32-10 (Salmon et al.,
// SC'11; the Random123 round and key schedule) of the counter
// (j, i, h, b) under the key (seed_lo, seed_hi): output word 0 is stream 1
// (text), word 1 stream 2 (layout). They are a pure function of
// (seed, b, h, i, j, stream), so the forward, both backward kernels and a
// checkpoint recompute draw the same masks whatever their tiling (the TPU's
// depend on the tile). ops/biacm_attention.py:attention_dropout_bits
// computes the same bits with torch integer ops. The kernels also take the
// bits as two explicit uint32 (B, nh, L, L) tensors.
//
// What bounds it on the H100: at the training shape (B=8, nh=12, L=512)
// the forward does 4·B·nh·L²·80 = 8.1 GFLOP on ~32 MB, about 250 FLOP per
// byte, so bytes (~9.5 µs) and tensor-core time (~8.1 µs) are close; the
// backward's 5·2·B·nh·L²·80 = 20 GFLOP (~20 µs) bound it by operations.
// On top come the Philox rounds: one 10-round draw per (i, j) in the
// forward and three more in the backward (both sweeps of dq, and dk/dv),
// integer work the bounds do not count, and the dq kernel's first sweep
// recomputes the scores and dP once more to sum D. The design keeps the
// (L, L) scores, probabilities and masks out of device memory entirely
// (the plain version writes several fp32 (B, nh, L, L) tensors),
// accumulates dk/dv in registers, and runs every product on the tensor
// cores (mma.sync m16n8k16 bf16 → fp32). Simple first version: no TMA, no
// wgmma, no software pipelining.
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
// - dq: one CTA per (64-query tile, h, b). A first sweep over the key
//   tiles recomputes p from the statistics and dP, and sums D; a second
//   computes dS and accumulates dq. It writes D for the dk/dv kernel.
// - dk/dv: one CTA per (64-key tile, h, b), each warp owning 16 keys; it
//   loops over the query tiles, recomputes pᵀ from the statistics,
//   regenerates the bits of each (i, j), and accumulates dv_t, dv_l, dk_t,
//   dk_l in fp32 registers; written once, in bf16. No atomics: both
//   kernels are deterministic run to run.
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

using biacm::kDL;
using biacm::kDT;
using biacm::kNoDropout;
using biacm::kStrL;
using biacm::kStrT;
using biacm::kStrX;
using biacm::kThreads;
using biacm::kTile;
using biacm::lds32;
using biacm::load_a;
using biacm::load_rows;
using biacm::load_rows_t;
using biacm::mma_16816;
using biacm::pack_a;
using biacm::pack_a_split;
using biacm::rows;

// The backward's parameters: the forward's (inputs, bias, row statistics,
// dropout) plus the output gradients, D and the six input gradients.
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

// ---------------------------------------------------------------- forward
// kernel #2: the shared forward body (biacm_common.cuh) with the row
// statistics, and with the dropout masks unless the rate is 0
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
biacm_train_fwd_kernel(const biacm::FwdParams p) {
  biacm::forward_tile<kDropout, true>(p);
}

// ------------------------------------------------------------- dk / dv
__global__ void __launch_bounds__(kThreads)
biacm_train_dkdv_kernel(const BwdParams p) {
  // per query tile: q and dO as rows (B operands of the scores) and
  // transposed (B operands of dk, dv), plus the rows' statistics
  __shared__ __align__(16) __nv_bfloat16 s_q_t[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_q_l[kTile * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_qx_t[kDT * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_qx_l[kDL * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_d_t[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_d_l[kTile * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_dx_t[kDT * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_dx_l[kDL * kStrX];
  __shared__ float s_m[kTile], s_lg[kTile], s_delta[kTile];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, +8

  // K and V of this key tile → A fragments in registers (staged through
  // the q / dO buffers before the loop reuses them)
  load_rows<kDT, kStrT>(s_q_t, rows(p, 1, b, h, k0), p.stride[1][2], L - k0);
  load_rows<kDL, kStrL>(s_q_l, rows(p, 4, b, h, k0), p.stride[4][2], L - k0);
  load_rows<kDT, kStrT>(s_d_t, rows(p, 2, b, h, k0), p.stride[2][2], L - k0);
  load_rows<kDL, kStrL>(s_d_l, rows(p, 5, b, h, k0), p.stride[5][2], L - k0);
  __syncthreads();
  uint32_t ka_t[kDT / 16][4], ka_l[4], va_t[kDT / 16][4], va_l[4];
#pragma unroll
  for (int kk = 0; kk < kDT / 16; ++kk) {
    load_a<kStrT>(ka_t[kk], s_q_t, warp * 16, kk * 16, g, t);
    load_a<kStrT>(va_t[kk], s_d_t, warp * 16, kk * 16, g, t);
  }
  load_a<kStrL>(ka_l, s_q_l, warp * 16, 0, g, t);
  load_a<kStrL>(va_l, s_d_l, warp * 16, 0, g, t);
  const float* bias_row = p.bias + b * p.bias_stride;
  const float key_bias[2] = {key_a < L ? bias_row[key_a] : -INFINITY,
                             key_a + 8 < L ? bias_row[key_a + 8] : -INFINITY};

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

  const int64_t stat0 = (static_cast<int64_t>(b) * p.nh + h) * L;
  for (int q0 = 0; q0 < L; q0 += kTile) {
    const int qv = L - q0;
    __syncthreads();
    load_rows<kDT, kStrT>(s_q_t, rows(p, 0, b, h, q0), p.stride[0][2], qv);
    load_rows<kDL, kStrL>(s_q_l, rows(p, 3, b, h, q0), p.stride[3][2], qv);
    load_rows_t<kDT>(s_qx_t, rows(p, 0, b, h, q0), p.stride[0][2], qv);
    load_rows_t<kDL>(s_qx_l, rows(p, 3, b, h, q0), p.stride[3][2], qv);
    load_rows<kDT, kStrT>(s_d_t, drows(p, 0, b, h, q0), p.dstride[0][2], qv);
    load_rows<kDL, kStrL>(s_d_l, drows(p, 1, b, h, q0), p.dstride[1][2], qv);
    load_rows_t<kDT>(s_dx_t, drows(p, 0, b, h, q0), p.dstride[0][2], qv);
    load_rows_t<kDL>(s_dx_l, drows(p, 1, b, h, q0), p.dstride[1][2], qv);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = i < qv;
      const float2 st = ok ? p.stats[stat0 + q0 + i] : make_float2(0.f, 0.f);
      s_m[i] = ok ? st.x : INFINITY;  // p = 0 for query rows past L
      s_lg[i] = st.y;
      s_delta[i] = ok ? p.delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int nn = 0; nn < kTile / 16; ++nn) {  // 16 queries per step
      float e1[2][4], e2[2][4], ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qc = nn * 16 + half * 8;  // this n-tile's first query
        float st[4] = {0.f, 0.f, 0.f, 0.f}, sl[4] = {0.f, 0.f, 0.f, 0.f};
        float g1[4] = {0.f, 0.f, 0.f, 0.f}, g2[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* qr = s_q_t + (qc + g) * kStrT + t * 2;
        const __nv_bfloat16* dr = s_d_t + (qc + g) * kStrT + t * 2;
#pragma unroll
        for (int kk = 0; kk < kDT / 16; ++kk) {
          mma_16816(st, ka_t[kk], lds32(qr + kk * 16), lds32(qr + kk * 16 + 8));
          mma_16816(g1, va_t[kk], lds32(dr + kk * 16), lds32(dr + kk * 16 + 8));
        }
        const __nv_bfloat16* qlr = s_q_l + (qc + g) * kStrL + t * 2;
        const __nv_bfloat16* dlr = s_d_l + (qc + g) * kStrL + t * 2;
        mma_16816(sl, ka_l, lds32(qlr), lds32(qlr + 8));
        mma_16816(g2, va_l, lds32(dlr), lds32(dlr + 8));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kr = q >> 1;                 // key row g or g+8
          const int qi = qc + t * 2 + (q & 1);   // query within the tile
          const float sv = st[q] * p.scale_t + sl[q] * p.scale_l
                           + key_bias[kr];
          const float pv = __expf((sv - s_m[qi]) - s_lg[qi]);
          float dp;
          if (p.drop.mode == kNoDropout) {
            e1[half][q] = e2[half][q] = pv;
            dp = g1[q] + g2[q];
          } else {
            const int key = key_a + kr * 8, query = q0 + qi;
            bool k1 = false, k2 = false;
            if (key < L && query < L)
              biacm::keep_flags(p.drop, p.nh, L, b, h, query, key, k1, k2);
            e1[half][q] = k1 ? pv * p.drop.inv_keep : 0.f;
            e2[half][q] = k2 ? pv * p.drop.inv_keep : 0.f;
            dp = (k1 ? g1[q] * p.drop.inv_keep : 0.f)
                 + (k2 ? g2[q] * p.drop.inv_keep : 0.f);
          }
          ds[half][q] = pv * (dp - s_delta[qi]);
        }
      }
      uint32_t pa1[4], pa2[4], dsa[4], dsb[4];
      pack_a(pa1, e1);
      pack_a(pa2, e2);
      pack_a_split(dsa, dsb, ds);
#pragma unroll
      for (int n = 0; n < kDT / 8; ++n) {
        const int off = (n * 8 + g) * kStrX + nn * 16 + t * 2;
        mma_16816(dv_t[n], pa1, lds32(s_dx_t + off), lds32(s_dx_t + off + 8));
        mma_16816(dk_t[n], dsa, lds32(s_qx_t + off), lds32(s_qx_t + off + 8));
        mma_16816(dk_t[n], dsb, lds32(s_qx_t + off), lds32(s_qx_t + off + 8));
      }
#pragma unroll
      for (int n = 0; n < kDL / 8; ++n) {
        const int off = (n * 8 + g) * kStrX + nn * 16 + t * 2;
        mma_16816(dv_l[n], pa2, lds32(s_dx_l + off), lds32(s_dx_l + off + 8));
        mma_16816(dk_l[n], dsa, lds32(s_qx_l + off), lds32(s_qx_l + off + 8));
        mma_16816(dk_l[n], dsb, lds32(s_qx_l + off), lds32(s_qx_l + off + 8));
      }
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
// kernel, the second accumulates dq = dS·k with dS = p ⊙ (dP − D).
__global__ void __launch_bounds__(kThreads)
biacm_train_dq_kernel(const BwdParams p) {
  __shared__ __align__(16) __nv_bfloat16 s_k_t[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_k_l[kTile * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_kx_t[kDT * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_kx_l[kDL * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_v_t[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_v_l[kTile * kStrL];
  __shared__ float s_bias[kTile];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;

  // q and dO of this query tile → A fragments (staged through the K/V
  // buffers before the key loop reuses them)
  load_rows<kDT, kStrT>(s_k_t, rows(p, 0, b, h, q0), p.stride[0][2], L - q0);
  load_rows<kDL, kStrL>(s_k_l, rows(p, 3, b, h, q0), p.stride[3][2], L - q0);
  load_rows<kDT, kStrT>(s_v_t, drows(p, 0, b, h, q0), p.dstride[0][2],
                        L - q0);
  load_rows<kDL, kStrL>(s_v_l, drows(p, 1, b, h, q0), p.dstride[1][2],
                        L - q0);
  __syncthreads();
  uint32_t qa_t[kDT / 16][4], qa_l[4], da_t[kDT / 16][4], da_l[4];
#pragma unroll
  for (int kk = 0; kk < kDT / 16; ++kk) {
    load_a<kStrT>(qa_t[kk], s_k_t, warp * 16, kk * 16, g, t);
    load_a<kStrT>(da_t[kk], s_v_t, warp * 16, kk * 16, g, t);
  }
  load_a<kStrL>(qa_l, s_k_l, warp * 16, 0, g, t);
  load_a<kStrL>(da_l, s_v_l, warp * 16, 0, g, t);

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
  const float* bias_row = p.bias + b * p.bias_stride;

  // K, V (and, for dq, the transposed K) of the key tile at k0
  auto load_keys = [&](int k0, bool transposed) {
    const int kv = L - k0;
    __syncthreads();
    load_rows<kDT, kStrT>(s_k_t, rows(p, 1, b, h, k0), p.stride[1][2], kv);
    load_rows<kDL, kStrL>(s_k_l, rows(p, 4, b, h, k0), p.stride[4][2], kv);
    if (transposed) {
      load_rows_t<kDT>(s_kx_t, rows(p, 1, b, h, k0), p.stride[1][2], kv);
      load_rows_t<kDL>(s_kx_l, rows(p, 4, b, h, k0), p.stride[4][2], kv);
    }
    load_rows<kDT, kStrT>(s_v_t, rows(p, 2, b, h, k0), p.stride[2][2], kv);
    load_rows<kDL, kStrL>(s_v_l, rows(p, 5, b, h, k0), p.stride[5][2], kv);
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      s_bias[j] = j < kv ? bias_row[k0 + j] : -INFINITY;
    __syncthreads();
  };
  // p and dP of this warp's rows at keys kc .. kc+7 of the tile at k0 (C
  // fragments)
  auto p_dp = [&](int k0, int kc, float* pv, float* dp) {
    float st[4] = {0.f, 0.f, 0.f, 0.f}, sl[4] = {0.f, 0.f, 0.f, 0.f};
    float g1[4] = {0.f, 0.f, 0.f, 0.f}, g2[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* kr = s_k_t + (kc + g) * kStrT + t * 2;
    const __nv_bfloat16* vr = s_v_t + (kc + g) * kStrT + t * 2;
#pragma unroll
    for (int d = 0; d < kDT / 16; ++d) {
      mma_16816(st, qa_t[d], lds32(kr + d * 16), lds32(kr + d * 16 + 8));
      mma_16816(g1, da_t[d], lds32(vr + d * 16), lds32(vr + d * 16 + 8));
    }
    const __nv_bfloat16* klr = s_k_l + (kc + g) * kStrL + t * 2;
    const __nv_bfloat16* vlr = s_v_l + (kc + g) * kStrL + t * 2;
    mma_16816(sl, qa_l, lds32(klr), lds32(klr + 8));
    mma_16816(g2, da_l, lds32(vlr), lds32(vlr + 8));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q >> 1;
      const int kj = kc + t * 2 + (q & 1);  // key within the tile
      const float sv = st[q] * p.scale_t + sl[q] * p.scale_l + s_bias[kj];
      pv[q] = __expf((sv - row_m[r]) - row_lg[r]);
      if (p.drop.mode == kNoDropout) {
        dp[q] = g1[q] + g2[q];
      } else {
        const int row = row_a + r * 8, key = k0 + kj;
        bool k1 = false, k2 = false;
        if (row < L && key < L)
          biacm::keep_flags(p.drop, p.nh, L, b, h, row, key, k1, k2);
        dp[q] = (k1 ? g1[q] * p.drop.inv_keep : 0.f)
                + (k2 ? g2[q] * p.drop.inv_keep : 0.f);
      }
    }
  };

  // sweep 1: D
  float row_d[2] = {0.f, 0.f};  // this thread's partial row sums
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_keys(k0, false);
#pragma unroll
    for (int kc = 0; kc < kTile; kc += 8) {
      float pv[4], dp[4];
      p_dp(k0, kc, pv, dp);
      row_d[0] += pv[0] * dp[0] + pv[1] * dp[1];
      row_d[1] += pv[2] * dp[2] + pv[3] * dp[3];
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
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_keys(k0, true);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys per step
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float pv[4], dp[4];
        p_dp(k0, kk * 16 + half * 8, pv, dp);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ds[half][q] = pv[q] * (dp[q] - row_d[q >> 1]);
      }
      uint32_t dsa[4], dsb[4];
      pack_a_split(dsa, dsb, ds);
#pragma unroll
      for (int n = 0; n < kDT / 8; ++n) {
        const int off = (n * 8 + g) * kStrX + kk * 16 + t * 2;
        mma_16816(dq_t[n], dsa, lds32(s_kx_t + off), lds32(s_kx_t + off + 8));
        mma_16816(dq_t[n], dsb, lds32(s_kx_t + off), lds32(s_kx_t + off + 8));
      }
#pragma unroll
      for (int n = 0; n < kDL / 8; ++n) {
        const int off = (n * 8 + g) * kStrX + kk * 16 + t * 2;
        mma_16816(dq_l[n], dsa, lds32(s_kx_l + off), lds32(s_kx_l + off + 8));
        mma_16816(dq_l[n], dsb, lds32(s_kx_l + off), lds32(s_kx_l + off + 8));
      }
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
  p.stats = reinterpret_cast<float2*>(ptrs[9]);
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

}  // namespace

extern "C" {

// Launchers: on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets. Shared layout of `ptrs` (device pointers
// as uint64): [0..5] q_t, k_t, v_t, q_l, k_l, v_l (bf16), [6] bias (fp32
// (B, L)), [7..8] explicit bits (uint32 (B, nh, L, L) contiguous, or 0),
// [9] the row statistics (fp32 (B, nh, L, 2)). `strides` (int64 elements):
// [0..17] (batch, head, seq) of the six inputs, [18] the batch stride of
// bias. `mode`: 0 no dropout, 1 Philox bits from (seed_lo, seed_hi), 2 the
// explicit bits. Each returns the first nonzero cudaError_t of its
// launches (0 = launched).

// Forward: ptrs[10..11] = ct (B, L, nh, 64), cl (B, L, nh, 16), written
// with the statistics.
int biacm_train_fwd(const uint64_t* ptrs, const int64_t* strides, int B,
                    int nh, int L, float scale_t, float scale_l, int mode,
                    uint32_t seed_lo, uint32_t seed_hi, uint32_t thr,
                    float inv_keep, void* stream) {
  biacm::FwdParams p = make_params(ptrs, strides, nh, L, scale_t, scale_l,
                                   mode, seed_lo, seed_hi, thr, inv_keep);
  p.out[0] = reinterpret_cast<__nv_bfloat16*>(ptrs[10]);
  p.out[1] = reinterpret_cast<__nv_bfloat16*>(ptrs[11]);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == biacm::kNoDropout)
    biacm_train_fwd_kernel<false><<<grid, kThreads, 0, s>>>(p);
  else
    biacm_train_fwd_kernel<true><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward (the dq kernel, which also writes D, then the dk/dv kernel):
// ptrs[10..11] dct, dcl; [12] the fp32 (B, nh, L) scratch for D;
// [13..18] dq_t, dk_t, dv_t, dq_l, dk_l, dv_l (B, L, nh, d).
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
    p.dout[i] = reinterpret_cast<const __nv_bfloat16*>(ptrs[10 + i]);
    for (int j = 0; j < 3; ++j) p.dstride[i][j] = strides[19 + 3 * i + j];
  }
  p.delta = reinterpret_cast<float*>(ptrs[12]);
  for (int i = 0; i < 6; ++i)
    p.grad[i] = reinterpret_cast<__nv_bfloat16*>(ptrs[13 + i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  biacm_train_dq_kernel<<<grid, kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  biacm_train_dkdv_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* biacm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
