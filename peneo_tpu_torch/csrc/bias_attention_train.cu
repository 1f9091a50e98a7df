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
// Dropout bits: keep = bits < thr, thr = min(round((1−r)·2³²), 2³²−1), as
// on the TPU. In-kernel, the bits are word 0 of Philox4x32-10 of the
// counter (j, i, h, b) under the key (seed_lo, seed_hi), one draw per
// element (one mask). They are a pure function of (seed, b, h, i, j), so
// the forward, both backward kernels and a checkpoint recompute draw the
// same mask whatever their tiling.
// ops/biacm_attention.py:element_dropout_bits computes the same bits with
// torch integer ops. The kernels also take the bits as an explicit uint32
// (B, nh, L, L) tensor.
//
// What bounds it on the H100: bytes. At the training shape (B=8, nh=12,
// L=709) the forward reads 193 MB of bias against 35 MB of q/k/v/out
// (~0.068 ms at 3.35 TB/s; its 12 GFLOP are ~0.012 ms). The backward must
// read the bias once and write dbias once (193 MB each) beside ~61 MB of
// q/k/v/dc/dq/dk/dv: 447 MB, ~0.133 ms, against 31 GFLOP (~0.031 ms). This
// design reads the bias three times (both sweeps of the dq kernel, and the
// dk/dv kernel) and writes dbias once; the (L, L) scores, probabilities
// and masks never reach device memory (the plain version writes several
// fp32 (B, nh, L, L) tensors), dk/dv accumulate in registers, every product
// runs on the tensor cores (mma.sync m16n8k16 bf16 → fp32). Simple first
// version: no TMA, no wgmma, no software pipelining.
//
// Design (FlashAttention-2 layout; the TPU kernels hold a (b, h)'s full K/V
// rows and a (TQ, L) fp32 tile in VMEM, recompute whole rows instead of
// saving statistics, and build dk/dv across a sequential grid axis, none of
// which fits Hopper's unordered CTAs):
// - forward: kernel #4's body (relbias::forward_tile of bias_common.cuh)
//   instantiated with the row statistics (max m, log of the sum l), fp32
//   (B, nh, L, 2), and with the mask on the un-normalised p unless the rate
//   is 0. The backward recomputes p = exp((s − m) − log l).
// - dq: one CTA per (64-query tile, h, b). A first sweep over the key tiles
//   recomputes p and dP and sums D; a second forms dS, puts it in place of
//   the staged bias tile in shared memory, writes that tile to dbias
//   coalesced along the key axis, and accumulates dq. Each dbias element is
//   written exactly once, by this kernel. It also writes D for the dk/dv
//   kernel.
// - dk/dv: one CTA per (64-key tile, h, b), each warp owning 16 keys; it
//   loops over the query tiles, recomputes pᵀ from the statistics (reading
//   its bias elements straight from device memory into registers, 8
//   consecutive keys per row and quad-row, ahead of the tile's
//   shared-memory loads), regenerates the bits of each (i, j), and
//   accumulates dv and dk in fp32 registers; written once, in bf16. No
//   atomics: both kernels are deterministic run to run.
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
using relbias::bias_at;
using relbias::kD;
using relbias::kStrB;
using relbias::kStrT;
using relbias::kStrX;
using relbias::kThreads;
using relbias::kTile;
using relbias::lds32;
using relbias::load_a;
using relbias::load_rows;
using relbias::load_rows_t;
using relbias::mma_16816;
using relbias::pack_a;
using relbias::rows;
using relbias::score;

// The backward's parameters: the forward's (inputs, bias, mask, row
// statistics, dropout) plus the output gradient, D and the gradients.
struct BwdParams : relbias::FwdParams {
  const __nv_bfloat16* dout;             // dc
  int64_t dstride[3];
  __nv_bfloat16* grad[3];                // dq, dk, dv (B, L, nh, 64)
  float* dbias;                          // (B, nh, L, L) contiguous
  float* delta;                          // (B, nh, L): D, from the dq kernel
};

__device__ __forceinline__ const __nv_bfloat16* drows(const BwdParams& p,
                                                      int b, int h, int r0) {
  return p.dout + b * p.dstride[0] + h * p.dstride[1]
         + static_cast<int64_t>(r0) * p.dstride[2];
}

__device__ __forceinline__ void store_grad(__nv_bfloat16* o,
                                           const BwdParams& p, int b, int h,
                                           int row0, int g, int t,
                                           const float (*acc)[4], float sc) {
  biacm::store_rows<kD>(o, p.nh, p.L, b, h, row0, g, t, acc, sc, sc);
}

// ---------------------------------------------------------------- forward
// kernel #5: the shared forward body (bias_common.cuh) with the row
// statistics, and with the dropout mask unless the rate is 0
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
bias_train_fwd_kernel(const relbias::FwdParams p) {
  relbias::forward_tile<kDropout, true>(p);
}

// ------------------------------------------------------------- dk / dv
__global__ void __launch_bounds__(kThreads)
bias_train_dkdv_kernel(const BwdParams p) {
  // per query tile: q and dO as rows (B operands of the scores and of dP)
  // and transposed (B operands of dk, dv), plus the rows' statistics
  __shared__ __align__(16) __nv_bfloat16 s_q[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_qx[kD * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_d[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_dx[kD * kStrX];
  __shared__ float s_m[kTile], s_lg[kTile], s_delta[kTile];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, +8

  // K and V of this key tile → A fragments in registers (staged through
  // the q / dO buffers before the loop reuses them)
  load_rows<kD, kStrT>(s_q, rows(p, 1, b, h, k0), p.stride[1][2], L - k0);
  load_rows<kD, kStrT>(s_d, rows(p, 2, b, h, k0), p.stride[2][2], L - k0);
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a<kStrT>(ka[kk], s_q, warp * 16, kk * 16, g, t);
    load_a<kStrT>(va[kk], s_d, warp * 16, kk * 16, g, t);
  }
  const float* mask_row = p.mask + b * p.mask_stride;
  const bool key_ok[2] = {key_a < L, key_a + 8 < L};
  const float key_mask[2] = {key_ok[0] ? mask_row[key_a] : 0.f,
                             key_ok[1] ? mask_row[key_a + 8] : 0.f};
  // this thread's bias column: element (query i, key key_a) is bias_col[i·rs]
  const float* bias_col = bias_at(p, b, h, 0, key_a);
  const int64_t rs = p.bias_stride[2];

  float dv[kD / 8][4], dk[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) dv[n][q] = dk[n][q] = 0.f;

  const int64_t stat0 = (static_cast<int64_t>(b) * p.nh + h) * L;
  for (int q0 = 0; q0 < L; q0 += kTile) {
    const int qv = L - q0;
    // this thread's 2 x 32 bias elements of the tile, asked for before the
    // shared-memory loads so that their latency overlaps them: bv[kr][i]
    // is (query q0 + qi(i), key key_a + 8·kr), qi(i) = 8·(i/2) + 2t + i%2
    float bv[2][kTile / 2];
#pragma unroll
    for (int kr = 0; kr < 2; ++kr)
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        const int query = q0 + (i >> 1) * 8 + t * 2 + (i & 1);
        bv[kr][i] = key_ok[kr] && query < L
            ? bias_col[query * rs + kr * 8] : 0.f;
      }
    __syncthreads();
    load_rows<kD, kStrT>(s_q, rows(p, 0, b, h, q0), p.stride[0][2], qv);
    load_rows_t<kD>(s_qx, rows(p, 0, b, h, q0), p.stride[0][2], qv);
    load_rows<kD, kStrT>(s_d, drows(p, b, h, q0), p.dstride[2], qv);
    load_rows_t<kD>(s_dx, drows(p, b, h, q0), p.dstride[2], qv);
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
      float e[2][4], ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qc = nn * 16 + half * 8;  // this n-tile's first query
        float st[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* qr = s_q + (qc + g) * kStrT + t * 2;
        const __nv_bfloat16* dr = s_d + (qc + g) * kStrT + t * 2;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          mma_16816(st, ka[kk], lds32(qr + kk * 16), lds32(qr + kk * 16 + 8));
          mma_16816(g1, va[kk], lds32(dr + kk * 16), lds32(dr + kk * 16 + 8));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kr = q >> 1;                 // key row g or g+8
          const int qi = qc + t * 2 + (q & 1);   // query within the tile
          const int query = q0 + qi;
          const bool ok = key_ok[kr] && query < L;
          const float sv = score(st[q], p.scale,
                                 bv[kr][(nn * 2 + half) * 2 + (q & 1)],
                                 key_mask[kr], ok);
          const float pv = __expf((sv - s_m[qi]) - s_lg[qi]);
          float dp;
          if (p.drop.mode == kNoDropout) {
            e[half][q] = pv;
            dp = g1[q];
          } else {
            const bool keep = ok && relbias::keep_flag(
                p.drop, p.nh, L, b, h, query, key_a + kr * 8);
            e[half][q] = keep ? pv * p.drop.inv_keep : 0.f;
            dp = keep ? g1[q] * p.drop.inv_keep : 0.f;
          }
          ds[half][q] = pv * (dp - s_delta[qi]);
        }
      }
      uint32_t pa[4], dsa[4], dsb[4];
      pack_a(pa, e);
      pack_a_split(dsa, dsb, ds);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int off = (n * 8 + g) * kStrX + nn * 16 + t * 2;
        mma_16816(dv[n], pa, lds32(s_dx + off), lds32(s_dx + off + 8));
        mma_16816(dk[n], dsa, lds32(s_qx + off), lds32(s_qx + off + 8));
        mma_16816(dk[n], dsb, lds32(s_qx + off), lds32(s_qx + off + 8));
      }
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
// accumulates dq = dS·k.
__global__ void __launch_bounds__(kThreads)
bias_train_dq_kernel(const BwdParams p) {
  __shared__ __align__(16) __nv_bfloat16 s_k[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_kx[kD * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_v[kTile * kStrT];
  __shared__ __align__(16) float s_bias[kTile * kStrB];
  __shared__ float s_mask[kTile];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;

  // q and dO of this query tile → A fragments (staged through the K/V
  // buffers before the key loop reuses them)
  load_rows<kD, kStrT>(s_k, rows(p, 0, b, h, q0), p.stride[0][2], L - q0);
  load_rows<kD, kStrT>(s_v, drows(p, b, h, q0), p.dstride[2], L - q0);
  __syncthreads();
  uint32_t qa[kD / 16][4], da[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a<kStrT>(qa[kk], s_k, warp * 16, kk * 16, g, t);
    load_a<kStrT>(da[kk], s_v, warp * 16, kk * 16, g, t);
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

  // K, V, the bias tile and the mask (and, for dq, the transposed K) of
  // the key tile at k0
  auto load_keys = [&](int k0, bool transposed) {
    const int kv = L - k0;
    __syncthreads();
    load_rows<kD, kStrT>(s_k, rows(p, 1, b, h, k0), p.stride[1][2], kv);
    if (transposed)
      load_rows_t<kD>(s_kx, rows(p, 1, b, h, k0), p.stride[1][2], kv);
    load_rows<kD, kStrT>(s_v, rows(p, 2, b, h, k0), p.stride[2][2], kv);
    relbias::load_bias_tile(s_bias, bias_at(p, b, h, q0, k0),
                            p.bias_stride[2], L - q0, kv);
    relbias::load_mask_tile(s_mask, p, b, k0);
    __syncthreads();
  };
  // p and dP of this warp's rows at keys kc .. kc+7 of the tile at k0 (C
  // fragments)
  auto p_dp = [&](int k0, int kc, float* pv, float* dp) {
    float st[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* kr = s_k + (kc + g) * kStrT + t * 2;
    const __nv_bfloat16* vr = s_v + (kc + g) * kStrT + t * 2;
#pragma unroll
    for (int d = 0; d < kD / 16; ++d) {
      mma_16816(st, qa[d], lds32(kr + d * 16), lds32(kr + d * 16 + 8));
      mma_16816(g1, da[d], lds32(vr + d * 16), lds32(vr + d * 16 + 8));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q >> 1;
      const int kj = kc + t * 2 + (q & 1);  // key within the tile
      const float bv = s_bias[(warp * 16 + g + r * 8) * kStrB + kj];
      const float sv = score(st[q], p.scale, bv, s_mask[kj], k0 + kj < L);
      pv[q] = __expf((sv - row_m[r]) - row_lg[r]);
      if (p.drop.mode == kNoDropout) {
        dp[q] = g1[q];
      } else {
        const int row = row_a + r * 8, key = k0 + kj;
        const bool keep = row < L && key < L
            && relbias::keep_flag(p.drop, p.nh, L, b, h, row, key);
        dp[q] = keep ? g1[q] * p.drop.inv_keep : 0.f;
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

  // sweep 2: dS → dbias, dq
  float dq[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_keys(k0, true);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys per step
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kc = kk * 16 + half * 8;
        float pv[4], dp[4];
        p_dp(k0, kc, pv, dp);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ds[half][q] = pv[q] * (dp[q] - row_d[q >> 1]);
          // dS takes the place of the bias element this thread just read
          s_bias[(warp * 16 + g + (q >> 1) * 8) * kStrB + kc + t * 2
                 + (q & 1)] = ds[half][q];
        }
      }
      uint32_t dsa[4], dsb[4];
      pack_a_split(dsa, dsb, ds);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int off = (n * 8 + g) * kStrX + kk * 16 + t * 2;
        mma_16816(dq[n], dsa, lds32(s_kx + off), lds32(s_kx + off + 8));
        mma_16816(dq[n], dsb, lds32(s_kx + off), lds32(s_kx + off + 8));
      }
    }
    // the dS tile → dbias, a warp writing 32 consecutive floats of one row
    __syncthreads();
    float* out = p.dbias + ((stat0 + q0) * L + k0);
    const int rv = L - q0, cv = L - k0;
#pragma unroll 8
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      if (r < rv && c < cv)
        out[static_cast<int64_t>(r) * L + c] = s_bias[r * kStrB + c];
    }
  }
  store_grad(p.grad[0], p, b, h, q0 + warp * 16, g, t, dq, p.scale);
}

}  // namespace

extern "C" {

// Launchers: on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets. `ptrs[0..7]` and `strides[0..12]` as
// relbias::make_params (bias_common.cuh) lays them out. Each returns the
// first nonzero cudaError_t of its launches (0 = launched).

// Forward: writes ctx (ptrs[7]) and the statistics (ptrs[6]).
int bias_train_fwd(const uint64_t* ptrs, const int64_t* strides, int B,
                   int nh, int L, float scale, int mode, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t thr, float inv_keep,
                   void* stream) {
  const relbias::FwdParams p = relbias::make_params(
      ptrs, strides, nh, L, scale, mode, seed_lo, seed_hi, thr, inv_keep);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kNoDropout)
    bias_train_fwd_kernel<false><<<grid, kThreads, 0, s>>>(p);
  else
    bias_train_fwd_kernel<true><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward (the dq kernel, which also writes D and dbias, then the dk/dv
// kernel): ptrs[7] is unused; [8] dc; [9] the fp32 (B, nh, L) scratch for
// D; [10..12] dq, dk, dv (B, L, nh, 64); [13] dbias (fp32 (B, nh, L, L)
// contiguous). strides[13..15]: (batch, head, seq) of dc.
int bias_train_bwd(const uint64_t* ptrs, const int64_t* strides, int B,
                   int nh, int L, float scale, int mode, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t thr, float inv_keep,
                   void* stream) {
  BwdParams p{};
  static_cast<relbias::FwdParams&>(p) = relbias::make_params(
      ptrs, strides, nh, L, scale, mode, seed_lo, seed_hi, thr, inv_keep);
  p.dout = reinterpret_cast<const __nv_bfloat16*>(ptrs[8]);
  for (int j = 0; j < 3; ++j) p.dstride[j] = strides[13 + j];
  p.delta = reinterpret_cast<float*>(ptrs[9]);
  for (int i = 0; i < 3; ++i)
    p.grad[i] = reinterpret_cast<__nv_bfloat16*>(ptrs[10 + i]);
  p.dbias = reinterpret_cast<float*>(ptrs[13]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((L + kTile - 1) / kTile, nh, B);
  bias_train_dq_kernel<<<grid, kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_train_dkdv_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* bias_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
