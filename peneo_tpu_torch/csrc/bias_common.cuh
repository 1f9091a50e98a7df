// Device code shared by the rel-bias attention kernels (bias_attention.cu,
// the inference forward, and bias_attention_train.cu, the training forward
// and backward): single-stream attention of head dim 64 with a per-element
// fp32 bias (B, nh, L, L) added to the scores, as LayoutLMv3 uses it. Built
// on the mma.sync fragments, row loaders and Philox generator of
// biacm_common.cuh.
//
// The bias is the traffic: every (query, key) pair reads 4 bytes of it
// against 2·64·2 bytes of q/k/v per row. Its rows are L fp32 long, so with
// L = 709 they are 4-byte aligned only: the bias is read with scalar loads,
// coalesced along the key axis (a warp reads 32 consecutive floats of one
// row), through the (batch, head, row) strides the caller passes; the last
// dim must be contiguous. No padded row stride is asked of the caller.

#pragma once

#include <cfloat>

#include "biacm_common.cuh"

namespace relbias {

using biacm::kStrT;
using biacm::kStrX;
using biacm::kThreads;
using biacm::kTile;
using biacm::kWarps;
using biacm::lds32;
using biacm::load_a;
using biacm::load_rows;
using biacm::load_rows_t;
using biacm::mma_16816;
using biacm::pack_a;

constexpr int kD = 64;                   // head dim
// fp32 (kTile, kTile) bias tile in shared memory: a row stride of 72 floats
// makes the float2 reads of a C fragment (row g, columns 2t..2t+1)
// conflict-free per half-warp and keeps them 8-byte aligned
constexpr int kStrB = kTile + 8;

struct FwdParams {
  const __nv_bfloat16* in[3];            // q, k, v
  int64_t stride[3][3];                  // (batch, head, seq) in elements
  const float* bias;                     // (B, nh, L, L) fp32, last dim dense
  int64_t bias_stride[3];                // (batch, head, row) in elements
  const float* mask;                     // (B, L) additive key mask
  int64_t mask_stride;                   // batch stride of mask
  __nv_bfloat16* out;                    // ctx (B, L, nh, 64)
  float2* stats;                         // (B, nh, L): (row max, log sum)
  biacm::Dropout drop;                   // one mask: bits[0] / Philox word 0
  int nh, L;
  float scale;
};

// Rows r0.. of the (b, h) slice of input `which`.
__device__ __forceinline__ const __nv_bfloat16* rows(const FwdParams& p,
                                                     int which, int b, int h,
                                                     int r0) {
  return p.in[which] + b * p.stride[which][0] + h * p.stride[which][1]
         + static_cast<int64_t>(r0) * p.stride[which][2];
}

// Element (r0, c0) of the (b, h) bias matrix.
__device__ __forceinline__ const float* bias_at(const FwdParams& p, int b,
                                                int h, int r0, int c0) {
  return p.bias + b * p.bias_stride[0] + h * p.bias_stride[1]
         + static_cast<int64_t>(r0) * p.bias_stride[2] + c0;
}

// Copy the (kTile, kTile) fp32 tile at `src` (row stride rs) into shared
// memory (row stride kStrB), a warp reading 32 consecutive floats of one
// row per step; rows at or past `rv` and columns at or past `cv` are 0.
__device__ __forceinline__ void load_bias_tile(float* dst, const float* src,
                                               int64_t rs, int rv, int cv) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    dst[r * kStrB + c] = (r < rv && c < cv) ? src[r * rs + c] : 0.f;
  }
}

// The additive key mask of keys k0.. of batch b into shared memory.
__device__ __forceinline__ void load_mask_tile(float* dst, const FwdParams& p,
                                               int b, int k0) {
  const float* m = p.mask + b * p.mask_stride;
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    dst[j] = k0 + j < p.L ? m[k0 + j] : 0.f;
}

// The score of one (query, key) pair: fp32, clamped to the finite range so
// that a mask of finfo(f32).min plus a negative bias never becomes −inf; a
// key past L (ok == false) is −inf and contributes exactly 0.
__device__ __forceinline__ float score(float qk, float scale, float bias,
                                       float mask, bool ok) {
  return ok ? fmaxf(qk * scale + bias + mask, -FLT_MAX) : -INFINITY;
}

// The keep flag of element (query i, key j) of head (b, h); i, j < L: word 0
// of the Philox draw at the counter (j, i, h, b), or the explicit bits.
__device__ __forceinline__ bool keep_flag(const biacm::Dropout& d, int nh,
                                          int L, int b, int h, int i, int j) {
  uint32_t bits;
  if (d.mode == biacm::kPhilox) {
    bits = biacm::philox4x32_10(make_uint4(j, i, h, b), d.seed_lo,
                                d.seed_hi).x;
  } else {
    bits = d.bits[0][((static_cast<int64_t>(b) * nh + h) * L + i) * L + j];
  }
  return bits < d.thr;
}

// One CTA (kThreads threads, grid (query tiles, nh, B)) of the forward:
//   s = q·kᵀ·scale + bias + mask,  p = softmax(s),  ctx = p1·v
// with p1 = p, or (kDropout) p1 = keep ? p/(1−r) : 0 applied to the
// un-normalised p before p·v (the running sum counts every key). kStats
// also writes each row's (max m, log of the sum l) for the backward.
//
// Keys are tiled by kTile with an online softmax; each warp owns 16 query
// rows whose Q fragments stay in registers. Per key tile the CTA stages K,
// Vᵀ, the (64, 64) bias tile and the key mask in shared memory. The first
// tile always holds key 0 < L and every valid score is finite, so the
// running max is finite from tile one and a fully masked row gives a
// uniform p, never NaN. p is rounded to bf16 before p·v (as the TPU kernel
// does, here before normalisation, where p ≤ 1).
template <bool kDropout, bool kStats>
__device__ __forceinline__ void forward_tile(const FwdParams& p) {
  __shared__ __align__(16) __nv_bfloat16 s_k[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_v[kD * kStrX];
  __shared__ __align__(16) float s_bias[kTile * kStrB];
  __shared__ float s_mask[kTile];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8

  // Q of this query tile → A fragments (staged through the K buffer)
  load_rows<kD, kStrT>(s_k, rows(p, 0, b, h, q0), p.stride[0][2], L - q0);
  __syncthreads();
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    load_a<kStrT>(qa[kk], s_k, warp * 16, kk * 16, g, t);

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int kv = L - k0;  // valid keys in this tile (may exceed kTile)
    __syncthreads();        // every warp is done with the previous tile
    load_rows<kD, kStrT>(s_k, rows(p, 1, b, h, k0), p.stride[1][2], kv);
    load_rows_t<kD>(s_v, rows(p, 2, b, h, k0), p.stride[2][2], kv);
    load_bias_tile(s_bias, bias_at(p, b, h, q0, k0), p.bias_stride[2],
                   L - q0, kv);
    load_mask_tile(s_mask, p, b, k0);
    __syncthreads();

    // scores: s[j] covers keys j*8 .. j*8+7 (C fragments)
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float st[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = s_k + (j * 8 + g) * kStrT + t * 2;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        mma_16816(st, qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
      const int c = j * 8 + t * 2;
      const float2 b0 = *reinterpret_cast<const float2*>(
          s_bias + (warp * 16 + g) * kStrB + c);
      const float2 b1 = *reinterpret_cast<const float2*>(
          s_bias + (warp * 16 + g + 8) * kStrB + c);
      const float m0 = s_mask[c], m1 = s_mask[c + 1];
      s[j][0] = score(st[0], p.scale, b0.x, m0, c < kv);
      s[j][1] = score(st[1], p.scale, b0.y, m1, c + 1 < kv);
      s[j][2] = score(st[2], p.scale, b1.x, m0, c < kv);
      s[j][3] = score(st[3], p.scale, b1.y, m1, c + 1 < kv);
    }

    // online softmax update
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = __expf(m_run[r] - mx[r]);  // 0 on the first tile
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      s[j][0] = __expf(s[j][0] - mx[0]);
      s[j][1] = __expf(s[j][1] - mx[0]);
      s[j][2] = __expf(s[j][2] - mx[1]);
      s[j][3] = __expf(s[j][3] - mx[1]);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // p·v: the score C fragments of keys kk*16 .. +15 are the A fragment
    // of one k16 step; with dropout, the masked and rescaled copy
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      if constexpr (kDropout) {
        float e[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = row_a + (q >> 1) * 8;
            const int col = k0 + j * 8 + t * 2 + (q & 1);
            const bool keep = row < L && col < L
                && keep_flag(p.drop, p.nh, L, b, h, row, col);
            e[half][q] = keep ? s[j][q] * p.drop.inv_keep : 0.f;
          }
        }
        pack_a(pa, e);
      } else {
        pack_a(pa, &s[2 * kk]);
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* vr = s_v + (n * 8 + g) * kStrX + kk * 16 + t * 2;
        mma_16816(acc[n], pa, lds32(vr), lds32(vr + 8));
      }
    }
  }

  // normalise and store rows row_a, row_a + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  biacm::store_rows<kD>(p.out, p.nh, L, b, h, q0 + warp * 16, g, t, acc,
                        1.f / l_run[0], 1.f / l_run[1]);
  if constexpr (kStats) {
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + r * 8;
        if (row < L)
          p.stats[(static_cast<int64_t>(b) * p.nh + h) * L + row] =
              make_float2(m_run[r], logf(l_run[r]));
      }
    }
  }
}

// Host side: the parameters all three launchers share. `ptrs` (device
// pointers as uint64): [0..2] q, k, v (bf16), [3] bias (fp32 (B, nh, L, L)),
// [4] mask (fp32 (B, L)), [5] explicit bits (uint32 (B, nh, L, L)
// contiguous, or 0), [6] the row statistics (fp32 (B, nh, L, 2), or 0),
// [7] ctx (bf16 (B, L, nh, 64)). `strides` (int64 elements): [0..8]
// (batch, head, seq) of q, k, v; [9..11] (batch, head, row) of bias; [12]
// the batch stride of mask. `mode`: 0 no dropout, 1 Philox bits from
// (seed_lo, seed_hi), 2 the explicit bits.
inline FwdParams make_params(const uint64_t* ptrs, const int64_t* strides,
                             int nh, int L, float scale, int mode,
                             uint32_t seed_lo, uint32_t seed_hi, uint32_t thr,
                             float inv_keep) {
  FwdParams p = {};
  for (int i = 0; i < 3; ++i) {
    p.in[i] = reinterpret_cast<const __nv_bfloat16*>(ptrs[i]);
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.bias = reinterpret_cast<const float*>(ptrs[3]);
  for (int j = 0; j < 3; ++j) p.bias_stride[j] = strides[9 + j];
  p.mask = reinterpret_cast<const float*>(ptrs[4]);
  p.mask_stride = strides[12];
  p.drop.bits[0] = reinterpret_cast<const uint32_t*>(ptrs[5]);
  p.stats = reinterpret_cast<float2*>(ptrs[6]);
  p.out = reinterpret_cast<__nv_bfloat16*>(ptrs[7]);
  p.nh = nh;
  p.L = L;
  p.scale = scale;
  p.drop.mode = mode;
  p.drop.seed_lo = seed_lo;
  p.drop.seed_hi = seed_hi;
  p.drop.thr = thr;
  p.drop.inv_keep = inv_keep;
  return p;
}

}  // namespace relbias
