// Device code shared by the BiACM kernels (biacm_attention.cu, the
// inference forward, and biacm_attention_train.cu, the training forward and
// backward): the mma.sync m16n8k16 bf16 → fp32 product, bf16 packing,
// 16-byte row copies from device memory into shared memory, the dropout
// bits, and the one forward body both forward kernels instantiate.
//
// mma.sync m16n8k16 fragments (per thread; g = lane / 4, t = lane % 4):
//   A (16×16, row-major):  a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
//                          2t+8..), a3 = (g+8, 2t+8..)
//   B (16×8, "col"):       b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g): two
//                          consecutive k of one n, i.e. a row of a (n, k)
//                          row-major tile
//   C (16×8):              c0..1 = (g, 2t..2t+1), c2..3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring n-tiles are exactly the A fragment
// of one k16 step (rounded to bf16): score tiles feed the next product
// straight from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace biacm {

constexpr int kTile = 64;                // query rows or keys per CTA / step
constexpr int kWarps = kTile / 16;       // each warp owns 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kDT = 64;                  // text head dim
constexpr int kDL = 16;                  // layout head dim
// shared-memory row strides in bf16 elements: +8 (16 bytes) staggers rows
// across banks and keeps every row 16-byte aligned
constexpr int kStrT = kDT + 8;           // (rows, d=64) tiles
constexpr int kStrL = kDL + 8;           // (rows, d=16) tiles
constexpr int kStrX = kTile + 8;         // transposed tiles: (d, rows)

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0 + {g, g+8}, columns k0 + {2t.., 2t+8..} of a
// row-major shared-memory tile with row stride STR.
template <int STR>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int r0, int k0, int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * STR + k0 + t * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * STR);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * STR + 8);
}

// The A fragment of a (16, 16) slice given as the C fragments of its two
// (16, 8) halves, rounded to bf16: c[half][q].
__device__ __forceinline__ void pack_a(uint32_t* a, const float (*c)[4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// The same A fragment as two bf16 parts, hi = bf16(c) and lo = bf16(c −
// hi): an mma of each into one accumulator multiplies by c to about 16
// significant bits instead of 8.
__device__ __forceinline__ void pack_a_split(uint32_t* hi, uint32_t* lo,
                                             const float (*c)[4]) {
  float rest[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rest[half][q] = c[half][q]
                      - __bfloat162float(__float2bfloat16_rn(c[half][q]));
  pack_a(hi, c);
  pack_a(lo, rest);
}

// Copy kTile rows of D bf16 (row r at src + r*row_stride) into shared
// memory at dst (row stride STR), 16 bytes per thread per step; rows at or
// past `valid` are zero-filled.
template <int D, int STR>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid)
      v = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * STR + col) = v;
  }
}

// Same, stored transposed: dst[d * kStrX + row].
template <int D>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            int64_t row_stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid)
      v = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * kStrX + r] = e[i];
  }
}

// ------------------------------------------------------------ dropout bits
// keep_s = bits_s < thr. In-kernel, the bits are Philox4x32-10 (Salmon et
// al., SC'11; the Random123 round and key schedule) of the counter
// (j, i, h, b) under the key (seed_lo, seed_hi): output word 0 is stream 1
// (text), word 1 stream 2 (layout). ops/biacm_attention.py:
// attention_dropout_bits computes the same bits with torch integer ops.
enum BitsMode { kNoDropout = 0, kPhilox = 1, kExplicit = 2 };

struct Dropout {
  const uint32_t* bits[2];               // explicit (B, nh, L, L) bits
  uint32_t seed_lo, seed_hi, thr;
  float inv_keep;                        // 1 / (1 − rate)
  int mode;                              // BitsMode
};

// Philox4x32-10 (Random123's philox4x32round / bumpkey): 10 rounds, the
// key bumped by the Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The two keep flags of element (query i, key j) of head (b, h); i, j < L.
__device__ __forceinline__ void keep_flags(const Dropout& d, int nh, int L,
                                           int b, int h, int i, int j,
                                           bool& k1, bool& k2) {
  uint32_t b1, b2;
  if (d.mode == kPhilox) {
    const uint4 r = philox4x32_10(make_uint4(j, i, h, b), d.seed_lo,
                                  d.seed_hi);
    b1 = r.x;
    b2 = r.y;
  } else {
    const int64_t idx = ((static_cast<int64_t>(b) * nh + h) * L + i) * L + j;
    b1 = d.bits[0][idx];
    b2 = d.bits[1][idx];
  }
  k1 = b1 < d.thr;
  k2 = b2 < d.thr;
}

// ----------------------------------------------------------------- forward
struct FwdParams {
  const __nv_bfloat16* in[6];            // q_t, k_t, v_t, q_l, k_l, v_l
  int64_t stride[6][3];                  // (batch, head, seq) in elements
  const float* bias;                     // (B, L) additive key mask
  int64_t bias_stride;                   // batch stride of bias
  __nv_bfloat16* out[2];                 // ctx_t, ctx_l (B, L, nh, d)
  float2* stats;                         // (B, nh, L): (row max, log sum)
  Dropout drop;
  int nh, L;
  float scale_t, scale_l;
};

// Rows r0.. of the (b, h) slice of input `which`.
__device__ __forceinline__ const __nv_bfloat16* rows(const FwdParams& p,
                                                     int which, int b, int h,
                                                     int r0) {
  return p.in[which] + b * p.stride[which][0] + h * p.stride[which][1]
         + static_cast<int64_t>(r0) * p.stride[which][2];
}

// Store rows row0 + g and row0 + g + 8 (C fragment halves) of a (16, D)
// fp32 accumulator as bf16 into the (B, L, nh, D) output `o`, scaled.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, int nh, int L,
                                           int b, int h, int row0, int g,
                                           int t, const float (*acc)[4],
                                           float scale0, float scale1) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= L) continue;
    const float sc = r ? scale1 : scale0;
    const int64_t tok = (static_cast<int64_t>(b) * L + row) * nh + h;
    __nv_bfloat16* dst = o + tok * D + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * r] * sc, acc[n][2 * r + 1] * sc);
  }
}

// One CTA (kThreads threads, grid (query tiles, nh, B)) of the forward:
//   s = q_t·k_tᵀ·scale_t + q_l·k_lᵀ·scale_l + bias,  p = softmax(s),
//   ctx_t = p1·v_t, ctx_l = p2·v_l
// with p1 = p2 = p, or (kDropout) p_s = keep_s ? p/(1−r) : 0 applied to the
// un-normalised p before each p·v product (the running sum counts every
// key: dropout scales the products, not the normaliser). kStats also
// writes each row's (max m, log of the sum l).
//
// Keys are tiled by kTile with an online softmax (running row max and sum,
// rescaled per tile); each warp owns 16 query rows, whose Q fragments stay
// in registers for the whole key loop. The padding mask is finite
// (finfo(f32).min/2), so a tile of padding gives a finite row max, never
// inf − inf; keys past L get −inf and contribute exactly 0, and the first
// tile always holds key 0 < L. p is rounded to bf16 before p·v (as the TPU
// kernel does, here before normalisation, where p ≤ 1).
template <bool kDropout, bool kStats>
__device__ __forceinline__ void forward_tile(const FwdParams& p) {
  __shared__ __align__(16) __nv_bfloat16 s_q_t[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_q_l[kTile * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_k_t[kTile * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_k_l[kTile * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_v_t[kDT * kStrX];
  __shared__ __align__(16) __nv_bfloat16 s_v_l[kDL * kStrX];
  __shared__ float s_bias[kTile];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8

  load_rows<kDT, kStrT>(s_q_t, rows(p, 0, b, h, q0), p.stride[0][2], L - q0);
  load_rows<kDL, kStrL>(s_q_l, rows(p, 3, b, h, q0), p.stride[3][2], L - q0);
  __syncthreads();
  uint32_t qa_t[kDT / 16][4], qa_l[4];
#pragma unroll
  for (int kk = 0; kk < kDT / 16; ++kk)
    load_a<kStrT>(qa_t[kk], s_q_t, warp * 16, kk * 16, g, t);
  load_a<kStrL>(qa_l, s_q_l, warp * 16, 0, g, t);

  // running statistics of rows row_a (index 0) and row_a + 8 (index 1)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc_t[kDT / 8][4], acc_l[kDL / 8][4];
#pragma unroll
  for (int n = 0; n < kDT / 8; ++n)
    acc_t[n][0] = acc_t[n][1] = acc_t[n][2] = acc_t[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kDL / 8; ++n)
    acc_l[n][0] = acc_l[n][1] = acc_l[n][2] = acc_l[n][3] = 0.f;
  const float* bias_row = p.bias + b * p.bias_stride;

  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int kv = L - k0;  // valid keys in this tile (may exceed kTile)
    __syncthreads();        // every warp is done with the previous tile
    load_rows<kDT, kStrT>(s_k_t, rows(p, 1, b, h, k0), p.stride[1][2], kv);
    load_rows<kDL, kStrL>(s_k_l, rows(p, 4, b, h, k0), p.stride[4][2], kv);
    load_rows_t<kDT>(s_v_t, rows(p, 2, b, h, k0), p.stride[2][2], kv);
    load_rows_t<kDL>(s_v_l, rows(p, 5, b, h, k0), p.stride[5][2], kv);
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      s_bias[j] = j < kv ? bias_row[k0 + j] : -INFINITY;
    __syncthreads();

    // scores: s[j] covers keys j*8 .. j*8+7 (C fragments)
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float st[4] = {0.f, 0.f, 0.f, 0.f};
      float sl[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = s_k_t + (j * 8 + g) * kStrT + t * 2;
#pragma unroll
      for (int kk = 0; kk < kDT / 16; ++kk)
        mma_16816(st, qa_t[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
      const __nv_bfloat16* klr = s_k_l + (j * 8 + g) * kStrL + t * 2;
      mma_16816(sl, qa_l, lds32(klr), lds32(klr + 8));
      const float b0 = s_bias[j * 8 + t * 2], b1 = s_bias[j * 8 + t * 2 + 1];
      s[j][0] = st[0] * p.scale_t + sl[0] * p.scale_l + b0;
      s[j][1] = st[1] * p.scale_t + sl[1] * p.scale_l + b1;
      s[j][2] = st[2] * p.scale_t + sl[2] * p.scale_l + b0;
      s[j][3] = st[3] * p.scale_t + sl[3] * p.scale_l + b1;
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
    for (int n = 0; n < kDT / 8; ++n) {
      acc_t[n][0] *= alpha[0]; acc_t[n][1] *= alpha[0];
      acc_t[n][2] *= alpha[1]; acc_t[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kDL / 8; ++n) {
      acc_l[n][0] *= alpha[0]; acc_l[n][1] *= alpha[0];
      acc_l[n][2] *= alpha[1]; acc_l[n][3] *= alpha[1];
    }

    // p·v: the score C fragments of keys kk*16 .. +15 are the A fragment
    // of one k16 step; with dropout, each stream gets its own masked copy
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa1[4], pa2[4];
      if constexpr (kDropout) {
        float e1[2][4], e2[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = row_a + (q >> 1) * 8;
            const int col = k0 + j * 8 + t * 2 + (q & 1);
            bool k1 = false, k2 = false;
            if (row < L && col < L)
              keep_flags(p.drop, p.nh, L, b, h, row, col, k1, k2);
            e1[half][q] = k1 ? s[j][q] * p.drop.inv_keep : 0.f;
            e2[half][q] = k2 ? s[j][q] * p.drop.inv_keep : 0.f;
          }
        }
        pack_a(pa1, e1);
        pack_a(pa2, e2);
      } else {
        pack_a(pa1, &s[2 * kk]);
      }
      const uint32_t* pl = kDropout ? pa2 : pa1;
#pragma unroll
      for (int n = 0; n < kDT / 8; ++n) {
        const __nv_bfloat16* vr = s_v_t + (n * 8 + g) * kStrX + kk * 16 + t * 2;
        mma_16816(acc_t[n], pa1, lds32(vr), lds32(vr + 8));
      }
#pragma unroll
      for (int n = 0; n < kDL / 8; ++n) {
        const __nv_bfloat16* vr = s_v_l + (n * 8 + g) * kStrX + kk * 16 + t * 2;
        mma_16816(acc_l[n], pl, lds32(vr), lds32(vr + 8));
      }
    }
  }

  // normalise and store rows row_a, row_a + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  store_rows<kDT>(p.out[0], p.nh, L, b, h, q0 + warp * 16, g, t, acc_t, inv0,
                  inv1);
  store_rows<kDL>(p.out[1], p.nh, L, b, h, q0 + warp * 16, g, t, acc_l, inv0,
                  inv1);
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

}  // namespace biacm
