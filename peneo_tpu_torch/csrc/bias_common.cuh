// Device code shared by the rel-bias attention kernels (bias_attention.cu,
// the inference forward, and bias_attention_train.cu, the training forward
// and backward): single-stream attention of head dim 64 with a per-element
// fp32 bias (B, nh, L, L) added to the scores, as LayoutLMv3 uses it. Built
// on the mma.sync fragments, the tile ring (cp.async, ldmatrix) and the
// Philox generator of biacm_common.cuh; the one forward body both forward
// kernels instantiate.
//
// The bias is the traffic: every (query, key) pair reads 4 bytes of it
// against 2·64·2 bytes of q/k/v per row, so each kernel is bound by bytes
// on the H100 (the serving forward by 4·B·nh·L² bytes of bias: 0.27 ms at
// B=32, L=709). What this file does about it:
//
// - Every tile travels by cp.async into a 2-stage ring in dynamic shared
//   memory while the warps compute on the other stage: K and V (or Q and
//   dO) as (64, 64) bf16 row tiles, the (64, 64) fp32 bias tile, the key
//   mask and the tile's packed keep flags; one wait_group and one barrier
//   per tile. A thread's requests are consecutive rows at 32-bit offsets
//   from a base the whole CTA shares (biacm_common.cuh).
// - Fragments come from the row tiles by ldmatrix.x4; where a product
//   wants a tile transposed (V in p·v, K in dS·k, Q and dO in dSᵀ·q and
//   pᵀ·dO) by its .trans form. No transposed copy is written and no tile is
//   read from device memory twice. (The first version loaded every tile
//   synchronously through registers, wrote transposed copies with 2-byte
//   stores, read fragments 4 bytes at a time, and the dk/dv kernel read Q
//   and dO from device memory twice per query tile.)
// - The bias tile: where its rows are 16-byte aligned (base and row stride
//   a multiple of 4 floats) each request moves 16 bytes; otherwise (any
//   bias with a contiguous last dim and 4-byte rows, e.g. L = 709 dense)
//   4 bytes. The choice is made per launch from the pointer and strides
//   (FwdParams::bias_vec, a CTA-uniform branch): both routes are this
//   kernel. The model's RelBias allocates rows of L rounded up to a
//   multiple of 4 floats (712 for 709), so its bias takes the 16-byte
//   route. In shared memory the tile has a row stride of 72 floats where
//   threads read it query-major (float2 of a C fragment row: conflict-free
//   per half-warp) and 68 where the dk/dv kernel reads it key-major (a
//   warp's 8 keys × 4 query pairs fall in 32 distinct banks).
// - Dropout: one mask, drawn once per training forward by a mask kernel
//   of its own (bias_attention_train.cu), four keys per Philox4x32-10 draw:
//   the bits of element (i, j) are word j & 3 of the draw at the counter
//   (j >> 2, i, h, b), a pure function of (seed, b, h, i, j) whatever the
//   tiling. It writes the keep flags bit-packed, int32 (B, nh, L,
//   ceil(L / 32)), bit j % 32 of word j / 32 of row i; the forward and both
//   backward kernels read them tile by tile ([word][row] in shared memory)
//   and draw nothing. Masking p is an AND on its packed bf16 halves. (The
//   first version drew one full draw per element, using one word of four,
//   in the forward and three times in the backward: ~0.3 ms per pass at the
//   training shape, half of the forward.)
//
// Measured on an H100 80GB HBM3 at 700 W, device time at the main path's
// shapes (nh=12, L=709; PERF.md §6): the serving forward (#4, B=32) 0.37 ms
// against its bound of 0.27 (bytes; the first version 0.94), the training
// forward with its mask kernel (#5, B=8) 0.16 against 0.07 (0.53), the
// backward (#6) 0.45 against 0.14 (2.1-2.2). ptxas: #4 144 registers, #5
// 168 (138 at rate 0), dq 161, dk/dv 162, the mask kernel 29; no spill, no
// stack frame. The ring's shared memory (75,264 B a CTA; 74,240 for dk/dv)
// allows 3 CTAs per SM, and __launch_bounds__ asks for 3.

#pragma once

#include <cfloat>

#include "biacm_common.cuh"

namespace relbias {

using biacm::bfrag_off;
using biacm::cp_async;
using biacm::cp_async_commit;
using biacm::cp_async_wait;
using biacm::frag_off;
using biacm::keep_pair_mask;
using biacm::kStrT;
using biacm::kThreads;
using biacm::kTile;
using biacm::ldsm_x4;
using biacm::ldsm_x4_t;
using biacm::load_rows_async;
using biacm::mma_16816;
using biacm::pack_a;
using biacm::smem_u32;
using biacm::static_for;

constexpr int kD = 64;                   // head dim
// shared-memory row strides of the fp32 bias tile, in floats (rows stay
// 16-byte aligned for cp.async): read query-major (forward, dq) / key-major
// (dk/dv)
constexpr int kStrB = kTile + 8;
constexpr int kStrBT = kTile + 4;

// One stage of the tile ring, in bytes: two (kTile, 64) bf16 row tiles (K
// and V for the forward and dq; Q and dO for dk/dv), the fp32 bias tile,
// then (forward, dq) the key mask and the tile's keep words, [word][row].
constexpr int kOffA = 0;
constexpr int kOffB = biacm::kBytesT;
constexpr int kOffBias = 2 * biacm::kBytesT;
constexpr int kOffF = kOffBias + kTile * kStrB * 4;
constexpr int kKeepWords = 2 * kTile;
constexpr int kOffKeep = kOffF + kTile * 4;
constexpr int kStageBytes = kOffKeep + kKeepWords * 4;
constexpr int kSmemBytes = 2 * kStageBytes;

struct FwdParams {
  const __nv_bfloat16* in[3];            // q, k, v
  int64_t stride[3][3];                  // (batch, head, seq) in elements
  const float* bias;                     // (B, nh, L, L) fp32, last dim dense
  int64_t bias_stride[3];                // (batch, head, row) in elements
  bool bias_vec;                         // 16-byte aligned bias rows
  const float* mask;                     // (B, L) additive key mask
  int64_t mask_stride;                   // batch stride of mask
  __nv_bfloat16* out;                    // ctx (B, L, nh, 64)
  float2* stats;                         // (B, nh, L): (row max, log sum)
  uint32_t* keep;                        // packed keep flags (B, nh, L,
                                         // ceil(L / 32)): written by the
                                         // mask kernel, read by the forward
                                         // and the backward
  biacm::Dropout drop;                   // bits[0]: explicit (B, nh, L, L)
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

// Element (0, 0) of the (b, h) bias matrix (the same for the whole CTA).
__device__ __forceinline__ const float* bias_head(const FwdParams& p, int b,
                                                  int h) {
  return p.bias + b * p.bias_stride[0] + h * p.bias_stride[1];
}

// Word 0 of row 0 of head (b, h) in the packed keep flags.
__device__ __forceinline__ const uint32_t* keep_head(const FwdParams& p,
                                                     int b, int h) {
  const int words = (p.L + 31) / 32;
  return p.keep + (static_cast<int64_t>(b) * p.nh + h)
                  * (static_cast<int64_t>(p.L) * words);
}

// cp.async of 16 bytes of which the first `n` are read and the rest
// zero-filled (`src` 16-byte aligned, valid even when n == 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

// The fp32 bias tile of rows r0 .. r0 + 63, keys c0 .. c0 + 63 of a (b, h)
// matrix (`head`, rows rs elements apart) → the shared tile at dst (row
// stride STR floats); rows or keys at or past L are zero-filled. vec: 16
// bytes per request (16 threads a row, each 8 consecutive rows; a partial
// last group of keys reads only its valid bytes); else 4 (a thread per key,
// 32 consecutive rows each). Offsets are 32-bit from the CTA's `head` (the
// wrapper checks that a head's rows fit).
template <int STR>
__device__ __forceinline__ void load_bias_async(uint32_t dst,
                                                const float* head, int rs,
                                                int r0, int c0, int L,
                                                bool vec) {
  if (vec) {
    constexpr int kGroups = kTile / 4, kRows = kTile * kGroups / kThreads;
    const int row = threadIdx.x / kGroups * kRows;
    const int col = (threadIdx.x % kGroups) * 4;
    const int n = min(max(L - (c0 + col), 0), 4) * 4;
    const int from = (r0 + row) * rs + c0 + col;
    dst += (row * STR + col) * 4;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool ok = n > 0 && r0 + row + i < L;
      cp_async16(dst + i * STR * 4, head + (ok ? from + i * rs : 0),
                 ok ? n : 0);
    }
  } else {
    constexpr int kRows = kTile * kTile / kThreads;
    const int row = threadIdx.x / kTile * kRows;
    const int col = threadIdx.x % kTile;
    const bool col_ok = c0 + col < L;
    const int from = (r0 + row) * rs + c0 + col;
    dst += (row * STR + col) * 4;
#pragma unroll 8
    for (int i = 0; i < kRows; ++i) {
      const bool ok = col_ok && r0 + row + i < L;
      cp_async<4>(dst + i * STR * 4, head + (ok ? from + i * rs : 0), ok);
    }
  }
}

// The keep words of queries q0 .. +63 × keys k0 .. +63 (`head` the head's
// packed flags, `words` a row's) → the shared words at dst, [word][row];
// rows past L and words past the row's end are 0. A thread copies word
// threadIdx.x % 2 of row threadIdx.x / 2.
__device__ __forceinline__ void load_keep_async(uint32_t dst,
                                                const uint32_t* head,
                                                int words, int q0, int k0,
                                                int L) {
  const int row = threadIdx.x / 2, w = threadIdx.x % 2;
  const bool ok = q0 + row < L && k0 / 32 + w < words;
  cp_async<4>(dst + (w * kTile + row) * 4,
              head + (ok ? (q0 + row) * words + k0 / 32 + w : 0), ok);
}

// The score of one (query, key) pair: fp32, clamped to the finite range so
// that a mask of finfo(f32).min plus a negative bias never becomes −inf; a
// key past L (ok == false) is −inf and contributes exactly 0.
__device__ __forceinline__ float score(float qk, float scale, float bias,
                                       float mask, bool ok) {
  return ok ? fmaxf(qk * scale + bias + mask, -FLT_MAX) : -INFINITY;
}

// One CTA (kThreads threads, grid (query tiles, nh, B), kSmemBytes of
// dynamic shared memory) of the forward:
//   s = q·kᵀ·scale + bias + mask,  p = softmax(s),  ctx = p1·v
// with p1 = p, or (kDropout) p1 = keep ? p/(1−r) : 0 applied to the
// un-normalised p before p·v (the running sum counts every key); the keep
// flags come bit-packed from p.keep. kStats also writes each row's (max m,
// log of the sum l) for the backward.
//
// Keys are tiled by kTile with an online softmax; each warp owns 16 query
// rows whose Q fragments stay in registers. K, V, the bias tile, the key
// mask (and the keep words) of tile i + 1 travel into the other stage while
// the warps compute on tile i. The first tile always holds key 0 < L and
// every valid score is finite, so the running max is finite from tile one
// and a fully masked row gives a uniform p, never NaN. p is rounded to bf16
// before p·v (as the TPU kernel does, here before normalisation, where
// p ≤ 1).
template <bool kDropout, bool kStats>
__device__ __forceinline__ void forward_tile(const FwdParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8
  const float* mask_row = p.mask + b * p.mask_stride;
  const float* bias = bias_head(p, b, h);
  const int rs = static_cast<int>(p.bias_stride[2]);
  const uint32_t* keep = kDropout ? keep_head(p, b, h) : nullptr;
  const int words = (L + 31) / 32;

  const uint32_t sbase = smem_u32(smem);
  // K, V, the bias tile, the key mask (and keep words) of the key tile at
  // k0 → stage `stage`; one group
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
    if constexpr (kDropout) load_keep_async(s + kOffKeep, keep, words, q0,
                                            k0, L);
    cp_async_commit();
  };

  // Q of this query tile → A fragments, staged through stage 1's K tile (a
  // group of its own) while key tile 0 is already on its way to stage 0
  load_rows_async<kD, kStrT>(sbase + kStageBytes + kOffA, rows(p, 0, b, h, 0),
                             p.stride[0][2], q0, L);
  cp_async_commit();
  fetch_keys(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const uint32_t off_a = frag_off<kStrT>(lane);
  const uint32_t off_b = bfrag_off<kStrT>(lane);
  uint32_t qa[kD / 16][4];
  {
    const uint32_t q = sbase + kStageBytes + kOffA + warp * 16 * kStrT * 2
                       + off_a;
    static_for<kD / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      ldsm_x4<kk * 32>(qa[kk], q);
    });
  }

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile, kv = L - k0;  // kv: valid keys (may be > 64)
    // tile `it` has landed, and every warp is done with the other stage
    // (tile it − 1; before tile 0, the Q fragments): refill that stage
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) fetch_keys(k0 + kTile, (it + 1) & 1);
    const uint32_t st = sbase + (it & 1) * kStageBytes;
    const unsigned char* sp = smem + (it & 1) * kStageBytes;
    const float* s_bias = reinterpret_cast<const float*>(sp + kOffBias)
                          + (warp * 16 + g) * kStrB + t * 2;
    const float* s_mask = reinterpret_cast<const float*>(sp + kOffF) + t * 2;

    // scores: s[j] covers keys j*8 .. j*8+7 (C fragments)
    float s[kTile / 8][4];
    static_for<kTile / 8>([&](auto j_) {
      constexpr int j = decltype(j_)::value;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      static_for<kD / 32>([&](auto k2_) {  // two k16 steps per load
        constexpr int k2 = decltype(k2_)::value;
        uint32_t kb[4];
        ldsm_x4<kOffA + j * 8 * kStrT * 2 + k2 * 64>(kb, st + off_b);
        mma_16816(sc, qa[2 * k2], kb[0], kb[1]);
        mma_16816(sc, qa[2 * k2 + 1], kb[2], kb[3]);
      });
      const float2 b0 = *reinterpret_cast<const float2*>(s_bias + j * 8);
      const float2 b1 =
          *reinterpret_cast<const float2*>(s_bias + 8 * kStrB + j * 8);
      const float2 m = *reinterpret_cast<const float2*>(s_mask + j * 8);
      const int c = j * 8 + t * 2;
      s[j][0] = score(sc[0], p.scale, b0.x, m.x, c < kv);
      s[j][1] = score(sc[1], p.scale, b0.y, m.y, c + 1 < kv);
      s[j][2] = score(sc[2], p.scale, b1.x, m.x, c < kv);
      s[j][3] = score(sc[3], p.scale, b1.y, m.y, c + 1 < kv);
    });

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
    // of one k16 step. With dropout they carry the 1/(1−r) scale and the
    // mask zeroes whole bf16 halves, which equals rounding keep ? p/(1−r)
    // : 0. V is read transposed from its row tile (ldmatrix .trans).
    static_for<kTile / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      uint32_t pa[4];
      if constexpr (kDropout) {
        float e[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            e[half][q] = s[2 * kk + half][q] * p.drop.inv_keep;
        pack_a(pa, e);
        // the keep words that hold these keys, rows g and g + 8
        const uint32_t* s_keep = reinterpret_cast<const uint32_t*>(
            sp + kOffKeep) + (kk / 2) * kTile + warp * 16 + g;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t w = s_keep[r * 8];
#pragma unroll
          for (int half = 0; half < 2; ++half)
            pa[2 * half + r] &=
                keep_pair_mask(w >> (((2 * kk + half) % 4) * 8 + t * 2));
        }
      } else {
        pack_a(pa, &s[2 * kk]);
      }
      static_for<kD / 16>([&](auto np_) {  // v columns np*16 .. +15
        constexpr int np = decltype(np_)::value;
        uint32_t vb[4];
        ldsm_x4_t<kOffB + (kk * 16 * kStrT + np * 16) * 2>(vb, st + off_a);
        mma_16816(acc[2 * np], pa, vb[0], vb[1]);
        mma_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
      });
    });
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
// [7] ctx (bf16 (B, L, nh, 64)), [8] the packed keep flags (int32 (B, nh,
// L, ceil(L / 32)), or 0). `strides` (int64 elements): [0..8] (batch,
// head, seq) of q, k, v; [9..11] (batch, head, row) of bias; [12] the batch
// stride of mask. `mode`: 0 no dropout, 1 Philox bits from (seed_lo,
// seed_hi), 2 the explicit bits, 3 Philox bits from the int64 key at
// ptrs[5] (read on the card when the mask kernel runs).
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
  p.bias_vec = ptrs[3] % 16 == 0 && strides[9] % 4 == 0
               && strides[10] % 4 == 0 && strides[11] % 4 == 0;
  p.mask = reinterpret_cast<const float*>(ptrs[4]);
  p.mask_stride = strides[12];
  p.drop.bits[0] = reinterpret_cast<const uint32_t*>(ptrs[5]);
  p.drop.seed = reinterpret_cast<const unsigned long long*>(ptrs[5]);
  p.stats = reinterpret_cast<float2*>(ptrs[6]);
  p.out = reinterpret_cast<__nv_bfloat16*>(ptrs[7]);
  p.keep = reinterpret_cast<uint32_t*>(ptrs[8]);
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
