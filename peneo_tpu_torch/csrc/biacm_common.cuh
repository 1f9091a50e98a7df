// Device code shared by the BiACM kernels (biacm_attention.cu, the
// inference forward, and biacm_attention_train.cu, the training forward and
// backward): the mma.sync m16n8k16 bf16 → fp32 product and its fragments,
// bf16 packing, the asynchronous tile ring (cp.async into shared memory,
// ldmatrix out of it), the dropout bits, and the one forward body both
// forward kernels instantiate. The rel-bias kernels (bias_common.cuh) build
// on the product, the packing, the tile ring and the Philox generator of
// this file.
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
//
// What bounds the BiACM kernels on the H100 is not the tensor cores (the
// backward's eleven tile products are 44 GFLOP, ~0.05 ms at the bf16 peak)
// but what surrounds the products: exposed load latency, the instructions
// that form addresses, shared-memory instructions and bank conflicts,
// registers (they decide how many CTAs an SM holds) and the integer rounds
// of the dropout generator. What this file does about each:
//
// - Tiles sit in shared memory once, as rows (stride kStrT / kStrL, see
//   below), and every fragment comes from one ldmatrix.x4 (four 8×8
//   matrices per instruction). Where a product needs the tile transposed
//   (V in p·v; K in dS·k; Q and dO in dSᵀ·q and pᵀ·dO) the .trans form of
//   ldmatrix transposes each 8×8 on the way to the registers: no transposed
//   copy is ever written, and no tile is read from device memory twice.
//   ldmatrix address patterns (lane l supplies one 16-byte row address;
//   lanes 0-7 matrix 0, 8-15 matrix 1, 16-23 matrix 2, 24-31 matrix 3):
//     frag_off   row l % 16, column block l / 16: the A fragment of a
//                (16, 16) slice; with .trans on a (k, n) row-major tile,
//                the B fragments (b0, b1) of n-tiles n0 and n0 + 8
//     bfrag_off  row l % 8, column block l / 8: the B fragments of one
//                n-tile (8 rows of a (n, k) row-major tile) for two k16
//                steps, (b0, b1) of k0 then of k0 + 16
//     bpair_off  row l % 8 + 8·(l / 16), column block (l / 8) % 2: the B
//                fragments of two n-tiles for one k16 step (the d = 16
//                layout stream)
//   A lane keeps one address per pattern and stage; where a fragment lies
//   in the tile is the instruction's immediate offset.
// - Bank conflicts are avoided by row padding, not a swizzle: rows of
//   kStrT = 72 and kStrL = 24 bf16 are 144 and 48 bytes, i.e. 36 and 12
//   words, so the eight 16-byte rows of one ldmatrix phase start at words
//   {0, 4, …, 28} (mod 32) for kStrT and {0, 12, 24, 4, 16, 28, 8, 20} for
//   kStrL: eight distinct 4-word groups, all 32 banks once. Rows stay
//   16-byte aligned, as cp.async and ldmatrix require.
// - The next tile is fetched with cp.async (16 bytes per request, zero-fill
//   past L through the src-size operand) into the other stage of a 2-stage
//   ring while the warps compute on the current one: one wait_group and
//   one __syncthreads() per tile. A thread's requests are consecutive rows
//   at 32-bit offsets from a base the whole CTA shares, so a tile's copies
//   cost a few dozen instructions and no registers between tiles.
// - One Philox4x32-10 draw serves two adjacent keys of both streams, and
//   the draws are made once per training forward, by a kernel of their own
//   at full occupancy; the attention kernels read the keep flags
//   bit-packed (see "dropout bits" below). Masking p is an AND on the
//   packed bf16 halves of its A fragments.

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

// The bf16x2 mask that keeps the low half if bit 0 of `bits` is set and
// the high half if bit 1 is: a packed pair of probabilities AND this mask is
// the pair with its dropped elements set to 0.
__device__ __forceinline__ uint32_t keep_pair_mask(uint32_t bits) {
  return ((bits & 1u) ? 0x0000ffffu : 0u) | ((bits & 2u) ? 0xffff0000u : 0u);
}

// ------------------------------------------- ldmatrix, cp.async, tile ring
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Compile-time loop: f(Int<0>{}), …, f(Int<N − 1>{}). The index is a
// constant expression inside f (decltype(i)::value), so it can be an
// instruction's immediate operand.
template <int I>
struct Int {
  static constexpr int value = I;
};
template <int N, int I = 0, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    static_for<N, I + 1>(f);
  }
}

// Four 8×8 b16 matrices from shared memory; `addr` + OFF is this lane's
// row address (a shared-space byte address, 16-byte aligned; OFF travels
// as the instruction's immediate, so one base register serves a whole
// tile). Register i holds elements (g, 2t..2t+1) of matrix i.
template <int OFF>
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
      "[%4+%5];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr), "n"(OFF)
      : "memory");
}

// Same, each matrix transposed: register i holds (2t..2t+1, g) of matrix i.
template <int OFF>
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4+%5];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr), "n"(OFF)
      : "memory");
}

// This lane's byte offsets into a row-major tile of row stride STR (bf16
// elements) for the three ldmatrix address patterns of the header comment.
template <int STR>
__device__ __forceinline__ uint32_t frag_off(int lane) {
  return ((lane % 16) * STR + (lane / 16) * 8) * 2;
}
template <int STR>
__device__ __forceinline__ uint32_t bfrag_off(int lane) {
  return ((lane % 8) * STR + (lane / 8) * 8) * 2;
}
template <int STR>
__device__ __forceinline__ uint32_t bpair_off(int lane) {
  return ((lane % 8 + (lane / 16) * 8) * STR + ((lane / 8) % 2) * 8) * 2;
}

// Asynchronous copies global → shared (`dst` a shared-space byte address)
// of BYTES (16 bypasses L1, 4 and 8 go through it); with ok == false
// nothing is read and the destination is zero-filled (src must still be a
// valid, aligned address).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows r0 .. r0 + kTile − 1 of a (L, D) bf16 slice (`src` its row 0, rows
// row_stride elements apart) → the tile at the shared address dst (row
// stride STR), asynchronously, 16 bytes per request; rows at
// or past L are zero-filled. A thread copies one column block of
// consecutive rows (four for D = 64, one for D = 16; the D / 8 threads of
// a row are neighbours, so requests coalesce): its addresses cost one
// multiply per tile and then steps of row_stride, and nothing but the
// slice's base (uniform over the CTA) has to live between tiles.
template <int D, int STR>
__device__ __forceinline__ void load_rows_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int64_t row_stride, int r0,
                                                int L) {
  constexpr int kChunks = D / 8, kRows = kTile * kChunks / kThreads;
  const int row = threadIdx.x / kChunks * kRows;
  const int col = (threadIdx.x % kChunks) * 8;
  // 32-bit element offsets from the slice's base, which is the same for
  // the whole CTA (the wrapper checks that L·row_stride fits): only `row`
  // and `col` are per-thread values that live across tiles
  const int stride = static_cast<int>(row_stride);
  const int from = (r0 + row) * stride + col;
  dst += (row * STR + col) * 2;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool ok = r0 + row + i < L;
    cp_async<16>(dst + i * STR * 2, src + (ok ? from + i * stride : 0), ok);
  }
}

// One stage of the tile ring, in bytes: two (kTile, 64) tiles and two
// (kTile, 16) tiles (K and V of both streams for the forward and dq, Q and
// dO for dk/dv), then per-row fp32 values (kOffF) and the tile's packed
// keep flags.
constexpr int kBytesT = kTile * kStrT * 2;
constexpr int kBytesL = kTile * kStrL * 2;
constexpr int kOffAT = 0;
constexpr int kOffAL = kOffAT + kBytesT;
constexpr int kOffBT = kOffAL + kBytesL;
constexpr int kOffBL = kOffBT + kBytesT;
constexpr int kOffF = kOffBL + kBytesL;
// A (kTile, kTile) tile's keep flags in shared memory: [stream][word][row],
// word w = keys w*32 .. w*32+31 of the tile.
constexpr int kKeepWords = 2 * 2 * kTile;
// the stage of the forward and of dq: the tiles, the key bias of the tile,
// the keep words
constexpr int kOffKeep = kOffF + kTile * 4;
constexpr int kStageBytes = kOffKeep + kKeepWords * 4;
constexpr int kSmemBytes = 2 * kStageBytes;

// The additive key mask of keys k0 .. k0 + kTile − 1 of one batch row into
// the shared floats at dst (their shared address dst_addr); keys past L
// get −inf (a plain store: the stage is not being read, and the barrier
// that publishes the copies publishes it too).
__device__ __forceinline__ void load_key_bias_async(float* dst,
                                                    uint32_t dst_addr,
                                                    const float* bias_row,
                                                    int k0, int L) {
  const int j = threadIdx.x;
  if (j < kTile) {
    if (k0 + j < L)
      cp_async<4>(dst_addr + j * 4, bias_row + k0 + j, true);
    else
      dst[j] = -INFINITY;
  }
}

// ------------------------------------------------------------ dropout bits
// keep_s = bits_s < thr on 32 bits. In-kernel, the bits are Philox4x32-10
// (Salmon et al., SC'11; the Random123 round and key schedule) under the
// key (seed_lo, seed_hi). The BiACM mask kernel (biacm_attention_train.cu)
// makes one draw per two adjacent keys: the counter is (j >> 1, i, h, b), output words 0 / 1 are streams 1
// (text) / 2 (layout) of key 2·(j >> 1), words 2 / 3 the same of key
// 2·(j >> 1) + 1 — a pure function of (seed, b, h, i, j, stream), whatever
// the tiling. ops/biacm_attention.py:attention_dropout_bits computes the
// same bits with torch integer ops. (The rel-bias mask kernel makes one
// draw per four keys of its one mask: bias_common.cuh.)
//
// Only that kernel draws (or reads explicit bits), once per training
// forward. It writes the keep flags bit-packed, one bit per (i, j) and
// stream: uint32 (2, B, nh, L, ceil(L / 32)), bit j % 32 of word j / 32 of
// row i; bits of keys past L are 0. The forward and both backward kernels
// read that tensor tile by tile and draw nothing: a pass of draws over the
// (L, L) elements costs more than the forward's products, the attention
// kernels would make four, and inside them the generator's registers and
// integer rounds compete with the products.
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

// The keep flags of elements (query i, keys j and j + 1), j even, of head
// (b, h): f[0] / f[1] streams 1 / 2 of key j, f[2] / f[3] of key j + 1.
// Rows and keys at or past L keep nothing.
__device__ __forceinline__ void keep_flags_pair(const Dropout& d, int nh,
                                                int L, int b, int h, int i,
                                                int j, bool* f) {
  f[0] = f[1] = f[2] = f[3] = false;
  if (i >= L || j >= L) return;
  const bool second = j + 1 < L;
  uint4 w = make_uint4(0, 0, 0xffffffffu, 0xffffffffu);
  if (d.mode == kPhilox) {
    w = philox4x32_10(make_uint4(j >> 1, i, h, b), d.seed_lo, d.seed_hi);
  } else {
    const int64_t idx = ((static_cast<int64_t>(b) * nh + h) * L + i) * L + j;
    w.x = d.bits[0][idx];
    w.y = d.bits[1][idx];
    if (second) {
      w.z = d.bits[0][idx + 1];
      w.w = d.bits[1][idx + 1];
    }
  }
  f[0] = w.x < d.thr;
  f[1] = w.y < d.thr;
  f[2] = second && w.z < d.thr;
  f[3] = second && w.w < d.thr;
}

// ----------------------------------------------------------------- forward
struct FwdParams {
  const __nv_bfloat16* in[6];            // q_t, k_t, v_t, q_l, k_l, v_l
  int64_t stride[6][3];                  // (batch, head, seq) in elements
  const float* bias;                     // (B, L) additive key mask
  int64_t bias_stride;                   // batch stride of bias
  __nv_bfloat16* out[2];                 // ctx_t, ctx_l (B, L, nh, d)
  float2* stats;                         // (B, nh, L): (row max, log sum)
  uint32_t* keep;                        // packed keep flags (2, B, nh, L,
                                         // ceil(L / 32)): written by the
                                         // mask kernel, read by the forward
                                         // and the backward
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

// Word 0 of row 0 of head (b, h), stream s, in the packed keep flags (the
// same for the whole CTA), and the words per row.
__device__ __forceinline__ int64_t keep_head(const FwdParams& p, int s, int b,
                                             int h) {
  const int words = (p.L + 31) / 32;
  return ((static_cast<int64_t>(s) * gridDim.z + b) * p.nh + h)
         * (static_cast<int64_t>(p.L) * words);
}

// The keep words of queries q0 .. +63 × keys k0 .. +63 of head (b, h) →
// the shared words at dst, [stream][word][row]; rows past L and words past
// the row's end are 0. A thread copies word threadIdx.x % 2 of row
// threadIdx.x / 2 of both streams.
__device__ __forceinline__ void load_keep_async(uint32_t dst,
                                                const FwdParams& p, int b,
                                                int h, int q0, int k0) {
  const int words = (p.L + 31) / 32;
  const int row = threadIdx.x / 2, w = threadIdx.x % 2;
  const bool ok = q0 + row < p.L && k0 / 32 + w < words;
  // a head's L·words fit 32 bits (the wrapper checks L·row_stride)
  const int word = ok ? (q0 + row) * words + k0 / 32 + w : 0;
#pragma unroll
  for (int s = 0; s < 2; ++s)
    cp_async<4>(dst + ((s * 2 + w) * kTile + row) * 4,
                p.keep + keep_head(p, s, b, h) + word, ok);
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

// One CTA (kThreads threads, grid (query tiles, nh, B), kSmemBytes of
// dynamic shared memory) of the forward:
//   s = q_t·k_tᵀ·scale_t + q_l·k_lᵀ·scale_l + bias,  p = softmax(s),
//   ctx_t = p1·v_t, ctx_l = p2·v_l
// with p1 = p2 = p, or (kDropout) p_s = keep_s ? p/(1−r) : 0 applied to the
// un-normalised p before each p·v product (the running sum counts every
// key: dropout scales the products, not the normaliser); the keep flags
// come bit-packed from p.keep. kStats also writes each row's (max m, log
// of the sum l).
//
// Keys are tiled by kTile with an online softmax (running row max and sum,
// rescaled per tile); each warp owns 16 query rows, whose Q fragments stay
// in registers for the whole key loop. K, V (as rows) and the key bias of
// tile i + 1 (and, with dropout, its keep words) travel by cp.async into
// the other stage while the warps compute on tile i. The padding mask is
// finite (finfo(f32).min/2), so a
// tile of padding gives a finite row max, never inf − inf; keys past L get
// −inf and contribute exactly 0, and the first tile always holds key
// 0 < L. p is rounded to bf16 before p·v (as the TPU kernel does, here
// before normalisation, where p ≤ 1).
template <bool kDropout, bool kStats>
__device__ __forceinline__ void forward_tile(const FwdParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8
  const float* bias_row = p.bias + b * p.bias_stride;

  const uint32_t sbase = smem_u32(smem);
  // K, V and the key bias of the tile at k0 → stage `stage`; one group
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
    load_key_bias_async(
        reinterpret_cast<float*>(smem + stage * kStageBytes + kOffF),
        s + kOffF, bias_row, k0, L);
    if constexpr (kDropout) load_keep_async(s + kOffKeep, p, b, h, q0, k0);
    cp_async_commit();
  };

  // Q of this query tile → A fragments, staged through stage 1's K tiles
  // (a group of its own) while key tile 0 is already on its way to stage 0
  load_rows_async<kDT, kStrT>(sbase + kStageBytes + kOffAT,
                              rows(p, 0, b, h, 0), p.stride[0][2], q0, L);
  load_rows_async<kDL, kStrL>(sbase + kStageBytes + kOffAL,
                              rows(p, 3, b, h, 0), p.stride[3][2], q0, L);
  cp_async_commit();
  fetch_keys(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  const uint32_t off_a_t = frag_off<kStrT>(lane);
  const uint32_t off_a_l = frag_off<kStrL>(lane);
  const uint32_t off_b_t = bfrag_off<kStrT>(lane);
  const uint32_t off_b_l = bpair_off<kStrL>(lane);
  uint32_t qa_t[kDT / 16][4], qa_l[4];
  {
    const uint32_t q_t = sbase + kStageBytes + kOffAT
                         + warp * 16 * kStrT * 2 + off_a_t;
    static_for<kDT / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      ldsm_x4<kk * 32>(qa_t[kk], q_t);
    });
    ldsm_x4<0>(qa_l, sbase + kStageBytes + kOffAL + warp * 16 * kStrL * 2
                         + off_a_l);
  }

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

  const int tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    // tile `it` has landed, and every warp is done with the other stage
    // (tile it − 1; before tile 0, the Q fragments): refill that stage
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) fetch_keys(k0 + kTile, (it + 1) & 1);
    // this lane's ldmatrix row addresses at the stage's origin, one per
    // address pattern and row stride
    const uint32_t st = sbase + (it & 1) * kStageBytes;
    const uint32_t st_a_t = st + off_a_t, st_a_l = st + off_a_l;
    const uint32_t st_b_t = st + off_b_t, st_b_l = st + off_b_l;
    const float* s_bias = reinterpret_cast<const float*>(
        smem + (it & 1) * kStageBytes + kOffF);

    // scores: s[j] covers keys j*8 .. j*8+7 (C fragments)
    float s[kTile / 8][4];
    static_for<kTile / 16>([&](auto jj_) {
      constexpr int jj = decltype(jj_)::value;
      uint32_t kl[4];  // k_l fragments of n-tiles 2jj, 2jj + 1
      ldsm_x4<kOffAL + jj * 16 * kStrL * 2>(kl, st_b_l);
      static_for<2>([&](auto half_) {
        constexpr int half = decltype(half_)::value, j = 2 * jj + half;
        float sc_t[4] = {0.f, 0.f, 0.f, 0.f};
        float sc_l[4] = {0.f, 0.f, 0.f, 0.f};
        static_for<kDT / 32>([&](auto k2_) {  // two k16 steps per load
          constexpr int k2 = decltype(k2_)::value;
          uint32_t kb[4];
          ldsm_x4<kOffAT + j * 8 * kStrT * 2 + k2 * 64>(kb, st_b_t);
          mma_16816(sc_t, qa_t[2 * k2], kb[0], kb[1]);
          mma_16816(sc_t, qa_t[2 * k2 + 1], kb[2], kb[3]);
        });
        mma_16816(sc_l, qa_l, kl[2 * half], kl[2 * half + 1]);
        const float2 kb2 =
            *reinterpret_cast<const float2*>(s_bias + j * 8 + t * 2);
        s[j][0] = sc_t[0] * p.scale_t + sc_l[0] * p.scale_l + kb2.x;
        s[j][1] = sc_t[1] * p.scale_t + sc_l[1] * p.scale_l + kb2.y;
        s[j][2] = sc_t[2] * p.scale_t + sc_l[2] * p.scale_l + kb2.x;
        s[j][3] = sc_t[3] * p.scale_t + sc_l[3] * p.scale_l + kb2.y;
      });
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
    // p as bf16 A fragments: the score C fragments of keys kk*16 .. +15
    // are the A fragment of one k16 step. With dropout they carry the
    // 1/(1−r) scale, and each stream's mask then zeroes whole bf16 halves,
    // which equals rounding keep ? p/(1−r) : 0.
    uint32_t pp[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if constexpr (kDropout) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[2 * kk + half][q] *= p.drop.inv_keep;
      }
      pack_a(pp[kk], &s[2 * kk]);
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

    // p·v; with dropout, each stream gets its own masked copy of p
    static_for<kTile / 16>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value;
      uint32_t pa2[4];
      uint32_t* pa1 = pp[kk];
      if constexpr (kDropout) {
        // the keep words of streams 1, 2 that hold these keys, per row
        const uint32_t* s_keep = reinterpret_cast<const uint32_t*>(
            smem + (it & 1) * kStageBytes + kOffKeep)
            + (kk / 2) * kTile + warp * 16 + g;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t w1 = s_keep[r * 8], w2 = s_keep[2 * kTile + r * 8];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int sh = ((2 * kk + half) % 4) * 8 + t * 2;
            pa2[2 * half + r] = pa1[2 * half + r] & keep_pair_mask(w2 >> sh);
            pa1[2 * half + r] &= keep_pair_mask(w1 >> sh);
          }
        }
      }
      const uint32_t* pl = kDropout ? pa2 : pa1;
      static_for<kDT / 16>([&](auto np_) {  // v_t columns np*16 .. +15
        constexpr int np = decltype(np_)::value;
        uint32_t vb[4];
        ldsm_x4_t<kOffBT + (kk * 16 * kStrT + np * 16) * 2>(vb, st_a_t);
        mma_16816(acc_t[2 * np], pa1, vb[0], vb[1]);
        mma_16816(acc_t[2 * np + 1], pa1, vb[2], vb[3]);
      });
      uint32_t vb[4];
      ldsm_x4_t<kOffBL + kk * 16 * kStrL * 2>(vb, st_a_l);
      mma_16816(acc_l[0], pl, vb[0], vb[1]);
      mma_16816(acc_l[1], pl, vb[2], vb[3]);
    });
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

// Allow `kernel` its dynamic shared memory (above the 48 KB default), once
// per device; returns the cudaError_t of the attribute call.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  }
  return err;
}

}  // namespace biacm
