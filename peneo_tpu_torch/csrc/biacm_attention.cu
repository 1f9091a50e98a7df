// BiACM (dual-stream) attention of LiLT for Hopper, inference forward.
//
// Replaces the Pallas TPU kernel `_kernel` / `biacm_attention` in
// peneo_tpu/ops/biacm_attention.py. Per (batch b, head h):
//
//   s     = q_t·k_tᵀ·scale_t + q_l·k_lᵀ·scale_l + bias[b]     fp32
//   p     = softmax(s)                                         fp32 stats
//   ctx_t = p·v_t  (d = 64),   ctx_l = p·v_l  (d = 16)          bf16 out
//
// The two score products stay separate (d = 64 and d = 16, each summed with
// its own scale) and share one online softmax; they are not concatenated to
// head_dim 80.
//
// What bounds it on the H100: at the serving shape (B=32, nh=12, L=512)
// one call does 4·B·nh·L²·80 = 32.2 GFLOP on ~126 MB of bf16 q/k/v/out,
// about 256 FLOP per byte — just under the card's ~295 FLOP/byte balance
// point, so the bound is the bytes (~38 µs) with the tensor-core time close
// behind (~33 µs). The design keeps the (L, L) scores and probabilities out
// of device memory entirely (the plain version writes and re-reads them),
// reads every K/V tile once per 64-row query tile, and runs both products
// on the tensor cores (mma.sync m16n8k16 bf16 → fp32). This is the simple
// first version: no TMA, no wgmma, no software pipelining.
//
// Design, and how it differs from the TPU kernel: the TPU kernel keeps the
// full K/V rows of a (b, h) in VMEM and does a one-pass softmax over a
// (128, L) fp32 tile. A Hopper SM has 227 KB of shared memory, less than the
// K/V of both streams plus that score tile at L=512, so here the keys are
// tiled (64 per step) and the softmax is online (running row max m and sum
// l, rescaled per tile).
//
// - One CTA per (64-row query tile, h, b); 4 warps, each owning 16 query
//   rows. Q fragments stay in registers for the whole key loop.
// - The padding mask is finite (finfo(f32).min/2, not -inf), so a key tile
//   that is all padding gives a finite row max and never inf − inf. Keys
//   past L (ragged tail) get -inf and contribute exactly 0; the first tile
//   always holds key 0 < L, so the running max is finite from tile one.
// - p is rounded to bf16 before p·v, as the TPU kernel does; here that
//   happens before normalisation (un-normalised p ≤ 1), and l sums the fp32
//   p, so the rounding differs slightly from the one-pass kernel.
// - Any L ≥ 1: query rows and keys past L are predicated (zero-filled
//   loads, stores skipped).
// - q/k/v are read through strides (batch, head, seq; the last dim must be
//   contiguous), so the (B, L, nh, d) projection outputs are used in place.
//   The wrapper checks 16-byte alignment of every row. Outputs are written
//   (B, L, nh, d) contiguous.
//
// Build: nvcc -O3 -std=c++17 -gencode=arch=compute_90a,code=sm_90a -shared
//        -Xcompiler -fPIC (peneo_tpu_torch/ops/cuda_build.py). Plain C ABI,
//        loaded with ctypes (peneo_tpu_torch/ops/biacm_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileQ = 64;          // query rows per CTA
constexpr int kTileK = 64;          // keys per step of the key loop
constexpr int kDT = 64;             // text head dim
constexpr int kDL = 16;             // layout head dim
constexpr int kWarps = kTileQ / 16;
constexpr int kThreads = 32 * kWarps;
// shared-memory row strides in bf16 elements: +8 (16 bytes) staggers rows
// across banks and keeps every row 16-byte aligned
constexpr int kStrT = kDT + 8;      // (rows, d=64) tiles
constexpr int kStrL = kDL + 8;      // (rows, d=16) tiles
constexpr int kStrV = kTileK + 8;   // transposed V tiles: (d, keys)
static_assert(kTileQ == kTileK, "load_rows copies kTileK rows for Q too");

struct Params {
  const __nv_bfloat16* in[6];       // q_t, k_t, v_t, q_l, k_l, v_l
  int64_t stride[6][3];             // (batch, head, seq) in elements
  const float* bias;                // (B, L) additive key mask
  int64_t bias_stride;              // batch stride of bias
  __nv_bfloat16* out_t;             // (B, L, nh, 64) contiguous
  __nv_bfloat16* out_l;             // (B, L, nh, 16) contiguous
  int nh, L;
  float scale_t, scale_l;
};

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

// Copy `rows` rows of D bf16 (row r at src + r*row_stride) into shared
// memory at dst (row stride STR), 16 bytes per thread per step; rows at or
// past `valid` are zero-filled.
template <int D, int STR>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTileK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid)
      v = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * STR + col) = v;
  }
}

// Same, stored transposed: dst[d * kStrV + key].
template <int D>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            int64_t row_stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTileK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid)
      v = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * kStrV + r] = e[i];
  }
}

__global__ void __launch_bounds__(kThreads)
biacm_fwd_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 s_q_t[kTileQ * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_q_l[kTileQ * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_k_t[kTileK * kStrT];
  __shared__ __align__(16) __nv_bfloat16 s_k_l[kTileK * kStrL];
  __shared__ __align__(16) __nv_bfloat16 s_v_t[kDT * kStrV];
  __shared__ __align__(16) __nv_bfloat16 s_v_l[kDL * kStrV];
  __shared__ float s_bias[kTileK];

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair

  const __nv_bfloat16* base[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    base[i] = p.in[i] + b * p.stride[i][0] + h * p.stride[i][1];

  // ---- Q tile → registers (A fragments, rows warp*16 + {g, g+8})
  load_rows<kDT, kStrT>(s_q_t, base[0] + q0 * p.stride[0][2], p.stride[0][2],
                        L - q0);
  load_rows<kDL, kStrL>(s_q_l, base[3] + q0 * p.stride[3][2], p.stride[3][2],
                        L - q0);
  __syncthreads();
  uint32_t qa_t[kDT / 16][4], qa_l[4];
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < kDT / 16; ++kk) {
      const __nv_bfloat16* q = s_q_t + kk * 16 + t * 2;
      qa_t[kk][0] = lds32(q + r * kStrT);
      qa_t[kk][1] = lds32(q + (r + 8) * kStrT);
      qa_t[kk][2] = lds32(q + r * kStrT + 8);
      qa_t[kk][3] = lds32(q + (r + 8) * kStrT + 8);
    }
    const __nv_bfloat16* q = s_q_l + t * 2;
    qa_l[0] = lds32(q + r * kStrL);
    qa_l[1] = lds32(q + (r + 8) * kStrL);
    qa_l[2] = lds32(q + r * kStrL + 8);
    qa_l[3] = lds32(q + (r + 8) * kStrL + 8);
  }

  // running row statistics for rows g (index 0) and g+8 (index 1)
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

  for (int k0 = 0; k0 < L; k0 += kTileK) {
    const int kv = L - k0;  // valid keys in this tile (may exceed kTileK)
    __syncthreads();        // every warp is done with the previous tile
    load_rows<kDT, kStrT>(s_k_t, base[1] + k0 * p.stride[1][2],
                          p.stride[1][2], kv);
    load_rows<kDL, kStrL>(s_k_l, base[4] + k0 * p.stride[4][2],
                          p.stride[4][2], kv);
    load_rows_t<kDT>(s_v_t, base[2] + k0 * p.stride[2][2], p.stride[2][2],
                     kv);
    load_rows_t<kDL>(s_v_l, base[5] + k0 * p.stride[5][2], p.stride[5][2],
                     kv);
    for (int j = threadIdx.x; j < kTileK; j += kThreads)
      s_bias[j] = j < kv ? bias_row[k0 + j] : -INFINITY;
    __syncthreads();

    // ---- scores: s[j] covers keys j*8 .. j*8+7 (C fragments)
    float s[kTileK / 8][4];
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
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

    // ---- online softmax update
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
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
    for (int j = 0; j < kTileK / 8; ++j) {
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

    // ---- p·v: the score C fragments of keys kk*16 .. +15 are exactly the
    // A fragment of one k16 step (rounded to bf16 here)
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kDT / 8; ++n) {
        const __nv_bfloat16* vr = s_v_t + (n * 8 + g) * kStrV + kk * 16 + t * 2;
        mma_16816(acc_t[n], pa, lds32(vr), lds32(vr + 8));
      }
#pragma unroll
      for (int n = 0; n < kDL / 8; ++n) {
        const __nv_bfloat16* vr = s_v_l + (n * 8 + g) * kStrV + kk * 16 + t * 2;
        mma_16816(acc_l[n], pa, lds32(vr), lds32(vr + 8));
      }
    }
  }

  // ---- normalise and store rows q0 + warp*16 + {g, g+8}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= L) continue;
    const float inv = 1.f / l_run[r];
    const int64_t tok = (static_cast<int64_t>(b) * L + row) * p.nh + h;
    __nv_bfloat16* ot = p.out_t + tok * kDT + t * 2;
    __nv_bfloat16* ol = p.out_l + tok * kDL + t * 2;
#pragma unroll
    for (int n = 0; n < kDT / 8; ++n)
      *reinterpret_cast<uint32_t*>(ot + n * 8) =
          pack_bf16(acc_t[n][2 * r] * inv, acc_t[n][2 * r + 1] * inv);
#pragma unroll
    for (int n = 0; n < kDL / 8; ++n)
      *reinterpret_cast<uint32_t*>(ol + n * 8) =
          pack_bf16(acc_l[n][2 * r] * inv, acc_l[n][2 * r + 1] * inv);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets; the launcher leaves it as it is.
// `strides` holds 19 int64: (batch, head, seq) element strides of q_t, k_t,
// v_t, q_l, k_l, v_l, then the batch stride of bias. Returns the
// cudaError_t of the launch (0 = launched).
int biacm_attention_fwd(const void* q_t, const void* k_t, const void* v_t,
                        const void* q_l, const void* k_l, const void* v_l,
                        const void* bias, void* out_t, void* out_l,
                        const int64_t* strides, int B, int nh, int L,
                        float scale_t, float scale_l, void* stream) {
  Params p;
  const void* in[6] = {q_t, k_t, v_t, q_l, k_l, v_l};
  for (int i = 0; i < 6; ++i) {
    p.in[i] = static_cast<const __nv_bfloat16*>(in[i]);
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.bias = static_cast<const float*>(bias);
  p.bias_stride = strides[18];
  p.out_t = static_cast<__nv_bfloat16*>(out_t);
  p.out_l = static_cast<__nv_bfloat16*>(out_l);
  p.nh = nh;
  p.L = L;
  p.scale_t = scale_t;
  p.scale_l = scale_l;
  dim3 grid((L + kTileQ - 1) / kTileQ, nh, B);
  biacm_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* biacm_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
