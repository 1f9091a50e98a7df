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
// on the tensor cores (mma.sync m16n8k16 bf16 → fp32). What the kernel
// spends its time on is not the products but load latency and
// shared-memory instructions, so the K/V tiles of the next step travel by
// cp.async into a 2-stage ring while the warps compute, sit in shared
// memory once, as rows, and reach the registers through ldmatrix (.trans
// for V): biacm_common.cuh. No TMA, no wgmma.
//
// Design, and how it differs from the TPU kernel: the TPU kernel keeps the
// full K/V rows of a (b, h) in VMEM and does a one-pass softmax over a
// (128, L) fp32 tile. A Hopper SM has 227 KB of shared memory, less than the
// K/V of both streams plus that score tile at L=512, so here the keys are
// tiled (64 per step) and the softmax is online (running row max m and sum
// l, rescaled per tile). The body is `biacm::forward_tile` of
// biacm_common.cuh, which the training forward (biacm_attention_train.cu)
// instantiates too, with dropout and row statistics:
//
// - One CTA per (64-row query tile, h, b); 4 warps, each owning 16 query
//   rows. Q fragments stay in registers for the whole key loop; ≤ 168
//   registers a thread, 3 CTAs per SM.
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

#include "biacm_common.cuh"

namespace {

// kernel #1: the shared forward body without dropout and without the row
// statistics (biacm_common.cuh)
__global__ void __launch_bounds__(biacm::kThreads, 3)
biacm_fwd_kernel(const biacm::FwdParams p) {
  biacm::forward_tile<false, false>(p);
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
  biacm::FwdParams p = {};
  const void* in[6] = {q_t, k_t, v_t, q_l, k_l, v_l};
  for (int i = 0; i < 6; ++i) {
    p.in[i] = static_cast<const __nv_bfloat16*>(in[i]);
    for (int j = 0; j < 3; ++j) p.stride[i][j] = strides[3 * i + j];
  }
  p.bias = static_cast<const float*>(bias);
  p.bias_stride = strides[18];
  p.out[0] = static_cast<__nv_bfloat16*>(out_t);
  p.out[1] = static_cast<__nv_bfloat16*>(out_l);
  p.nh = nh;
  p.L = L;
  p.scale_t = scale_t;
  p.scale_l = scale_l;
  static bool allowed[64] = {};
  const cudaError_t err = biacm::allow_shared_memory(
      biacm_fwd_kernel, biacm::kSmemBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + biacm::kTile - 1) / biacm::kTile, nh, B);
  biacm_fwd_kernel<<<grid, biacm::kThreads, biacm::kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What cudaOccupancyMaxActiveBlocksPerMultiprocessor grants the kernel on
// the current device: resident CTAs per SM, or minus the cudaError_t.
// `smem_bytes` receives its dynamic shared memory.
int biacm_attention_occupancy(int* smem_bytes) {
  static bool allowed[64] = {};
  cudaError_t err = biacm::allow_shared_memory(
      biacm_fwd_kernel, biacm::kSmemBytes, allowed);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  *smem_bytes = biacm::kSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, biacm_fwd_kernel, biacm::kThreads, *smem_bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* biacm_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
