// Rel-bias attention of LayoutLMv3 for Hopper, inference forward.
//
// Replaces the Pallas TPU kernel `_kernel` / `bias_attention` in
// peneo_tpu/ops/bias_attention.py. Per (batch b, head h):
//
//   s   = q·kᵀ·scale + rel_bias[b, h] + key_mask[b]     fp32
//   p   = softmax(s)                                     fp32 stats
//   ctx = p·v  (d = 64)                                  bf16 out
//
// rel_bias is the model's precomputed fp32 (B, nh, L, L) relative-position
// bias (1D + 2D bucket tables, already divided by √d), shared by all layers.
//
// What bounds it on the H100: bytes, and of them the bias. At the serving
// shape (B=32, nh=12, L=709: 512 text positions + 197 visual tokens) one
// call reads 4·B·nh·L² = 772 MB of bias against 139 MB of bf16 q/k/v/out,
// and does 4·B·nh·L²·64 = 49 GFLOP: 54 FLOP per byte, far under the card's
// ~295 FLOP/byte balance point. The least time is the bias read (~0.27 ms).
// The design reads each bias element exactly once, keeps the (L, L) scores
// and probabilities out of device memory (the plain version writes and
// re-reads them several times), and runs both products on the tensor cores
// (mma.sync m16n8k16 bf16 → fp32). No TMA and no wgmma: the products are
// not what binds.
//
// Design, and how it differs from the TPU kernel: the TPU kernel keeps the
// full K/V rows of a (b, h) and a (TQ, L) fp32 score tile in VMEM, pads L
// to a multiple of 64 and gives way to the einsum path above 10 % padding.
// Here the keys are tiled (64 per step) with an online softmax and
// predicated tails, so any L ≥ 1 runs without padding. The body is
// `relbias::forward_tile` of bias_common.cuh, which the training forward
// (bias_attention_train.cu) instantiates too, with dropout and row
// statistics:
//
// - One CTA per (64-row query tile, h, b); 4 warps, each owning 16 query
//   rows. Q fragments stay in registers for the whole key loop.
// - K, V (as row tiles), the (64, 64) fp32 bias tile and the key mask of
//   the next key tile travel by cp.async into the other stage of a 2-stage
//   ring (75,264 B of dynamic shared memory) while the warps compute on the
//   current one; fragments by ldmatrix (V by its .trans form). The bias
//   tile moves in 16-byte requests where its rows are 16-byte aligned (the
//   model's RelBias pads rows of 709 floats to 712), else in 4-byte ones
//   (any bias with a contiguous last dim, through its strides).
// - Valid scores are clamped to the finite range, so a mask of
//   finfo(f32).min plus a negative bias stays finite and a fully masked row
//   gives a uniform p, never NaN. Keys past L get −inf and contribute 0.
// - p is rounded to bf16 before p·v, as the TPU kernel does (here before
//   normalisation, where p ≤ 1).
// - q/k/v are read through (batch, head, seq) strides with a contiguous
//   last dim, so the (B, L, nh, d) projection outputs are used in place; the
//   output is written (B, L, nh, d) contiguous.
// - Residency: the shared memory of the ring allows 3 CTAs per SM (the
//   register cap of __launch_bounds__ matches; ptxas takes 144 registers,
//   no spill), 11.6 waves of the 4,608 CTAs at B=32. On an H100 80GB HBM3
//   at 700 W one call takes 0.37 ms of device time against the bias read's
//   0.27 (PERF.md §6).
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

// kernel #4: the shared forward body without dropout and without the row
// statistics (bias_common.cuh)
__global__ void __launch_bounds__(relbias::kThreads, 3)
bias_fwd_kernel(const relbias::FwdParams p) {
  relbias::forward_tile<false, false>(p);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets. `ptrs` and `strides` as
// relbias::make_params lays them out (bits, statistics and keep flags
// unused here).
// Returns the cudaError_t of the launch (0 = launched).
int bias_attention_fwd(const uint64_t* ptrs, const int64_t* strides, int B,
                       int nh, int L, float scale, void* stream) {
  const relbias::FwdParams p = relbias::make_params(
      ptrs, strides, nh, L, scale, biacm::kNoDropout, 0, 0, 0, 1.f);
  static bool allowed[64] = {};
  const cudaError_t err = biacm::allow_shared_memory(
      bias_fwd_kernel, relbias::kSmemBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + relbias::kTile - 1) / relbias::kTile, nh, B);
  bias_fwd_kernel<<<grid, relbias::kThreads, relbias::kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What cudaOccupancyMaxActiveBlocksPerMultiprocessor grants the kernel on
// the current device: resident CTAs per SM, or minus the cudaError_t.
// `smem_bytes` receives its dynamic shared memory.
int bias_attention_occupancy(int* smem_bytes) {
  static bool allowed[64] = {};
  cudaError_t err = biacm::allow_shared_memory(
      bias_fwd_kernel, relbias::kSmemBytes, allowed);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  *smem_bytes = relbias::kSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bias_fwd_kernel, relbias::kThreads, *smem_bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* bias_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
