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
// (mma.sync m16n8k16 bf16 → fp32). Simple first version: no TMA (bias rows
// of 709 floats are not 16-byte aligned), no wgmma, no software pipelining.
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
// - Per key tile the (64, 64) fp32 bias tile is staged in shared memory,
//   read from device memory coalesced along the key axis with scalar loads
//   through the strides the wrapper passes (last dim contiguous); the model
//   allocates rel_bias with its natural row stride L, no padding.
// - Valid scores are clamped to the finite range, so a mask of
//   finfo(f32).min plus a negative bias stays finite and a fully masked row
//   gives a uniform p, never NaN. Keys past L get −inf and contribute 0.
// - p is rounded to bf16 before p·v, as the TPU kernel does (here before
//   normalisation, where p ≤ 1).
// - q/k/v are read through (batch, head, seq) strides with a contiguous
//   last dim, so the (B, L, nh, d) projection outputs are used in place; the
//   output is written (B, L, nh, d) contiguous.
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
__global__ void __launch_bounds__(relbias::kThreads)
bias_fwd_kernel(const relbias::FwdParams p) {
  relbias::forward_tile<false, false>(p);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, which the caller sets. `ptrs` and `strides` as
// relbias::make_params lays them out (bits and statistics unused here).
// Returns the cudaError_t of the launch (0 = launched).
int bias_attention_fwd(const uint64_t* ptrs, const int64_t* strides, int B,
                       int nh, int L, float scale, void* stream) {
  const relbias::FwdParams p = relbias::make_params(
      ptrs, strides, nh, L, scale, biacm::kNoDropout, 0, 0, 0, 1.f);
  dim3 grid((L + relbias::kTile - 1) / relbias::kTile, nh, B);
  bias_fwd_kernel<<<grid, relbias::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* bias_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
