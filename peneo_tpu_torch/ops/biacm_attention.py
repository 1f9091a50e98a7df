"""Fused BiACM (dual-stream) attention of LiLT: the CUDA kernel and its
plain twin.

Counterpart of ``peneo_tpu/ops/biacm_attention.py:biacm_attention`` (the
Pallas TPU inference kernel). Per (batch, head):

    s     = q_t·k_tᵀ·scale_t + q_l·k_lᵀ·scale_l + bias      fp32
    p     = softmax(s)
    ctx_t = p·v_t   (d = 64);   ctx_l = p·v_l   (d = 16)

Public layout is the JAX package's: q/k/v ``(B, nh, L, d)`` (any strides
with a contiguous last dim — the LiLT layer passes transposed views of its
``(B, L, nh, d)`` projections), ``bias`` ``(B, L)`` fp32 additive key mask.

- :func:`biacm_attention` is the entry point. On a CUDA tensor it launches
  the hand-written kernel (``csrc/biacm_attention.cu``, built with nvcc at
  first use) and raises if the kernel cannot build or launch; on a CPU
  tensor it runs :func:`biacm_attention_reference`.
- :func:`biacm_attention_reference` is the plain twin (einsum + softmax in
  fp32). It runs on the card only when a caller asks for it by name.
- :func:`biacm_attention_cuda` is the kernel wrapper; its ``launches``
  attribute counts the launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

SOURCE = "biacm_attention.cu"
HEAD_DIM_T = 64  # head dims the CUDA kernel is compiled for
HEAD_DIM_L = 16

_LIB = None
_LIB_LOCK = threading.Lock()


def biacm_attention_reference(q_t, k_t, v_t, q_l, k_l, v_l, bias,
                              scale_t: float, scale_l: float):
    """Plain PyTorch BiACM attention. Scores, softmax and the p·v products
    run in fp32; p is rounded to the input dtype before p·v and the outputs
    are returned in the input dtype, as the TPU kernel does. Returns
    ``(ctx_t (B, nh, L, d_t), ctx_l (B, nh, L, d_l))``."""
    f = torch.float32
    s = (torch.einsum("bhld,bhmd->bhlm", q_t.to(f), k_t.to(f)) * scale_t
         + torch.einsum("bhld,bhmd->bhlm", q_l.to(f), k_l.to(f)) * scale_l
         + bias.to(f)[:, None, None, :])
    p = torch.softmax(s, dim=-1).to(q_t.dtype).to(f)
    ctx_t = torch.einsum("bhlm,bhmd->bhld", p, v_t.to(f))
    ctx_l = torch.einsum("bhlm,bhmd->bhld", p, v_l.to(f))
    return ctx_t.to(q_t.dtype), ctx_l.to(q_t.dtype)


def load_kernel():
    """The CUDA library (built with nvcc at first use, then cached); raises
    if it cannot be built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .cuda_build import build_library

            lib = ctypes.CDLL(build_library(SOURCE))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.biacm_attention_fwd.argtypes = (
                [vp] * 9 + [ctypes.POINTER(ctypes.c_int64), i32, i32, i32,
                            ctypes.c_float, ctypes.c_float, vp])
            lib.biacm_attention_fwd.restype = i32
            lib.biacm_attention_error_string.argtypes = [i32]
            lib.biacm_attention_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")
    vec = 16 // x.element_size()  # kernel loads 16-byte rows pieces
    if x.data_ptr() % 16 or any(st % vec for st in x.stride()[:-1]):
        raise ValueError(f"{name}: rows must be 16-byte aligned (strides "
                         f"{x.stride()})")


def biacm_attention_cuda(q_t, k_t, v_t, q_l, k_l, v_l, bias,
                         scale_t: float, scale_l: float):
    """Launch the CUDA kernel on the current stream. Inputs bf16 on one CUDA
    device, d_t = 64, d_l = 16, any L ≥ 1. Outputs are ``(B, nh, L, d)``
    views of ``(B, L, nh, d)`` contiguous buffers."""
    if not q_t.is_cuda:
        raise ValueError("biacm_attention_cuda takes CUDA tensors")
    B, nh, L, dt = q_t.shape
    dl = q_l.shape[-1]
    if (dt, dl) != (HEAD_DIM_T, HEAD_DIM_L):
        raise ValueError(f"the CUDA kernel is built for head dims "
                         f"({HEAD_DIM_T}, {HEAD_DIM_L}), got ({dt}, {dl})")
    if L < 1:
        raise ValueError("L must be >= 1")
    dev = q_t.device
    for name, x, d in (("q_t", q_t, dt), ("k_t", k_t, dt), ("v_t", v_t, dt),
                       ("q_l", q_l, dl), ("k_l", k_l, dl), ("v_l", v_l, dl)):
        _check(name, x, (B, nh, L, d), torch.bfloat16, dev)
    if bias.device != dev or bias.dtype != torch.float32 \
            or tuple(bias.shape) != (B, L) or bias.stride(-1) != 1:
        raise ValueError(f"bias: expected contiguous-row float32 (B, L) on "
                         f"{dev}, got {bias.dtype} {tuple(bias.shape)}")
    lib = load_kernel()
    out_t = torch.empty((B, L, nh, dt), dtype=torch.bfloat16, device=dev)
    out_l = torch.empty((B, L, nh, dl), dtype=torch.bfloat16, device=dev)
    strides = (ctypes.c_int64 * 19)(
        *[s for x in (q_t, k_t, v_t, q_l, k_l, v_l)
          for s in (x.stride(0), x.stride(1), x.stride(2))], bias.stride(0))
    with torch.cuda.device(dev):  # the launch targets the inputs' device
        rc = lib.biacm_attention_fwd(
            q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), q_l.data_ptr(),
            k_l.data_ptr(), v_l.data_ptr(), bias.data_ptr(), out_t.data_ptr(),
            out_l.data_ptr(), strides, B, nh, L, float(scale_t),
            float(scale_l), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("biacm_attention kernel launch failed: "
                           + lib.biacm_attention_error_string(rc).decode())
    biacm_attention_cuda.launches += 1
    return out_t.transpose(1, 2), out_l.transpose(1, 2)


biacm_attention_cuda.launches = 0


def biacm_attention(q_t, k_t, v_t, q_l, k_l, v_l, bias,
                    scale_t: float, scale_l: float):
    """BiACM attention: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors. Returns ``(ctx_t (B, nh, L, d_t), ctx_l (B, nh, L, d_l))``."""
    if q_t.is_cuda:
        return biacm_attention_cuda(q_t, k_t, v_t, q_l, k_l, v_l, bias,
                                    scale_t, scale_l)
    return biacm_attention_reference(q_t, k_t, v_t, q_l, k_l, v_l, bias,
                                     scale_t, scale_l)
