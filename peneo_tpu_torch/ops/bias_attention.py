"""Fused rel-bias attention of LayoutLMv3 and LayoutLMv2: the CUDA kernels
and their plain twins — the inference forward (kernel #4) and the training
pair (kernels #5 and #6, forward with attention dropout and its backward
with the bias gradient).

Counterpart of ``peneo_tpu/ops/bias_attention.py`` (the Pallas TPU kernels
``bias_attention`` and ``bias_attention_train``). Per (batch, head):

    s   = q·kᵀ·scale + bias + mask      fp32
    p   = softmax(s)
    ctx = p·v                           (d = 64)

Public layout is the JAX package's: q/k/v ``(B, nh, L, d)`` (any strides
with a contiguous last dim — the layer passes transposed views of its
``(B, L, nh, d)`` projections), ``bias`` ``(B, nh, L, L)`` fp32 (the
relative-position bias, divided by √d for LayoutLMv3, unscaled for
LayoutLMv2; any batch/head/row strides with a contiguous last dim: rows
16-byte aligned, as the model's ``RelBias`` lays them out, move in 16-byte
requests, others in 4-byte ones), ``mask`` ``(B, L)`` fp32 additive key
mask.

- :func:`bias_attention` is the inference entry point. It calls the
  operator ``peneo::bias_attention`` (:func:`bias_attention_op`, a
  ``torch.library`` custom op with a fake, kept by ``torch.export`` as one
  node of the graph). On a CUDA tensor it launches the hand-written kernel
  (``csrc/bias_attention.cu``, built with nvcc at first use) and raises if
  the kernel cannot build or launch; on a CPU tensor it runs
  :func:`bias_attention_reference`, the plain twin (einsum + softmax in
  fp32), which runs on the card only when a caller asks for it by name.
- :func:`bias_attention_train` is the training entry point (``rng`` an int
  seed or explicit mask bits). It applies :class:`BiasAttentionTrain`: on
  CUDA tensors the forward kernel and the backward kernels
  (``csrc/bias_attention_train.cu``), on CPU tensors
  :func:`bias_attention_train_reference` and its autograd gradient.
  Gradients flow to q, k, v **and the bias** (``dbias = dS``, fp32).
- One dropout mask over ``p``: keep iff ``bits < keep_threshold(rate)``,
  kept values scaled by ``1/(1-rate)``. On the card a mask kernel, launched
  with the forward, draws the bits: four keys per Philox4x32-10 draw, word
  ``j & 3`` of the draw at the counter ``(j >> 2, i, h, b)``, i.e.
  ``element_dropout_bits(seed, B, nh, L)``. It writes the keep flags
  bit-packed, int32 ``(B, nh, L, ceil(L / 32))`` (``pack_keep_mask``'s
  layout), which the forward and the backward read: the backward draws
  nothing, and the flags, not the seed, are saved for it.
- :func:`bias_attention_cuda`, :func:`bias_attention_train_fwd_cuda` and
  :func:`bias_attention_train_bwd_cuda` launch the kernels; each counts its
  launches in ``launches`` (the forward one per call of the mask kernel and
  the attention kernel, the backward one per call of its two kernels).
  :func:`kernel_occupancy` reports what the runtime grants each kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .biacm_attention import (_MODES, _U32, _aligned, _check,
                              _kernel_layout, _u32, device_seed,
                              element_dropout_bits, keep_threshold,
                              twin_vjp, unpack_keep_mask)

SOURCE = "bias_attention.cu"
TRAIN_SOURCE = "bias_attention_train.cu"
HEAD_DIM = 64  # head dim the CUDA kernels are compiled for

_LIB = None
_TRAIN_LIB = None
_LIB_LOCK = threading.Lock()


def _scores(q, k, bias, mask, scale: float):
    f = torch.float32
    return (torch.einsum("bhld,bhmd->bhlm", q.to(f), k.to(f)) * scale
            + bias.to(f) + mask.to(f)[:, None, None, :])


def bias_attention_reference(q, k, v, bias, mask, scale: float):
    """Plain PyTorch rel-bias attention. Scores, softmax and the p·v product
    run in fp32; p is rounded to the input dtype before p·v and the output
    is returned in the input dtype, as the TPU kernel does. Returns ``ctx``
    ``(B, nh, L, d)``."""
    f = torch.float32
    p = torch.softmax(_scores(q, k, bias, mask, scale), dim=-1)
    ctx = torch.einsum("bhlm,bhmd->bhld", p.to(q.dtype).to(f), v.to(f))
    return ctx.to(q.dtype)


def bias_attention_train_reference(q, k, v, bias, mask, bits, scale: float,
                                   rate: float = 0.0):
    """Plain PyTorch training rel-bias attention with explicit mask bits
    ``bits`` ((B, nh, L, L), ignored at ``rate == 0``). As the TPU kernel:
    fp32 scores and softmax, ``p1 = keep ? p/(1-r) : 0`` rounded to the
    input dtype before the fp32 ``p1·v`` product, output in the input dtype.
    Autograd through it gives the reference gradients of q, k, v and bias."""
    f = torch.float32
    p = torch.softmax(_scores(q, k, bias, mask, scale), dim=-1)
    if rate > 0.0:
        p = torch.where(_u32(bits) < keep_threshold(rate),
                        p * (1.0 / (1.0 - rate)), 0.0)
    ctx = torch.einsum("bhlm,bhmd->bhld", p.to(q.dtype).to(f), v.to(f))
    return ctx.to(q.dtype)


def _bind(lib, names, argtypes, error_string):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, error_string)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


_PTRS, _STRIDES = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)


def load_kernel():
    """The inference kernel's CUDA library (built with nvcc at first use,
    then cached); raises if it cannot be built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .cuda_build import build_library

            lib = _bind(
                ctypes.CDLL(build_library(SOURCE)), ["bias_attention_fwd"],
                [_PTRS, _STRIDES, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_void_p],
                "bias_attention_error_string")
            lib.bias_attention_occupancy.argtypes = [
                ctypes.POINTER(ctypes.c_int)]
            lib.bias_attention_occupancy.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def load_train_kernel():
    """The training kernels' CUDA library (built at first use, cached);
    raises if it cannot be built or loaded."""
    global _TRAIN_LIB
    with _LIB_LOCK:
        if _TRAIN_LIB is None:
            from .cuda_build import build_library

            lib = ctypes.CDLL(build_library(TRAIN_SOURCE))
            u32 = ctypes.c_uint32
            common = [_PTRS, _STRIDES, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int, u32, u32,
                      u32, ctypes.c_float]
            _bind(lib, ["bias_train_fwd", "bias_train_bwd"],
                  common + [ctypes.c_void_p], "bias_train_error_string")
            lib.bias_train_occupancy.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.bias_train_occupancy.restype = ctypes.c_int
            _TRAIN_LIB = lib
    return _TRAIN_LIB


KERNEL_NAMES = ("bias_fwd_kernel", "bias_train_fwd_kernel<true>",
                "bias_train_fwd_kernel<false>", "bias_train_dq_kernel",
                "bias_train_dkdv_kernel", "bias_keep_mask_kernel")


def kernel_occupancy(device=None) -> dict:
    """What ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` grants each
    rel-bias kernel on ``device``: ``{name: {"ctas_per_sm",
    "dynamic_smem"}}`` at the kernels' 128 threads a CTA."""
    out = {}
    with torch.cuda.device(device):
        for i, name in enumerate(KERNEL_NAMES):
            smem = ctypes.c_int(0)
            if i == 0:
                lib = load_kernel()
                n = lib.bias_attention_occupancy(ctypes.byref(smem))
                err = lib.bias_attention_error_string
            else:
                lib = load_train_kernel()
                n = lib.bias_train_occupancy(i - 1, ctypes.byref(smem))
                err = lib.bias_train_error_string
            if n < 0:
                raise RuntimeError(f"occupancy query of {name} failed: "
                                   + err(-n).decode())
            out[name] = {"ctas_per_sm": n, "dynamic_smem": smem.value}
    return out


def _check_inputs(q, k, v, bias, mask):
    """Wrapper checks shared by the CUDA launchers; returns (B, nh, L)."""
    if not q.is_cuda:
        raise ValueError("the rel-bias CUDA kernels take CUDA tensors")
    B, nh, L, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernels are built for head dim "
                         f"{HEAD_DIM}, got {d}")
    if L < 1 or L >= 2 ** 17:  # a head's L·ceil(L/32) keep words: 32 bits
        raise ValueError("L must be in [1, 2^17)")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, (B, nh, L, d), torch.bfloat16, dev)
    if bias.device != dev or bias.dtype != torch.float32 \
            or tuple(bias.shape) != (B, nh, L, L) or bias.stride(-1) != 1:
        raise ValueError(
            f"bias: expected float32 (B, nh, L, L) = {(B, nh, L, L)} on "
            f"{dev} with a contiguous last dim, got {bias.dtype} "
            f"{tuple(bias.shape)} strides {bias.stride()} on {bias.device}")
    # the kernels index a head's bias rows with 32-bit element offsets
    if (L + 64) * bias.stride(2) >= 2 ** 31:
        raise ValueError(f"bias: a head's rows must span fewer than 2^31 "
                         f"elements (row stride {bias.stride(2)})")
    if mask.device != dev or mask.dtype != torch.float32 \
            or tuple(mask.shape) != (B, L) or mask.stride(-1) != 1:
        raise ValueError(f"mask: expected contiguous-row float32 (B, L) on "
                         f"{dev}, got {mask.dtype} {tuple(mask.shape)}")
    return B, nh, L


def _strides(q, k, v, bias, mask, *more):
    return ([s for x in (q, k, v, bias) for s in x.stride()[:3]]
            + [mask.stride(0)] + [s for x in more for s in x.stride()[:3]])


def _carray(ctype, values):
    return (ctype * len(values))(*values)


def _raise_on(rc, lib, error_string, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + getattr(lib, error_string)(rc).decode())


def bias_attention_cuda(q, k, v, bias, mask, scale: float):
    """Launch kernel #4 on the current stream. q/k/v bf16 on one CUDA
    device, d = 64, any L ≥ 1; bias fp32 (B, nh, L, L), mask fp32 (B, L).
    The output is a ``(B, nh, L, d)`` view of a ``(B, L, nh, d)`` buffer."""
    B, nh, L = _check_inputs(q, k, v, bias, mask)
    lib = load_kernel()
    out = torch.empty((B, L, nh, HEAD_DIM), dtype=torch.bfloat16,
                      device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), 0, 0, out.data_ptr(), 0]
    with torch.cuda.device(q.device):  # the launch targets the inputs' device
        rc = lib.bias_attention_fwd(
            _carray(ctypes.c_uint64, ptrs),
            _carray(ctypes.c_int64, _strides(q, k, v, bias, mask)), B, nh, L,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "bias_attention_error_string", "bias_attention")
    bias_attention_cuda.launches += 1
    return out.transpose(1, 2)


bias_attention_cuda.launches = 0


@torch.library.custom_op("peneo::bias_attention", mutates_args=(),
                         device_types="cpu")
def bias_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, mask: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Kernel #4 as the operator ``peneo::bias_attention``, which an
    exported program holds as one node. The bias keeps its strides (the
    padded rows of ``RelBias`` go in without a copy). CPU tensors run the
    plain twin (its output copied into the kernel's layout, so that both
    devices return the strides the fake gives); CUDA tensors run
    :func:`bias_attention_cuda`, which launches the kernel or raises."""
    ctx = bias_attention_reference(q, k, v, bias, mask, scale)
    return _kernel_layout(ctx).copy_(ctx)


bias_attention_op.register_kernel("cuda")(bias_attention_cuda)


@bias_attention_op.register_fake
def _(q, k, v, bias, mask, scale):
    return _kernel_layout(q)


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.scale = inputs[5]


bias_attention_op.register_autograd(
    lambda ctx, dctx: (*twin_vjp(bias_attention_reference, ctx, dctx,
                                 ctx.scale), None),
    setup_context=_save_inputs)


def bias_attention(q, k, v, bias, mask, scale: float):
    """Rel-bias attention through ``peneo::bias_attention``: the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors. Returns ``ctx
    (B, nh, L, d)``, a view of a ``(B, L, nh, d)`` buffer."""
    return bias_attention_op(q, k, v, bias, mask, float(scale))


# ---------------------------------------------------------------------------
# Training: forward with attention dropout (kernel #5) and backward (#6).
# ---------------------------------------------------------------------------

def _rng_args(rng, rate: float, shape, dev):
    """(mode, seed_lo, seed_hi, bits): ``rng`` is an int seed (the in-kernel
    generator), a 0-d int64 tensor on the card holding the seed (its
    address goes where the bits' would) or explicit bits (B, nh, L, L),
    int64 or int32 bit patterns, passed to the kernel as uint32."""
    if rate <= 0.0:
        return _MODES["none"], 0, 0, None
    if device_seed(rng, dev):
        return _MODES["device"], 0, 0, rng
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != tuple(shape) or rng.device != dev:
            raise ValueError(f"bits: expected {tuple(shape)} on {dev}, got "
                             f"{tuple(rng.shape)} on {rng.device}")
        if rng.dtype == torch.int64:
            rng = torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng)
        elif rng.dtype != torch.int32:
            raise ValueError(f"bits: int64 or int32 bits, got {rng.dtype}")
        return _MODES["bits"], 0, 0, rng.to(torch.int32).contiguous()
    seed = int(rng)
    return _MODES["philox"], seed & _U32, (seed >> 32) & _U32, None


def _dropout_args(rng, rate):
    mode, lo, hi, _ = rng
    return (mode, lo, hi, keep_threshold(rate) if rate > 0 else 0,
            1.0 / (1.0 - rate) if rate > 0 else 1.0)


def bias_attention_train_fwd_cuda(q, k, v, bias, mask, rng, scale: float,
                                  rate: float = 0.0):
    """Launch the training forward (kernel #5; at ``rate > 0`` the mask
    kernel first, then the attention kernel) on the current stream.
    Returns ``(ctx, stats, keep)``: the output as a ``(B, nh, L, d)`` view
    of a ``(B, L, nh, d)`` bf16 buffer, fp32 ``(B, nh, L, 2)`` row
    statistics (max, log of the sum) and, at ``rate > 0``, the keep flags
    packed as :func:`pack_keep_mask` packs them, int32 ``(B, nh, L,
    ceil(L / 32))`` (else None), both for the backward."""
    B, nh, L = _check_inputs(q, k, v, bias, mask)
    dev = q.device
    rng = _rng_args(rng, rate, (B, nh, L, L), dev)
    lib = load_train_kernel()
    out = torch.empty((B, L, nh, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((B, nh, L, 2), dtype=torch.float32, device=dev)
    keep = None
    if rate > 0.0:
        keep = torch.empty((B, nh, L, (L + 31) // 32), dtype=torch.int32,
                           device=dev)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), 0 if rng[3] is None else rng[3].data_ptr(),
            stats.data_ptr(), out.data_ptr(),
            0 if keep is None else keep.data_ptr()]
    with torch.cuda.device(dev):
        rc = lib.bias_train_fwd(
            _carray(ctypes.c_uint64, ptrs),
            _carray(ctypes.c_int64, _strides(q, k, v, bias, mask)), B, nh, L,
            float(scale), *_dropout_args(rng, rate),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "bias_train_error_string",
              "bias_attention_train forward")
    bias_attention_train_fwd_cuda.launches += 1
    return out.transpose(1, 2), stats, keep


bias_attention_train_fwd_cuda.launches = 0


def bias_attention_train_bwd_cuda(q, k, v, bias, mask, keep, stats, dctx,
                                  scale: float, rate: float = 0.0):
    """Launch the training backward (kernel #6: the dq kernel, which also
    sums ``D = rowsum(p ⊙ dP)`` and writes ``dbias``, then the dk/dv kernel)
    on the current stream. ``stats`` and ``keep`` are the forward's row
    statistics and packed keep flags (``keep`` is ignored at ``rate ==
    0``); the backward draws no bits. ``dctx`` is the output gradient
    (bf16, any strides with a contiguous, 16-byte aligned last dim). dS
    enters the dq/dk products as hi + lo bf16 parts.
    Returns ``(dq, dk, dv, dbias)``: dq/dk/dv as ``(B, nh, L, d)`` views of
    ``(B, L, nh, d)`` bf16 buffers (dk/dv accumulate in fp32 registers),
    dbias fp32 ``(B, nh, L, L)``, a view of a ``(B, nh, L, L4)`` buffer with
    ``L4`` = L rounded up to a multiple of 4 (16-byte rows)."""
    B, nh, L = _check_inputs(q, k, v, bias, mask)
    dev = q.device
    _check("dctx", dctx, (B, nh, L, HEAD_DIM), torch.bfloat16, dev)
    if tuple(stats.shape) != (B, nh, L, 2) or not stats.is_contiguous() \
            or stats.dtype != torch.float32 or stats.device != dev:
        raise ValueError("stats: expected the forward's contiguous float32 "
                         f"(B, nh, L, 2) on {dev}")
    if rate > 0.0:
        shape = (B, nh, L, (L + 31) // 32)
        if keep is None or tuple(keep.shape) != shape \
                or not keep.is_contiguous() or keep.dtype != torch.int32 \
                or keep.device != dev:
            raise ValueError("keep: expected the forward's contiguous int32 "
                             f"{shape} on {dev}")
    # the backward reads only whether there is dropout (mode 0 or not)
    rng = (_MODES["philox"] if rate > 0.0 else _MODES["none"], 0, 0, None)
    lib = load_train_kernel()
    grads = [torch.empty((B, L, nh, HEAD_DIM), dtype=torch.bfloat16,
                         device=dev) for _ in range(3)]
    dbias = torch.empty((B, nh, L, -(-L // 4) * 4), dtype=torch.float32,
                        device=dev)[..., :L]
    delta = torch.empty((B, nh, L), dtype=torch.float32, device=dev)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), 0, stats.data_ptr(), 0,
            keep.data_ptr() if rate > 0.0 else 0, dctx.data_ptr(),
            delta.data_ptr(), *(g.data_ptr() for g in grads),
            dbias.data_ptr()]
    with torch.cuda.device(dev):
        rc = lib.bias_train_bwd(
            _carray(ctypes.c_uint64, ptrs),
            _carray(ctypes.c_int64,
                    _strides(q, k, v, bias, mask, dctx, dbias)),
            B, nh, L, float(scale), *_dropout_args(rng, rate),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "bias_train_error_string",
              "bias_attention_train backward")
    bias_attention_train_bwd_cuda.launches += 1
    return (*(g.transpose(1, 2) for g in grads), dbias)


bias_attention_train_bwd_cuda.launches = 0


def keep_flag_bits(keep: torch.Tensor, L: int) -> torch.Tensor:
    """Bits for the plain twin from kernel #5's packed keep flags ``(B, nh,
    L, ceil(L / 32))``: 0 where an element is kept (below every threshold),
    2³² − 1 where it is dropped."""
    return torch.where(unpack_keep_mask(keep, L), 0, _U32)


def _cpu_bits(rng, rate, q):
    if rate <= 0.0:
        return None
    if isinstance(rng, torch.Tensor) and rng.dim() > 0:
        return rng
    B, nh, L, _ = q.shape  # an int seed, or a 0-d tensor holding one
    return element_dropout_bits(int(rng), B, nh, L, device=q.device)


class BiasAttentionTrain(torch.autograd.Function):
    """Differentiable training rel-bias attention. CUDA tensors: kernel #5
    forward, kernel #6 backward; the forward's packed keep flags (not the
    seed) are kept for the backward with the row statistics (a checkpoint
    recompute redraws the same flags from the same seed). CPU tensors: the
    plain twin, and its autograd gradient recomputed in the backward. The
    bias gets ``dbias = dS``; the key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, rng, scale, rate):
        ctx.args = (scale, rate)
        if q.is_cuda:
            out, stats, keep = bias_attention_train_fwd_cuda(
                q, k, v, bias, mask, rng, scale, rate)
            saved = (q, k, v, bias, mask, stats)
            ctx.save_for_backward(*saved + (() if keep is None else (keep,)))
            return out
        ctx.rng = _cpu_bits(rng, rate, q)
        ctx.save_for_backward(q, k, v, bias, mask)
        return bias_attention_train_reference(q, k, v, bias, mask, ctx.rng,
                                              scale, rate)

    @staticmethod
    def backward(ctx, dctx):
        scale, rate = ctx.args
        saved = ctx.saved_tensors  # once: a checkpoint unpacks it once
        if saved[0].is_cuda:
            q, k, v, bias, mask, stats = saved[:6]
            keep = saved[6] if len(saved) > 6 else None
            grads = bias_attention_train_bwd_cuda(
                q, k, v, bias, mask, keep, stats,
                _aligned(dctx.to(torch.bfloat16)), scale, rate)
            return (*grads, None, None, None, None)
        q, k, v, bias, mask = saved
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
            out = bias_attention_train_reference(*leaves, mask, ctx.rng,
                                                 scale, rate)
            grads = torch.autograd.grad(out, leaves, dctx)
        return (*grads, None, None, None, None)


def bias_attention_train(q, k, v, bias, mask, rng, scale: float,
                         rate: float = 0.0):
    """Differentiable rel-bias attention with attention dropout at ``rate``
    (one mask over the probabilities). Layout of the JAX function: q/k/v
    ``(B, nh, L, d)``, ``bias (B, nh, L, L)`` fp32 (trained), ``mask
    (B, L)`` fp32; ``rng`` an int seed (the mask kernel's Philox bits,
    ``element_dropout_bits(...)`` on the CPU), a 0-d int64 tensor holding
    the seed (on the card: read by the mask kernel when it runs, so a CUDA
    graph's replays draw fresh masks) or explicit bits ``(B, nh, L, L)``.
    Returns ``ctx (B, nh, L, d)``."""
    return BiasAttentionTrain.apply(q, k, v, bias, mask, rng, float(scale),
                                    float(rate))
