"""Fused BiACM (dual-stream) attention of LiLT: the CUDA kernels and their
plain twins — the inference forward (kernel #1) and the training pair
(kernels #2 and #3, forward with attention dropout and its backward).

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

Training (counterpart of ``biacm_attention_train``, the custom-VJP pair of
Pallas kernels ``_fwd_train_kernel`` / ``_bwd_train_kernel``): two
independent dropout masks over the shared ``p``, one per stream, keep iff
``bits < keep_threshold(rate)``, kept values scaled by ``1/(1-rate)``.

- :func:`biacm_attention_train` is the entry point (the JAX function's
  layout; ``rng`` an int seed or explicit ``(bits1, bits2)``). It applies
  :class:`BiacmAttentionTrain`: on CUDA tensors the forward kernel and the
  backward kernels (``csrc/biacm_attention_train.cu``), on CPU tensors the
  plain twin and its autograd gradient. A small mask kernel, launched with
  the forward, draws the masks once; the forward and the backward read
  them bit-packed. A pass of Philox draws over the (L, L) elements measured
  longer than the forward's products and the attention kernels would make
  four, so the masks (L²/4 bytes per head), not the seed, are what is
  saved.
- :func:`biacm_attention_train_reference` is the plain twin, taking explicit
  mask bits; autograd through it gives the reference gradients.
- :func:`attention_dropout_bits` gives, in torch integer ops, exactly the
  bits the mask kernel draws on the card: Philox4x32-10 under the key
  ``(seed mod 2³², seed >> 32)``, one draw per two adjacent keys: the
  counter is ``(j >> 1, i, h, b)``, words 0 / 1 are the text / layout
  stream of key ``2·(j >> 1)``, words 2 / 3 those of key ``2·(j >> 1) + 1``.
  The bits are a pure function of ``(seed, b, h, i, j, stream)``, so a
  checkpoint recompute draws identical masks.
  :func:`element_dropout_bits` is the one-mask mapping of the rel-bias mask
  kernel (``ops/bias_attention.py``): four keys per draw, word ``j & 3`` of
  the draw at the counter ``(j >> 2, i, h, b)``.
- The forward launch hands the masks to the backward bit-packed, int32
  ``(2, B, nh, L, ceil(L / 32))`` (stream, …, bit ``j % 32`` of word
  ``j // 32``); :func:`pack_keep_mask` / :func:`unpack_keep_mask` are the
  plain definition of that layout, :func:`keep_mask_bits` turns it back
  into bits the twin accepts.
- :func:`biacm_attention_train_fwd_cuda` / :func:`biacm_attention_train_bwd_cuda`
  launch the kernels; each counts its launches in ``launches`` (the
  backward counts one per call of its two kernels).
"""

from __future__ import annotations

import ctypes
import threading

import torch

SOURCE = "biacm_attention.cu"
TRAIN_SOURCE = "biacm_attention_train.cu"
HEAD_DIM_T = 64  # head dims the CUDA kernels are compiled for
HEAD_DIM_L = 16

_LIB = None
_TRAIN_LIB = None
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
            lib.biacm_attention_occupancy.argtypes = [ctypes.POINTER(i32)]
            lib.biacm_attention_occupancy.restype = i32
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
    # the kernels index a head's rows with 32-bit element offsets
    if (x.shape[2] + 64) * x.stride(2) >= 2 ** 31:
        raise ValueError(f"{name}: a head's rows must span fewer than 2^31 "
                         f"elements (L {x.shape[2]}, row stride {x.stride(2)})")


def _check_qkv(q_t, k_t, v_t, q_l, k_l, v_l, bias):
    """Wrapper checks shared by the CUDA launchers; returns (B, nh, L)."""
    if not q_t.is_cuda:
        raise ValueError("the BiACM CUDA kernels take CUDA tensors")
    B, nh, L, dt = q_t.shape
    dl = q_l.shape[-1]
    if (dt, dl) != (HEAD_DIM_T, HEAD_DIM_L):
        raise ValueError(f"the CUDA kernels are built for head dims "
                         f"({HEAD_DIM_T}, {HEAD_DIM_L}), got ({dt}, {dl})")
    if L < 1 or L >= 2 ** 17:  # a head's L·ceil(L/32) keep words: 32 bits
        raise ValueError("L must be in [1, 2^17)")
    dev = q_t.device
    for name, x, d in (("q_t", q_t, dt), ("k_t", k_t, dt), ("v_t", v_t, dt),
                       ("q_l", q_l, dl), ("k_l", k_l, dl), ("v_l", v_l, dl)):
        _check(name, x, (B, nh, L, d), torch.bfloat16, dev)
    if bias.device != dev or bias.dtype != torch.float32 \
            or tuple(bias.shape) != (B, L) or bias.stride(-1) != 1:
        raise ValueError(f"bias: expected contiguous-row float32 (B, L) on "
                         f"{dev}, got {bias.dtype} {tuple(bias.shape)}")
    return B, nh, L


def biacm_attention_cuda(q_t, k_t, v_t, q_l, k_l, v_l, bias,
                         scale_t: float, scale_l: float):
    """Launch the CUDA kernel on the current stream. Inputs bf16 on one CUDA
    device, d_t = 64, d_l = 16, any L ≥ 1. Outputs are ``(B, nh, L, d)``
    views of ``(B, L, nh, d)`` contiguous buffers."""
    B, nh, L = _check_qkv(q_t, k_t, v_t, q_l, k_l, v_l, bias)
    dev = q_t.device
    lib = load_kernel()
    out_t = torch.empty((B, L, nh, HEAD_DIM_T), dtype=torch.bfloat16,
                        device=dev)
    out_l = torch.empty((B, L, nh, HEAD_DIM_L), dtype=torch.bfloat16,
                        device=dev)
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


# ---------------------------------------------------------------------------
# Training: forward with attention dropout (kernel #2) and backward (#3).
# ---------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF
_MODES = {"none": 0, "philox": 1, "bits": 2}


def keep_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) = 1 - rate (the TPU kernels')."""
    return min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m·x, for x an int64
    tensor in [0, 2³²). m ≥ 2³¹ would overflow int64 in one product, so m
    is split into 16-bit halves: m·x = (x·m_hi)·2¹⁶ + x·m_lo."""
    a = x * (m & 0xFFFF)                    # < 2⁴⁸
    b = x * (m >> 16)                       # < 2⁴⁸
    t = a + ((b & 0xFFFF) << 16)            # < 2⁴⁹
    return (b >> 16) + (t >> 32), t & _U32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123's round and key schedule) on int64 tensors
    holding uint32 words; broadcasts the four counter words. Returns the
    four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_key(seed: int):
    seed = int(seed)
    return seed & _U32, (seed >> 32) & _U32


def dropout_bits_at(seed: int, b, h, i, j):
    """The two streams' uint32 dropout bits (as int64 tensors) at
    broadcastable index tensors ``b, h, i, j`` (batch, head, query, key):
    words 0 / 1 of the draw at counter ``(j >> 1, i, h, b)`` for an even
    key, words 2 / 3 for an odd one."""
    j = j.long()
    out = philox4x32_10(j >> 1, i.long(), h.long(), b.long(),
                        *_seed_key(seed))
    odd = (j & 1).bool()
    return torch.where(odd, out[2], out[0]), torch.where(odd, out[3], out[1])


def _index(n: int, axis: int, device):
    shape = [1, 1, 1, 1]
    shape[axis] = n
    return torch.arange(n, device=device).view(shape)


def attention_dropout_bits(seed: int, B: int, nh: int, L: int, device=None):
    """The bits the mask kernel draws on the card for one call: ``(bits1,
    bits2)``, int64 ``(B, nh, L, L)`` in [0, 2³²), stream 1 (text) and
    stream 2 (layout). One draw per pair of keys, as in the kernel."""
    pairs = (L + 1) // 2
    out = philox4x32_10(_index(pairs, 3, device), _index(L, 2, device),
                        _index(nh, 1, device), _index(B, 0, device),
                        *_seed_key(seed))
    out = [w.expand(B, nh, L, pairs) for w in out]

    def interleave(even, odd):
        return torch.stack((even, odd), -1).reshape(B, nh, L, 2 * pairs)[
            ..., :L]

    return interleave(out[0], out[2]), interleave(out[1], out[3])


def element_dropout_bits(seed: int, B: int, nh: int, L: int, device=None):
    """The bits the rel-bias mask kernel draws on the card for its one
    mask, int64 ``(B, nh, L, L)`` in [0, 2³²): four keys per draw, the bits
    of (query i, key j) are word ``j & 3`` of Philox4x32-10 at the counter
    ``(j >> 2, i, h, b)`` (a ragged last draw uses its first words)."""
    quads = (L + 3) // 4
    out = philox4x32_10(_index(quads, 3, device), _index(L, 2, device),
                        _index(nh, 1, device), _index(B, 0, device),
                        *_seed_key(seed))
    words = torch.stack([w.expand(B, nh, L, quads) for w in out], -1)
    return words.reshape(B, nh, L, 4 * quads)[..., :L]


def pack_keep_mask(keep: torch.Tensor) -> torch.Tensor:
    """Bit-pack keep flags along the last (key) axis: bool ``(..., L)`` →
    int32 ``(..., ceil(L / 32))`` with key ``j`` at bit ``j % 32`` of word
    ``j // 32`` (the bit patterns of the kernels' uint32 words); the bits
    past ``L`` of the last word are 0."""
    L = keep.shape[-1]
    words = (L + 31) // 32
    k = torch.nn.functional.pad(keep.to(torch.int64), (0, words * 32 - L))
    k = k.view(*keep.shape[:-1], words, 32)
    w = (k << torch.arange(32, device=keep.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_keep_mask(words: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of :func:`pack_keep_mask`: int32 ``(..., ceil(L / 32))`` →
    bool ``(..., L)``."""
    bit = (words.to(torch.int64)[..., None]
           >> torch.arange(32, device=words.device)) & 1
    return bit.reshape(*words.shape[:-1], -1)[..., :L].bool()


def keep_mask_bits(mask: torch.Tensor, L: int):
    """``(bits1, bits2)`` for the plain twin from the forward launch's
    packed keep flags ``(2, B, nh, L, ceil(L / 32))``: 0 where an element
    is kept (below every threshold), 2³² − 1 where it is dropped."""
    keep = unpack_keep_mask(mask, L)
    bits = torch.where(keep, 0, _U32)
    return bits[0], bits[1]


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """Bits as int64 in [0, 2³²) (from int64, or int32 bit patterns)."""
    return bits.to(torch.int64) & _U32


def biacm_attention_train_reference(q_t, k_t, v_t, q_l, k_l, v_l, bias, bits,
                                    scale_t: float, scale_l: float,
                                    rate: float = 0.0):
    """Plain PyTorch training BiACM attention with explicit mask bits
    ``bits = (bits1, bits2)`` ((B, nh, L, L), ignored at ``rate == 0``).
    As the TPU kernel: fp32 scores and softmax, ``p_s = keep_s ? p/(1-r) :
    0`` rounded to the input dtype before the fp32 ``p_s·v_s`` products,
    outputs in the input dtype. Returns ``(ctx_t, ctx_l)``."""
    f = torch.float32
    s = (torch.einsum("bhld,bhmd->bhlm", q_t.to(f), k_t.to(f)) * scale_t
         + torch.einsum("bhld,bhmd->bhlm", q_l.to(f), k_l.to(f)) * scale_l
         + bias.to(f)[:, None, None, :])
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        thr, inv = keep_threshold(rate), 1.0 / (1.0 - rate)
        p1 = torch.where(_u32(bits[0]) < thr, p * inv, 0.0)
        p2 = torch.where(_u32(bits[1]) < thr, p * inv, 0.0)
    else:
        p1 = p2 = p
    ctx_t = torch.einsum("bhlm,bhmd->bhld", p1.to(q_t.dtype).to(f), v_t.to(f))
    ctx_l = torch.einsum("bhlm,bhmd->bhld", p2.to(q_t.dtype).to(f), v_l.to(f))
    return ctx_t.to(q_t.dtype), ctx_l.to(q_t.dtype)


def load_train_kernel():
    """The training kernels' CUDA library (built at first use, cached);
    raises if it cannot be built or loaded."""
    global _TRAIN_LIB
    with _LIB_LOCK:
        if _TRAIN_LIB is None:
            from .cuda_build import build_library

            lib = ctypes.CDLL(build_library(TRAIN_SOURCE))
            args = [ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_float, ctypes.c_void_p]
            for fn in (lib.biacm_train_fwd, lib.biacm_train_bwd):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.biacm_train_occupancy.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.biacm_train_occupancy.restype = ctypes.c_int
            lib.biacm_train_error_string.argtypes = [ctypes.c_int]
            lib.biacm_train_error_string.restype = ctypes.c_char_p
            _TRAIN_LIB = lib
    return _TRAIN_LIB


KERNEL_NAMES = ("biacm_fwd_kernel", "biacm_train_fwd_kernel<true>",
                "biacm_train_fwd_kernel<false>", "biacm_train_dq_kernel",
                "biacm_train_dkdv_kernel", "biacm_keep_mask_kernel")


def kernel_occupancy(device=None) -> dict:
    """What ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` grants each
    BiACM kernel on ``device``: ``{name: {"ctas_per_sm", "dynamic_smem"}}``
    at the kernels' 128 threads a CTA."""
    out = {}
    with torch.cuda.device(device):
        for i, name in enumerate(KERNEL_NAMES):
            smem = ctypes.c_int(0)
            if i == 0:
                lib = load_kernel()
                n = lib.biacm_attention_occupancy(ctypes.byref(smem))
                err = lib.biacm_attention_error_string
            else:
                lib = load_train_kernel()
                n = lib.biacm_train_occupancy(i - 1, ctypes.byref(smem))
                err = lib.biacm_train_error_string
            if n < 0:
                raise RuntimeError(f"occupancy query of {name} failed: "
                                   + err(-n).decode())
            out[name] = {"ctas_per_sm": n, "dynamic_smem": smem.value}
    return out


def _rng_args(rng, rate: float, shape, dev):
    """(mode, seed_lo, seed_hi, bits1, bits2): ``rng`` is an int seed (the
    in-kernel generator) or explicit ``(bits1, bits2)`` (B, nh, L, L)
    int64 or int32 bit patterns, passed to the kernel as uint32."""
    if rate <= 0.0:
        return _MODES["none"], 0, 0, None, None
    if isinstance(rng, (tuple, list)):
        bits = []
        for name, x in zip(("bits1", "bits2"), rng):
            if tuple(x.shape) != tuple(shape) or x.device != dev:
                raise ValueError(f"{name}: expected {tuple(shape)} on {dev}, "
                                 f"got {tuple(x.shape)} on {x.device}")
            if x.dtype == torch.int64:
                x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
            elif x.dtype != torch.int32:
                raise ValueError(f"{name}: int64 or int32 bits, got {x.dtype}")
            bits.append(x.to(torch.int32).contiguous())
        return _MODES["bits"], 0, 0, bits[0], bits[1]
    seed = int(rng)
    return _MODES["philox"], seed & _U32, (seed >> 32) & _U32, None, None


def _launch(fn, name, ptrs, strides, B, nh, L, scale_t, scale_l, rate, rng):
    mode, lo, hi = rng[:3]
    rc = fn((ctypes.c_uint64 * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(strides))(*strides), B, nh, L,
            float(scale_t), float(scale_l), mode, lo, hi,
            keep_threshold(rate) if rate > 0 else 0,
            1.0 / (1.0 - rate) if rate > 0 else 1.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + load_train_kernel().biacm_train_error_string(
                               rc).decode())


def _strides3(*xs):
    return [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]


def biacm_attention_train_fwd_cuda(q_t, k_t, v_t, q_l, k_l, v_l, bias, rng,
                                   scale_t: float, scale_l: float,
                                   rate: float = 0.0):
    """Launch the training forward (kernel #2; at ``rate > 0`` the mask
    kernel first, then the attention kernel) on the current stream.
    Returns ``(ctx_t, ctx_l, stats, keep)``: the outputs as ``(B, nh, L,
    d)`` views of ``(B, L, nh, d)`` bf16 buffers, fp32 ``(B, nh, L, 2)`` row
    statistics (max, log of the sum) and, at ``rate > 0``, the two masks'
    keep flags packed as :func:`pack_keep_mask` packs them, int32 ``(2, B,
    nh, L, ceil(L / 32))`` (else None), both for the backward."""
    B, nh, L = _check_qkv(q_t, k_t, v_t, q_l, k_l, v_l, bias)
    dev = q_t.device
    rng = _rng_args(rng, rate, (B, nh, L, L), dev)
    lib = load_train_kernel()
    out_t = torch.empty((B, L, nh, HEAD_DIM_T), dtype=torch.bfloat16,
                        device=dev)
    out_l = torch.empty((B, L, nh, HEAD_DIM_L), dtype=torch.bfloat16,
                        device=dev)
    stats = torch.empty((B, nh, L, 2), dtype=torch.float32, device=dev)
    keep = None
    if rate > 0.0:
        keep = torch.empty((2, B, nh, L, (L + 31) // 32), dtype=torch.int32,
                           device=dev)
    ins = (q_t, k_t, v_t, q_l, k_l, v_l)
    ptrs = [x.data_ptr() for x in ins] + [
        bias.data_ptr(), *(0 if x is None else x.data_ptr() for x in rng[3:]),
        stats.data_ptr(), 0 if keep is None else keep.data_ptr(),
        out_t.data_ptr(), out_l.data_ptr()]
    with torch.cuda.device(dev):
        _launch(lib.biacm_train_fwd, "biacm_attention_train forward", ptrs,
                _strides3(*ins) + [bias.stride(0)], B, nh, L, scale_t,
                scale_l, rate, rng)
    biacm_attention_train_fwd_cuda.launches += 1
    return out_t.transpose(1, 2), out_l.transpose(1, 2), stats, keep


biacm_attention_train_fwd_cuda.launches = 0


def biacm_attention_train_bwd_cuda(q_t, k_t, v_t, q_l, k_l, v_l, bias, keep,
                                   stats, dct, dcl, scale_t: float,
                                   scale_l: float, rate: float = 0.0):
    """Launch the training backward (kernel #3: the dq kernel, which also
    sums ``D = rowsum(p ⊙ dP)``, then the dk/dv kernel) on the current
    stream. ``stats`` and ``keep`` are the forward's row statistics and
    packed keep flags (``keep`` is ignored at ``rate == 0``); the backward
    draws no bits. ``dct``/``dcl`` are the output gradients (bf16, any
    strides with a contiguous, 16-byte aligned last dim). Returns
    ``(dq_t, dk_t, dv_t, dq_l, dk_l, dv_l)`` as ``(B, nh, L, d)`` views of
    ``(B, L, nh, d)`` bf16 buffers (dk/dv accumulate in fp32 registers)."""
    B, nh, L = _check_qkv(q_t, k_t, v_t, q_l, k_l, v_l, bias)
    dev = q_t.device
    for name, x, d in (("dct", dct, HEAD_DIM_T), ("dcl", dcl, HEAD_DIM_L)):
        _check(name, x, (B, nh, L, d), torch.bfloat16, dev)
    if tuple(stats.shape) != (B, nh, L, 2) or not stats.is_contiguous() \
            or stats.dtype != torch.float32 or stats.device != dev:
        raise ValueError("stats: expected the forward's contiguous float32 "
                         f"(B, nh, L, 2) on {dev}")
    if rate > 0.0:
        shape = (2, B, nh, L, (L + 31) // 32)
        if keep is None or tuple(keep.shape) != shape \
                or not keep.is_contiguous() or keep.dtype != torch.int32 \
                or keep.device != dev:
            raise ValueError("keep: expected the forward's contiguous int32 "
                             f"{shape} on {dev}")
    # the backward reads only whether there is dropout (mode 0 or not)
    rng = (_MODES["philox"] if rate > 0.0 else _MODES["none"], 0, 0)
    lib = load_train_kernel()
    grads = [torch.empty((B, L, nh, d), dtype=torch.bfloat16, device=dev)
             for d in (HEAD_DIM_T,) * 3 + (HEAD_DIM_L,) * 3]
    delta = torch.empty((B, nh, L), dtype=torch.float32, device=dev)
    ins = (q_t, k_t, v_t, q_l, k_l, v_l)
    ptrs = ([x.data_ptr() for x in ins]
            + [bias.data_ptr(), 0, 0, stats.data_ptr(),
               keep.data_ptr() if rate > 0.0 else 0, dct.data_ptr(),
               dcl.data_ptr(), delta.data_ptr()]
            + [g.data_ptr() for g in grads])
    strides = _strides3(*ins) + [bias.stride(0)] + _strides3(dct, dcl)
    with torch.cuda.device(dev):
        _launch(lib.biacm_train_bwd, "biacm_attention_train backward", ptrs,
                strides, B, nh, L, scale_t, scale_l, rate, rng)
    biacm_attention_train_bwd_cuda.launches += 1
    return tuple(g.transpose(1, 2) for g in grads)


biacm_attention_train_bwd_cuda.launches = 0


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it through its strides (last
    dim contiguous, 16-byte rows), else a contiguous copy."""
    vec = 16 // x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 \
            and all(s % vec == 0 for s in x.stride()[:-1]):
        return x
    return x.contiguous()


def _cpu_bits(rng, rate, q_t):
    if rate <= 0.0:
        return None
    if isinstance(rng, (tuple, list)):
        return tuple(rng)
    B, nh, L, _ = q_t.shape
    return attention_dropout_bits(int(rng), B, nh, L, device=q_t.device)


class BiacmAttentionTrain(torch.autograd.Function):
    """Differentiable training BiACM attention. CUDA tensors: kernel #2
    forward, kernel #3 backward; the forward's packed keep flags (not the
    seed) are kept for the backward with the row statistics. CPU tensors:
    the plain twin, and its autograd gradient recomputed in the backward.
    The bias gets no gradient (a padding mask)."""

    @staticmethod
    def forward(ctx, q_t, k_t, v_t, q_l, k_l, v_l, bias, rng, scale_t,
                scale_l, rate):
        ctx.args = (scale_t, scale_l, rate)
        ins = (q_t, k_t, v_t, q_l, k_l, v_l)
        if q_t.is_cuda:
            ct, cl, stats, keep = biacm_attention_train_fwd_cuda(
                *ins, bias, rng, scale_t, scale_l, rate)
            saved = (*ins, bias, stats) + (() if keep is None else (keep,))
            ctx.save_for_backward(*saved)
            return ct, cl
        ctx.rng = _cpu_bits(rng, rate, q_t)
        ctx.save_for_backward(*ins, bias)
        return biacm_attention_train_reference(*ins, bias, ctx.rng, scale_t,
                                               scale_l, rate)

    @staticmethod
    def backward(ctx, dct, dcl):
        scale_t, scale_l, rate = ctx.args
        saved = ctx.saved_tensors  # once: a checkpoint unpacks it once
        if saved[0].is_cuda:
            *ins, bias, stats = saved[:8]
            keep = saved[8] if len(saved) > 8 else None
            dq_t, dk_t, dv_t, dq_l, dk_l, dv_l = biacm_attention_train_bwd_cuda(
                *ins, bias, keep, stats,
                _aligned(dct.to(torch.bfloat16)),
                _aligned(dcl.to(torch.bfloat16)), scale_t, scale_l, rate)
            return dq_t, dk_t, dv_t, dq_l, dk_l, dv_l, None, None, None, \
                None, None
        *ins, bias = saved
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ins]
            outs = biacm_attention_train_reference(
                *leaves, bias, ctx.rng, scale_t, scale_l, rate)
            grads = torch.autograd.grad(outs, leaves, (dct, dcl))
        return (*grads, None, None, None, None, None)


def biacm_attention_train(q_t, k_t, v_t, q_l, k_l, v_l, bias, rng,
                          scale_t: float, scale_l: float, rate: float = 0.0):
    """Differentiable BiACM attention with attention dropout at ``rate``
    (two independent masks, one per stream). Layout of the JAX function:
    q/k/v ``(B, nh, L, d)``, ``bias (B, L)`` fp32; ``rng`` an int seed (the
    mask kernel's Philox bits, :func:`attention_dropout_bits` on the CPU) or
    explicit ``(bits1, bits2)`` (B, nh, L, L). Returns ``(ctx_t, ctx_l)``."""
    return BiacmAttentionTrain.apply(q_t, k_t, v_t, q_l, k_l, v_l, bias, rng,
                                     float(scale_t), float(scale_l),
                                     float(rate))
