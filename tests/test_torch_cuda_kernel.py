"""The CUDA kernels (BiACM #1-#3, rel-bias #4-#6) against their plain twins
on the card, and the int8 serving product (``torch._int_mm``) against its
integer twin. Needs a CUDA device (and nvcc to build the kernels); skips
without one. On the GPU
machine run it with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py``
(``--noconftest`` skips the JAX setup of ``tests/conftest.py``; this file
imports no JAX)."""

import pytest
import torch

from peneo_tpu_torch.ops import biacm_attention as ba
from peneo_tpu_torch.ops import bias_attention as rb
from peneo_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda
NEG = torch.finfo(torch.float32).min / 2


@pytest.mark.parametrize("L", [1, 63, 128, 200, 512])
def test_kernel_matches_plain_twin_on_card(L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_kernel(L, B=2, nh=12)


def _check_kernel(L, B, nh):
    """Kernel #1 against its fp32 twin on (B, nh, L, d) views."""
    gen = torch.Generator(device="cuda").manual_seed(L)

    def heads(d):  # (B, nh, L, d) views of (B, L, nh, d), as the model passes
        x = torch.randn((B, L, nh, d), generator=gen, device="cuda")
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads(64) for _ in range(3)] + [heads(16) for _ in range(3)]
    bias = torch.zeros((B, L), device="cuda")
    bias[0::2, : L // 2] = NEG       # leading keys padded (whole key tiles)
    bias[1::2, L - L // 3:] = NEG    # trailing keys padded
    before = ba.biacm_attention_cuda.launches
    got = ba.biacm_attention(*qkv, bias, 0.125, 0.25)
    want = ba.biacm_attention_reference(*(x.float() for x in qkv), bias,
                                        0.125, 0.25)
    torch.cuda.synchronize()
    assert ba.biacm_attention_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert (g.float() - w).abs().max().item() <= 2e-2


def _train_inputs(L, seed, spread=None, B=2, nh=12):
    """q/k/v, bias and output gradients; with a ``spread``, each head's
    q/k/v rows are one shared row plus ``spread`` times noise (nearly
    collinear, as in LiLT-base's last layers), halved to keep values O(1)
    for the absolute forward gate."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def heads(d, collinear=False):
        x = torch.randn((B, L, nh, d), generator=gen, device="cuda")
        if collinear:
            x = 0.5 * (x[:, :1] + spread * x)
        return x.to(torch.bfloat16).transpose(1, 2)

    c = spread is not None
    qkv = [heads(64, c) for _ in range(3)] + [heads(16, c) for _ in range(3)]
    bias = torch.zeros((B, L), device="cuda")
    bias[0::2, : L // 2] = NEG
    bias[1::2, L - L // 3:] = NEG
    dctx = (heads(64), heads(16))
    return qkv, bias, dctx


def _zero_reference_bounds(qkv, dctx, rate, scale_t, scale_l):
    """Largest |dq_t|, |dk_t|, |dq_l|, |dk_l| the kernels may return where
    the reference gradient is exactly 0: with one key (L = 1) p = 1, so
    dS = p (dP - D) = 0. The kernels sum D from dP in the dq kernel and
    form dP again in the dk/dv kernel with the operands swapped, so the two
    may differ by fp32 rounding, a few units of 2^-24 of the row's sum of
    |terms| (|dct * v_t| + |dcl * v_l|, over 1 - rate). The bound allows
    2^-16 of it: far above fp32 rounding, far below one bf16 rounding
    (2^-8) on the way. dq = dS k scale, dk = dS^T q scale."""
    q_t, k_t, v_t, q_l, k_l, v_l = (x.float() for x in qkv)
    terms = ((dctx[0].float() * v_t).abs().sum(-1)
             + (dctx[1].float() * v_l).abs().sum(-1)) / (1.0 - rate)
    ds = 2.0 ** -16 * terms.max().item()
    return {0: ds * k_t.abs().max().item() * scale_t,
            1: ds * q_t.abs().max().item() * scale_t,
            3: ds * k_l.abs().max().item() * scale_l,
            4: ds * q_l.abs().max().item() * scale_l}


def _check_grad(i, got, want, zero_bounds):
    """A gradient's max abs err over its own max |reference| <= 2e-2
    (bf16 rounding of p/(1-r) in dv and of the gradient, 2^-8 relative
    each, summed in another order); where the reference is exactly 0, its
    max |got| <= the bound of _zero_reference_bounds."""
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    if scale == 0.0:
        assert err <= zero_bounds[i], (i, err, zero_bounds[i])
    else:
        assert err <= 2e-2 * scale, (i, err, scale)


def test_ldmatrix_fragment_order_on_card():
    """The kernels read every mma fragment with ldmatrix, the transposed
    ones (V in p·v) with its .trans form. With one-hot operands each output
    element names the one fragment element it came from: q = row i of the
    identity makes the scores of a zero-bias head the keys' column i, and
    p = softmax of a bias that leaves one key j(i) makes ctx row i the row
    j(i) of v, exactly. Distinct v values, both streams, two key tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, nh, L = 1, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(3)

    def heads(x):  # (B, L, nh, d) storage viewed (B, nh, L, d)
        return x.to(torch.bfloat16).transpose(1, 2).contiguous() \
            .transpose(1, 2)

    # integers up to 255 are exact in bf16; every (key, column) distinct
    v_t = heads((torch.arange(L * 64, device="cuda") % 251).float()
                .view(1, 1, L, 64).expand(B, nh, L, 64)
                + torch.arange(nh, device="cuda").view(1, nh, 1, 1))
    v_l = heads((torch.arange(L * 16, device="cuda") % 239).float()
                .view(1, 1, L, 16).expand(B, nh, L, 16))
    # scores: q_t = 8·one-hot(i % 64), k_t[j] = row of integers → s = k_t[j,
    # i % 64] (scale 1/8); q_l, k_l likewise with scale 1/4, weight 4
    k_t = heads(torch.randint(-3, 4, (B, nh, L, 64), generator=gen,
                              device="cuda").float())
    k_l = heads(torch.randint(-3, 4, (B, nh, L, 16), generator=gen,
                              device="cuda").float())
    eye_t = torch.eye(64, device="cuda").repeat(2, 1) * 8
    eye_l = torch.eye(16, device="cuda").repeat(8, 1) * 4
    q_t = heads(eye_t.view(1, 1, L, 64).expand(B, nh, L, 64))
    q_l = heads(eye_l.view(1, 1, L, 16).expand(B, nh, L, 16))
    bias = torch.zeros((B, L), device="cuda")
    got = ba.biacm_attention(q_t, k_t, v_t, q_l, k_l, v_l, bias, 0.125, 0.25)
    want = ba.biacm_attention_reference(
        *(x.float() for x in (q_t, k_t, v_t, q_l, k_l, v_l)), bias, 0.125,
        0.25)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        # |ctx| ≤ 255, so one bf16 step of the output is up to 1; a wrong
        # fragment order is off by tens
        assert (g.float() - w).abs().max().item() <= 2.0
    # one key left per batch row: ctx is that key's v row, bit for bit
    for j in (0, 5, 77, 127):
        bias = torch.full((B, L), NEG, device="cuda")
        bias[:, j] = 0.0
        got = ba.biacm_attention(q_t, k_t, v_t, q_l, k_l, v_l, bias, 0.125,
                                 0.25)
        torch.cuda.synchronize()
        assert torch.equal(got[0], v_t[:, :, j:j + 1].expand_as(got[0]))
        assert torch.equal(got[1], v_l[:, :, j:j + 1].expand_as(got[1]))


@pytest.mark.parametrize("L", [1, 63, 65, 200, 512])
def test_packed_keep_mask_on_card(L):
    """Kernel #2's packed keep flags equal pack_keep_mask of
    ``attention_dropout_bits < threshold`` word for word, with the
    in-kernel generator and with explicit bits; kernel #3 fed the
    forward's flags and fed the plainly packed ones agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    qkv, bias, dctx = _train_inputs(L, seed=L + 3)
    B, nh = bias.shape[0], qkv[0].shape[1]
    seed, rate = 99 + L, 0.1
    bits = ba.attention_dropout_bits(seed, B, nh, L, device="cuda")
    want = ba.pack_keep_mask(torch.stack(bits) < ba.keep_threshold(rate))
    for rng in (seed, bits):
        *_, stats, keep = ba.biacm_attention_train_fwd_cuda(
            *qkv, bias, rng, 0.125, 0.25, rate)
        torch.cuda.synchronize()
        assert keep.dtype == torch.int32 and keep.shape == want.shape
        assert torch.equal(keep, want)
    a = ba.biacm_attention_train_bwd_cuda(*qkv, bias, keep, stats, *dctx,
                                          0.125, 0.25, rate)
    b = ba.biacm_attention_train_bwd_cuda(*qkv, bias, want.contiguous(),
                                          stats, *dctx, 0.125, 0.25, rate)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [1, 63, 65, 128, 200, 512, "512-collinear"])
def test_train_kernels_match_plain_twin_on_card(L, rate):
    """Kernels #2 (forward) and #3 (backward) against the fp32 twin and
    its autograd gradients on the same bf16 inputs and output gradients,
    with the in-kernel bits (the twin takes attention_dropout_bits of the
    same seed) and with explicit bits; L = 1, 63, 65 and 200 leave ragged
    tails of rows, keys and keep words. Forward: max abs err <= 2e-2, as
    kernel #1; gradients: see _check_grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    spread = None
    if L == "512-collinear":  # dq, dk: small differences of large terms
        L, spread = 512, 0.1
    _check_train_kernels(L, rate, _train_inputs(L, seed=L + 7,
                                                spread=spread))


def _check_train_kernels(L, rate, inputs):
    """Kernels #2/#3 against the fp32 twin on ``inputs`` (see
    test_train_kernels_match_plain_twin_on_card)."""
    qkv, bias, dctx = inputs
    B, nh = bias.shape[0], qkv[0].shape[1]
    seed = 1234 + L
    bits = ba.attention_dropout_bits(seed, B, nh, L, device="cuda")
    leaves = [x.float().requires_grad_() for x in qkv]
    want = ba.biacm_attention_train_reference(*leaves, bias, bits, 0.125,
                                              0.25, rate)
    want_grads = torch.autograd.grad(want, leaves, dctx)
    outs = {}
    for name, rng in (("philox", seed), ("bits", bits)):
        ins = [x.detach().clone().requires_grad_() for x in qkv]
        fwd0 = ba.biacm_attention_train_fwd_cuda.launches
        bwd0 = ba.biacm_attention_train_bwd_cuda.launches
        got = ba.biacm_attention_train(*ins, bias, rng, 0.125, 0.25, rate)
        grads = torch.autograd.grad(got, ins, dctx)
        torch.cuda.synchronize()
        assert ba.biacm_attention_train_fwd_cuda.launches == fwd0 + 1
        assert ba.biacm_attention_train_bwd_cuda.launches == bwd0 + 1
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert (g.float() - w).abs().max().item() <= 2e-2, name
        bounds = _zero_reference_bounds(qkv, dctx, rate, 0.125, 0.25)
        for i, (g, w) in enumerate(zip(grads, want_grads)):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert torch.isfinite(g).all()
            _check_grad(i, g, w, bounds)
        outs[name] = (got, grads)
    # the in-kernel generator draws exactly attention_dropout_bits
    for a, b in zip(outs["philox"][0] + outs["philox"][1],
                    outs["bits"][0] + outs["bits"][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ rel-bias
def _with_stride(bias, stride):
    """``bias`` itself ("natural": contiguous, rows of L floats, 4-byte
    aligned when L is odd) or the same values as a view of an (nh, B, L, L4)
    buffer, L4 = L rounded up to a multiple of 4 ("padded": 16-byte rows,
    the layout of the model's RelBias)."""
    if stride == "natural":
        return bias
    B, nh, L, _ = bias.shape
    buf = torch.full((nh, B, L, -(-L // 4) * 4), float("nan"),
                     device=bias.device)
    out = buf.permute(1, 0, 2, 3)[..., :L]
    out.copy_(bias)
    return out


def _bias_inputs(L, seed, spread=None, text_masked=0, stride="natural",
                 B=2, nh=12):
    """q/k/v (B, nh, L, 64) views of (B, L, nh, 64), an fp32 (B, nh, L, L)
    bias (at the row stride ``stride`` names, see _with_stride), a key mask
    and an output gradient. ``text_masked`` = n: every key of batch row 0
    but the last n (the visual tokens: 197 for LayoutLMv3, 49 for
    LayoutLMv2) is masked with finfo(f32).min itself, under a bias made
    negative there (mask + bias would overflow without the kernel's
    clamp)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def heads(collinear=False):
        x = torch.randn((B, L, nh, 64), generator=gen, device="cuda")
        if collinear:
            x = 0.5 * (x[:, :1] + spread * x)
        return x.to(torch.bfloat16).transpose(1, 2)

    c = spread is not None
    qkv = [heads(c) for _ in range(3)]
    bias = torch.randn((B, nh, L, L), generator=gen, device="cuda")
    mask = torch.zeros((B, L), device="cuda")
    if text_masked:
        n = L - text_masked
        mask[0, :n] = torch.finfo(torch.float32).min
        bias[0, :, :, :n] = -bias[0, :, :, :n].abs() - 1.0
    else:
        mask[0::2, : L // 2] = NEG
    mask[1::2, L - L // 3:] = NEG
    return qkv, _with_stride(bias, stride), mask, heads()


# 709: LayoutLMv3 (512 text + 197 visual tokens); 561: LayoutLMv2 (512 +
# 49), whose last key tile is ragged (561 = 8·64 + 49) and whose natural
# bias rows (561 floats) are not 16-byte aligned
BIAS_CASES = [1, 63, 128, 200, 709, "709-collinear", "709-textmasked", 561,
              "561-textmasked"]
STRIDES = ["natural", "padded"]


def _bias_case(L):
    if L == "709-collinear":
        return 709, dict(spread=0.1)
    if L == "709-textmasked":
        return 709, dict(text_masked=197)
    if L == "561-textmasked":
        return 561, dict(text_masked=49)
    return L, {}


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("L", BIAS_CASES)
def test_bias_kernel_matches_plain_twin_on_card(L, stride):
    """Kernel #4 against the fp32 twin: max abs err <= 2e-2 (bf16 rounding
    of p and of the output), with the bias rows in 4-byte and in 16-byte
    requests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    L, kw = _bias_case(L)
    _check_bias_kernel(L, _bias_inputs(L, seed=L, stride=stride, **kw))


def _check_bias_kernel(L, inputs):
    """Kernel #4 against the fp32 twin on ``inputs`` (see
    test_bias_kernel_matches_plain_twin_on_card)."""
    (q, k, v), bias, mask, _ = inputs
    before = rb.bias_attention_cuda.launches
    got = rb.bias_attention(q, k, v, bias, mask, 0.125)
    want = rb.bias_attention_reference(q.float(), k.float(), v.float(), bias,
                                       mask, 0.125)
    torch.cuda.synchronize()
    assert rb.bias_attention_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() <= 2e-2
    # a strided bias (batch-expanded) is read through its strides
    shared = bias[:1].expand(bias.shape[0], -1, -1, -1)
    got = rb.bias_attention(q, k, v, shared, mask, 0.125)
    want = rb.bias_attention_reference(q.float(), k.float(), v.float(),
                                       shared, mask, 0.125)
    assert (got.float() - want).abs().max().item() <= 2e-2
    if L > 1:  # a bias whose last dim is not contiguous is refused
        with pytest.raises(ValueError):
            rb.bias_attention(q, k, v, bias.transpose(2, 3), mask, 0.125)


@pytest.mark.parametrize("L", [1, 63, 128, 200, 709, 561])
def test_bias_packed_keep_flags_on_card(L):
    """Kernel #5's packed keep flags equal pack_keep_mask of
    ``element_dropout_bits < threshold`` word for word, with the in-kernel
    generator and with explicit bits; kernel #6 fed the forward's flags and
    fed the plainly packed ones agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (q, k, v), bias, mask, dctx = _bias_inputs(L, seed=L + 3,
                                               stride="padded")
    B, nh = mask.shape[0], q.shape[1]
    seed, rate = 99 + L, 0.1
    bits = ba.element_dropout_bits(seed, B, nh, L, device="cuda")
    want = ba.pack_keep_mask(bits < ba.keep_threshold(rate))
    for rng in (seed, bits):
        _, stats, keep = rb.bias_attention_train_fwd_cuda(
            q, k, v, bias, mask, rng, 0.125, rate)
        torch.cuda.synchronize()
        assert keep.dtype == torch.int32 and keep.shape == want.shape
        assert torch.equal(keep, want)
    a = rb.bias_attention_train_bwd_cuda(q, k, v, bias, mask, keep, stats,
                                         dctx, 0.125, rate)
    b = rb.bias_attention_train_bwd_cuda(q, k, v, bias, mask,
                                         want.contiguous(), stats, dctx,
                                         0.125, rate)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", BIAS_CASES)
def test_bias_train_kernels_match_plain_twin_on_card(L, rate, stride):
    """Kernels #5 (forward) and #6 (backward) against the fp32 twin and its
    autograd gradients (dq, dk, dv and dbias) on the same bf16 inputs, with
    the in-kernel bits (the twin takes element_dropout_bits of the same
    seed) and with explicit bits, the bias rows in 4-byte and in 16-byte
    requests. Forward max abs err <= 2e-2; each gradient's max abs err
    <= 2e-2 of its own max |reference|; where the reference is exactly 0
    (L = 1: one key, p = 1, dS = 0) the kernel's value is bounded by 2^-16
    of the row's sum of |dc * v| terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    L, kw = _bias_case(L)
    _check_bias_train_kernels(L, rate, stride, _bias_inputs(
        L, seed=L + 7, stride=stride, **kw))


def _check_bias_train_kernels(L, rate, stride, inputs):
    """Kernels #5/#6 against the fp32 twin on ``inputs`` (see
    test_bias_train_kernels_match_plain_twin_on_card)."""
    qkv, bias, mask, dctx = inputs
    B, nh = mask.shape[0], qkv[0].shape[1]
    seed = 4321 + L
    bits = ba.element_dropout_bits(seed, B, nh, L, device="cuda")
    leaves = [x.float().requires_grad_() for x in qkv] \
        + [bias.clone().requires_grad_()]
    want = rb.bias_attention_train_reference(*leaves, mask, bits, 0.125, rate)
    want_grads = torch.autograd.grad(want, leaves, dctx.float())
    q, k, v = (x.float() for x in qkv)
    ds0 = 2.0 ** -16 * ((dctx.float() * v).abs().sum(-1)
                        / (1.0 - rate)).max().item()
    zero_bounds = [ds0 * k.abs().max().item() * 0.125,
                   ds0 * q.abs().max().item() * 0.125, 0.0, ds0]
    outs = {}
    for name, rng in (("philox", seed), ("bits", bits)):
        ins = [x.detach().clone().requires_grad_() for x in qkv] \
            + [_with_stride(bias.detach(), stride).requires_grad_()]
        fwd0 = rb.bias_attention_train_fwd_cuda.launches
        bwd0 = rb.bias_attention_train_bwd_cuda.launches
        got = rb.bias_attention_train(*ins, mask, rng, 0.125, rate)
        grads = torch.autograd.grad(got, ins, dctx)
        torch.cuda.synchronize()
        assert rb.bias_attention_train_fwd_cuda.launches == fwd0 + 1
        assert rb.bias_attention_train_bwd_cuda.launches == bwd0 + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert (got.float() - want).abs().max().item() <= 2e-2, name
        for i, (g, w) in enumerate(zip(grads, want_grads)):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert g.dtype == (torch.float32 if i == 3 else torch.bfloat16)
            _check_grad(i, g, w, zero_bounds)
        outs[name] = (got, *grads)
    for a, b in zip(outs["philox"], outs["bits"]):
        assert torch.equal(a, b)


# a tensor-parallel rank's heads (nh / tp = 6 of LiLT-base's and
# LayoutLMv3-base's 12 at tp 2), at the main path's shapes otherwise:
# serving B = 32, training B = 8, L = 512 (LiLT), 709 (LayoutLMv3) and
# 561 (LayoutXLM), the bias at the model's padded stride
TP_NH = 6


def test_tp_heads_kernel_matches_plain_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_kernel(512, B=32, nh=TP_NH)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tp_heads_train_kernels_match_plain_twin_on_card(rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _check_train_kernels(512, rate, _train_inputs(512, seed=519, B=8,
                                                  nh=TP_NH))


@pytest.mark.parametrize("L", [709, 561])
def test_tp_heads_bias_kernel_matches_plain_twin_on_card(L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _check_bias_kernel(L, _bias_inputs(L, seed=L, stride="padded", B=32,
                                       nh=TP_NH))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [709, 561])
def test_tp_heads_bias_train_kernels_match_plain_twin_on_card(L, rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _check_bias_train_kernels(L, rate, "padded", _bias_inputs(
        L, seed=L + 7, stride="padded", B=8, nh=TP_NH))


def _seed_graph_check(keep_of, seed):
    """``keep_of(rng)`` → packed keep flags. The flags of a seed held on the
    card (a 0-d int64 tensor) equal those of the same seed by value, bit
    for bit; in a CUDA graph that adds 1 to the seed before the launch, two
    replays give different flags, each equal to the by-value flags of the
    seed it read."""
    by_value = keep_of(seed)
    on_card = torch.tensor(seed, dtype=torch.int64, device="cuda")
    assert torch.equal(keep_of(on_card), by_value)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        on_card.add_(1)
        flags = keep_of(on_card)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(flags.clone())
    torch.cuda.synchronize()
    assert int(on_card) == seed + 2
    for i, got in enumerate(replays):
        assert torch.equal(got, keep_of(seed + i + 1))
    assert not torch.equal(replays[0], replays[1])


@pytest.mark.parametrize("L", [1, 65, 512])
def test_device_seed_keep_flags_on_card(L):
    """Kernel #2 with its seed in device memory (what a CUDA graph of the
    training step passes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    qkv, bias, _ = _train_inputs(L, seed=L + 5)
    # (2, 8) at L = 1: both streams' one flag, so that replays can differ
    rate = 0.5 if L == 1 else 0.1
    _seed_graph_check(lambda rng: ba.biacm_attention_train_fwd_cuda(
        *qkv, bias, rng, 0.125, 0.25, rate)[3], (3 << 32) + 77 * L)


@pytest.mark.parametrize("L", [561, 709])
def test_bias_device_seed_keep_flags_on_card(L):
    """Kernel #5 with its seed in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (q, k, v), bias, mask, _ = _bias_inputs(L, seed=L + 5, stride="padded")
    _seed_graph_check(lambda rng: rb.bias_attention_train_fwd_cuda(
        q, k, v, bias, mask, rng, 0.125, 0.1)[2], (3 << 32) + 77 * L)


def _rank_offset_check(keep_of, want_of, seed):
    """Rank 1's layer seed (host-drawn and on the card) is rank 0's plus
    ``RANK_STRIDE``; its packed keep flags differ from rank 0's and equal
    the plain bits' of the offset seed, for both kinds of seed."""
    from peneo_tpu_torch.models import dropout_seeds as ds

    step = torch.tensor(5, dtype=torch.int64, device="cuda")
    host = [ds.HostSeeds(torch.Generator().manual_seed(seed), r).layer(0)
            for r in (0, 1)]
    card = [ds.StepSeeds(seed, step, r).layer(0) for r in (0, 1)]
    assert host[1] == host[0] + ds.RANK_STRIDE
    assert int(card[1]) == int(card[0]) + ds.RANK_STRIDE
    for rank0, rank1 in (host, card):
        flags = [keep_of(rank0), keep_of(rank1)]
        torch.cuda.synchronize()
        assert not torch.equal(flags[0], flags[1])
        assert torch.equal(flags[0], want_of(int(rank0)))
        assert torch.equal(flags[1], want_of(int(rank0) + ds.RANK_STRIDE))


@pytest.mark.parametrize("L", [65, 512])
def test_rank_offset_keep_flags_on_card(L):
    """Kernel #2 on data-parallel rank 1 draws other masks than rank 0,
    those of ``attention_dropout_bits`` at the offset seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    qkv, bias, _ = _train_inputs(L, seed=L + 7)
    B, nh = bias.shape[0], qkv[0].shape[1]

    def want(seed):
        bits = ba.attention_dropout_bits(seed, B, nh, L, device="cuda")
        return ba.pack_keep_mask(torch.stack(bits) < ba.keep_threshold(0.1))

    _rank_offset_check(lambda rng: ba.biacm_attention_train_fwd_cuda(
        *qkv, bias, rng, 0.125, 0.25, 0.1)[3], want, 11 + L)


@pytest.mark.parametrize("L", [561, 709])
def test_bias_rank_offset_keep_flags_on_card(L):
    """Kernel #5 on rank 1: ``element_dropout_bits`` at the offset seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (q, k, v), bias, mask, _ = _bias_inputs(L, seed=L + 7, stride="padded")
    B, nh = mask.shape[0], q.shape[1]

    def want(seed):
        bits = ba.element_dropout_bits(seed, B, nh, L, device="cuda")
        return ba.pack_keep_mask(bits < ba.keep_threshold(0.1))

    _rank_offset_check(lambda rng: rb.bias_attention_train_fwd_cuda(
        q, k, v, bias, mask, rng, 0.125, 0.1)[2], want, 11 + L)


@pytest.mark.parametrize("written_on", ["cuda", "cpu"])
def test_capturable_optimizer_checkpoint_round_trip_on_card(tmp_path,
                                                            written_on):
    """The trainer's AdamW on the card is ``capturable``: its per-parameter
    step counts are device tensors. A checkpoint written through
    ``CheckpointManager`` (by the card's capturable AdamW, or on the CPU by
    a non-capturable one) and read back on the CPU restores them onto the
    parameters' device with their values, a capturable AdamW that steps
    inside a CUDA graph, and the schedule's device counter in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.checkpoint import CheckpointManager

    def build(device):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 8),
                                    torch.nn.Linear(8, 2)).to(device)
        return (model, *T.make_optimizer(model, lr=1e-3, total_steps=10))

    def step(model, optimizer, scheduler, x):
        optimizer.zero_grad(set_to_none=False)
        model(x).square().sum().backward()
        scheduler.apply()
        optimizer.step()
        scheduler.step()

    model, optimizer, scheduler = build(written_on)
    assert all(g["capturable"] == (written_on == "cuda")
               for g in optimizer.param_groups)
    x = torch.randn(4, 8, device=written_on)
    for _ in range(3):
        step(model, optimizer, scheduler, x)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, {"optimizer": optimizer.state_dict(),
                  "scheduler": scheduler.state_dict()})
    state = ckpt.restore(map_location="cpu")
    fresh_model, fresh, schedule = build("cuda")
    counter = schedule.count
    T.load_optimizer_state(fresh, state["optimizer"])
    schedule.load_state_dict(state["scheduler"])
    assert schedule.count is counter and int(counter) == 3
    for group in fresh.param_groups:
        assert group["capturable"] and group["lr"].is_cuda
    for old, new in zip(optimizer.state.values(), fresh.state.values()):
        assert new["step"].is_cuda and float(new["step"]) == 3.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert new[key].is_cuda and torch.equal(new[key].cpu(),
                                                    old[key].cpu())
    # the restored optimizer steps inside a graph: two replays, two steps
    x = x.cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(fresh_model, fresh, schedule, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(fresh_model, fresh, schedule, x)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert int(schedule.count) == 6
    assert all(float(s["step"]) == 6.0 for s in fresh.state.values())


@pytest.mark.parametrize("rows", [1, 16, 17, 1000])
def test_int8_gemm_matches_integer_twin_on_card(rows):
    """Full-range s8 operands, rows below the library's minimum of 17 too
    (padded with zeros): the s32 product equals the twin and an int64 CPU
    product bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(rows)
    xq = torch.randint(-127, 128, (rows, 768), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (384, 768), generator=gen, device="cuda",
                       dtype=torch.int8)
    before = quant.int8_matmul_cuda.launches
    got = quant.int8_matmul(xq, wq)
    torch.cuda.synchronize()
    assert quant.int8_matmul_cuda.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (rows, 384)
    assert torch.equal(got, quant.int8_matmul_reference(xq, wq))
    assert torch.equal(got.cpu().long(), xq.cpu().long() @ wq.cpu().long().t())


def test_int8_gemm_refuses_unaligned_sizes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xq = torch.ones((32, 20), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(xq, torch.ones((16, 20), dtype=torch.int8,
                                         device="cuda"))


def test_int8_linear_on_card_equals_cpu():
    """The same bf16 input and fp32 weights: the card's int8 layer returns
    the CPU twin's values bit for bit (IEEE division, round half to even,
    exact integer products, the same fp32 multiplies and add)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((4, 100, 384), generator=gen) * 3).to(torch.bfloat16)
    x[1, 7] = 0  # a zero row
    w = torch.randn((384, 384), generator=gen) * 0.05
    b = torch.randn(384, generator=gen)
    want = quant.int8_linear(x, w, b)
    got = quant.int8_linear(x.cuda(), w.cuda(), b.cuda())
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


def test_custom_ops_launch_or_raise_on_card():
    """``peneo::biacm_attention`` / ``peneo::bias_attention`` on CUDA
    tensors: one launch each, the kernel's output layout (the fakes'), and
    float32 inputs (which the kernels do not take) raise instead of
    falling back to the twin, as does a backward through #1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def heads(d, dtype=torch.bfloat16):
        x = torch.randn((2, 40, 12, d), generator=gen, device="cuda")
        return x.to(dtype).transpose(1, 2)

    mask = torch.zeros((2, 40), device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        qkv = [heads(d, dtype) for d in (64, 64, 64, 16, 16, 16)]
        bias = torch.randn((12, 2, 40, 40), generator=gen,
                           device="cuda").permute(1, 0, 2, 3)
        calls = (lambda: ba.biacm_attention_op(*qkv, mask, 0.125, 0.25),
                 lambda: rb.bias_attention_op(*qkv[:3], bias, mask, 0.125))
        counters = (ba.biacm_attention_cuda, rb.bias_attention_cuda)
        for call, counter in zip(calls, counters):
            before = counter.launches
            if dtype == torch.float32:
                with pytest.raises(ValueError, match="bfloat16"):
                    call()
                assert counter.launches == before
                continue
            out = call()
            out = out[0] if isinstance(out, tuple) else out
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert out.stride() == (40 * 12 * 64, 64, 12 * 64, 1)
    # the inference kernels have no backward (training runs #2/#3, #5/#6)
    qkv = [heads(d).detach().requires_grad_(True)
           for d in (64, 64, 64, 16, 16, 16)]
    out = ba.biacm_attention_op(*qkv, mask, 0.125, 0.25)[0]
    with pytest.raises(RuntimeError, match="no backward"):
        out.float().sum().backward()
