"""The CUDA BiACM kernel against its plain twin on the card. Needs a CUDA
device (and nvcc to build the kernel); skips without one. On the GPU
machine run it with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py``
(``--noconftest`` skips the JAX setup of ``tests/conftest.py``; this file
imports no JAX)."""

import pytest
import torch

from peneo_tpu_torch.ops import biacm_attention as ba

pytestmark = pytest.mark.cuda
NEG = torch.finfo(torch.float32).min / 2


@pytest.mark.parametrize("L", [1, 63, 128, 200, 512])
def test_kernel_matches_plain_twin_on_card(L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(L)
    B, nh = 2, 12

    def heads(d):  # (B, nh, L, d) views of (B, L, nh, d), as the model passes
        x = torch.randn((B, L, nh, d), generator=gen, device="cuda")
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads(64) for _ in range(3)] + [heads(16) for _ in range(3)]
    bias = torch.zeros((B, L), device="cuda")
    bias[0, : L // 2] = NEG       # leading keys padded (whole key tiles)
    bias[1, L - L // 3:] = NEG    # trailing keys padded
    before = ba.biacm_attention_cuda.launches
    got = ba.biacm_attention(*qkv, bias, 0.125, 0.25)
    want = ba.biacm_attention_reference(*(x.float() for x in qkv), bias,
                                        0.125, 0.25)
    torch.cuda.synchronize()
    assert ba.biacm_attention_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert (g.float() - w).abs().max().item() <= 2e-2


def _train_inputs(L, seed, spread=None):
    """q/k/v, bias and output gradients; with a ``spread``, each head's
    q/k/v rows are one shared row plus ``spread`` times noise (nearly
    collinear, as in LiLT-base's last layers), halved to keep values O(1)
    for the absolute forward gate."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, nh = 2, 12

    def heads(d, collinear=False):
        x = torch.randn((B, L, nh, d), generator=gen, device="cuda")
        if collinear:
            x = 0.5 * (x[:, :1] + spread * x)
        return x.to(torch.bfloat16).transpose(1, 2)

    c = spread is not None
    qkv = [heads(64, c) for _ in range(3)] + [heads(16, c) for _ in range(3)]
    bias = torch.zeros((B, L), device="cuda")
    bias[0, : L // 2] = NEG
    bias[1, L - L // 3:] = NEG
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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [1, 63, 128, 200, 512, "512-collinear"])
def test_train_kernels_match_plain_twin_on_card(L, rate):
    """Kernels #2 (forward) and #3 (backward) against the fp32 twin and
    its autograd gradients on the same bf16 inputs and output gradients,
    with the in-kernel bits (the twin takes attention_dropout_bits of the
    same seed) and with explicit bits. Forward: max abs err <= 2e-2, as
    kernel #1; gradients: see _check_grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    spread = None
    if L == "512-collinear":  # dq, dk: small differences of large terms
        L, spread = 512, 0.1
    qkv, bias, dctx = _train_inputs(L, seed=L + 7, spread=spread)
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
