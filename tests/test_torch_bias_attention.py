"""Rel-bias attention of the PyTorch port
(peneo_tpu_torch/ops/bias_attention.py) against the JAX package's Pallas
kernels in interpret mode on the same numpy inputs: the inference twin vs
``bias_attention(interpret=True)`` (and through ``maybe_fused_ctx`` at an
unaligned L), the training twin and ``BiasAttentionTrain`` on CPU tensors vs
``bias_attention_train(..., interpret=True, inkernel_rng=False)`` fed the
same mask bits — forward values and the gradients of q, k, v and the bias —
at tests/test_bias_attention*.py's tolerances (fp32: 2e-5 forward, 2e-4
gradients: other summation orders of fp32 sums over L terms)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.ops import bias_attention as jb
from peneo_tpu_torch.ops import biacm_attention as ba
from peneo_tpu_torch.ops import bias_attention as rb

torch.set_num_threads(1)
B, NH, D = 2, 2, 64
SCALE = 1.0 / D ** 0.5
NEG = np.finfo(np.float32).min / 2


def _inputs(L, seed):
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.standard_normal((B, NH, L, D)) * 0.5).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((B, NH, L, L)).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    mask[0, L - 7:] = NEG  # padded keys on one row
    dctx = rng.standard_normal((B, NH, L, D)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, size=(B, NH, L, L),
                        dtype=np.uint64).astype(np.uint32)
    return (q, k, v), bias, mask, dctx, bits


def test_twin_matches_pallas_kernel():
    (q, k, v), bias, mask, _, _ = _inputs(256, seed=0)
    want = jb.bias_attention(*(jnp.asarray(x) for x in (q, k, v, bias, mask)),
                             SCALE, interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v, bias, mask)]
    for fn in (rb.bias_attention_reference, rb.bias_attention):
        got = fn(*t, SCALE)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    assert rb.bias_attention_cuda.launches == 0


def test_twin_matches_gate_at_unaligned_length():
    """``maybe_fused_ctx`` pads L = 120 to 128 inside; the port takes any
    L. Its layout is the layers': q/k/v (B, L, nh, d), mask (B, 1, 1, L),
    context (B, L, nh·d)."""
    L = 120
    (q, k, v), bias, mask, _, _ = _inputs(L, seed=1)
    blhd = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)]
    want = jb.maybe_fused_ctx(*blhd, jnp.asarray(bias),
                              jnp.asarray(mask)[:, None, None, :], SCALE,
                              deterministic=True, dropout_p=0.0)
    assert want is not None  # the kernel engaged (interpret mode)
    got = rb.bias_attention(*(torch.from_numpy(x)
                              for x in (q, k, v, bias, mask)), SCALE)
    got = got.transpose(1, 2).reshape(B, L, NH * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _jax_train(qkv, bias, mask, dctx, bits, rate, L):
    def f(q, k, v, b):
        return jb.bias_attention_train(
            q, k, v, b, jnp.asarray(mask), jnp.asarray(bits), SCALE,
            rate=rate, tile_q=min(128, L), interpret=True,
            inkernel_rng=False)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (*qkv, bias)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dctx))]


@pytest.mark.parametrize("fn", ["twin", "function"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [128, 40])
def test_matches_pallas_training_kernel(L, rate, fn):
    qkv, bias, mask, dctx, bits = _inputs(L, seed=L + int(rate * 10))
    want_out, want_grads = _jax_train(qkv, bias, mask, dctx, bits, rate, L)
    impl = (rb.bias_attention_train_reference if fn == "twin"
            else rb.bias_attention_train)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (*qkv, bias)]
    out = impl(*leaves, torch.from_numpy(mask),
               torch.from_numpy(bits.view(np.int32)), SCALE, rate)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dctx))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=2e-5,
                               atol=2e-5)
    for got, want, name in zip(grads, want_grads, ("q", "k", "v", "bias")):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_seed_path_draws_word_0_of_the_biacm_bits():
    """An int seed on CPU tensors draws ``element_dropout_bits(...)``, the
    one mask the CUDA mask kernel draws on the card (four keys per Philox
    draw); its kept share is 1 - rate within 4 standard deviations."""
    L = 48
    qkv, bias, mask, _, _ = _inputs(L, seed=3)
    bits = ba.element_dropout_bits(99, B, NH, L)
    t = [torch.from_numpy(x) for x in (*qkv, bias, mask)]
    a = rb.bias_attention_train(*t, 99, SCALE, 0.1)
    b = rb.bias_attention_train_reference(*t, bits, SCALE, 0.1)
    assert torch.equal(a, b)
    kept = (bits < ba.keep_threshold(0.1)).float().mean().item()
    assert abs(kept - 0.9) < 4 * (0.09 / bits.numel()) ** 0.5


def test_twin_gradients_from_packed_flags():
    """The twin fed ``keep_flag_bits`` of the packed keep flags (kernel
    #5's output layout, ``pack_keep_mask`` of the keep flags) gives exactly
    the outputs and gradients it gives from the bits themselves."""
    L, rate = 40, 0.1
    qkv, bias, mask, dctx, bits = _inputs(L, seed=11)
    t = [torch.from_numpy(x).requires_grad_() for x in (*qkv, bias)]
    m, d = torch.from_numpy(mask), torch.from_numpy(dctx)
    raw = torch.from_numpy(bits.astype(np.int64))
    packed = ba.pack_keep_mask(raw < ba.keep_threshold(rate))
    assert packed.shape == (B, NH, L, 2) and packed.dtype == torch.int32
    outs = []
    for b in (raw, rb.keep_flag_bits(packed, L)):
        out = rb.bias_attention_train_reference(*t, m, b, SCALE, rate)
        outs.append([out] + list(torch.autograd.grad(out, t, d)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_fully_masked_row_is_finite():
    """Every key masked with finfo.min itself under a negative bias: the
    softmax stays finite (uniform over the keys)."""
    L = 16
    (q, k, v), bias, mask, _, _ = _inputs(L, seed=4)
    mask[:] = np.finfo(np.float32).min
    got = rb.bias_attention(*(torch.from_numpy(x) for x in
                              (q, k, v, -np.abs(bias), mask)), SCALE)
    assert torch.isfinite(got).all()


def test_cuda_launchers_refuse_cpu_tensors():
    qkv, bias, mask, dctx, _ = _inputs(16, seed=2)
    t = [torch.from_numpy(x) for x in (*qkv, bias, mask)]
    with pytest.raises(ValueError, match="CUDA"):
        rb.bias_attention_cuda(*t, SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        rb.bias_attention_train_fwd_cuda(*t, 1, SCALE, 0.1)
    assert rb.bias_attention_train_fwd_cuda.launches == 0
    assert rb.bias_attention_train_bwd_cuda.launches == 0
