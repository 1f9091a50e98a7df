"""BiACM attention of the PyTorch port (peneo_tpu_torch/ops/biacm_attention.py):
its plain twin against the JAX package's Pallas kernel (interpret mode on
the CPU) and the JAX einsum path for a ragged length. Tolerance: fp32
rtol = atol = 2e-5, as tests/test_biacm_attention.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.ops.biacm_attention import biacm_attention as jax_biacm
from peneo_tpu_torch.ops import biacm_attention as ba

torch.set_num_threads(1)
B, NH, DT, DL = 2, 2, 64, 16
SCALES = (1.0 / DT ** 0.5, 1.0 / DL ** 0.5)
NEG = np.finfo(np.float32).min / 2


def _inputs(L, seed):
    """(B, nh, L, d) fp32 q/k/v of both streams and a (B, L) key mask: row 1
    has its last 17 keys padded, row 0 (for L > 64) its first 64 keys."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, NH, L, d)).astype(np.float32)
           for d in (DT, DT, DT, DL, DL, DL)]
    bias = np.zeros((B, L), np.float32)
    bias[1, -17:] = NEG
    if L > 64:
        bias[0, :64] = NEG
    return qkv, bias


def _port(qkv, bias, fn=ba.biacm_attention_reference):
    out = fn(*(torch.from_numpy(x) for x in qkv), torch.from_numpy(bias),
             *SCALES)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("L", [128, 256])
def test_plain_twin_matches_pallas_kernel(L):
    qkv, bias = _inputs(L, seed=L)
    want = jax_biacm(*(jnp.asarray(x) for x in qkv), jnp.asarray(bias),
                     *SCALES, interpret=True)
    for got, ref, name in zip(_port(qkv, bias), want, ("ctx_t", "ctx_l")):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_plain_twin_matches_einsum_path_ragged():
    """L=40 is off the Pallas kernel's L % 128 grid; the JAX model runs the
    einsum path there (peneo_tpu/models/lilt.py:267-281), written here on
    its (B, L, nh, d) layout."""
    L = 40
    qkv, bias = _inputs(L, seed=7)
    q_t, k_t, v_t, q_l, k_l, v_l = (jnp.asarray(x).transpose(0, 2, 1, 3)
                                    for x in qkv)
    s_t = jnp.einsum("blhd,bmhd->bhlm", q_t, k_t) / jnp.sqrt(float(DT))
    s_l = jnp.einsum("blhd,bmhd->bhlm", q_l, k_l) / jnp.sqrt(float(DL))
    scores = s_t + s_l + jnp.asarray(bias)[:, None, None, :]
    probs = jax.nn.softmax(scores, axis=-1)
    want = (jnp.einsum("bhlm,bmhd->blhd", probs, v_t).transpose(0, 2, 1, 3),
            jnp.einsum("bhlm,bmhd->blhd", probs, v_l).transpose(0, 2, 1, 3))
    for got, ref, name in zip(_port(qkv, bias), want, ("ctx_t", "ctx_l")):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_dispatch_runs_plain_twin_on_cpu_tensors():
    qkv, bias = _inputs(72, seed=1)
    for got, ref in zip(_port(qkv, bias, ba.biacm_attention),
                        _port(qkv, bias)):
        np.testing.assert_array_equal(got, ref)


def test_cuda_wrapper_refuses_cpu_tensors():
    qkv, bias = _inputs(16, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        ba.biacm_attention_cuda(*(torch.from_numpy(x) for x in qkv),
                                torch.from_numpy(bias), *SCALES)
    assert ba.biacm_attention_cuda.launches == 0
