"""Class-weighted cross-entropy of the PyTorch port
(peneo_tpu_torch/ops/losses.py) against ``peneo_tpu.ops.losses`` on the
same numpy logits, targets, masks and class weights: the per-element CE,
the weight lookup, the weighted mean and its (num, den) parts. fp32, rtol
1e-6 (the same operations in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peneo_tpu.ops import losses as jl
from peneo_tpu_torch.ops import losses as tl

torch.set_num_threads(1)


def _case(n_classes, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((2, 24, 30, n_classes)) * 3).astype(
        np.float32)
    targets = rng.integers(0, n_classes, (2, 24, 30)).astype(np.int32)
    mask = rng.random((2, 24, 30)) < 0.6
    weights = np.asarray([1.0, 10.0, 10.0][:n_classes], np.float32)
    return logits, targets, mask, weights


@pytest.mark.parametrize("n_classes", [2, 3])
def test_per_element_ce_and_weight_lookup(n_classes):
    logits, targets, _, weights = _case(n_classes, seed=n_classes)
    np.testing.assert_allclose(
        tl._per_element_ce(torch.from_numpy(logits),
                           torch.from_numpy(targets)).numpy(),
        np.asarray(jl._per_element_ce(jnp.asarray(logits),
                                      jnp.asarray(targets))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tl.class_weight_lookup(torch.from_numpy(weights),
                               torch.from_numpy(targets)).numpy(),
        np.asarray(jl.class_weight_lookup(jnp.asarray(weights),
                                          jnp.asarray(targets))))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_classes", [2, 3])
def test_weighted_cross_entropy(n_classes, masked):
    logits, targets, mask, weights = _case(n_classes, seed=10 + n_classes)
    m = mask if masked else None
    ours = tl.weighted_cross_entropy(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(targets),
        torch.from_numpy(weights), None if m is None else torch.from_numpy(m))
    theirs = jl.weighted_cross_entropy(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(targets),
        jnp.asarray(weights), None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    num, den = tl.weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(weights), None if m is None else torch.from_numpy(m),
        return_sum_and_weight=True)
    jnum, jden = jl.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(weights),
        None if m is None else jnp.asarray(m), return_sum_and_weight=True)
    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-6)
    np.testing.assert_allclose(float(den), float(jden), rtol=1e-6)


def test_empty_mask_gives_zero_not_nan():
    logits, targets, mask, weights = _case(3, seed=5)
    out = tl.weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(weights), torch.zeros(mask.shape, dtype=torch.bool))
    assert float(out) == 0.0
