"""OHEM and the other pair losses of the PyTorch port
(peneo_tpu_torch/ops/losses.py, the decoder's streaming OHEM) against
``peneo_tpu.ops.losses`` and the JAX decoder on the same numpy inputs and
weights (fp32, relative 1e-5; the decoder's weight gradients within 1e-4 of
each tensor's max |g|): dense OHEM at the JAX tests' (k_pos, k_neg) cases
and with fewer elements than k, its gradient, streaming equal to dense, the
focal loss under its three reductions, random-sample CE fed JAX's own noise,
``peneo_head_loss``'s dispatch, and the decoder's OHEM losses and gradients
for a tiny LiLT and LayoutLMv3 at L = 64 and a tiny LiLT at L = 512 with
OHEM 128/512 (tests/test_losses.py:135-176's shape)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.ops import losses as jl
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.ops import losses as tl

torch.set_num_threads(1)
RTOL = 1e-5
K_CASES = [(5, 7), (-1, 6), (4, -1), (100, 100)]


def _case(seed, shape=(2, 24, 24), n_classes=3):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (n_classes,)) * 2).astype(np.float32)
    targets = rng.integers(0, n_classes, shape).astype(np.int32)
    mask = rng.random(shape) < 0.7
    weights = np.asarray([1.0, 10.0, 10.0][:n_classes], np.float32)
    return logits, targets, mask, weights


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("k_pos,k_neg", K_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_ohem_cross_entropy_matches_jax(k_pos, k_neg, masked):
    logits, targets, mask, w = _case(1)
    m = mask if masked else None
    ours = tl.ohem_cross_entropy(*_t(logits, targets, w),
                                 None if m is None else _t(m)[0],
                                 k_pos, k_neg)
    theirs = jl.ohem_cross_entropy(*_j(logits, targets, w),
                                   None if m is None else jnp.asarray(m),
                                   k_pos, k_neg)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL)


def test_ohem_fewer_elements_than_k():
    """kept = min(k, #selected): 3 negatives and 1 positive under k = 10."""
    logits = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    targets = np.asarray([0, 0, 0, 1], np.int32)
    w = np.ones(2, np.float32)
    ours = float(tl.ohem_cross_entropy(*_t(logits, targets, w), None, 10, 10))
    theirs = float(jl.ohem_cross_entropy(*_j(logits, targets, w), None,
                                         10, 10))
    ce = -torch.log_softmax(torch.from_numpy(logits), -1)[
        torch.arange(4), torch.from_numpy(targets).long()]
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)
    np.testing.assert_allclose(ours, float(ce.mean()), rtol=RTOL)


@pytest.mark.parametrize("k_pos,k_neg", K_CASES)
def test_ohem_gradient_matches_jax(k_pos, k_neg):
    """torch.topk carries the gradient to the kept elements only, as
    jax.lax.top_k does (distinct values: no ties at the k-th)."""
    logits, targets, mask, w = _case(3)
    x = torch.from_numpy(logits).requires_grad_()
    tl.ohem_cross_entropy(x, *_t(targets, w, mask), k_pos,
                          k_neg).backward()
    g = jax.grad(lambda z: jl.ohem_cross_entropy(
        z, *_j(targets, w, mask), k_pos, k_neg))(jnp.asarray(logits))
    g = np.asarray(g)
    assert np.abs(g).max() > 1e-3
    np.testing.assert_allclose(x.grad.numpy(), g, rtol=RTOL,
                               atol=1e-7 * np.abs(g).max())


@pytest.mark.parametrize("k_pos,k_neg", K_CASES)
def test_ohem_streaming_matches_dense(k_pos, k_neg):
    """Row blocks folded into the streaming state == dense OHEM on the
    concatenated logits (the port's and JAX's)."""
    logits, targets, mask, w = _case(6)
    dense = float(tl.ohem_cross_entropy(*_t(logits, targets, w, mask),
                                        k_pos, k_neg))
    state = tl.ohem_stream_init(k_pos, k_neg)
    jstate = jl.ohem_stream_init(k_pos, k_neg)
    for r0 in range(0, logits.shape[1], 8):
        blk = (logits[:, r0:r0 + 8], targets[:, r0:r0 + 8], w,
               mask[:, r0:r0 + 8])
        state = tl.ohem_stream_update(state, *_t(*blk))
        jstate = jl.ohem_stream_update(jstate, *_j(*blk))
    streamed = float(tl.ohem_stream_final(state))
    np.testing.assert_allclose(streamed, dense, rtol=RTOL)
    np.testing.assert_allclose(streamed, float(jl.ohem_stream_final(jstate)),
                               rtol=RTOL)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_sigmoid_focal_loss_matches_jax(reduction):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 40)) * 3).astype(np.float32)
    targets = (rng.random((3, 40)) < 0.3).astype(np.float32)
    for alpha, gamma in ((0.25, 2.0), (-1.0, 1.5)):
        ours = tl.sigmoid_focal_loss(*_t(logits, targets), alpha, gamma,
                                     reduction)
        theirs = jl.sigmoid_focal_loss(*_j(logits, targets), alpha, gamma,
                                       reduction)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("k_bg,k_fg", [(30, 10), (2000, 2000)])
@pytest.mark.parametrize("weighted", [False, True])
def test_random_sample_mean_with_jax_noise(k_bg, k_fg, weighted):
    """The sampling and the mean, fed JAX's own uniform draw, give JAX's
    random-sample CE; the port's draw comes from a torch.Generator and is
    reproducible from its seed."""
    logits, targets, mask, w = _case(5)
    key = jax.random.PRNGKey(7)
    theirs = jl.random_sample_cross_entropy(
        *_j(logits, targets), key, k_bg, k_fg,
        class_weights=jnp.asarray(w) if weighted else None,
        mask=jnp.asarray(mask))
    ce = tl._per_element_ce(*_t(logits, targets))
    if weighted:
        ce = ce * tl.class_weight_lookup(*_t(w, targets))
    noise = np.asarray(jax.random.uniform(key, targets.shape))
    ours = tl.random_sample_mean(ce, *_t(targets, noise), k_bg, k_fg,
                                 _t(mask)[0])
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL)
    draws = [float(tl.random_sample_cross_entropy(
        *_t(logits, targets), torch.Generator().manual_seed(3), k_bg, k_fg,
        _t(w)[0] if weighted else None, _t(mask)[0])) for _ in range(2)]
    assert draws[0] == draws[1] and np.isfinite(draws[0])


@pytest.mark.parametrize("k_pos,k_neg", [(-1, -1), (5, 7), (-1, 6)])
def test_peneo_head_loss_dispatch(k_pos, k_neg):
    logits, targets, mask, w = _case(8)
    ours = tl.peneo_head_loss(*_t(logits, targets, w, mask), k_pos, k_neg)
    theirs = jl.peneo_head_loss(*_j(logits, targets, w, mask), k_pos, k_neg)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL)
    want = (tl.weighted_cross_entropy(*_t(logits, targets, w, mask))
            if (k_pos, k_neg) == (-1, -1) else
            tl.ohem_cross_entropy(*_t(logits, targets, w, mask), k_pos, k_neg))
    assert float(ours) == float(want)


# the decoder's streaming OHEM against the JAX model --------------------------

def _model_cfg(family, L, layers, ohem):
    common = dict(vocab_size=120, hidden_size=48, num_hidden_layers=layers,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=L + 16, pad_token_id=0,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  initializer_range=0.15)
    if family == "v3":
        name, backbone = "layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=8, shape_size=8, input_size=32, **common)
    else:
        name, backbone = "lilt-infoxlm-base", LiltConfig(**common)
    return PEneoConfig(
        backbone_name=name, backbone_config=backbone.to_dict(),
        pair_block_size=16 if L <= 64 else 128, max_seq_len=L,
        initializer_range=0.15, peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_loss_ratio=[1.0, 0.5, 2.0, 1.0, 1.5],
        peneo_ohem_num_positive=ohem[0], peneo_ohem_num_negative=ohem[1])


def _batch(B, L, spots, image, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 120, (B, L)).astype(np.int32)
    ids[-1, -7:] = 0
    x0 = rng.integers(0, 900, (B, L))
    y0 = rng.integers(0, 900, (B, L))
    batch = {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
             "bbox": np.stack([x0, y0, x0 + 40, y0 + 20],
                              -1).astype(np.int32)}
    ld = L - 1
    labels = {}
    for name in HEAD_NAMES:
        n_cls = 2 if name == "line_extraction" else 3
        m = np.zeros((B, ld, ld), np.int8)
        for b in range(B):
            for _ in range(spots):
                i = int(rng.integers(0, ld - 8))
                m[b, i, int(rng.integers(i, ld - 8))] = rng.integers(1, n_cls)
        labels[name] = m
    batch["labels"] = labels
    if image:
        batch["image"] = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    return batch


def _port_and_jax(family, L, layers, ohem, B, spots):
    cfg = _model_cfg(family, L, layers, ohem)
    batch = _batch(B, L, spots, image=family == "v3")
    args = (batch["input_ids"], batch["bbox"], batch["attention_mask"])
    image = batch.get("image")
    model = PEneoModel(cfg, dtype=jnp.float32)
    params = jax.device_get(jax.jit(lambda *a: model.init(
        jax.random.PRNGKey(0), *a, image=image))(*args)["params"])
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    port = PortModel(port_cfg)
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    return cfg, model, params, port, port_cfg, batch


@pytest.mark.parametrize("family,L,layers,ohem,B,spots", [
    ("lilt", 64, 2, (5, 7), 2, 6),
    ("v3", 64, 2, (5, 7), 2, 6),
    ("lilt", 512, 1, (128, 512), 1, 6),
], ids=["lilt-L64", "v3-L64", "lilt-L512"])
def test_decoder_ohem_losses_and_gradients_match_jax(family, L, layers, ohem,
                                                      B, spots):
    cfg, model, params, port, port_cfg, batch = _port_and_jax(
        family, L, layers, ohem, B, spots)
    args = (batch["input_ids"], batch["bbox"], batch["attention_mask"])
    image = batch.get("image")
    labels = {k: jnp.asarray(v) for k, v in batch["labels"].items()}

    def loss(p):
        out = model.apply({"params": p}, *args, labels=labels,
                          deterministic=True, image=image)
        return out["total"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    gwant = jax_params_to_state_dict(jax.device_get(grads), port_cfg)
    port.train()
    got = port(*_t(*args), labels={k: torch.from_numpy(v)
                                   for k, v in batch["labels"].items()},
               image=None if image is None else torch.from_numpy(image))
    got["total"].backward()
    for key in got:
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]),
                                   rtol=RTOL, err_msg=key)
    checked = 0
    for name, p in port.named_parameters():
        if name.startswith("peneo_decoder."):
            g = gwant[name].numpy()
            gmax = np.abs(g).max()
            assert gmax > 1e-5, name  # not vacuous
            err = np.abs(p.grad.numpy() - g).max()
            assert err <= 1e-4 * gmax, (name, err, gmax)
            checked += 1
    assert checked >= 12


def test_decoder_ohem_also_decode_reports_the_ohem_losses():
    """Eval's one pass (``also_decode``, a row mask) reports the OHEM losses
    JAX reports, and the inference path's spots."""
    cfg, model, params, port, _, batch = _port_and_jax(
        "lilt", 64, 2, (5, 7), 2, 6)
    args = (batch["input_ids"], batch["bbox"], batch["attention_mask"])
    rm = np.asarray([1.0, 0.0], np.float32)
    want, _ = jax.jit(lambda p, lbl, m: model.apply(
        {"params": p}, *args, labels=lbl, deterministic=True,
        also_decode=True, label_row_mask=m))(params, batch["labels"], rm)
    port.eval()
    with torch.no_grad():
        losses, out = port(*_t(*args),
                           labels={k: torch.from_numpy(v)
                                   for k, v in batch["labels"].items()},
                           also_decode=True,
                           label_row_mask=torch.from_numpy(rm))
        plain = port(*_t(*args))
    for key in losses:
        np.testing.assert_allclose(float(losses[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)
    for name in HEAD_NAMES:
        for k in out[name]:
            assert torch.equal(out[name][k], plain[name][k]), (name, k)
