"""Training path of the PyTorch port's model (peneo_tpu_torch/models): the
decoder's losses from spot labels and from dense int8 labels, with
``label_row_mask`` and ``also_decode``, against the JAX PEneoModel on the
same weights (fp32, dropout 0, rtol 1e-5); the decoder's gradients through
the total loss; the backbone's gradients through a dense loss on
``last_hidden_state`` (through the whole decoder at this size they fall to
~1e-8 and prove nothing; tolerance of tests/test_biacm_train.py:195-207);
and gradient checkpointing, which must replay the same dropout masks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LiltConfig, PEneoConfig
from peneo_tpu.models.decoder import dense_labels_from_spots as jax_dense
from peneo_tpu.models.decoder import triu_valid_mask as jax_triu
from peneo_tpu.models.lilt import LiltModel as JaxLilt
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES, \
    dense_labels_from_spots, triu_valid_mask
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel

torch.set_num_threads(1)
L, B, S = 40, 2, 12
LD = L - 1


def _cfg(dropout=0.0, **kw):
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=120, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=L + 16, pad_token_id=0,
            hidden_dropout_prob=dropout,
            attention_probs_dropout_prob=dropout).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=LD * LD,
        spot_topk="exact", initializer_range=0.15,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_loss_ratio=[1.0, 0.5, 2.0, 1.0, 1.5], **kw)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 120, (B, L)).astype(np.int32)
    ids[1, -9:] = 0
    attn = (ids != 0).astype(np.int32)
    x0 = rng.integers(0, 900, (B, L))
    y0 = rng.integers(0, 900, (B, L))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    spots, dense = {}, {}
    for name in HEAD_NAMES:
        n_cls = 2 if name == "line_extraction" else 3
        arr = np.full((B, S, 3), [LD, LD, 0], np.int32)
        mat = np.zeros((B, LD, LD), np.int8)
        for b in range(B):
            for s in range(S - 3):  # the last rows stay padding
                i = int(rng.integers(0, LD - 9 * b))
                j = int(rng.integers(i, LD - 9 * b))
                t = int(rng.integers(1, n_cls))
                arr[b, s] = (i, j, t)
                mat[b, i, j] = t
        spots[name], dense[name] = arr, mat
    return ids, bbox, attn, spots, dense


@pytest.fixture(scope="module")
def setup():
    ids, bbox, attn, spots, dense = _inputs()
    cfg = _cfg()
    params = jax.device_get(jax.jit(PEneoModel(cfg).init)(
        jax.random.PRNGKey(3), ids, bbox, attn)["params"])
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    port = PortModel(port_cfg)
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    return cfg, params, port, (ids, bbox, attn), spots, dense


def _t(arrays):
    return [torch.from_numpy(np.asarray(x)) for x in arrays]


def test_dense_labels_and_triu_mask_match_jax():
    _, _, _, spots, dense = _inputs(5)
    for name in HEAD_NAMES:
        got = dense_labels_from_spots(torch.from_numpy(spots[name]), LD)
        want = jax_dense(jnp.asarray(spots[name]), LD)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), dense[name])
    for args in ((0, 16, 40, 39, 0), (16, 16, 24, 39, 16), (32, 16, 8, 30, 32)):
        np.testing.assert_array_equal(triu_valid_mask(*args).numpy(),
                                      np.asarray(jax_triu(*args)))


@pytest.mark.parametrize("row_mask", [None, (1.0, 0.0)])
@pytest.mark.parametrize("form", ["spots", "dense"])
def test_losses_match_jax(setup, form, row_mask):
    cfg, params, port, inputs, spots, dense = setup
    labels = spots if form == "spots" else dense
    rm = None if row_mask is None else np.asarray(row_mask, np.float32)
    want = jax.jit(lambda p, lbl, m: PEneoModel(cfg).apply(
        {"params": p}, *inputs, labels=lbl, deterministic=True,
        label_row_mask=m))(params, labels, rm)
    port.eval()
    with torch.no_grad():
        got = port(*_t(inputs), labels=dict(zip(labels, _t(labels.values()))),
                   label_row_mask=None if rm is None else torch.from_numpy(rm))
    assert set(got) == set(HEAD_NAMES) | {"total"}
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_also_decode_is_one_pass_of_losses_and_spots(setup):
    """``also_decode`` gives the JAX losses and exactly the inference
    path's compact spots (one pass over the grid for both)."""
    cfg, params, port, inputs, spots, _ = setup
    rm = np.asarray([1.0, 0.0], np.float32)
    want, _ = jax.jit(lambda p, lbl, m: PEneoModel(cfg).apply(
        {"params": p}, *inputs, labels=lbl, deterministic=True,
        also_decode=True, label_row_mask=m))(params, spots, rm)
    port.eval()
    with torch.no_grad():
        losses, out = port(*_t(inputs),
                           labels=dict(zip(spots, _t(spots.values()))),
                           also_decode=True,
                           label_row_mask=torch.from_numpy(rm))
        plain = port(*_t(inputs))
    for key in losses:
        np.testing.assert_allclose(float(losses[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for name in HEAD_NAMES:
        assert int(out[name]["spot_count"].sum()) > 0
        for k in out[name]:
            assert torch.equal(out[name][k], plain[name][k]), (name, k)


def test_decoder_gradients_match_jax(setup):
    cfg, params, port, inputs, spots, _ = setup
    model = PEneoModel(cfg)
    lbl = {k: jnp.asarray(v) for k, v in spots.items()}

    def loss(p):
        return model.apply({"params": p}, *inputs, labels=lbl,
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})["total"]

    total, grads = jax.jit(jax.value_and_grad(loss))(params)
    want = jax_params_to_state_dict(jax.device_get(grads),
                                    PortConfig.from_dict(cfg.to_dict()))
    port.train()
    port.zero_grad(set_to_none=True)
    got = port(*_t(inputs), labels=dict(zip(spots, _t(spots.values()))))
    got["total"].backward()
    np.testing.assert_allclose(float(got["total"].detach()), float(total),
                               rtol=1e-5)
    checked = 0
    for name, p in port.named_parameters():
        if name.startswith("peneo_decoder."):
            g = want[name].numpy()
            assert np.abs(g).max() > 1e-4, name  # not vacuous
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=2e-3,
                                       atol=2e-5, err_msg=name)
            checked += 1
    assert checked >= 12
    port.eval()


def test_backbone_gradients_match_jax(setup):
    """Dense loss on last_hidden_state keeps every backbone gradient O(1)."""
    cfg, params, port, inputs, _, _ = setup
    lilt = JaxLilt(LiltConfig.from_dict(cfg.backbone_config),
                   dtype=jnp.float32)
    w = np.random.default_rng(9).standard_normal(
        (B, L, 60)).astype(np.float32)

    def loss(p):
        out = lilt.apply({"params": p}, *inputs, deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(2)})
        return (out["last_hidden_state"] * w).sum()

    grads = jax.jit(jax.grad(loss))(params["backbone"])
    want = jax_params_to_state_dict(
        {"backbone": jax.device_get(grads),
         "peneo_decoder": params["peneo_decoder"]},
        PortConfig.from_dict(cfg.to_dict()))
    backbone = port.backbone.train()
    backbone.zero_grad(set_to_none=True)
    out = backbone(*_t(inputs))
    (out["last_hidden_state"] * torch.from_numpy(w)).sum().backward()
    gmax = max(float(p.grad.abs().max()) for p in backbone.parameters())
    assert gmax > 1e-1, f"gradients ~0 ({gmax:.2e}): comparison vacuous"
    for name, p in backbone.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want["backbone." + name].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    port.eval()


def test_gradient_checkpointing_replays_dropout():
    """With dropout 0.1, the checkpointed model (each LiLT layer and each
    pair block recomputed in the backward) gives the loss and gradients of
    the plain one: the recompute replays the same masks."""
    ids, bbox, attn, spots, _ = _inputs(2)
    results = []
    for ckpt in (False, True):
        cfg = PortConfig.from_dict(_cfg(0.1, gradient_checkpointing=ckpt)
                                   .to_dict())
        model = PortModel(cfg).init_weights(torch.Generator().manual_seed(4))
        assert model.backbone.gradient_checkpointing == ckpt
        model.train()
        torch.manual_seed(11)
        gen = torch.Generator().manual_seed(12)
        out = model(*_t((ids, bbox, attn)),
                    labels=dict(zip(spots, _t(spots.values()))),
                    generator=gen)
        out["total"].backward()
        results.append((float(out["total"]),
                        {n: p.grad.clone() for n, p in
                         model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert l0 == pytest.approx(l1, rel=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-7,
                                   msg=name)
