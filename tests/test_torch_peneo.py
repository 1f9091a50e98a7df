"""Full PEneoModel forward of the PyTorch port against the JAX package at a
tiny config (L=128, the Pallas BiACM kernel in interpret mode on the JAX
side), on the same weights: logits, top-k spot sets, and the packed spot
transport read by both packages' ``unpack_spots``. The same for LayoutLMv3
with an image (text L = 123 + 5 visual tokens = 128, the Pallas rel-bias
kernel in interpret mode on the JAX side), plus the five losses on labels:
the serving and eval forward of that family as a whole, SEP inside the
decoder's L - 1 positions. The same for LayoutLMv2 (text L = 79 + 49
visual tokens = 128, a 56 px image through one block per ResNeXt stage),
with the gradients of the bucket tables and of the tower's stem conv."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.models.decoder import compact_spots as jax_compact_spots
from peneo_tpu.models.decoder import pack_spots as jax_pack_spots
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline.decode import unpack_spots as jax_unpack_spots
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES, compact_spots, \
    pack_spots
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.pipeline.decode import unpack_spots

torch.set_num_threads(1)
L = 128
K = (L - 1) ** 2  # every triu position: no top-k truncation
MARGIN = 1e-4


def _cfg(max_spots):
    # initializer_range 0.15 (decoder init) spreads the logits to O(1) so
    # the top-2 softmax margins are mostly far above fp32 rounding
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=120, hidden_size=96, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=L + 16, pad_token_id=0).to_dict(),
        pair_block_size=32, max_seq_len=L, max_spots_per_head=max_spots,
        spot_topk="exact", use_fused_biacm=True, initializer_range=0.15)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 120, (2, L)).astype(np.int32)
    ids[1, -30:] = 0
    attn = (ids != 0).astype(np.int32)
    x0 = rng.integers(0, 900, (2, L))
    y0 = rng.integers(0, 900, (2, L))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    return ids, bbox, attn


@pytest.fixture(scope="module")
def models():
    ids, bbox, attn = _inputs()
    # init without the kernel (same param tree; interpret-mode init is slow)
    init_cfg = _cfg(0)
    init_cfg.use_fused_biacm = False
    params = jax.device_get(jax.jit(PEneoModel(init_cfg).init)(
        jax.random.PRNGKey(0), ids, bbox, attn)["params"])
    want = PEneoModel(_cfg(0)).apply({"params": params}, ids, bbox, attn,
                           deterministic=True, return_logits=True)
    port_cfg = PortConfig.from_dict(_cfg(K).to_dict())
    port = PortModel(port_cfg).eval()  # no dropout
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    return params, want, port, [torch.from_numpy(x) for x in (ids, bbox, attn)]


def _margins(logits):
    z = np.asarray(logits, np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_logits_and_tags_match(models):
    _, want, port, inputs = models
    with torch.inference_mode():
        got = port(*inputs, return_logits=True)
    for name in HEAD_NAMES:
        np.testing.assert_allclose(got[name]["logits"].numpy(),
                                   np.asarray(want[name]["logits"]),
                                   rtol=0, atol=1e-4, err_msg=name)
        triu = np.triu(np.ones((L - 1, L - 1), bool))[None]
        decisive = (_margins(want[name]["logits"]) > MARGIN) & triu
        assert decisive.sum() > 0.99 * triu.sum() * len(inputs[0]), name
        np.testing.assert_array_equal(
            got[name]["tags"].numpy()[decisive],
            np.asarray(want[name]["tags"])[decisive], err_msg=name)


def test_spot_sets_match(models):
    _, want, port, inputs = models
    # the JAX model's compact path: compact_spots on its dense maps
    jax_spots = {n: jax_compact_spots(want[n]["tags"], want[n]["scores"], K,
                                      "exact") for n in HEAD_NAMES}
    with torch.inference_mode():
        got = port(*inputs)
    Ld = L - 1
    for name in HEAD_NAMES:
        close = _margins(want[name]["logits"]) <= MARGIN  # (B, Ld, Ld)
        for b in range(len(inputs[0])):
            def spots(out):
                keep = np.asarray(out["spot_score"][b]) >= 0
                idx = np.asarray(out["spot_idx"][b])[keep]
                tag = np.asarray(out["spot_tag"][b])[keep]
                return {(int(i), int(t)) for i, t in zip(idx, tag)
                        if not close[b, i // Ld, i % Ld]}
            ours = {k: v.numpy() for k, v in got[name].items()}
            theirs = {k: np.asarray(v) for k, v in jax_spots[name].items()}
            assert theirs["spot_count"][b] <= K, name  # no top-k truncation
            assert spots(ours) == spots(theirs), (name, b)
            assert abs(int(ours["spot_count"][b])
                       - int(theirs["spot_count"][b])) <= close[b].sum()


LV = 123  # + 5 visual tokens of a 32 px image = 128


def _v3_cfg(max_spots):
    return PEneoConfig(
        backbone_name="layoutlmv3-base-chinese",
        backbone_config=LayoutLMv3Config(
            vocab_size=120, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=LV + 8, pad_token_id=1,
            coordinate_size=20, shape_size=24, input_size=32).to_dict(),
        pair_block_size=32, max_seq_len=LV, max_spots_per_head=max_spots,
        spot_topk="exact", use_fused_bias_attention=True,
        initializer_range=0.15)


def _v3_inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 120, (2, LV)).astype(np.int32)
    ids[:, 0] = 0            # CLS
    ids[0, -1] = 2           # SEP at the end of the full row
    ids[1, -31] = 2          # SEP, then padding
    ids[1, -30:] = 1
    attn = (ids != 1).astype(np.int32)
    x0 = rng.integers(0, 900, (2, LV))
    y0 = rng.integers(0, 900, (2, LV))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    bbox[ids <= 2] = 0
    image = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    ld = LV - 1
    labels = {}
    for name in HEAD_NAMES:
        n_cls = 2 if name == "line_extraction" else 3
        m = np.zeros((2, ld, ld), np.int8)
        for b in range(2):
            for _ in range(8):
                i = int(rng.integers(0, ld - 40))
                j = int(rng.integers(i, ld - 40))
                m[b, i, j] = rng.integers(1, n_cls)
        labels[name] = m
    return ids, bbox, attn, image, labels


@pytest.fixture(scope="module")
def v3_models():
    ids, bbox, attn, image, labels = _v3_inputs()
    init_cfg = _v3_cfg(0)
    init_cfg.use_fused_bias_attention = False  # same tree, faster init
    params = jax.device_get(jax.jit(
        lambda *a: PEneoModel(init_cfg).init(jax.random.PRNGKey(0), *a[:3],
                                             image=a[3]))(
        ids, bbox, attn, image)["params"])
    rng = np.random.default_rng(2)  # zero at init: make them take part
    for name in ("cls_token", "pos_embed"):
        params["backbone"][name] = (rng.standard_normal(
            params["backbone"][name].shape) * 0.1).astype(np.float32)
    jax_model = PEneoModel(_v3_cfg(0))
    want = jax_model.apply({"params": params}, ids, bbox, attn, image=image,
                           deterministic=True, return_logits=True)
    want_losses = jax_model.apply(
        {"params": params}, ids, bbox, attn, image=image,
        labels={k: jnp.asarray(v) for k, v in labels.items()},
        deterministic=True)
    port_cfg = PortConfig.from_dict(_v3_cfg((LV - 1) ** 2).to_dict())
    port = PortModel(port_cfg).eval()
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    tensors = [torch.from_numpy(x) for x in (ids, bbox, attn)]
    return (want, want_losses, port, tensors, torch.from_numpy(image),
            {k: torch.from_numpy(v) for k, v in labels.items()}, params)


def test_v3_logits_tags_and_spots_match(v3_models):
    want, _, port, inputs, image, _, _ = v3_models
    with torch.inference_mode():
        got = port(*inputs, image=image, return_logits=True)
        spots = port(*inputs, image=image)
    ld = LV - 1
    k = ld * ld
    triu = np.triu(np.ones((ld, ld), bool))[None]
    for name in HEAD_NAMES:
        assert got[name]["logits"].shape[1:3] == (ld, ld)
        np.testing.assert_allclose(got[name]["logits"].numpy(),
                                   np.asarray(want[name]["logits"]),
                                   rtol=0, atol=1e-4, err_msg=name)
        close = _margins(want[name]["logits"]) <= MARGIN
        decisive = ~close & triu
        assert decisive.sum() > 0.99 * triu.sum() * 2, name
        np.testing.assert_array_equal(
            got[name]["tags"].numpy()[decisive],
            np.asarray(want[name]["tags"])[decisive], err_msg=name)
        theirs = jax_compact_spots(want[name]["tags"], want[name]["scores"],
                                   k, "exact")
        for b in range(2):
            def spot_set(out):
                keep = np.asarray(out["spot_score"][b]) >= 0
                idx = np.asarray(out["spot_idx"][b])[keep]
                tag = np.asarray(out["spot_tag"][b])[keep]
                return {(int(i), int(t)) for i, t in zip(idx, tag)
                        if not close[b, i // ld, i % ld]}
            ours = {key: v.numpy() for key, v in spots[name].items()}
            assert spot_set(ours) == spot_set(
                {key: np.asarray(v) for key, v in theirs.items()}), (name, b)


def test_v3_losses_match(v3_models):
    """The five head losses and their total on dense labels: 1e-5
    relative."""
    _, want_losses, port, inputs, image, labels, _ = v3_models
    with torch.inference_mode():
        got = port(*inputs, image=image, labels=labels)
    assert set(got) == set(want_losses)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want_losses[key]),
                                   rtol=1e-5, err_msg=key)


BIAS_TABLES = ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias")


def test_v3_bias_table_gradients_match_jax(v3_models):
    """d(total loss)/d(each of the three relative-position bucket tables),
    before any optimizer: the port's table-gradient form (the backward of
    its bias build, fed by the attention's dbias) against ``jax.grad`` of
    the JAX model on the same weights, rtol 1e-3 of each table's largest
    |gradient| (scale included: a constant factor would show)."""
    _, _, port, inputs, image, labels, params = v3_models
    ids, bbox, attn = (x.numpy() for x in inputs)
    cfg = _v3_cfg(0)
    cfg.use_fused_bias_attention = False  # the XLA path, differentiable
    jax_model = PEneoModel(cfg)
    jax_labels = {k: jnp.asarray(v.numpy()) for k, v in labels.items()}

    def total(tables):
        p = dict(params, backbone=dict(params["backbone"], **tables))
        return jax_model.apply({"params": p}, ids, bbox, attn,
                               image=image.numpy(), labels=jax_labels,
                               deterministic=True)["total"]

    want = jax.jit(jax.grad(total))(
        {n: params["backbone"][n] for n in BIAS_TABLES})
    port.zero_grad(set_to_none=True)
    port(*inputs, image=image, labels=labels)["total"].backward()
    for name in BIAS_TABLES:
        ref = np.asarray(want[name]).T  # (bins, heads) -> (heads, bins)
        got = getattr(port.backbone.encoder, name).weight.grad.numpy()
        assert np.abs(ref).max() > 1e-6, name  # the table takes part
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)
    port.zero_grad(set_to_none=True)


LV2 = 79  # + 49 visual tokens = 128


def _v2_cfg(max_spots):
    return PEneoConfig(
        backbone_name="layoutxlm-base",
        backbone_config=LayoutLMv2Config(
            vocab_size=120, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=LV2 + 8, pad_token_id=1,
            coordinate_size=20, shape_size=24, visual_depths=[1, 1, 1, 1],
            input_size=56).to_dict(),
        pair_block_size=32, max_seq_len=LV2, max_spots_per_head=max_spots,
        spot_topk="exact", use_fused_bias_attention=True,
        initializer_range=0.15)


def _v2_inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 120, (2, LV2)).astype(np.int32)
    ids[:, 0] = 0            # CLS
    ids[1, -20:] = 1         # padding
    attn = (ids != 1).astype(np.int32)
    x0 = rng.integers(0, 900, (2, LV2))
    y0 = rng.integers(0, 900, (2, LV2))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    bbox[ids <= 1] = 0
    image = (rng.random((2, 3, 56, 56)) * 255).astype(np.float32)
    ld = LV2 - 1
    labels = {}
    for name in HEAD_NAMES:
        n_cls = 2 if name == "line_extraction" else 3
        m = np.zeros((2, ld, ld), np.int8)
        for b in range(2):
            for _ in range(8):
                i = int(rng.integers(0, ld - 25))
                j = int(rng.integers(i, ld - 25))
                m[b, i, j] = rng.integers(1, n_cls)
        labels[name] = m
    return ids, bbox, attn, image, labels


@pytest.fixture(scope="module")
def v2_models():
    ids, bbox, attn, image, labels = _v2_inputs()
    init_cfg = _v2_cfg(0)
    init_cfg.use_fused_bias_attention = False  # same tree, faster init
    params = jax.device_get(jax.jit(
        lambda *a: PEneoModel(init_cfg).init(jax.random.PRNGKey(0), *a[:3],
                                             image=a[3]))(
        ids, bbox, attn, image)["params"])
    rng = np.random.default_rng(2)  # zero at init: make them take part
    for i in range(2):
        for name in ("q_bias", "v_bias"):
            layer = params["backbone"][f"layer_{i}"]
            layer[name] = (rng.standard_normal(layer[name].shape)
                           * 0.1).astype(np.float32)
    jax_model = PEneoModel(_v2_cfg(0))
    want = jax_model.apply({"params": params}, ids, bbox, attn, image=image,
                           deterministic=True, return_logits=True)
    want_losses = jax_model.apply(
        {"params": params}, ids, bbox, attn, image=image,
        labels={k: jnp.asarray(v) for k, v in labels.items()},
        deterministic=True)
    port_cfg = PortConfig.from_dict(_v2_cfg((LV2 - 1) ** 2).to_dict())
    port = PortModel(port_cfg).eval()
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    tensors = [torch.from_numpy(x) for x in (ids, bbox, attn)]
    return (want, want_losses, port, tensors, torch.from_numpy(image),
            {k: torch.from_numpy(v) for k, v in labels.items()}, params)


def test_v2_logits_tags_and_spots_match(v2_models):
    want, _, port, inputs, image, _, _ = v2_models
    with torch.inference_mode():
        got = port(*inputs, image=image, return_logits=True)
        spots = port(*inputs, image=image)
    ld = LV2 - 1
    k = ld * ld
    triu = np.triu(np.ones((ld, ld), bool))[None]
    for name in HEAD_NAMES:
        assert got[name]["logits"].shape[1:3] == (ld, ld)
        np.testing.assert_allclose(got[name]["logits"].numpy(),
                                   np.asarray(want[name]["logits"]),
                                   rtol=0, atol=1e-4, err_msg=name)
        close = _margins(want[name]["logits"]) <= MARGIN
        decisive = ~close & triu
        assert decisive.sum() > 0.99 * triu.sum() * 2, name
        np.testing.assert_array_equal(
            got[name]["tags"].numpy()[decisive],
            np.asarray(want[name]["tags"])[decisive], err_msg=name)
        theirs = jax_compact_spots(want[name]["tags"], want[name]["scores"],
                                   k, "exact")
        for b in range(2):
            def spot_set(out):
                keep = np.asarray(out["spot_score"][b]) >= 0
                idx = np.asarray(out["spot_idx"][b])[keep]
                tag = np.asarray(out["spot_tag"][b])[keep]
                return {(int(i), int(t)) for i, t in zip(idx, tag)
                        if not close[b, i // ld, i % ld]}
            ours = {key: v.numpy() for key, v in spots[name].items()}
            assert spot_set(ours) == spot_set(
                {key: np.asarray(v) for key, v in theirs.items()}), (name, b)


def test_v2_losses_match(v2_models):
    """The five head losses and their total on dense labels: 1e-5
    relative."""
    _, want_losses, port, inputs, image, labels, _ = v2_models
    with torch.inference_mode():
        got = port(*inputs, image=image, labels=labels)
    assert set(got) == set(want_losses)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want_losses[key]),
                                   rtol=1e-5, err_msg=key)


def test_v2_table_and_tower_gradients_match_jax(v2_models):
    """d(total loss)/d(the three bucket tables, the unscaled bias's) and
    d/d(the tower's stem conv kernel and bias) against ``jax.grad`` on the
    same weights: the port's frozen norm of the stem is the identity
    (``s`` = 1), so its conv weight's and norm bias's gradients are the
    folded kernel's and bias's. rtol 1e-3 of each one's largest
    |gradient|."""
    _, _, port, inputs, image, labels, params = v2_models
    ids, bbox, attn = (x.numpy() for x in inputs)
    cfg = _v2_cfg(0)
    cfg.use_fused_bias_attention = False  # the XLA path, differentiable
    jax_model = PEneoModel(cfg)
    jax_labels = {k: jnp.asarray(v.numpy()) for k, v in labels.items()}
    bb = params["backbone"]

    def total(leaves):
        tower = dict(bb["visual_backbone"], stem=leaves["stem"])
        p = dict(params, backbone=dict(
            bb, visual_backbone=tower,
            **{n: leaves[n] for n in BIAS_TABLES}))
        return jax_model.apply({"params": p}, ids, bbox, attn,
                               image=image.numpy(), labels=jax_labels,
                               deterministic=True)["total"]

    want = jax.jit(jax.grad(total))(
        {"stem": bb["visual_backbone"]["stem"],
         **{n: bb[n] for n in BIAS_TABLES}})
    port.zero_grad(set_to_none=True)
    port(*inputs, image=image, labels=labels)["total"].backward()
    stem = port.backbone.visual.backbone.bottom_up.stem.conv1
    pairs = [(getattr(port.backbone.encoder, n).weight.grad,
              np.asarray(want[n]).T, n) for n in BIAS_TABLES]
    pairs += [(stem.weight.grad,
               np.asarray(want["stem"]["conv"]["kernel"]).transpose(
                   3, 2, 0, 1), "stem kernel"),
              (stem.norm.bias.grad, np.asarray(want["stem"]["conv"]["bias"]),
               "stem bias")]
    for got, ref, name in pairs:
        assert np.abs(ref).max() > 1e-7, name  # it takes part
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)
    port.zero_grad(set_to_none=True)


def test_compact_and_pack_match_jax_on_same_maps():
    """On identical dense tag/score maps the port's compact_spots and
    pack_spots give the JAX package's arrays bit for bit, and both
    packages' unpack_spots read them into the same dict."""
    rng = np.random.default_rng(3)
    tags = rng.integers(0, 3, (3, 40, 40)).astype(np.int32)
    scores = rng.random((3, 40, 40)).astype(np.float32)  # distinct: no ties
    k = 64
    ours = {n: compact_spots(torch.from_numpy(tags), torch.from_numpy(scores), k)
            for n in HEAD_NAMES}
    theirs = {n: jax_compact_spots(jnp.asarray(tags), jnp.asarray(scores), k,
                                   "exact") for n in HEAD_NAMES}
    big, small = (x.numpy() for x in pack_spots(ours))
    jbig, jsmall = (np.asarray(x) for x in jax_pack_spots(theirs))
    np.testing.assert_array_equal(big, jbig)
    np.testing.assert_array_equal(small, jsmall)
    a, b = unpack_spots(big, small), jax_unpack_spots(jbig, jsmall)
    for n in HEAD_NAMES:
        assert set(a[n]) == set(b[n])
        for key in a[n]:
            assert a[n][key].dtype == b[n][key].dtype, (n, key)
            np.testing.assert_array_equal(a[n][key], b[n][key])
