"""LayoutLMv2 / LayoutXLM backbone of the PyTorch port against the JAX
package's: the visual grid boxes by integer equality; the ResNeXt-FPN tower
alone on detectron2-style weights with non-identity frozen norms (folded by
the port on every call, by the JAX converter once), at 56 px, where the FPN's
res4 → res3 step is 4 → 7 and only ``nearest-exact`` is JAX's nearest
resize; the backbone on the same weights (carried across by the weight
bridge) with and without an image — text L = 79 plus the 49 visual tokens
gives L' = 128, hidden 256 = 4 heads of 64 (the CUDA kernels' geometry),
where the JAX side runs its Pallas rel-bias kernel in interpret mode; and
the unscaled bias with its three tables' gradients through ``RelBias``
against a plain gather."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv2Config, PEneoConfig
from peneo_tpu.models import layoutlmv2 as jv2
from peneo_tpu.models import layoutlmv3 as jv3
from peneo_tpu.models.convert_layoutlmv2 import convert_visual_backbone
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import LayoutLMv2Config as PortV2Config
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models import layoutlmv2 as pv2
from peneo_tpu_torch.models.convert import jax_params_to_state_dict

torch.set_num_threads(1)
L = 79  # + 49 visual tokens = 128
TINY = dict(
    vocab_size=120, hidden_size=256, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=64, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0, max_position_embeddings=L + 8,
    pad_token_id=1, coordinate_size=40, shape_size=48,
    visual_depths=[1, 1, 1, 1], input_size=56)


@pytest.mark.parametrize("grid", [(7, 7), (3, 5)])
def test_visual_grid_bbox_equals_jax(grid):
    got = pv2.visual_grid_bbox(*grid)
    assert got.shape == (grid[0] * grid[1], 4) and got.dtype == np.int64
    np.testing.assert_array_equal(got,
                                  np.asarray(jv2.visual_grid_bbox(*grid)))


def _randomize_tower(tower, seed):
    """detectron2-style random weights: fan-in normal convs (so that p2 is
    of order 1), FPN biases, non-identity frozen norms (as
    tests/test_layoutlmv2_parity.py draws them)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in tower.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5,
                                 generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=gen)
            if isinstance(m, pv2.FrozenBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


@pytest.mark.parametrize("size", [56, 64])
def test_tower_matches_jax(size):
    """p2 of the port's tower (frozen norms folded per call) against the
    JAX ``ResNeXtFPN`` on the JAX converter's folding of the same state
    dict: rtol 1e-4, atol 1e-3 (tests/test_layoutlmv2_parity.py's)."""
    depths, groups, wpg = (1, 1, 1, 1), 4, 8
    tower = pv2.ResNeXtFPN(depths, groups=groups, width_per_group=wpg)
    _randomize_tower(tower, seed=size)
    x = np.random.default_rng(size).normal(
        0, 1, (2, 3, size, size)).astype(np.float32)
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    params = convert_visual_backbone(
        {k: v.numpy() for k, v in tower.state_dict().items()}, depths=depths,
        prefix="")
    want = jv2.ResNeXtFPN(depths, groups=groups, width_per_group=wpg,
                          dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (2, 256, size // 4, size // 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_fpn_upsampling_is_nearest_exact():
    """At 56 px the res4 map is 4x4 and res3 7x7: torch's ``nearest``
    picks other rows there than JAX's nearest resize, ``nearest-exact``
    the same ones."""
    top = np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(2, 3, 4, 4)
    want = np.asarray(jax.image.resize(
        jnp.asarray(top.transpose(0, 2, 3, 1)), (2, 7, 7, 3),
        method="nearest")).transpose(0, 3, 1, 2)
    t = torch.from_numpy(top)
    exact = F.interpolate(t, size=(7, 7), mode="nearest-exact").numpy()
    plain = F.interpolate(t, size=(7, 7), mode="nearest").numpy()
    np.testing.assert_array_equal(exact, want)
    assert not np.array_equal(plain, want)


def test_frozen_norm_conv_is_conv_then_affine():
    """``ConvFrozenBN`` equals detectron2's conv then FrozenBatchNorm2d
    (y·s + b − mean·s), and its gradients reach the conv weight and the
    norm's bias only."""
    gen = torch.Generator().manual_seed(0)
    conv = pv2.ConvFrozenBN(8, 6, 3, stride=2, groups=2)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.3, generator=gen)
        conv.norm.weight.copy_(torch.rand(6, generator=gen) + 0.5)
        conv.norm.bias.copy_(torch.randn(6, generator=gen))
        conv.norm.running_mean.copy_(torch.randn(6, generator=gen))
        conv.norm.running_var.copy_(torch.rand(6, generator=gen) + 0.5)
    x = torch.randn((2, 8, 9, 9), generator=gen)
    n = conv.norm
    s = n.weight / torch.sqrt(n.running_var + 1e-5)
    want = F.conv2d(x, conv.weight, None, 2, 1, 1, 2) * s[:, None, None] \
        + (n.bias - n.running_mean * s)[:, None, None]
    got = conv(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert {k for k, p in conv.named_parameters()} == {"weight", "norm.bias"}
    assert conv.weight.grad is not None and n.bias.grad is not None
    assert {k for k, _ in conv.named_buffers()} == {
        "norm.weight", "norm.running_mean", "norm.running_var"}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 120, (2, L)).astype(np.int32)
    ids[1, -17:] = 1  # padded rows (pad_token_id = 1)
    attn = (ids != 1).astype(np.int32)
    x0 = rng.integers(0, 900, (2, L))
    y0 = rng.integers(0, 900, (2, L))
    bbox = np.stack([x0, y0, x0 + rng.integers(1, 100, (2, L)),
                     y0 + rng.integers(1, 100, (2, L))], -1).astype(np.int32)
    bbox[ids == 1] = 0
    bbox[:, 0] = 0
    image = (rng.random((2, 3, 56, 56)) * 255).astype(np.float32)
    return ids, bbox, attn, image


@pytest.fixture(scope="module")
def backbones():
    ids, bbox, attn, image = _inputs()
    cfg = LayoutLMv2Config.from_dict(TINY)
    peneo_cfg = PEneoConfig(backbone_name="layoutxlm-base",
                            backbone_config=dict(TINY), max_seq_len=L)
    # init with the image (creates the tower) on the einsum path; spread the
    # zero-initialised q/v biases and the LayerNorms so that they take part
    full = jax.device_get(jax.jit(
        lambda *a: PEneoModel(peneo_cfg).init(
            jax.random.PRNGKey(0), *a[:3], image=a[3]))(
        ids, bbox, attn, image)["params"])
    params = full["backbone"]
    rng = np.random.default_rng(5)
    for i in range(TINY["num_hidden_layers"]):
        for name in ("q_bias", "v_bias"):
            params[f"layer_{i}"][name] = (rng.standard_normal(
                params[f"layer_{i}"][name].shape) * 0.1).astype(np.float32)
    for name in ("visual_LayerNorm",):
        params[name] = {k: (v + rng.standard_normal(v.shape) * 0.1)
                        .astype(np.float32) for k, v in params[name].items()}
    sd = jax_params_to_state_dict(full, PortConfig.from_dict(
        peneo_cfg.to_dict()))
    model = pv2.LayoutLMv2Model(PortV2Config.from_dict(TINY)).eval()
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                           if k.startswith("backbone.")})
    return cfg, params, model


@pytest.mark.parametrize("with_image", [True, False])
def test_backbone_matches_jax(backbones, with_image):
    """last_hidden_state atol 1e-4 (fp32 sums in another order over two
    layers and the tower), 49 visual tokens either way."""
    cfg, params, model = backbones
    ids, bbox, attn, image = _inputs()
    img = image if with_image else None
    want = jv2.LayoutLMv2Model(cfg, dtype=jnp.float32,
                               visual_depths=tuple(cfg.visual_depths),
                               fused_attention=True).apply(
        {"params": params}, ids, bbox, attn, image=img, deterministic=True)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in (ids, bbox, attn)),
                    image=None if img is None else torch.from_numpy(img))
    want = np.asarray(want["last_hidden_state"])
    assert got["last_hidden_state"].shape == want.shape == \
        (2, L + 49, TINY["hidden_size"])
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), want,
                               rtol=0, atol=1e-4)
    if with_image:  # the image moves the visual tokens
        blank = model(*(torch.from_numpy(x) for x in (ids, bbox, attn)))
        assert (blank["last_hidden_state"][:, L:]
                - got["last_hidden_state"][:, L:]).abs().max() > 1e-2


def test_rel_bias_is_unscaled_and_its_gradients_match_plain(backbones):
    """The (B, nh, L', L') bias over [text ‖ grid] boxes equals the JAX
    model's gather arithmetic bit for bit, unscaled, with rows 16-byte
    aligned; the tables' gradients through the one-hot products equal
    autograd through a plain gather (atol 2e-4, as for LayoutLMv3)."""
    _, params, model = backbones
    ids, bbox, _, _ = _inputs()
    enc = model.encoder
    tables = [enc.rel_pos_bias.weight, enc.rel_pos_x_bias.weight,
              enc.rel_pos_y_bias.weight]
    box = np.concatenate(
        [bbox, np.broadcast_to(pv2.visual_grid_bbox(7, 7)[None], (2, 49, 4))],
        1)
    got = model.rel_bias(torch.from_numpy(box).long(), L, 49)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 128, 128)
    assert got.data_ptr() % 16 == 0
    assert all(s % 4 == 0 for s in got.stride()[:3]), got.stride()
    b1 = np.array(jv3.static_rel_pos_bucket(L, 49, 32, 128))
    cx, cy = box[:, :, 0], box[:, :, 3]
    bx = np.array(jv3.relative_position_bucket(
        jnp.asarray(cx[:, None, :] - cx[:, :, None]), 64, 256))
    by = np.array(jv3.relative_position_bucket(
        jnp.asarray(cy[:, None, :] - cy[:, :, None]), 64, 256))
    want = (params["rel_pos_bias"][b1][None]
            + (params["rel_pos_x_bias"][bx] + params["rel_pos_y_bias"][by]))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.transpose(0, 3, 1, 2))

    upstream = torch.from_numpy(np.random.default_rng(1).standard_normal(
        got.shape).astype(np.float32))
    grads = torch.autograd.grad(got, tables, upstream)
    plain = (tables[0].t()[torch.from_numpy(b1)][None]
             + tables[1].t()[torch.from_numpy(bx)]
             + tables[2].t()[torch.from_numpy(by)]).permute(0, 3, 1, 2)
    want_grads = torch.autograd.grad(plain, tables, upstream)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=2e-4)


def test_random_init_keeps_the_full_tower_finite():
    """The seeded init of a full ResNeXt-101 tower (which the reference
    takes pretrained) gives a p2 map of order 1: finite, neither vanished
    nor blown up over its 33 blocks."""
    model = pv2.LayoutLMv2Model(PortV2Config(
        vocab_size=32, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=1, intermediate_size=32, coordinate_size=8,
        shape_size=16, image_feature_pool_shape=[7, 7, 256]))
    model.init_weights(torch.Generator().manual_seed(0), 0.02)
    assert len(model.visual.backbone.bottom_up.res4) == 23
    image = torch.rand((1, 3, 56, 56),
                       generator=torch.Generator().manual_seed(1)) * 255
    with torch.inference_mode():
        feats = model.visual_features(image)
    assert feats.shape == (1, 49, 256)
    assert torch.isfinite(feats).all()
    assert 0.1 < feats.std().item() < 100.0
