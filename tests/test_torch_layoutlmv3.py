"""LayoutLMv3 backbone of the PyTorch port against the JAX package's: the
relative-position buckets and the visual boxes by integer equality, and the
backbone on the same weights (carried across by the weight bridge) with and
without an image — text L = 123 plus the 5 visual tokens of a 32 px image
gives L' = 128, where the JAX side runs its Pallas rel-bias kernel in
interpret mode (``fused_attention=True``); the text-only path runs its
einsum path. Also the gradient of the three bucket tables through
``RelBias`` (one-hot products) against autograd through a plain gather."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv3Config, PEneoConfig
from peneo_tpu.models import layoutlmv3 as jv3
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import LayoutLMv3Config as PortV3Config
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models import layoutlmv3 as pv3
from peneo_tpu_torch.models.convert import jax_params_to_state_dict

torch.set_num_threads(1)
L = 123
# the tiny geometry of tests/test_layoutlmv3_parity.py, widened to 4 heads
# of 64 (the Pallas kernel's lane width in interpret mode is no limit, but
# the CUDA kernels' head dim is) and to positions covering L + 2
TINY = dict(
    vocab_size=120, hidden_size=256, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=64, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0, max_position_embeddings=L + 2,
    type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5,
    coordinate_size=40, shape_size=48, max_2d_position_embeddings=1024,
    has_relative_attention_bias=True, rel_pos_bins=32, max_rel_pos=128,
    has_spatial_attention_bias=True, rel_2d_pos_bins=64, max_rel_2d_pos=256,
    visual_embed=True, input_size=32, patch_size=16)


@pytest.mark.parametrize("bins,max_distance", [(32, 128), (64, 256)])
def test_buckets_equal_jax_over_every_relative_position(bins, max_distance):
    rel = np.arange(-1100, 1101, dtype=np.int64)
    want = np.asarray(jv3.relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bins, max_distance))
    np.testing.assert_array_equal(
        pv3.relative_position_bucket(rel, bins, max_distance), want)
    got = pv3.relative_position_bucket(torch.from_numpy(rel), bins,
                                       max_distance)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seq_len,n_vis", [(512, 197), (123, 5), (40, 0)])
def test_static_bucket_matrix_equals_jax(seq_len, n_vis):
    want = np.asarray(jv3.static_rel_pos_bucket(seq_len, n_vis, 32, 128))
    got = pv3.static_rel_pos_bucket(seq_len, n_vis, 32, 128)
    assert got.shape == (seq_len + n_vis,) * 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", [2, 14])
def test_visual_bbox_equals_jax(grid):
    np.testing.assert_array_equal(pv3.visual_bbox(grid),
                                  np.asarray(jv3.visual_bbox(grid)))


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
    image = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    return ids, bbox, attn, image


@pytest.fixture(scope="module")
def backbones():
    ids, bbox, attn, image = _inputs()
    cfg = LayoutLMv3Config.from_dict(TINY)
    peneo_cfg = PEneoConfig(backbone_name="layoutlmv3-base",
                            backbone_config=dict(TINY), max_seq_len=L)
    # init with the image (creates the visual parameters) on the einsum
    # path; spread the zero-initialised cls_token / pos_embed and the
    # LayerNorms so that they take part in the comparison
    full = jax.device_get(jax.jit(
        lambda *a: PEneoModel(peneo_cfg).init(
            jax.random.PRNGKey(0), *a[:3], image=a[3]))(
        ids, bbox, attn, image)["params"])
    params = full["backbone"]
    rng = np.random.default_rng(5)
    for name in ("cls_token", "pos_embed"):
        params[name] = (rng.standard_normal(params[name].shape)
                        * 0.02).astype(np.float32)
    for name in ("visual_norm", "post_concat_LayerNorm"):
        params[name] = {k: (v + rng.standard_normal(v.shape) * 0.1)
                        .astype(np.float32) for k, v in params[name].items()}
    port_cfg = PortConfig.from_dict(peneo_cfg.to_dict())
    sd = jax_params_to_state_dict(full, port_cfg)
    model = pv3.LayoutLMv3Model(PortV3Config.from_dict(TINY)).eval()
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                           if k.startswith("backbone.")})
    return cfg, params, model


@pytest.mark.parametrize("with_image", [True, False])
def test_backbone_matches_jax(backbones, with_image):
    """last_hidden_state atol 1e-4 (fp32 sums in another order over two
    layers)."""
    cfg, params, model = backbones
    ids, bbox, attn, image = _inputs()
    img = image if with_image else None
    want = jv3.LayoutLMv3Model(cfg, dtype=jnp.float32,
                               fused_attention=True).apply(
        {"params": params}, ids, bbox, attn, image=img, deterministic=True)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in (ids, bbox, attn)),
                    image=None if img is None else torch.from_numpy(img))
    want = np.asarray(want["last_hidden_state"])
    assert got["last_hidden_state"].shape == want.shape == \
        (2, L + (5 if with_image else 0), TINY["hidden_size"])
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), want,
                               rtol=0, atol=1e-4)


def test_rel_bias_matches_jax_gather_and_plain_gradients(backbones):
    """The (B, nh, L', L') bias equals the JAX model's gather arithmetic bit
    for bit, with rows 16-byte aligned (row stride a multiple of 4 floats:
    padded at L' = 123 without the image, exact at 128 with it), and the
    tables' gradients through the one-hot products equal autograd through a
    plain gather (atol 2e-4: each entry is an fp32 sum of B·L'²/bins terms
    whose absolute values add up to ~3e3, taken in another order: 2^-24 ·
    3e3 ≈ 2e-4)."""
    _, params, model = backbones
    ids, bbox, _, _ = _inputs()
    enc = model.encoder
    for p in enc.parameters():
        p.requires_grad_(True)
    tables = [enc.rel_pos_bias.weight, enc.rel_pos_x_bias.weight,
              enc.rel_pos_y_bias.weight]
    for n_vis in (5, 0):
        box = np.concatenate(
            [bbox, np.broadcast_to(pv3.visual_bbox(2)[None], (2, 5, 4))],
            1)[:, :L + n_vis]
        got = model.rel_bias(torch.from_numpy(box).long(), L, n_vis)
        assert got.dtype == torch.float32 and got.stride(-1) == 1
        assert got.shape[-1] == L + n_vis and got.data_ptr() % 16 == 0
        assert all(s % 4 == 0 for s in got.stride()[:3]), got.stride()
        b1 = np.array(jv3.static_rel_pos_bucket(L, n_vis, 32, 128))
        cx, cy = box[:, :, 0], box[:, :, 3]
        bx = np.array(jv3.relative_position_bucket(
            jnp.asarray(cx[:, None, :] - cx[:, :, None]), 64, 256))
        by = np.array(jv3.relative_position_bucket(
            jnp.asarray(cy[:, None, :] - cy[:, :, None]), 64, 256))
        want = (params["rel_pos_bias"][b1][None]
                + (params["rel_pos_x_bias"][bx]
                   + params["rel_pos_y_bias"][by]))
        want = want.transpose(0, 3, 1, 2) / np.float32(np.sqrt(64.0))
        np.testing.assert_array_equal(got.detach().numpy(), want)

        upstream = torch.from_numpy(np.random.default_rng(1).standard_normal(
            got.shape).astype(np.float32))
        grads = torch.autograd.grad(got, tables, upstream)
        plain = (tables[0].t()[torch.from_numpy(b1)][None]
                 + tables[1].t()[torch.from_numpy(bx)]
                 + tables[2].t()[torch.from_numpy(by)]).permute(0, 3, 1, 2) \
            / 8.0
        want_grads = torch.autograd.grad(plain, tables, upstream)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=2e-4)
