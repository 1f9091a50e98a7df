"""Weight bridge of the PyTorch port (peneo_tpu_torch/models/convert.py):
JAX params → port state_dict → the JAX package's own torch-checkpoint
converter gives back identical arrays, key for key; and the config.json is
shared. LayoutLMv2 at the full ResNeXt-101 depth (the JAX converter reads
that depth): the round trip through identity frozen norms, and the port's
state_dict with random non-identity norms through the JAX converter's
folding."""

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.models.convert import convert_peneo_checkpoint
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import (jax_params_to_state_dict,
                                            state_dict_to_jax_params)
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel

torch.set_num_threads(1)
L = 32


def _cfg(num_layers, shrink):
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=50, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=L + 8).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=16,
        peneo_classifier_num_layers=num_layers,
        peneo_decoder_shrink=shrink)


def _v3_cfg():
    return PEneoConfig(
        backbone_name="layoutlmv3-base",
        backbone_config=LayoutLMv3Config(
            vocab_size=50, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=L + 8, coordinate_size=8, shape_size=8,
            input_size=32).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=16)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("num_layers,shrink", [(2, True), (1, False)])
def test_jax_params_roundtrip_through_port_state_dict(num_layers, shrink):
    cfg = _cfg(num_layers, shrink)
    ids = np.ones((1, L), np.int32)
    params = jax.device_get(jax.jit(PEneoModel(cfg).init)(
        jax.random.PRNGKey(0), ids, np.zeros((1, L, 4), np.int32),
        ids)["params"])
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    sd = jax_params_to_state_dict(params, port_cfg)
    model = PortModel(port_cfg)
    model.load_state_dict(sd)  # strict: every key present, none extra
    back = convert_peneo_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()}, cfg)
    _assert_same_tree(params, back)


def test_port_state_dict_to_jax_params_matches_jax_converter():
    cfg = _cfg(2, True)
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    model = PortModel(port_cfg).init_weights(torch.Generator().manual_seed(3))
    sd = model.state_dict()
    ours = state_dict_to_jax_params(sd, port_cfg)
    theirs = convert_peneo_checkpoint({k: v.numpy() for k, v in sd.items()},
                                      cfg)
    _assert_same_tree(ours, theirs)


def test_layoutlmv3_params_roundtrip_and_reference_keys():
    """JAX LayoutLMv3 params → port state dict → the JAX converter, leaf for
    leaf (the patch kernel and the three tables are transposed on the way,
    ``cls_token`` / ``pos_embed`` are not); the port's keys are exactly the
    reference keys that converter reads; and the port's own inverse agrees
    with it."""
    cfg = _v3_cfg()
    ids = np.ones((1, L), np.int32)
    params = jax.device_get(jax.jit(
        lambda i, b, img: PEneoModel(cfg).init(
            jax.random.PRNGKey(0), i, b, i, image=img))(
        ids, np.zeros((1, L, 4), np.int32),
        np.zeros((1, 3, 32, 32), np.float32))["params"])
    rng = np.random.default_rng(0)  # the JAX init leaves these at zero
    for name in ("cls_token", "pos_embed"):
        params["backbone"][name] = rng.standard_normal(
            params["backbone"][name].shape).astype(np.float32)
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    sd = jax_params_to_state_dict(params, port_cfg)
    model = PortModel(port_cfg)
    model.load_state_dict(sd)  # strict: every key present, none extra
    assert sd["backbone.patch_embed.proj.weight"].shape == (48, 3, 16, 16)
    assert sd["backbone.encoder.rel_pos_bias.weight"].shape == (4, 32)
    assert sd["backbone.encoder.rel_pos_x_bias.weight"].shape == (4, 64)
    assert sd["backbone.cls_token"].shape == (1, 1, 48)
    assert sd["backbone.pos_embed"].shape == (1, 5, 48)
    for key in ("backbone.norm.weight", "backbone.LayerNorm.bias",
                "backbone.encoder.layer.1.attention.self.query.weight",
                "backbone.encoder.layer.0.attention.output.LayerNorm.weight",
                "backbone.encoder.layer.0.intermediate.dense.bias",
                "backbone.embeddings.h_position_embeddings.weight"):
        assert key in sd, key
    numpy_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_peneo_checkpoint(numpy_sd, cfg)
    _assert_same_tree(params, back)
    _assert_same_tree(state_dict_to_jax_params(model.state_dict(), port_cfg),
                      back)


def _v2_cfg(fast_qkv=True):
    """Tiny text side, the full tower (3, 4, 23, 3) at 56 px."""
    return PEneoConfig(
        backbone_name="layoutxlm-base",
        backbone_config=LayoutLMv2Config(
            vocab_size=50, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=L + 8, coordinate_size=8, shape_size=8,
            fast_qkv=fast_qkv, input_size=56).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=16)


def test_layoutlmv2_params_roundtrip_and_reference_keys():
    """Random JAX LayoutLMv2 params (the full tower; shapes from the JAX
    model's init) → port state dict, whose frozen norms are the identity →
    the JAX converter folds them back to the same kernels and biases, leaf
    for leaf; the port's keys are detectron2's and HF's, and its own
    inverse agrees."""
    cfg = _v2_cfg()
    ids = np.ones((1, L), np.int32)
    shapes = jax.eval_shape(
        lambda i, b, img: PEneoModel(cfg).init(
            jax.random.PRNGKey(0), i, b, i, image=img),
        ids, np.zeros((1, L, 4), np.int32),
        np.zeros((1, 3, 56, 56), np.float32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape, np.float32) * 0.05, shapes)
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    sd = jax_params_to_state_dict(params, port_cfg)
    model = PortModel(port_cfg)
    model.load_state_dict(sd)  # strict: every key present, none extra
    tower = "backbone.visual.backbone."
    assert sd[tower + "bottom_up.stem.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd[tower + "bottom_up.res4.22.conv2.weight"].shape == \
        (1024, 32, 3, 3)
    assert sd[tower + "bottom_up.res5.0.shortcut.norm.running_var"].shape \
        == (2048,)
    assert tower + "bottom_up.res5.1.shortcut.weight" not in sd
    assert sd[tower + "fpn_lateral5.weight"].shape == (256, 2048, 1, 1)
    assert sd["backbone.encoder.layer.1.attention.self.qkv_linear.weight"] \
        .shape == (144, 48)
    assert sd["backbone.encoder.layer.0.attention.self.q_bias"].shape == \
        (1, 1, 48)
    for key in ("backbone.visual_proj.bias", "backbone.visual_LayerNorm.weight",
                "backbone.encoder.rel_pos_y_bias.weight",
                tower + "fpn_output2.bias"):
        assert key in sd, key
    numpy_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_peneo_checkpoint(numpy_sd, cfg)
    _assert_same_tree(params, back)
    _assert_same_tree(state_dict_to_jax_params(model.state_dict(), port_cfg),
                      back)


@pytest.mark.parametrize("variant", ["fast_qkv", "query_key_value",
                                     "fpn_frozen_norms"])
def test_layoutlmv2_port_state_dict_matches_jax_converter(variant):
    """The port's state_dict with random non-identity frozen norms: the
    port's ``state_dict_to_jax_params`` equals the JAX package's
    ``convert_peneo_checkpoint`` leaf for leaf (the same float64 fold), with
    fast_qkv or separate projections, and for a reference checkpoint whose
    FPN convs carry frozen norms in place of biases."""
    cfg = _v2_cfg(fast_qkv=variant != "query_key_value")
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    model = PortModel(port_cfg)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in model.named_parameters():
            t.normal_(0.0, 0.05, generator=gen)
        for name, t in model.named_buffers():  # the frozen norms' stats
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if variant == "fpn_frozen_norms":
        rng = np.random.default_rng(1)
        for i in range(2, 6):
            key = f"backbone.visual.backbone.fpn_lateral{i}."
            c = sd.pop(key + "bias").shape[0]
            for stat in ("weight", "bias", "running_mean", "running_var"):
                sd[key + "norm." + stat] = (rng.random(c) + 0.5).astype(
                    np.float32)
    ours = state_dict_to_jax_params(sd, port_cfg)
    theirs = convert_peneo_checkpoint(sd, cfg)
    _assert_same_tree(ours, theirs)
    conv1 = ours["backbone"]["visual_backbone"]["res3_0"]["conv1"]["conv"]
    assert conv1["kernel"].shape == (1, 1, 256, 512)


def test_config_json_is_shared(tmp_path):
    cfg = _cfg(2, True)
    cfg.save_pretrained(str(tmp_path / "jax"))
    port = PortConfig.from_pretrained(str(tmp_path / "jax"))
    assert port.to_dict() == cfg.to_dict()
    port.save_pretrained(str(tmp_path / "port"))
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()
    for name in ("lilt-roberta-en-base", "layoutlmv3-base", "layoutxlm-base",
                 "layoutlmv2-base-uncased"):
        assert PortConfig(backbone_name=name).backbone_family() == \
            PEneoConfig(backbone_name=name).backbone_family()
