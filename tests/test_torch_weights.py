"""Weight bridge of the PyTorch port (peneo_tpu_torch/models/convert.py):
JAX params → port state_dict → the JAX package's own torch-checkpoint
converter gives back identical arrays, key for key; and the config.json is
shared."""

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
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


def test_layoutlmv2_family_is_not_ported():
    cfg = PortConfig(backbone_name="layoutxlm-base")
    with pytest.raises(NotImplementedError, match="layoutlmv2"):
        PortModel(cfg)
    with pytest.raises(NotImplementedError, match="layoutlmv2"):
        jax_params_to_state_dict({}, cfg)


def test_config_json_is_shared(tmp_path):
    cfg = _cfg(2, True)
    cfg.save_pretrained(str(tmp_path / "jax"))
    port = PortConfig.from_pretrained(str(tmp_path / "jax"))
    assert port.to_dict() == cfg.to_dict()
    port.save_pretrained(str(tmp_path / "port"))
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()
    for name in ("lilt-roberta-en-base", "layoutlmv3-base", "layoutxlm-base"):
        assert PortConfig(backbone_name=name).backbone_family() == \
            PEneoConfig(backbone_name=name).backbone_family()
