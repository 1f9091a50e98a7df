"""LiLT backbone of the PyTorch port against the JAX package's LiltModel on
the same weights (carried across by the weight bridge): the Pallas BiACM
kernel in interpret mode at L=128 (the TINY config of
tests/test_biacm_attention.py) and the einsum path at a ragged L=40."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LiltConfig, PEneoConfig
from peneo_tpu.models.lilt import LiltModel
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.lilt import LiltModel as PortLilt

torch.set_num_threads(1)
TINY = dict(
    vocab_size=120, hidden_size=96, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=128,
    max_position_embeddings=128 + 16, channel_shrink_ratio=4,
    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    pad_token_id=0,
)


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 120, (2, L)).astype(np.int32)
    ids[1, -17:] = 0  # padding exercises the additive key mask
    attn = (ids != 0).astype(np.int32)
    x0 = rng.integers(0, 900, (2, L))
    y0 = rng.integers(0, 900, (2, L))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    return ids, bbox, attn


@pytest.mark.parametrize("L", [128, 40])
def test_lilt_matches_jax(L):
    cfg = PEneoConfig(backbone_name="lilt-infoxlm-base",
                      backbone_config=dict(TINY), max_seq_len=L)
    ids, bbox, attn = _inputs(L)
    params = jax.device_get(jax.jit(PEneoModel(cfg).init)(
        jax.random.PRNGKey(0), ids, bbox, attn)["params"])
    # fused_biacm=True: the Pallas kernel (interpret mode) at L % 128 == 0,
    # the einsum path otherwise
    want = LiltModel(LiltConfig.from_dict(TINY), dtype=jnp.float32,
                     fused_biacm=True).apply(
        {"params": params["backbone"]}, ids, bbox, attn, deterministic=True)

    port_cfg = PortConfig.from_dict(cfg.to_dict())
    sd = jax_params_to_state_dict(params, port_cfg)
    model = PortLilt(port_cfg.backbone())
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                           if k.startswith("backbone.")})
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in (ids, bbox, attn)))
    for key in ("semantic_output", "layout_output", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
