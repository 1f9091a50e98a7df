"""Full PEneoModel forward of the PyTorch port against the JAX package at a
tiny config (L=128, the Pallas BiACM kernel in interpret mode on the JAX
side), on the same weights: logits, top-k spot sets, and the packed spot
transport read by both packages' ``unpack_spots``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LiltConfig, PEneoConfig
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
    port = PortModel(port_cfg)
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
