"""Int8 serving matmuls of the PyTorch port (peneo_tpu_torch/ops/quant.py)
against the JAX package's ``Int8Dense`` (peneo_tpu/ops/quant.py), at fp32
on the same weights and inputs: the linear alone, the decoder's int8 pair
head, and each family's whole model with ``quantize_backbone`` and
``quantize_pair_head`` set. A training step with the switches set has the
loss and gradients of one without them (int8 is for forwards outside
training only, as in JAX)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.ops.quant import Int8Dense
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.ops import quant

torch.set_num_threads(1)
L = 48
# int8 port vs int8 JAX on the same weights: the same operations in the
# same order, so the logits agree to fp32 rounding; a row's scale that
# differs by one ulp may still move one quantized input by one step, so
# the gate is scale-relative, ten times tighter than the int8-vs-float
# gates of tests/test_int8_pair_head.py (0.05 / 0.15), and the argmax maps
# must agree on every position whose top-2 margin is above 1e-3
REL_TOL = 5e-3
MARGIN = 1e-3


@pytest.mark.parametrize("shape,features", [
    ((2, 64, 384), 384),   # the pair head's hidden layer, 3-D
    ((5, 96), 40),         # 2-D, rows <= 16
    ((16, 48), 48),        # 16 rows, one of them zero
])
def test_int8_linear_matches_int8_dense(shape, features):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1, shape[-1])[3] = 0.0  # a zero row: scale clamped, y = b
    dense = Int8Dense(features)
    params = dense.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: a + 0.01, params)  # bias != 0
    want = np.asarray(dense.apply(params, jnp.asarray(x)))
    weight = torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy())
    bias = torch.from_numpy(np.array(params["params"]["bias"]))
    got = quant.int8_linear(torch.from_numpy(x), weight, bias).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_int8_matmul_twin_is_exact_in_integers():
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (37, 3072), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (24, 3072), generator=g, dtype=torch.int8)
    want = xq.long() @ wq.long().t()
    got = quant.int8_matmul(xq, wq)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), want)


def _margins(logits):
    z = np.asarray(logits, np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _lilt():
    return dict(backbone_name="lilt-infoxlm-base",
                backbone_config=LiltConfig(
                    vocab_size=120, hidden_size=48, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=96,
                    max_position_embeddings=L + 16,
                    pad_token_id=0).to_dict()), None


def _v3():
    return dict(backbone_name="layoutlmv3-base",
                backbone_config=LayoutLMv3Config(
                    vocab_size=120, hidden_size=48, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=96,
                    max_position_embeddings=L + 16, coordinate_size=8,
                    shape_size=8, input_size=32,
                    pad_token_id=0).to_dict()), 32


def _v2():
    return dict(backbone_name="layoutxlm-base",
                backbone_config=LayoutLMv2Config(
                    vocab_size=120, hidden_size=48, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=96,
                    max_position_embeddings=L + 16, coordinate_size=8,
                    shape_size=8, visual_depths=[1, 1, 1, 1],
                    input_size=56, pad_token_id=0).to_dict()), 56


FAMILIES = {"lilt": _lilt, "v3": _v3, "v2": _v2}


def _inputs(image_size, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 120, (2, L)).astype(np.int32)
    ids[1, -9:] = 0
    attn = (ids != 0).astype(np.int32)
    x0 = rng.integers(0, 900, (2, L))
    y0 = rng.integers(0, 900, (2, L))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    image = (None if image_size is None else rng.uniform(
        0, 255, (2, 3, image_size, image_size)).astype(np.float32))
    return ids, bbox, attn, image


def _cfg(family, **switches):
    kw, _ = FAMILIES[family]()
    return PEneoConfig(**kw, max_seq_len=L, pair_block_size=16,
                       max_spots_per_head=0, initializer_range=0.15,
                       **switches)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_setup(request):
    family = request.param
    image_size = FAMILIES[family]()[1]
    ids, bbox, attn, image = _inputs(image_size)
    kw = {} if image is None else {"image": image}
    params = jax.device_get(jax.jit(
        lambda *a, **k: PEneoModel(_cfg(family)).init(
            jax.random.PRNGKey(3), *a, deterministic=True, **k))(
        ids, bbox, attn, **kw)["params"])
    float_logits = PEneoModel(_cfg(family)).apply(
        {"params": params}, ids, bbox, attn, deterministic=True,
        return_logits=True, **kw)
    return family, params, (ids, bbox, attn, image), float_logits


def _port(family, params, **switches):
    cfg = PortConfig.from_dict(_cfg(family, **switches).to_dict())
    model = PortModel(cfg)
    model.load_state_dict(jax_params_to_state_dict(params, cfg))
    return model


def _port_inputs(inputs):
    ids, bbox, attn, image = inputs
    kw = {} if image is None else {"image": torch.from_numpy(image)}
    return [torch.from_numpy(x) for x in (ids, bbox, attn)], kw


@pytest.mark.parametrize("switches", [
    {"quantize_pair_head": "int8"},
    {"quantize_pair_head": "int8", "quantize_backbone": "int8"},
], ids=["pair_head", "pair_head+backbone"])
def test_int8_model_matches_jax(family_setup, switches):
    family, params, inputs, float_want = family_setup
    ids, bbox, attn, image = inputs
    kw = {} if image is None else {"image": image}
    want = PEneoModel(_cfg(family, **switches)).apply(
        {"params": params}, ids, bbox, attn, deterministic=True,
        return_logits=True, **kw)
    model = _port(family, params, **switches).eval()
    args, pkw = _port_inputs(inputs)
    quant.int8_matmul_cuda.launches = 0
    with torch.inference_mode():
        got = model(*args, return_logits=True, **pkw)
    assert quant.int8_matmul_cuda.launches == 0  # the CPU runs the twin
    triu = np.triu(np.ones((L - 1, L - 1), bool))[None]
    for name in HEAD_NAMES:
        a = np.asarray(want[name]["logits"])
        b = got[name]["logits"].numpy()
        span = np.abs(a).max()
        assert np.abs(a - b).max() / span < REL_TOL, (family, name)
        decisive = (_margins(a) > MARGIN) & triu
        assert decisive.sum() > 0.9 * triu.sum() * 2, (family, name)
        np.testing.assert_array_equal(
            b.argmax(-1)[decisive], a.argmax(-1)[decisive],
            err_msg=f"{family} {name}")
        # and int8 is really on: the logits differ from the float model's
        assert np.abs(np.asarray(float_want[name]["logits"]) - a).max() > 0


def _labels(seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for name in HEAD_NAMES:
        m = np.zeros((2, L - 1, L - 1), np.int64)
        i, j = np.sort(rng.integers(0, L - 10, (2, 20)), axis=0)
        m[0, i, j] = rng.integers(1, 3 if name != "line_extraction" else 2,
                                  20)
        out[name] = torch.from_numpy(m)
    return out


def test_training_step_ignores_the_switches(family_setup):
    """Dropout on, same seed: the loss and every gradient are bit-identical
    with and without both int8 switches."""
    family, params, inputs, _ = family_setup
    args, kw = _port_inputs(inputs)
    labels = _labels()
    results = []
    for switches in ({}, {"quantize_pair_head": "int8",
                          "quantize_backbone": "int8"}):
        model = _port(family, params, **switches).train()
        model.peneo_decoder.category_weights = torch.tensor([1.0, 10.0, 10.0])
        torch.manual_seed(0)
        loss = model(*args, labels=labels,
                     generator=torch.Generator().manual_seed(5), **kw)["total"]
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in
                                         model.named_parameters()
                                         if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and len(g0) > 10
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_cast_keeps_int8_weights_fp32():
    cfg = PortConfig.from_dict(_cfg("lilt", quantize_pair_head="int8",
                                    quantize_backbone="int8").to_dict())
    model = PortModel(cfg).cast(torch.bfloat16)
    layer = model.backbone.encoder.layer[0]
    assert layer.attention.self.query.weight.dtype == torch.float32
    assert layer.output.LayerNorm.weight.dtype == torch.bfloat16
    head = model.peneo_decoder.line_extraction_fc
    assert head[0].weight.dtype == torch.float32   # hidden: int8
    assert head[3].weight.dtype == torch.bfloat16  # output: float
    assert model.backbone.dtype == torch.bfloat16
