"""Optimizer trajectory of the PyTorch port (peneo_tpu_torch/pipeline/
train.py) against the JAX package's ``make_train_step`` + ``make_optimizer``:
K=4 optimizer steps from identical weights on identical batches, all dropout
0, warmup ratio 0.3 (HF's ceil: 2 warmup steps of 4), weight decay, gradient
clipping and the 30× decoder group. Per-step losses and learning rates and
the end-state parameter norms (global, decoder, backbone) agree at
tests/test_optimizer_parity.py's tolerances (losses rtol 2e-3, the first
3e-4; norms rtol 1e-4). The same for a LayoutLMv3 config with an image in
every batch, where the three relative-position bucket tables after the 4
steps are compared too: they hold the table gradients (``RelBias``'s one-hot
products against XLA's scatter-add) and the weight-decay groups (the
tables, ``norm.weight``, ``cls_token`` and ``pos_embed`` are decayed,
``LayerNorm.weight`` is not)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline.train import create_train_state, jit_train_step, \
    linear_schedule as jax_schedule, make_optimizer as jax_optimizer
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.pipeline import train as T

torch.set_num_threads(1)
K, L, B = 4, 48, 2
LR, WARMUP_RATIO, WEIGHT_DECAY, MAX_GRAD_NORM, SPEEDUP = \
    2e-4, 0.3, 0.01, 1.0, 30.0


def _cfg():
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=120, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=L + 16, pad_token_id=0,
            hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        pair_block_size=16, max_seq_len=L,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=SPEEDUP)


def _v3_cfg():
    return PEneoConfig(
        backbone_name="layoutlmv3-base-chinese",
        backbone_config=LayoutLMv3Config(
            vocab_size=120, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=L + 16, pad_token_id=0,
            coordinate_size=8, shape_size=8, input_size=32,
            # a wide init: attention far from uniform, so that the bucket
            # tables' gradients are well above Adam's eps
            initializer_range=0.2, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        pair_block_size=16, max_seq_len=L,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=SPEEDUP)


def _batches(n, seed=7, image=False):
    rng = np.random.default_rng(seed)
    ld = L - 1
    out = []
    for _ in range(n):
        ids = rng.integers(2, 120, (B, L)).astype(np.int32)
        ids[1, -6:] = 0
        attn = (ids != 0).astype(np.int32)
        x0 = rng.integers(0, 900, (B, L))
        y0 = rng.integers(0, 900, (B, L))
        bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
        labels = {}
        for name in HEAD_NAMES:
            n_cls = 2 if name == "line_extraction" else 3
            m = np.zeros((B, ld, ld), np.int8)
            for b in range(B):
                for _ in range(5):
                    i = int(rng.integers(0, ld - 6))
                    j = int(rng.integers(i, ld - 6))
                    m[b, i, j] = rng.integers(1, n_cls)
            labels[name] = m
        out.append({"input_ids": ids, "bbox": bbox, "attention_mask": attn,
                    "labels": labels})
        if image:
            out[-1]["image"] = rng.normal(size=(B, 3, 32, 32)).astype(
                np.float32)
    return out


def _norms(named):
    def norm(pred):
        return float(np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                                 for n, v in named if pred(n))))
    return {"all": norm(lambda n: True),
            "decoder": norm(lambda n: "peneo_decoder" in n),
            "backbone": norm(lambda n: "peneo_decoder" not in n)}


def _trajectories(cfg, batches):
    model = PEneoModel(cfg)
    b0 = batches[0]
    params = jax.device_get(jax.jit(
        lambda *a: model.init(jax.random.PRNGKey(0), *a[:3],
                              image=a[3] if len(a) > 3 else None))(
        b0["input_ids"], b0["bbox"], b0["attention_mask"],
        *([b0["image"]] if "image" in b0 else []))["params"])

    # JAX
    opt = jax_optimizer(params, lr=LR, total_steps=K,
                        warmup_ratio=WARMUP_RATIO, weight_decay=WEIGHT_DECAY,
                        downstream_speedup_ratio=SPEEDUP,
                        max_grad_norm=MAX_GRAD_NORM)
    state = create_train_state(cfg, model, opt, b0, params=params)
    step = jit_train_step(model, opt)
    sched = jax_schedule(LR, K, WARMUP_RATIO)
    jax_run = []
    for k in range(K):
        b = batches[k % 2]
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b))
        jax_run.append((float(m["total"]), float(sched(k)),
                        float(m["grad_norm"])))
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(state.params))
    jax_norms = _norms([(jax.tree_util.keystr(p), v) for p, v in flat])

    # port
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    port = PortModel(port_cfg)
    port.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    optimizer, scheduler = T.make_optimizer(
        port, lr=LR, total_steps=K, warmup_ratio=WARMUP_RATIO,
        weight_decay=WEIGHT_DECAY, downstream_speedup_ratio=SPEEDUP)
    port_run = []
    for k in range(K):
        b = batches[k % 2]
        tb = {key: (torch.from_numpy(v) if key != "labels" else
                    {n: torch.from_numpy(m) for n, m in v.items()})
              for key, v in b.items()}
        m = T.train_step(port, optimizer, scheduler, tb, MAX_GRAD_NORM)
        port_run.append((float(m["total"]), float(m["learning_rate"]),
                         float(m["grad_norm"])))
    port_norms = _norms([(n, p.detach().numpy())
                         for n, p in port.named_parameters()])
    return (jax_run, jax_norms, port_run, port_norms,
            jax.device_get(state.params), port, params)


@pytest.fixture(scope="module")
def trajectories():
    return _trajectories(_cfg(), _batches(2))[:4]


@pytest.fixture(scope="module")
def v3_trajectories():
    return _trajectories(_v3_cfg(), _batches(2, image=True))


def test_losses_and_learning_rates(trajectories):
    jax_run, _, port_run, _ = trajectories
    ours, theirs = np.asarray(port_run), np.asarray(jax_run)
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], rtol=2e-3)
    np.testing.assert_allclose(ours[0, 0], theirs[0, 0], rtol=3e-4)
    np.testing.assert_allclose(ours[:, 1], theirs[:, 1], rtol=1e-6,
                               atol=1e-12)
    assert ours[0, 1] == 0.0 and ours[2, 1] == pytest.approx(LR)
    # grad_norm is the norm before clipping, as optax.global_norm(grads)
    np.testing.assert_allclose(ours[:, 2], theirs[:, 2], rtol=2e-3)
    assert ours[:, 2].max() > MAX_GRAD_NORM  # clipping was exercised


def test_end_state_parameter_norms(trajectories):
    _, jax_norms, _, port_norms = trajectories
    for key in ("all", "decoder", "backbone"):
        np.testing.assert_allclose(port_norms[key], jax_norms[key],
                                   rtol=1e-4, err_msg=key)


def test_v3_losses_learning_rates_and_norms(v3_trajectories):
    jax_run, jax_norms, port_run, port_norms = v3_trajectories[:4]
    ours, theirs = np.asarray(port_run), np.asarray(jax_run)
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], rtol=2e-3)
    np.testing.assert_allclose(ours[0, 0], theirs[0, 0], rtol=3e-4)
    np.testing.assert_allclose(ours[:, 1], theirs[:, 1], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(ours[:, 2], theirs[:, 2], rtol=2e-3)
    for key in ("all", "decoder", "backbone"):
        np.testing.assert_allclose(port_norms[key], jax_norms[key],
                                   rtol=1e-4, err_msg=key)


def test_v3_bias_tables_and_visual_parameters_after_steps(v3_trajectories):
    """The three bucket tables, and the other parameters whose decay group
    the key names decide, after the 4 steps. The tables move by ~2e-4 (three
    Adam steps at lr ≤ 2e-4) and agree to atol 2e-6, a hundredth of that
    (measured: 6e-8); the other parameters to atol 1e-4 (Adam's normalised
    steps amplify fp32 gradient noise where a gradient is near 0)."""
    *_, jax_params, port, start = v3_trajectories
    jb, sd = jax_params["backbone"], port.state_dict()
    moved = 0.0
    for name in ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias"):
        got = sd[f"backbone.encoder.{name}.weight"].numpy().T
        np.testing.assert_allclose(got, jb[name], rtol=0, atol=2e-6,
                                   err_msg=name)
        moved = max(moved, np.abs(jb[name] - start["backbone"][name]).max())
    assert moved > 2e-4  # the tables were trained
    for key, leaf in (("norm.weight", jb["visual_norm"]["scale"]),
                      ("LayerNorm.weight",
                       jb["post_concat_LayerNorm"]["scale"]),
                      ("cls_token", jb["cls_token"]),
                      ("pos_embed", jb["pos_embed"])):
        np.testing.assert_allclose(sd["backbone." + key].numpy(), leaf,
                                   rtol=0, atol=1e-4, err_msg=key)


def test_v3_parameter_groups():
    port = PortModel(PortConfig.from_dict(_v3_cfg().to_dict()))
    optimizer, _ = T.make_optimizer(port, lr=1e-3, total_steps=10,
                                    downstream_speedup_ratio=SPEEDUP)
    no_decay = set().union(*(set(g["names"]) for g in optimizer.param_groups
                             if g["weight_decay"] == 0))
    for name in ("encoder.rel_pos_bias.weight", "encoder.rel_pos_x_bias.weight",
                 "encoder.rel_pos_y_bias.weight", "norm.weight", "cls_token",
                 "pos_embed", "patch_embed.proj.weight"):
        assert "backbone." + name not in no_decay, name
    for name in ("LayerNorm.weight", "norm.bias", "patch_embed.proj.bias",
                 "embeddings.LayerNorm.weight",
                 "encoder.layer.1.output.LayerNorm.weight"):
        assert "backbone." + name in no_decay, name


def test_parameter_groups():
    port = PortModel(PortConfig.from_dict(_cfg().to_dict()))
    optimizer, _ = T.make_optimizer(port, lr=1e-3, total_steps=10,
                                    downstream_speedup_ratio=SPEEDUP)
    groups = {(g["initial_lr"], g["weight_decay"]): set(g["names"])
              for g in optimizer.param_groups}
    assert len(groups) == 4
    no_decay = set().union(*(v for (lr, wd), v in groups.items() if wd == 0))
    assert "backbone.encoder.layer.0.attention.output.LayerNorm.weight" \
        in no_decay
    assert "peneo_decoder.handshaking_kernel.combine_fc.bias" in no_decay
    assert "backbone.embeddings.word_embeddings.weight" not in no_decay
    decoder = set().union(*(v for (lr, wd), v in groups.items()
                            if lr == pytest.approx(1e-3 * SPEEDUP)))
    assert decoder == {n for n, _ in port.named_parameters()
                       if n.startswith("peneo_decoder.")}


def test_warmup_rounding_matches_hf():
    """9 steps × ratio 0.3 = 2.7: HF ceils to 3 warmup steps."""
    sched = T.linear_schedule(1.0, 9, warmup_ratio=0.3)
    assert T.warmup_steps(9, 0.3) == 3
    assert sched(3) == pytest.approx(1.0) and sched(2) < 1.0
    jax_sched = jax_schedule(1.0, 9, warmup_ratio=0.3)
    for s in range(12):
        assert sched(s) == pytest.approx(float(jax_sched(s)), abs=1e-7)
