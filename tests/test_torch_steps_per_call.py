"""K optimizer steps per call (``steps_per_call``) in the PyTorch port
(peneo_tpu_torch/pipeline/train.py ``MultiTrainStep``) on the CPU,
where the K steps run eagerly in a loop:

- against the JAX package's ``make_multi_train_step`` (a ``lax.scan`` of K
  steps) on the tiny LiLT config of tests/test_multi_step.py (B=2, L=13,
  pair blocks of 8, all dropout 0, the JAX init carried across by
  peneo_tpu_torch/models/convert.py): the mean total loss within rtol 2e-3
  and the parameter norms after the K steps within rtol 1e-4, the
  tolerances of tests/test_torch_train_step.py; the same for a LayoutLMv3
  config with an image in every batch, at that file's v3 sizes;
- against the port's own K sequential ``train_step`` calls: rtol 1e-6;
- the learning rate the device step counter gives (``LinearSchedule``) at
  every step across the warmup boundary, against ``linear_schedule`` and
  HF's ``get_linear_schedule_with_warmup``: rtol 1e-6;
- kernels #2 and #5's CPU twins take a seed held in a 0-d int64 tensor
  (what a CUDA graph of the step passes) with the result of the int seed,
  and the graph's per-layer seeds are a pure function of the trainer's
  seed, the step and the layer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
from peneo_tpu.data.tagging import batch_spots_to_matrix
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline import train as JT
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.dropout_seeds import (LAYERS_PER_STEP,
                                                  StepSeeds, layer_seed)
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.ops import biacm_attention as ba
from peneo_tpu_torch.ops import bias_attention as rb
from peneo_tpu_torch.pipeline import train as T

torch.set_num_threads(1)
K = 4
LR, TOTAL, SPEEDUP = 1e-3, 20, 30.0


def _lilt_cfg():
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=60, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, pad_token_id=0,
            hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        pair_block_size=8)


def _v3_cfg(L):
    return PEneoConfig(
        backbone_name="layoutlmv3-base-chinese",
        backbone_config=LayoutLMv3Config(
            vocab_size=120, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=L + 16, pad_token_id=0,
            coordinate_size=8, shape_size=8, input_size=32,
            initializer_range=0.2, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        pair_block_size=16, max_seq_len=L,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=SPEEDUP)


def _batches(rng, n, B, L, vocab=60, image=False):
    """tests/test_multi_step.py's batches (dense labels), with an image."""
    out = []
    for _ in range(n):
        ids = rng.integers(2, vocab, (B, L)).astype(np.int32)
        x0 = rng.integers(0, 800, (B, L))
        labels = {}
        for name in HEAD_NAMES:
            c = 2 if name == "line_extraction" else 3
            labels[name] = batch_spots_to_matrix(
                [[(0, 3, 1), (2, 5, c - 1)] for _ in range(B)], L - 1)
        out.append({
            "input_ids": ids,
            "bbox": np.stack([x0, x0, x0 + 20, x0 + 30], -1).astype(np.int32),
            "attention_mask": np.ones((B, L), np.int32),
            "labels": labels,
        })
        if image:
            out[-1]["image"] = rng.normal(size=(B, 3, 32, 32)).astype(
                np.float32)
    return out


def _stack(batches):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *batches)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _norms(named):
    def norm(pred):
        return float(np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                                 for n, v in named if pred(n))))
    return {"all": norm(lambda n: True),
            "decoder": norm(lambda n: "peneo_decoder" in n),
            "backbone": norm(lambda n: "peneo_decoder" not in n)}


def _port(cfg, params):
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    model = PortModel(port_cfg)
    model.load_state_dict(jax_params_to_state_dict(params, port_cfg))
    optimizer, scheduler = T.make_optimizer(
        model, lr=LR, total_steps=TOTAL, downstream_speedup_ratio=SPEEDUP)
    return model, optimizer, scheduler


def _against_jax(cfg, batches):
    """The JAX K-step call and the port's from the same init."""
    model = PEneoModel(cfg, dtype=jnp.float32)
    opt = JT.make_optimizer(None, lr=LR, total_steps=TOTAL,
                            downstream_speedup_ratio=SPEEDUP)
    state = JT.create_train_state(cfg, model, opt, batches[0], seed=0)
    params = jax.device_get(state.params)
    state, jax_mean = JT.make_multi_train_step(model, opt, K)(
        state, _stack(batches))
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(state.params))
    jax_norms = _norms([(jax.tree_util.keystr(p), v) for p, v in flat])

    port, optimizer, scheduler = _port(cfg, params)
    step_fn = T.MultiTrainStep(port, optimizer, scheduler, K, 1.0)
    mean = step_fn(_torch(_stack(batches)))
    port_norms = _norms([(n, p.detach().numpy())
                         for n, p in port.named_parameters()])
    return float(jax_mean["total"]), jax_norms, float(mean["total"]), \
        port_norms


def _check_against_jax(result):
    jax_total, jax_norms, port_total, port_norms = result
    np.testing.assert_allclose(port_total, jax_total, rtol=2e-3)
    for key in ("all", "decoder", "backbone"):
        np.testing.assert_allclose(port_norms[key], jax_norms[key],
                                   rtol=1e-4, err_msg=key)


def test_k_steps_match_jax_multi_train_step():
    rng = np.random.default_rng(0)
    _check_against_jax(_against_jax(_lilt_cfg(), _batches(rng, K, 2, 13)))


def test_v3_k_steps_with_images_match_jax():
    rng = np.random.default_rng(1)
    L = 48
    batches = _batches(rng, K, 2, L, vocab=120, image=True)
    _check_against_jax(_against_jax(_v3_cfg(L), batches))


def test_k_steps_match_k_sequential_train_steps():
    rng = np.random.default_rng(2)
    cfg = _lilt_cfg()
    batches = _batches(rng, K, 2, 13)
    params = jax.device_get(JT.create_train_state(
        cfg, PEneoModel(cfg), JT.make_optimizer(None, lr=LR,
                                                total_steps=TOTAL),
        batches[0], seed=3).params)

    seq, optimizer, scheduler = _port(cfg, params)
    per_step = [T.train_step(seq, optimizer, scheduler, _torch(b), 1.0)
                for b in batches]
    multi, optimizer, scheduler = _port(cfg, params)
    step_fn = T.MultiTrainStep(multi, optimizer, scheduler, K, 1.0)
    mean = step_fn(_torch(_stack(batches)))

    for name in per_step[0]:
        want = np.array([float(m[name]) for m in per_step])
        np.testing.assert_allclose(step_fn.per_step[name].numpy(), want,
                                   rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(mean[name]), want.mean(),
                                   rtol=1e-6, err_msg=name)
    assert int(scheduler.count) == K
    for (name, a), b in zip(seq.named_parameters(), multi.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_device_counter_learning_rate_matches_hf_schedule():
    """Nine steps of warmup ratio 0.3 (HF's ceil: 3 warmup steps) in three
    calls of K=3: every group's rate at every step, across the warmup
    boundary and to the end of the decay."""
    from transformers import get_linear_schedule_with_warmup

    total, ratio, k = 9, 0.3, 3
    model = PortModel(PortConfig.from_dict(_lilt_cfg().to_dict()))
    optimizer, scheduler = T.make_optimizer(
        model, lr=LR, total_steps=total, warmup_ratio=ratio,
        downstream_speedup_ratio=SPEEDUP)
    hf_opt = torch.optim.SGD(
        [{"params": [torch.zeros(1)], "lr": g["initial_lr"]}
         for g in optimizer.param_groups])
    hf = get_linear_schedule_with_warmup(hf_opt, T.warmup_steps(total, ratio),
                                         total)
    ours, hf_lrs, ours_groups = [], [], []
    for _ in range(total // k):
        for _ in range(k):
            ours_groups.append(scheduler.apply().tolist())
            hf_lrs.append([g["lr"] for g in hf_opt.param_groups])
            hf_opt.step()
            hf.step()
            scheduler.step()
    ours = np.array(ours_groups)
    np.testing.assert_allclose(ours, np.array(hf_lrs), rtol=1e-6, atol=1e-12)
    sched = T.linear_schedule(LR, total, ratio)
    np.testing.assert_allclose(ours[:, 0], [sched(s) for s in range(total)],
                               rtol=1e-6, atol=1e-12)
    assert ours[0, 0] == 0.0 and ours[3, 0] == pytest.approx(LR)
    assert int(scheduler.count) == total

    # the rate a K-step call reports for each of its steps
    batches = _batches(np.random.default_rng(4), k, 2, 13)
    scheduler.count.zero_()
    step_fn = T.MultiTrainStep(model, optimizer, scheduler, k, 1.0)
    for call in range(2):
        step_fn(_torch(_stack(batches)))
        np.testing.assert_allclose(
            step_fn.per_step["learning_rate"].numpy(),
            ours[call * k:(call + 1) * k, 0], rtol=1e-6, atol=1e-12)


def test_schedule_state_round_trips_in_place():
    model = PortModel(PortConfig.from_dict(_lilt_cfg().to_dict()))
    optimizer, scheduler = T.make_optimizer(model, lr=LR, total_steps=TOTAL)
    count, rates = scheduler.count, scheduler.lr
    optimizer.load_state_dict(optimizer.state_dict())
    scheduler.load_state_dict({"count": 5})
    assert scheduler.count is count and int(count) == 5
    assert all(g["lr"].data_ptr() == rates[i].data_ptr()
               for i, g in enumerate(optimizer.param_groups))
    np.testing.assert_allclose(float(optimizer.param_groups[0]["lr"]),
                               T.linear_schedule(LR, TOTAL)(5), rtol=1e-6)


@pytest.mark.parametrize("L", [1, 37])
def test_biacm_twin_takes_a_tensor_seed(L):
    gen = torch.Generator().manual_seed(L)
    qkv = [torch.randn((2, 2, L, d), generator=gen)
           for d in (64, 64, 64, 16, 16, 16)]
    bias = torch.zeros((2, L))
    seed = (7 << 32) + 12345
    a = ba.biacm_attention_train(*qkv, bias, seed, 0.125, 0.25, 0.3)
    b = ba.biacm_attention_train(*qkv, bias, torch.tensor(seed), 0.125,
                                 0.25, 0.3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("L", [1, 37])
def test_bias_twin_takes_a_tensor_seed(L):
    gen = torch.Generator().manual_seed(L)
    qkv = [torch.randn((2, 2, L, 64), generator=gen) for _ in range(3)]
    bias = torch.randn((2, 2, L, L), generator=gen)
    mask = torch.zeros((2, L))
    seed = (7 << 32) + 12345
    a = rb.bias_attention_train(*qkv, bias, mask, seed, 0.125, 0.3)
    b = rb.bias_attention_train(*qkv, bias, mask, torch.tensor(seed), 0.125,
                                0.3)
    assert torch.equal(a, b)


def test_step_seeds_are_a_function_of_seed_step_and_layer():
    step = torch.zeros((), dtype=torch.int64)
    seeds = StepSeeds(42, step)
    first = [int(layer_seed(seeds, i)) for i in range(12)]
    step += 1
    second = [int(layer_seed(seeds, i)) for i in range(12)]
    assert len(set(first + second)) == 24
    assert first[3] == (42 << 32) + 3
    assert second[0] == (42 << 32) + LAYERS_PER_STEP
    step.zero_()
    assert [int(layer_seed(StepSeeds(42, step), i))
            for i in range(12)] == first
    assert int(layer_seed(StepSeeds(43, step), 0)) != first[0]
    gen = torch.Generator().manual_seed(0)
    assert isinstance(layer_seed(gen, 0), int)
