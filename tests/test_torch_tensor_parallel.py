"""Tensor parallelism of the PyTorch port (peneo_tpu_torch/parallel/
tensor_parallel.py, the tp-aware backbones, decoder, trainer and service,
the dp × tp × sp grid of parallel/dist.py), on the CPU in fp32.

In process:

1. placement: for LiLT, LayoutLMv3 and LayoutLMv2 at small widths the split
   dim of every state-dict key equals the tp dim of the JAX package's
   ``param_shardings`` at ``make_mesh(dp=1, tp=2)`` on the conftest's
   virtual CPU devices (each tensor carried across by
   ``peneo_tpu_torch/models/convert.py`` with values unique over the whole
   tree, so that a tensor's shard is found by its values); the only
   exception is the combine (``combine_fc``: JAX ``comb_a``/``comb_b``),
   which the port keeps replicated by design; an odd vocabulary stays
   replicated in both;
2. a tp size that does not divide the heads raises, naming both.

Spawned gloo ranks (tests/test_torch_dist.py's harness: a free local port,
the JAX trainer's coordinator flags, 120 s per subprocess; the trainer,
the checkpoints and the service at tp 2 are in
tests/test_torch_tensor_parallel_runs.py), fp32, dropout 0, random biases:

3. per family at tp 2 (two ranks): eval logits within 1e-5 of one process,
   3 optimizer steps' losses and grad norms within 1e-5, every parameter
   after step 3 (gathered) within 1e-5 of one process's (relative, in the
   tensor's norm: Adam divides each element's gradient by its own scale,
   so the rounding of a near-zero gradient reaches the update at full
   size), and the losses within 1e-4 of the JAX package's steps on a
   ``make_mesh(dp=1, tp=2)`` mesh from the same weights and batch
   (tests/test_parallel_train.py's tolerance); for LiLT the int8 serving
   forward (``quantize_backbone`` and ``quantize_pair_head``) at tp 2
   equals int8 at tp 1 within 1e-5.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.data.tagging import batch_spots_to_matrix
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.parallel import mesh as pmesh
from peneo_tpu.pipeline import train as JT
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.parallel import tensor_parallel as tpar

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
B, L = 4, 17            # the step parity's batch (Ld = 16)
STEPS = 3
LR, SPEEDUP, MAX_GRAD_NORM = 1e-3, 30.0, 1.0
FAMILIES = ("lilt", "v3", "v2")


def _backbone(family, vocab=64):
    common = dict(vocab_size=vocab, hidden_size=48, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=96,
                  max_position_embeddings=64, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0, pad_token_id=0)
    if family == "v3":
        return "layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=8, shape_size=8, input_size=32, **common)
    if family == "v2":  # one block per ResNeXt stage
        return "layoutxlm-base", LayoutLMv2Config(
            coordinate_size=8, shape_size=8, visual_depths=[1, 1, 1, 1],
            **common)
    return "lilt-infoxlm-base", LiltConfig(**common)


def _cfg(family, vocab=64, **kw):
    name, bc = _backbone(family, vocab)
    return PEneoConfig(backbone_name=name, backbone_config=bc.to_dict(),
                       pair_block_size=8, initializer_range=0.3,
                       peneo_category_weights=[1.0, 10.0, 10.0],
                       peneo_downstream_speedup_ratio=SPEEDUP,
                       max_spots_per_head=64, **kw)


def _batch(family, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 900, (B, L))
    y0 = rng.integers(0, 900, (B, L))
    out = {"input_ids": rng.integers(2, 64, (B, L)).astype(np.int32),
           "bbox": np.stack([x0, y0, x0 + 50, y0 + 20], -1).astype(np.int32),
           "attention_mask": np.ones((B, L), np.int32)}
    if family == "v3":
        out["image"] = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    if family == "v2":  # BGR 0-255, a 56 px page: 7×7 visual tokens
        out["image"] = (rng.random((B, 3, 56, 56)) * 255).astype(np.float32)
    Ld = L - 1
    labels = {}
    for name in HEAD_NAMES:
        c = 2 if name == "line_extraction" else 3
        spots = [[(int(i), int(rng.integers(i, Ld)), int(rng.integers(1, c)))
                  for i in rng.integers(0, Ld, 5)] for _ in range(B)]
        labels[name] = batch_spots_to_matrix(spots, Ld)
    out["labels"] = labels
    return out


def _jax_params(cfg, batch):
    model = PEneoModel(cfg)
    args = [batch[k] for k in ("input_ids", "bbox", "attention_mask")]
    if "image" in batch:
        args.append(batch["image"])
    params = jax.device_get(jax.jit(lambda *a: model.init(
        jax.random.PRNGKey(0), *a[:3], deterministic=True,
        image=a[3] if len(a) > 3 else None))(*args)["params"])
    # random biases: a row-parallel bias added once per rank would show
    rng = np.random.default_rng(1)

    def randomize(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomize(v)
            elif k == "bias":
                tree[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    np.float32)
    randomize(params)
    return params


def _tensors(batch):
    return {k: ({n: torch.from_numpy(np.asarray(m)) for n, m in v.items()}
                if k == "labels" else torch.from_numpy(v))
            for k, v in batch.items()}


# 1-2. placement ------------------------------------------------------------

def _unique_leaves(params):
    """``params`` with every leaf replaced by consecutive values 1, 2, …
    unique over the tree (exact in fp32)."""
    counter = [0]

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            n = int(np.prod(v.shape))
            out[k] = (np.arange(n) + counter[0] + 1).reshape(v.shape).astype(
                np.float32)
            counter[0] += n
        return out
    out = fill(params)
    assert counter[0] < 2 ** 24
    return out, counter[0]


def _placement(family, vocab=64):
    """(keys checked, keys JAX splits and the port does not, the port's
    splits, its state dict) at tp 2."""
    cfg = _cfg(family, vocab)
    params, n = _unique_leaves(_jax_params(cfg, _batch(family)))
    mesh = pmesh.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    shardings = pmesh.param_shardings(params, mesh)
    # value v → JAX's tp shard of it (-1: replicated)
    shard_of = np.full(n + 1, -2, np.int64)
    for leaf, sharding in zip(jax.tree_util.tree_leaves(params),
                              jax.tree_util.tree_leaves(shardings)):
        spec = tuple(sharding.spec)
        idx = leaf.astype(np.int64)
        if "tp" in spec:
            dim = spec.index("tp")
            pos = np.indices(leaf.shape)[dim]
            shard_of[idx] = pos // (leaf.shape[dim] // 2)
        else:
            shard_of[idx] = -1
    state = jax_params_to_state_dict(params, PortConfig.from_dict(
        cfg.to_dict()))
    splits = tpar.param_splits(state, 2)
    checked, exceptions = 0, []
    for key, t in state.items():
        values = t.detach().numpy().astype(np.float64)
        idx = values.astype(np.int64)
        if (values != idx).any() or (idx < 1).any() or (idx > n).any():
            continue  # converted, not copied: the v2 tower's frozen norms
        if key in splits:
            dim = splits[key]
            for shard, part in enumerate(np.split(idx, 2, axis=dim)):
                assert set(shard_of[part].reshape(-1)) == {shard}, key
            checked += 1
        elif (shard_of[idx] >= 0).any():
            exceptions.append(key)
    return checked, exceptions, splits, state


@pytest.mark.parametrize("family", FAMILIES)
def test_placement_matches_jax_param_shardings(family):
    checked, exceptions, splits, _ = _placement(family)
    # q/k/v (both LiLT streams), two MLP layers, two row-parallel outputs
    # a layer, the word table, fc_0 (weight, bias) and fc_out of each head
    assert checked == len(splits) and checked > 20
    assert exceptions == ["peneo_decoder.handshaking_kernel.combine_fc."
                          "weight", "peneo_decoder.handshaking_kernel."
                          "combine_fc.bias"]
    assert "backbone.embeddings.word_embeddings.weight" in splits
    if family == "v2":  # the fused qkv and its biases stay replicated
        assert not any("qkv_linear" in k or "q_bias" in k for k in splits)


def test_odd_vocabulary_stays_replicated_as_in_jax():
    _, _, splits, state = _placement("lilt", vocab=65)
    key = "backbone.embeddings.word_embeddings.weight"
    assert state[key].shape[0] == 65 and key not in splits
    assert any(k.endswith("attention.self.query.weight") for k in splits)


def test_tp_that_does_not_divide_the_heads_raises():
    cfg = PortConfig.from_dict(_cfg("lilt").to_dict())
    with pytest.raises(ValueError, match="tp 3 does not divide the "
                                         "backbone's 4 attention heads"):
        PortModel(cfg).set_tensor_parallel(0, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_partial_linear_sums_unrounded_products(dtype):
    """A row split's partial products, summed over its two halves, equal one
    product of the operands rounded to the compute dtype (fp32 sums of exact
    products), and the TF32 switch is left as it was."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 16, generator=g).to(dtype)
    w = torch.randn(5, 16, generator=g).to(dtype)
    was = torch.backends.cuda.matmul.allow_tf32
    got = sum(tpar.partial_linear(x[:, s], w[:, s])
              for s in (slice(0, 8), slice(8, 16)))
    assert got.dtype == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 == was
    np.testing.assert_allclose(got.double().numpy(),
                               (x.double() @ w.double().t()).numpy(),
                               rtol=1e-6, atol=1e-5)


# spawned gloo ranks ---------------------------------------------------------

WORKER = r"""
import json, os, sys
repo, mode, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from peneo_tpu_torch.parallel import dist as pdist
from peneo_tpu_torch.parallel import tensor_parallel as tpar

if mode == "step":
    from peneo_tpu_torch.config import PEneoConfig
    from peneo_tpu_torch.models.peneo import PEneoModel
    from peneo_tpu_torch.pipeline import train as T
    pdist.init_distributed("cpu", spec["address"], spec["n"], spec["pid"])
    pdist.grid(1, spec["n"], 1)
    data = torch.load(spec["data"], weights_only=False)
    tp = tpar.TpShard(pdist.tp_index(), spec["n"], pdist.tp_group())

    def model_of(cfg):
        m = PEneoModel(PEneoConfig.from_dict(cfg))
        m.load_state_dict(data["state"])
        m.set_data_parallel(True)
        m.set_tensor_parallel(tp.index, tp.size, tp.group)
        return m

    def eval_logits(m, batch):
        m.eval()
        image = {"image": batch["image"]} if "image" in batch else {}
        with torch.no_grad():
            out = m(batch["input_ids"], batch["bbox"],
                    batch["attention_mask"], return_logits=True, **image)
        return {n: out[n]["logits"].numpy() for n in out}

    result = {}
    model = model_of(data["cfg"])
    result["logits"] = eval_logits(model, data["batch"])
    if data.get("int8_cfg"):
        result["int8_logits"] = eval_logits(model_of(data["int8_cfg"]),
                                            data["batch"])
    opt, sched = T.make_optimizer(model, **data["opt"])
    steps = []
    for _ in range(data["steps"]):
        m = T.train_step(model, opt, sched, data["batch"], data["clip"])
        steps.append((float(m["total"]), float(m["grad_norm"])))
    result["steps"] = steps
    full = tpar.gather_state_dict(model.state_dict(), model.tp_splits, tp)
    result["params"] = {k: v.numpy() for k, v in full.items()}
    result["splits"] = model.tp_splits
    if pdist.rank() == 0:
        torch.save(result, spec["out"])
    pdist.shutdown()
    print("RESULT " + json.dumps({"rank": pdist.rank()}), flush=True)
    sys.exit(0)

argv = spec
if mode == "serve":
    from peneo_tpu_torch import serve
    records = serve.main(argv)
    print("RESULT " + json.dumps({"rank": pdist.rank(), "pages":
                                  len(records)}), flush=True)
    sys.exit(0)
from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

args = run_rfund.build_argparser().parse_args(argv)
run_rfund.init_parallel(args)
cfg, model, train_ds, eval_ds, collator, tok = run_rfund.setup(args)
trainer = PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                       train_ds, eval_ds, collator, tokenizer=tok)
losses = []
log = trainer.log

def capture(record):
    if "loss/total" in record:
        losses.append(record["loss/total"])
    log(record)

trainer.log = capture
trainer.train()
trainer.save_model()
result = {"rank": pdist.rank(), "world": pdist.world(),
          "grid": [pdist.dp_index(), pdist.tp_index(), pdist.sp_index()],
          "seed_offset": trainer.seeds.offset, "losses": losses,
          "eval": trainer.evaluate()}
print("RESULT " + json.dumps(result), flush=True)
pdist.barrier()
pdist.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(mode, argv, nproc):
    """``nproc`` worker processes (a process group when > 1). ``argv`` is a
    command line, or for ``step`` a spec dict."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(nproc):
        if mode == "step":
            arg = dict(argv, address=f"localhost:{port}", n=nproc, pid=pid)
        else:
            arg = argv + ([] if nproc == 1 else
                          ["--coordinator_address", f"localhost:{port}",
                           "--num_processes", str(nproc),
                           "--process_id", str(pid)])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, REPO, mode, json.dumps(arg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


def _results(procs):
    """The workers' RESULT records in rank order. A worker that fails or
    outlives the timeout fails the test, and every worker is killed."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, \
                f"worker failed:\n{out[-2000:]}\n{err[-3000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


# 3. the model's step, per family ----------------------------------------------

def _one_process(cfg_dict, state, batch, int8_cfg=None):
    """What the step workers compute, in this process at tp 1."""
    from peneo_tpu_torch.pipeline import train as T

    def model_of(c):
        m = PortModel(PortConfig.from_dict(c))
        m.load_state_dict(state)
        return m

    def logits(m):
        m.eval()
        image = {"image": batch["image"]} if "image" in batch else {}
        with torch.no_grad():
            out = m(batch["input_ids"], batch["bbox"],
                    batch["attention_mask"], return_logits=True, **image)
        return {n: out[n]["logits"].numpy() for n in out}

    model = model_of(cfg_dict)
    result = {"logits": logits(model)}
    if int8_cfg:
        result["int8_logits"] = logits(model_of(int8_cfg))
    opt, sched = T.make_optimizer(model, lr=LR, total_steps=10,
                                  downstream_speedup_ratio=SPEEDUP)
    steps = []
    for _ in range(STEPS):
        m = T.train_step(model, opt, sched, batch, MAX_GRAD_NORM)
        steps.append((float(m["total"]), float(m["grad_norm"])))
    result["steps"] = steps
    result["params"] = {k: v.numpy() for k, v in model.state_dict().items()}
    return result


def _jax_steps(cfg, params, batch):
    """The JAX package's STEPS steps on a make_mesh(dp=1, tp=2) mesh."""
    model = PEneoModel(cfg, dtype=jax.numpy.float32)
    opt = JT.make_optimizer(None, lr=LR, total_steps=10,
                            downstream_speedup_ratio=SPEEDUP)
    state = JT.create_train_state(cfg, model, opt, batch, params=params)
    mesh = pmesh.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    state = JT.shard_state(state, mesh, pmesh.param_shardings(state.params,
                                                              mesh))
    bs = pmesh.batch_sharding(mesh)
    dev_batch = jax.tree_util.tree_map(lambda x: jax.device_put(x, bs),
                                       batch)
    step = JT.jit_train_step(model, opt)
    out = []
    for _ in range(STEPS):
        state, metrics = step(state, dev_batch)
        out.append(float(metrics["total"]))
    return out


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Per family: the tp 2 ranks (spawned, all families at once), one
    process, and the JAX package's tp 2 mesh."""
    base = tmp_path_factory.mktemp("tp_steps")
    procs, setups = {}, {}
    for family in FAMILIES:
        cfg = _cfg(family)
        batch = _batch(family)
        params = _jax_params(cfg, batch)
        port_cfg = PortConfig.from_dict(cfg.to_dict())
        state = jax_params_to_state_dict(params, port_cfg)
        int8_cfg = None
        if family == "lilt":
            int8_cfg = dict(cfg.to_dict(), quantize_backbone="int8",
                            quantize_pair_head="int8")
        data = {"cfg": cfg.to_dict(), "int8_cfg": int8_cfg, "state": state,
                "batch": _tensors(batch), "steps": STEPS,
                "clip": MAX_GRAD_NORM,
                "opt": {"lr": LR, "total_steps": 10,
                        "downstream_speedup_ratio": SPEEDUP}}
        path = str(base / f"{family}.pt")
        torch.save(data, path)
        out = str(base / f"{family}.out.pt")
        procs[family] = (_start("step", {"data": path, "out": out}, 2), out)
        setups[family] = (cfg, params, batch, data)
    runs = {}
    for family in FAMILIES:
        cfg, params, batch, data = setups[family]
        solo = _one_process(data["cfg"], data["state"], data["batch"],
                            data["int8_cfg"])
        jax_losses = _jax_steps(cfg, params, batch)
        _results(procs[family][0])
        tp = torch.load(procs[family][1], weights_only=False)
        runs[family] = {"tp": tp, "solo": solo, "jax": jax_losses}
    return runs


@pytest.mark.parametrize("family", FAMILIES)
def test_tp2_forward_steps_and_parameters_equal_one_process(step_runs,
                                                            family):
    tp, solo = step_runs[family]["tp"], step_runs[family]["solo"]
    assert len(tp["splits"]) > 20
    for name in HEAD_NAMES:
        np.testing.assert_allclose(tp["logits"][name], solo["logits"][name],
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(np.asarray(tp["steps"]),
                               np.asarray(solo["steps"]), rtol=1e-5)
    assert solo["steps"][-1][0] < solo["steps"][0][0]
    assert set(tp["params"]) == set(solo["params"])
    for key, want in solo["params"].items():
        got = tp["params"][key]
        assert got.shape == want.shape, key
        assert _rel(got, want) <= 1e-5, key


def _rel(got, want):
    """‖got − want‖ / ‖want‖ (Frobenius, fp64)."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("family", FAMILIES)
def test_tp2_losses_equal_jax_tp2_mesh(step_runs, family):
    tp = step_runs[family]["tp"]
    np.testing.assert_allclose([s[0] for s in tp["steps"]],
                               step_runs[family]["jax"], rtol=1e-4)


def test_int8_at_tp2_equals_int8_at_tp1(step_runs):
    tp, solo = step_runs["lilt"]["tp"], step_runs["lilt"]["solo"]
    moved = 0.0
    for name in HEAD_NAMES:
        np.testing.assert_allclose(tp["int8_logits"][name],
                                   solo["int8_logits"][name], rtol=0,
                                   atol=1e-5, err_msg=name)
        moved = max(moved, float(np.abs(solo["int8_logits"][name]
                                        - solo["logits"][name]).max()))
    assert moved > 1e-3  # int8 was on
