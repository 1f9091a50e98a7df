"""Fully sharded data parallelism of the PyTorch port (peneo_tpu_torch/
parallel/fsdp.py: FSDP2 over the dp ranks, HSDP under sp, the trainer's
sharded states), on the CPU in fp32 against one process, DDP and the JAX
package's ``param_shardings(fsdp=True)`` meshes.

In process:

1. placement: for LiLT, LayoutLMv3 and LayoutLMv2 at widths where some
   leaves reach 2^15 elements, every parameter that JAX shards over dp at
   ``make_mesh(dp=2, tp=1)`` and ``make_mesh(dp=2, tp=2)`` (on the
   conftest's virtual CPU devices) is split by the port's ``fsdp_dims`` so
   that each (dp, tp) rank's piece holds exactly the values JAX's device
   holds (leaves carried across with values unique over the tree, as in
   tests/test_torch_tensor_parallel.py); every other parameter is one JAX
   replicates over dp (under 2^15 elements), which FSDP2 shards on dim 0
   by design.

Spawned gloo ranks (tests/test_torch_tensor_parallel.py's harness), fp32,
dropout 0, random biases, global B = 4:

2. dp 2, dp 2 × tp 2 and dp 2 × sp 2 (HSDP), each with fsdp and with DDP:
   3 steps' losses and grad norms within 1e-5 (relative) of one process's,
   at dp 2 every gathered parameter after step 3 within 1e-5 (relative, in
   the tensor's norm); fsdp within 1e-5 of DDP on the same grid, and no
   further from one process (LiLT on every grid, LayoutLMv3 at dp 2); at
   dp 2 LiLT's losses within 1e-4 of the JAX package's fsdp steps on a
   ``make_mesh(dp=2)`` mesh (tests/test_parallel_train.py's tolerance);
3. memory: each parameter's placement is the one ``fsdp_dims`` gives, and
   a sharded leaf's local shard holds its full numel / dp (/ tp when tp
   splits it too);
4. ``run_rfund --fsdp`` across layouts (the counterpart of
   tests/test_trainer_checkpoint.py's mesh-portable checkpoints): a dp 2
   checkpoint without fsdp restores at dp 2 fsdp and at dp 2 × tp 2 fsdp
   with 0 steps run to the checkpoint's parameters bit for bit; 2 more
   steps under fsdp give DDP's losses (1e-5); the fsdp run's
   ``pytorch_model.bin`` loads in one process and into the JAX package
   through ``peneo_tpu/models/convert.py``, with equal losses; and an fsdp
   checkpoint resumes without fsdp.
"""

import hashlib
import json
import os
import shutil
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
from peneo_tpu_torch.parallel import fsdp
from peneo_tpu_torch.parallel import tensor_parallel as tpar
from test_torch_tensor_parallel import (_free_port, _rel, _tensors,
                                        _unique_leaves)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
B, L = 4, 17             # the global batch (Ld = 16)
STEPS = 3
LR, SPEEDUP, MAX_GRAD_NORM = 1e-3, 30.0, 1.0
# hidden 64 and an intermediate of 512: the MLP kernels (64 × 512) and the
# word table (512 × 64) reach JAX's 2^15 elements
WIDTHS = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=512,
              max_position_embeddings=64, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, pad_token_id=0)
FAMILIES = ("lilt", "v3")
# the (dp, tp, sp) grids of the spawned step runs, each with and without
# fsdp; LayoutLMv3 at dp 2 only
GRIDS = {"dp2": (2, 1, 1), "dp2_tp2": (2, 2, 1), "dp2_sp2": (2, 1, 2)}
FAMILY_GRIDS = {"lilt": tuple(GRIDS), "v3": ("dp2",)}
# each grid's runs: fsdp (True), DDP (False) and, for LiLT, the K-step
# path's gradient mean without either ("sync")
_MODES = {"lilt": (True, False, "sync"), "v3": (True, False)}


def _cfg(family):
    if family == "v3":  # 4 coordinate + 2 shape embeddings make hidden
        name, bc = "layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=12, shape_size=8, input_size=32, **WIDTHS)
    elif family == "v2":  # one block per ResNeXt stage
        name, bc = "layoutxlm-base", LayoutLMv2Config(
            coordinate_size=12, shape_size=8, visual_depths=[1, 1, 1, 1],
            **WIDTHS)
    else:
        name, bc = "lilt-infoxlm-base", LiltConfig(**WIDTHS)
    return PEneoConfig(backbone_name=name, backbone_config=bc.to_dict(),
                       pair_block_size=8, initializer_range=0.3,
                       peneo_category_weights=[1.0, 10.0, 10.0],
                       peneo_downstream_speedup_ratio=SPEEDUP,
                       max_spots_per_head=64)


def _batch(family, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 900, (B, L))
    y0 = rng.integers(0, 900, (B, L))
    out = {"input_ids": rng.integers(2, 512, (B, L)).astype(np.int32),
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
    image = batch.get("image")
    params = jax.device_get(jax.jit(lambda a, b, c, im: model.init(
        jax.random.PRNGKey(0), a, b, c, deterministic=True, image=im))(
            *args, image)["params"])
    # random biases: a bias gathered or reduced twice would show
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


# 1. placement ---------------------------------------------------------------

def _coords(params, shardings, n):
    """value → its (dp, tp) coordinate on JAX's mesh (-1: replicated over
    that axis)."""
    out = {axis: np.full(n + 1, -2, np.int64) for axis in ("dp", "tp")}
    for leaf, sharding in zip(jax.tree_util.tree_leaves(params),
                              jax.tree_util.tree_leaves(shardings)):
        spec = tuple(sharding.spec)
        idx = leaf.astype(np.int64)
        for axis, size in (("dp", 2), ("tp", sharding.mesh.shape["tp"])):
            if axis in spec:
                dim = spec.index(axis)
                out[axis][idx] = (np.indices(leaf.shape)[dim]
                                  // (leaf.shape[dim] // size))
            else:
                out[axis][idx] = -1
    return out


@pytest.fixture(scope="module")
def unique_trees():
    """Each family's JAX init with values unique over the tree, made once."""
    trees = {}

    def of(family):
        if family not in trees:
            trees[family] = _unique_leaves(_jax_params(_cfg(family),
                                                       _batch(family)))
        return trees[family]
    return of


@pytest.mark.parametrize("tp", [1, 2], ids=["dp2", "dp2_tp2"])
@pytest.mark.parametrize("family", ["lilt", "v3", "v2"])
def test_placement_matches_jax_fsdp_param_shardings(unique_trees, family,
                                                    tp):
    cfg = _cfg(family)
    params, n = unique_trees(family)
    mesh = pmesh.make_mesh(dp=2, tp=tp, devices=jax.devices()[:2 * tp])
    coords = _coords(params, pmesh.param_shardings(params, mesh, fsdp=True),
                     n)
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    state = jax_params_to_state_dict(params, port_cfg)
    splits = tpar.param_splits(state, tp)
    dims = fsdp.fsdp_dims(PortModel(port_cfg), 2, tp)
    sharded, small = 0, []
    for key, dim in dims.items():
        values = state[key].detach().numpy().astype(np.float64)
        idx = values.astype(np.int64)
        if (values != idx).any() or (idx < 1).any() or (idx > n).any():
            continue  # converted, not copied: the v2 tower's frozen norms
        if dim is None:
            # JAX replicates it over dp: a leaf under 2^15 elements
            assert (coords["dp"][idx] == -1).all(), key
            assert idx.size < fsdp.FSDP_MIN_ELEMENTS, key
            small.append(key)
            continue
        tp_parts = (np.split(idx, tp, axis=splits[key]) if key in splits
                    else [idx] * tp)
        for t, part in enumerate(tp_parts):
            for d, piece in enumerate(np.split(part, 2, axis=dim)):
                assert set(coords["dp"][piece].reshape(-1)) == {d}, key
                if tp > 1:
                    want = {t} if key in splits else {-1}
                    assert set(coords["tp"][piece].reshape(-1)) == want, key
        sharded += 1
    # each layer's two (LiLT: four) MLP kernels at least, and the word table
    assert sharded >= 2 * WIDTHS["num_hidden_layers"] + 1, sharded
    assert "backbone.embeddings.word_embeddings.weight" not in small


def test_flax_dim_order_picks_jax_dim_among_equal_ones():
    """A square kernel: JAX takes the first of the equal dims in the flax
    order (the input dim), which is torch's dim 1."""
    model = torch.nn.Sequential(torch.nn.Linear(256, 256),
                                torch.nn.Conv2d(64, 64, 3))
    dims = fsdp.fsdp_dims(model, 2)
    assert dims == {"0.weight": 1, "0.bias": None, "1.weight": 1,
                    "1.bias": None}
    assert set(fsdp.fsdp_dims(model, 1).values()) == {None}


# spawned gloo ranks ----------------------------------------------------------

WORKER = r"""
import json, os, sys
repo, mode, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from peneo_tpu_torch.parallel import dist as pdist
from peneo_tpu_torch.parallel import fsdp
from peneo_tpu_torch.parallel import tensor_parallel as tpar

if mode == "step":
    from torch.nn.parallel import DistributedDataParallel
    from peneo_tpu_torch.config import PEneoConfig
    from peneo_tpu_torch.models.peneo import PEneoModel
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import tree_map
    pdist.init_distributed("cpu", spec["address"], spec["n"], spec["pid"])
    for run in spec["runs"]:
        dp, tp, sp = run["grid"]
        pdist.grid(dp, tp, sp)
        data = torch.load(run["data"], weights_only=False)
        model = PEneoModel(PEneoConfig.from_dict(data["cfg"]))
        model.load_state_dict(data["state"])
        model.set_data_parallel(True)
        shard = tpar.NO_TP
        if tp > 1:
            shard = tpar.TpShard(pdist.tp_index(), tp, pdist.tp_group())
            model.set_tensor_parallel(shard.index, tp, shard.group)
        if sp > 1:
            model.set_sequence_parallel(pdist.sp_index(), sp,
                                        pdist.sp_group())
        splits = getattr(model, "tp_splits", {})
        want = fsdp.fsdp_dims(model, dp, tp)
        step_model, sync = model, None
        if run["fsdp"]:
            fsdp.apply_fsdp(model, torch.device("cpu"))
        elif run.get("sync"):  # the K-step path's mean, in place of DDP
            params = [p for p in model.parameters() if p.requires_grad]
            sync = lambda: pdist.replica_mean_grads(params)
        else:
            step_model = DistributedDataParallel(
                model, process_group=pdist.replica_group())
        opt, sched = T.make_optimizer(model, **data["opt"])
        per = data["batch"]["input_ids"].shape[0] // dp
        rows = slice(pdist.dp_index() * per, (pdist.dp_index() + 1) * per)
        batch = tree_map(lambda t: t[rows], data["batch"])
        steps = []
        for _ in range(data["steps"]):
            m = T.train_step(step_model, opt, sched, batch, data["clip"],
                             grad_sync=sync)
            steps.append((float(m["total"]), float(m["grad_norm"])))
        full = tpar.gather_state_dict(fsdp.full_state(model.state_dict()),
                                      splits, shard)
        moments = fsdp.full_optimizer_state(opt.state_dict())["state"]
        local = {}
        for name, p in model.named_parameters():
            if run["fsdp"]:
                local[name] = {
                    "placements": [repr(q) for q in p.placements],
                    "local": p.to_local().numel(), "global": p.numel(),
                    "want": want[name], "tp_split": name in splits,
                    "moment_is_sharded": type(opt.state[p]["exp_avg"])
                                         is type(p)}
        result = {"steps": steps, "local": local,
                  "params": {k: v.numpy() for k, v in full.items()},
                  "n_moments": len(moments)}
        if pdist.rank() == 0:
            torch.save(result, run["out"])
        pdist.barrier()
    pdist.shutdown()
    print("RESULT " + json.dumps({"rank": pdist.rank()}), flush=True)
    sys.exit(0)

import hashlib
from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

args = run_rfund.build_argparser().parse_args(spec)
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
digests = {k: hashlib.sha256(v.detach().float().numpy().tobytes()).hexdigest()
           for k, v in trainer._full_model_state().items()}
if args.do_eval:
    trainer.save_model()
result = {"rank": pdist.rank(), "step": trainer.step, "losses": losses,
          "digests": digests, "fsdp": trainer.fsdp}
print("RESULT " + json.dumps(result), flush=True)
pdist.barrier()
pdist.shutdown()
"""


def _start(mode, arg, nproc, logs):
    """``nproc`` worker processes over gloo, their output in files under
    ``logs`` (a pipe left unread fills up and stalls a rank in a
    collective): ``arg`` is a spec dict for ``step``, a command line
    otherwise."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    os.makedirs(logs, exist_ok=True)
    procs = []
    for pid in range(nproc):
        if mode == "step":
            a = dict(arg, address=f"localhost:{port}", n=nproc, pid=pid)
        else:
            a = arg + ["--coordinator_address", f"localhost:{port}",
                       "--num_processes", str(nproc), "--process_id",
                       str(pid)]
        path = os.path.join(logs, f"rank{pid}.log")
        with open(path, "w") as log:
            procs.append((subprocess.Popen(
                [sys.executable, "-c", WORKER, REPO, mode, json.dumps(a)],
                stdout=log, stderr=subprocess.STDOUT, text=True, env=env),
                path))
    return procs


def _results(procs):
    """The workers' RESULT records in rank order. A worker that fails or
    outlives the timeout fails the test, and every worker is killed."""
    results = []
    try:
        for p, path in procs:
            p.wait(timeout=TIMEOUT)
            with open(path) as f:
                out = f.read()
            assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


# 2-3. steps and placement per grid --------------------------------------------

def _one_process(data):
    """What the step workers compute, in this process, on the global
    batch."""
    from peneo_tpu_torch.pipeline import train as T

    model = PortModel(PortConfig.from_dict(data["cfg"]))
    model.load_state_dict(data["state"])
    opt, sched = T.make_optimizer(model, **data["opt"])
    steps = []
    for _ in range(STEPS):
        m = T.train_step(model, opt, sched, data["batch"], MAX_GRAD_NORM)
        steps.append((float(m["total"]), float(m["grad_norm"])))
    return {"steps": steps,
            "params": {k: v.numpy() for k, v in model.state_dict().items()}}


def _jax_fsdp_steps(cfg, params, batch):
    """The JAX package's STEPS steps on a make_mesh(dp=2) mesh with
    param_shardings(fsdp=True)."""
    model = PEneoModel(cfg, dtype=jax.numpy.float32)
    opt = JT.make_optimizer(None, lr=LR, total_steps=10,
                            downstream_speedup_ratio=SPEEDUP)
    state = JT.create_train_state(cfg, model, opt, batch, params=params)
    mesh = pmesh.make_mesh(dp=2, devices=jax.devices()[:2])
    state = JT.shard_state(state, mesh, pmesh.param_shardings(
        state.params, mesh, fsdp=True))
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
    """Per family and grid: rank 0's result with fsdp (True), with DDP
    (False) and, for LiLT, with neither but ``dist.replica_mean_grads``
    after each backward ("sync"); one process's; for LiLT, JAX's dp 2 fsdp
    steps."""
    base = tmp_path_factory.mktemp("fsdp_steps")
    setups, runs2, runs4 = {}, [], []
    for family in FAMILIES:
        cfg = _cfg(family)
        batch = _batch(family)
        params = _jax_params(cfg, batch)
        state = jax_params_to_state_dict(
            params, PortConfig.from_dict(cfg.to_dict()))
        data = {"cfg": cfg.to_dict(), "state": state,
                "batch": _tensors(batch), "steps": STEPS,
                "clip": MAX_GRAD_NORM,
                "opt": {"lr": LR, "total_steps": 10,
                        "downstream_speedup_ratio": SPEEDUP}}
        path = str(base / f"{family}.pt")
        torch.save(data, path)
        setups[family] = (cfg, params, batch, data)
        for name in FAMILY_GRIDS[family]:
            grid = GRIDS[name]
            for sharded in _MODES[family]:
                run = {"grid": grid, "fsdp": sharded is True,
                       "sync": sharded == "sync", "data": path,
                       "out": str(base / f"{family}.{name}.{sharded}.pt")}
                (runs2 if grid[1] * grid[2] == 1 else runs4).append(run)
    procs = _start("step", {"runs": runs2}, 2, str(base / "logs2")) + \
        _start("step", {"runs": runs4}, 4, str(base / "logs4"))
    out = {}
    for family in FAMILIES:
        cfg, params, batch, data = setups[family]
        out[family] = {"solo": _one_process(data)}
        if family == "lilt":
            out[family]["jax"] = _jax_fsdp_steps(cfg, params, batch)
    _results(procs)
    for family in FAMILIES:
        for name in FAMILY_GRIDS[family]:
            out[family][name] = {sharded: torch.load(
                str(base / f"{family}.{name}.{sharded}.pt"),
                weights_only=False) for sharded in _MODES[family]}
    return out


def _close_params(got, want, tol=1e-5):
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert _rel(got[key], w) <= tol, key


CASES = [(f, g) for f in FAMILIES for g in FAMILY_GRIDS[f]]


@pytest.mark.parametrize("family,grid", CASES)
def test_steps_equal_one_process(step_runs, family, grid):
    """fsdp's 3 steps: losses and grad norms within 1e-5 of one process's;
    at dp 2 every parameter too."""
    run, solo = step_runs[family][grid][True], step_runs[family]["solo"]
    np.testing.assert_allclose(np.asarray(run["steps"]),
                               np.asarray(solo["steps"]), rtol=1e-5)
    assert solo["steps"][-1][0] < solo["steps"][0][0]
    if grid == "dp2":
        _close_params(run["params"], solo["params"])


@pytest.mark.parametrize("family,grid", CASES)
def test_fsdp_equals_the_grid_without_it(step_runs, family, grid):
    """fsdp against DDP on the same grid: steps and every parameter after
    step 3 within 1e-5. Under tp or sp both sit as far from one process
    as the split's fp32 sums put them (a near-zero gradient's rounding
    reaches Adam's update at full size): the decoder's shrink bias
    3.3e-5 (tp 2) and 1.4e-5 (sp 2) of its norm, with or without fsdp."""
    fs, ddp = step_runs[family][grid][True], step_runs[family][grid][False]
    np.testing.assert_allclose(np.asarray(fs["steps"]),
                               np.asarray(ddp["steps"]), rtol=1e-5)
    _close_params(fs["params"], ddp["params"])
    solo = step_runs[family]["solo"]["params"]
    for key, want in solo.items():
        assert _rel(fs["params"][key], want) <= max(
            1e-5, 1.01 * _rel(ddp["params"][key], want)), key


@pytest.mark.parametrize("grid", FAMILY_GRIDS["lilt"])
def test_replica_mean_grads_equals_ddp(step_runs, grid):
    """The gradient mean of K > 1 steps in a group (one all-reduce of the
    gradients over the replica group after each backward, no DDP) against
    DDP's on the same grid: every step's loss and grad norm and every
    parameter after step 3, bit for bit over a replica group of two ranks
    (dp 2, dp 2 × tp 2); over four (dp 2 × sp 2) the ring sums the four
    shares in another order than DDP's buckets, so within 1e-6."""
    sync, ddp = step_runs["lilt"][grid]["sync"], step_runs["lilt"][grid][False]
    dp, tp, sp = GRIDS[grid]
    if dp * sp == 2:
        assert sync["steps"] == ddp["steps"]
        for key, want in ddp["params"].items():
            np.testing.assert_array_equal(sync["params"][key], want, key)
    else:
        np.testing.assert_allclose(np.asarray(sync["steps"]),
                                   np.asarray(ddp["steps"]), rtol=1e-6)
        _close_params(sync["params"], ddp["params"], 1e-6)


def test_losses_equal_jax_fsdp_mesh(step_runs):
    """LiLT at dp 2 (tests/test_parallel_train.py's fsdp case)."""
    np.testing.assert_allclose(
        [s[0] for s in step_runs["lilt"]["dp2"][True]["steps"]],
        step_runs["lilt"]["jax"], rtol=1e-4)


@pytest.mark.parametrize("family,grid", CASES)
def test_shards_hold_their_share(step_runs, family, grid):
    """Every parameter sits on its fsdp_dims dim (dim 0 where JAX
    replicates); a leaf JAX shards holds its full numel / dp locally (the
    full numel of this rank's tp shard under tp), its AdamW moments are
    sharded alike."""
    dp, tp, sp = GRIDS[grid]
    run = step_runs[family][grid][True]
    local = run["local"]
    assert local and run["n_moments"] == len(local)
    sharded = 0
    for name, r in local.items():
        dim = 0 if r["want"] is None else r["want"]
        want = (["Replicate()", f"Shard(dim={dim})"] if sp > 1
                else [f"Shard(dim={dim})"])
        assert r["placements"] == want, name
        assert r["moment_is_sharded"], name
        if r["want"] is not None:
            assert r["local"] * dp == r["global"], name
            sharded += 1
    assert sharded >= 5


# 4. run_rfund --fsdp across layouts -------------------------------------------

LT = 64
RUN_STEPS = 4


def _write_model(path):
    from peneo_tpu_torch.config import LiltConfig as PortLilt
    from peneo_tpu_torch.data.synthetic import ToyTokenizer

    os.makedirs(path)
    tok = ToyTokenizer()
    cfg = PortConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=PortLilt(**dict(
            WIDTHS, vocab_size=tok.vocab_size,
            max_position_embeddings=LT + 16),
            initializer_range=0.15).to_dict(),
        pair_block_size=16, initializer_range=0.15,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0)
    model = PortModel(cfg).init_weights(torch.Generator().manual_seed(0))
    cfg.save_pretrained(path)
    tok.save_pretrained(path)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return path


def _argv(model_dir, data_dir, out, steps, *flags):
    return ["--synthetic_data", "--model_name_or_path", model_dir,
            "--data_dir", data_dir, "--output_dir", out, "--device", "cpu",
            "--dtype", "float32", "--max_seq_len", str(LT),
            "--max_steps", str(steps), "--logging_steps", "1",
            "--eval_steps", "0", "--save_steps", "2",
            "--save_total_limit", "1", "--learning_rate", "1e-3",
            "--warmup_ratio", "0", "--per_device_train_batch_size", "2",
            "--per_device_eval_batch_size", "2",
            "--metric_for_best_model", "", *flags]


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """A dp 2 run without fsdp (checkpoint at step 4), then from copies of
    its directory: restores at dp 2 fsdp and dp 2 × tp 2 fsdp (0 steps),
    and 2 more steps at dp 2 with and without fsdp; an fsdp run's
    checkpoint resumed without fsdp."""
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset

    base = tmp_path_factory.mktemp("fsdp_layouts")
    data = str(base / "data")
    write_rfund_dataset(data, "en", n_train=16, n_val=4, seed=3)
    model_dir = _write_model(str(base / "model"))
    ddp_out = str(base / "ddp")
    out = {"ddp": _results(_start("train", _argv(
        model_dir, data, ddp_out, RUN_STEPS, "--no_resume"), 2,
        str(base / "logs_ddp"))),
        "model_dir": model_dir, "data": data, "ddp_out": ddp_out}
    runs = {"fsdp_0": (RUN_STEPS, 2, ["--fsdp"]),
            "fsdp_tp2_0": (RUN_STEPS, 4, ["--fsdp", "--tp", "2"]),
            "fsdp_more": (RUN_STEPS + 2, 2, ["--fsdp", "--do_eval"]),
            "ddp_more": (RUN_STEPS + 2, 2, [])}
    procs = {name: _start("train", _argv(
        model_dir, data, _copy(ddp_out, str(base / name)), steps, *flags),
        n, str(base / f"logs_{name}")) for name, (steps, n, flags)
        in runs.items()}
    for name in runs:
        out[name] = _results(procs[name])
    # the fsdp run's step-6 checkpoint, resumed without fsdp (0 steps)
    back = _copy(str(base / "fsdp_more"), str(base / "back"))
    out["back"] = _results(_start("train", _argv(
        model_dir, data, back, RUN_STEPS + 2), 2, str(base / "logs_back")))
    out["fsdp_more_dir"] = str(base / "fsdp_more")
    return out


def _digests(state):
    return {k: hashlib.sha256(v.float().numpy().tobytes()).hexdigest()
            for k, v in state.items()}


def _checkpoint_digests(out_dir, step):
    from peneo_tpu_torch.pipeline.checkpoint import CheckpointManager

    return _digests(CheckpointManager(os.path.join(
        out_dir, "checkpoints")).restore(step, map_location="cpu")["model"])


@pytest.mark.parametrize("run", ["fsdp_0", "fsdp_tp2_0"])
def test_checkpoint_restores_at_another_layout_bit_for_bit(layouts, run):
    want = _checkpoint_digests(layouts["ddp_out"], RUN_STEPS)
    for r in layouts[run]:
        assert r["fsdp"] and r["step"] == RUN_STEPS and r["losses"] == []
        assert r["digests"] == want


def test_fsdp_continues_as_ddp_does(layouts):
    more, ddp = layouts["fsdp_more"], layouts["ddp_more"]
    assert [r["step"] for r in more] == [RUN_STEPS + 2] * 2
    assert len(ddp[0]["losses"]) == 2 and more[0]["losses"] == \
        more[1]["losses"]
    np.testing.assert_allclose(more[0]["losses"], ddp[0]["losses"],
                               rtol=1e-5)
    # and the uninterrupted run's first steps were DDP's
    assert len(layouts["ddp"][0]["losses"]) == RUN_STEPS


def test_fsdp_checkpoint_resumes_without_fsdp(layouts):
    want = _checkpoint_digests(layouts["fsdp_more_dir"], RUN_STEPS + 2)
    for r in layouts["back"]:
        assert not r["fsdp"] and r["losses"] == []
        assert r["digests"] == want


def test_fsdp_save_loads_in_one_process_and_into_jax(layouts):
    import jax.numpy as jnp

    from peneo_tpu.models.convert import convert_peneo_checkpoint
    from peneo_tpu_torch.pipeline.infer import load_weights

    out = layouts["fsdp_more_dir"]
    saved = torch.load(os.path.join(out, "pytorch_model.bin"),
                       weights_only=True)
    model = PortModel(PortConfig.from_pretrained(out))
    load_weights(model, out)
    assert _digests(model.state_dict()) == _checkpoint_digests(
        out, RUN_STEPS + 2)
    # the same weights in the JAX package: one forward's loss alike
    jcfg = PEneoConfig.from_pretrained(out)
    params = convert_peneo_checkpoint(
        {k: v.numpy() for k, v in saved.items()}, jcfg)
    batch = _batch("lilt")
    batch["input_ids"] %= jcfg.backbone_config["vocab_size"]
    jax_total = float(PEneoModel(jcfg, dtype=jnp.float32).apply(
        {"params": params}, batch["input_ids"], batch["bbox"],
        batch["attention_mask"], labels=batch["labels"],
        deterministic=True)["total"])
    t = _tensors(batch)
    model.eval()
    with torch.no_grad():
        port_total = float(model(t["input_ids"], t["bbox"],
                                 t["attention_mask"],
                                 labels=t["labels"])["total"])
    np.testing.assert_allclose(port_total, jax_total, rtol=1e-5)
