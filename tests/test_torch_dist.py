"""Data-parallel fine-tuning of the PyTorch port across processes
(peneo_tpu_torch/parallel/dist.py, the trainer under DDP, the decoder's
global-batch losses), on the CPU over gloo.

Two rank processes are spawned as tests/test_multiprocess_e2e.py spawns its
workers (a free local port; ``--coordinator_address --num_processes
--process_id``, the JAX trainer's flags; each subprocess under a 120 s
timeout), with a tiny LiLT at dropout 0, and a one-process run of the same
global batches beside them. Checked:

1. the two ranks' loss trajectory over 4 steps equals the one-process run's
   (relative 1e-5), with plain CE and with OHEM, and the same on both ranks;
   both ranks resume from rank 0's step-2 checkpoint onto the same steps;
2. step 1's loss equals the JAX package's single-device loss on the same
   weights and the same global batch;
3. eval over dev files listed twice gives the same metrics on both ranks,
   equal to the one-process eval's, with the dedup count equal to the number
   of unique files;
4. rank 0's saved directory loads in one process, without ``module.``
   prefixes, and holds the weights both ranks ended with;
5. a mismatched ``output_dir`` raises on every rank;
6. ``steps_per_call`` 2 trains under the process group (no longer
   refused): both ranks log, call by call, the mean of the K = 1 run's two
   losses; ``--fsdp`` in one process trains exactly as without it (fsdp
   itself: tests/test_torch_fsdp.py; K in a group:
   tests/test_torch_steps_per_call_dist.py); ``--tp 2`` (run_rfund and
   serve) without a process group raises ``ValueError`` naming the launch
   (``--sp``: tests/test_torch_seq_parallel.py; tp itself:
   tests/test_torch_tensor_parallel*.py).

And in process: each rank's dropout seeds are offset by ``rank · 1000003``
and reach kernel #5's (LayoutLMv3) and #2's (LiLT) plain twins; the feed
gives each rank its rows of one global batch; the OHEM merge keeps the global
top k whatever the ties.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
L = 64
STEPS = 4
SAVE_EVERY = 2
B_RANK = 2  # per rank; the one-process run takes the global 4
EVAL_RANK = 3

torch.set_num_threads(1)

WORKER = r"""
import json, os, sys
repo, mode, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.parallel import dist as pdist
from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

args = run_rfund.build_argparser().parse_args(argv)
run_rfund.init_parallel(args)
cfg, model, train_ds, eval_ds, collator, tok = run_rfund.setup(args)
targs = run_rfund.training_arguments(args)
result = {"rank": pdist.rank(), "world": pdist.world()}
if mode == "refuse":
    targs.steps_per_call = 2
    trainer = PEneoTrainer(cfg, model, targs, train_ds, eval_ds, collator)
    log = trainer.log
    result["steps_per_call"] = []

    def capture(record):
        if "loss/total" in record:
            result["steps_per_call"].append(record["loss/total"])
        log(record)

    trainer.log = capture
    trainer.train()
    del trainer
    targs.steps_per_call = 1
    targs.output_dir = os.path.join(args.output_dir, f"rank{pdist.rank()}")
    try:
        PEneoTrainer(cfg, model, targs, train_ds, eval_ds, collator)
    except ValueError as e:
        result["output_dir"] = str(e)
else:
    # every dev file twice: the dedup must count each once
    items = [eval_ds[i] for i in range(len(eval_ds))] * 2
    trainer = PEneoTrainer(cfg, model, targs, train_ds, items, collator,
                           tokenizer=tok)
    losses = []
    log = trainer.log

    def capture(record):
        if "loss/total" in record:
            losses.append(record["loss/total"])
        log(record)

    trainer.log = capture
    trainer.train()
    trainer.save_model()
    result["losses"] = losses
    result["eval"] = trainer.evaluate()
    result["weights"] = {k: float(v.double().sum())
                         for k, v in trainer.model.state_dict().items()}
print("RESULT " + json.dumps(result), flush=True)
pdist.barrier()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _argv(model_dir, data_dir, out, per_rank, eval_rank):
    return ["--synthetic_data", "--model_name_or_path", model_dir,
            "--data_dir", data_dir, "--output_dir", out, "--device", "cpu",
            "--dtype", "float32", "--max_seq_len", str(L),
            "--max_steps", str(STEPS), "--logging_steps", "1",
            "--eval_steps", "0", "--save_steps", str(SAVE_EVERY),
            "--save_total_limit", "2",
            "--learning_rate", "1e-3", "--warmup_ratio", "0",
            "--per_device_train_batch_size", str(per_rank),
            "--per_device_eval_batch_size", str(eval_rank),
            "--metric_for_best_model", "", "--no_resume"]


def _launch(mode, argv, nproc):
    """``nproc`` worker processes (a process group when > 1); their
    RESULT records in rank order. A worker that fails or outlives the
    timeout fails the test, and every worker is killed."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(nproc):
        extra = ([] if nproc == 1 else
                 ["--coordinator_address", f"localhost:{port}",
                  "--num_processes", str(nproc), "--process_id", str(pid)])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, REPO, mode,
             json.dumps(argv + extra)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
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


def _write_model(path, ohem=None):
    from peneo_tpu_torch.config import LiltConfig, PEneoConfig
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.models.peneo import PEneoModel

    os.makedirs(path)
    tok = ToyTokenizer()
    kw = {} if ohem is None else dict(peneo_ohem_num_positive=ohem[0],
                                      peneo_ohem_num_negative=ohem[1])
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=tok.vocab_size, pad_token_id=0, hidden_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=L + 16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            # a wide init: distinct CE values, no ties at the k-th (a tie
            # may move OHEM's gradient between tied elements)
            initializer_range=0.15).to_dict(),
        pair_block_size=16, initializer_range=0.15,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0, **kw)
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(0))
    cfg.save_pretrained(path)
    tok.save_pretrained(path)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return path


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset

    root = str(tmp_path_factory.mktemp("dist_data"))
    write_rfund_dataset(root, "en", n_train=16, n_val=6, seed=3)
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_dir):
    """For plain CE and for OHEM 5/7: the two ranks' results and the
    one-process run's, from the same model directory."""
    base = tmp_path_factory.mktemp("dist_runs")
    out = {}
    for loss, ohem in (("ce", None), ("ohem", (5, 7))):
        model_dir = _write_model(str(base / f"model_{loss}"), ohem)
        out[loss] = {
            "model_dir": model_dir, "data_dir": data_dir,
            "dp": _launch("train", _argv(model_dir, data_dir,
                                         str(base / f"dp_{loss}"), B_RANK,
                                         EVAL_RANK), 2),
            "solo": _launch("train", _argv(model_dir, data_dir,
                                           str(base / f"solo_{loss}"),
                                           2 * B_RANK, 2 * EVAL_RANK), 1)[0],
            "dp_out": str(base / f"dp_{loss}")}
    return out


@pytest.mark.parametrize("loss", ["ce", "ohem"])
def test_two_ranks_reproduce_one_process(runs, loss):
    dp, solo = runs[loss]["dp"], runs[loss]["solo"]
    assert [r["world"] for r in dp] == [2, 2] and solo["world"] == 1
    assert len(solo["losses"]) == STEPS
    assert dp[0]["losses"] == dp[1]["losses"]
    np.testing.assert_allclose(dp[0]["losses"], solo["losses"], rtol=1e-5)
    # the runs moved: a trajectory of one repeated value would prove little
    assert solo["losses"][-1] < solo["losses"][0]


def test_ranks_resume_from_rank0_checkpoint(runs, tmp_path):
    """Both ranks restore rank 0's step-2 checkpoint (the model, the
    optimizer, every rank's RNG states, the feed position) and take the
    uninterrupted run's steps 3 and 4."""
    import shutil

    out = str(tmp_path / "resumed")
    shutil.copytree(runs["ce"]["dp_out"], out)
    shutil.rmtree(os.path.join(out, "checkpoints", f"checkpoint-{STEPS}"))
    argv = _argv(runs["ce"]["model_dir"], runs["ce"]["data_dir"], out, B_RANK,
                 EVAL_RANK)
    argv.remove("--no_resume")
    resumed = _launch("train", argv, 2)
    want = runs["ce"]["dp"][0]["losses"][SAVE_EVERY:]
    for r in resumed:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-6)


def test_step1_loss_equals_jax(runs, data_dir):
    import jax
    import jax.numpy as jnp

    from peneo_tpu.config import PEneoConfig as JaxConfig
    from peneo_tpu.models.peneo import PEneoModel as JaxModel
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.models.convert import state_dict_to_jax_params
    from peneo_tpu_torch.pipeline.loader import DataFeed, batch_arrays

    model_dir = runs["ce"]["model_dir"]
    args = run_rfund.build_argparser().parse_args(
        _argv(model_dir, data_dir, runs["ce"]["dp_out"], 2 * B_RANK, 1))
    cfg, _, train_ds, _, collator, _ = run_rfund.setup(args)
    feed = DataFeed(train_ds, collator, 2 * B_RANK, shuffle=True,
                    seed=args.seed)
    batch = batch_arrays(next(iter(feed)))
    params = state_dict_to_jax_params(
        torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                   weights_only=True), cfg)
    jcfg = JaxConfig.from_pretrained(model_dir)
    total = jax.jit(lambda p, b: JaxModel(jcfg, dtype=jnp.float32).apply(
        {"params": p}, b["input_ids"], b["bbox"], b["attention_mask"],
        labels=b["labels"], deterministic=True)["total"])(params, batch)
    for got in (runs["ce"]["dp"][0]["losses"][0],
                runs["ce"]["solo"]["losses"][0]):
        np.testing.assert_allclose(got, float(total), rtol=1e-5)


def test_eval_is_gathered_and_deduped(runs):
    n_unique = 6
    for loss in ("ce", "ohem"):
        dp, solo = runs[loss]["dp"], runs[loss]["solo"]
        a, b = dp[0]["eval"], dp[1]["eval"]
        timing = "eval_samples_per_second"
        assert {k: v for k, v in a.items() if k != timing} == \
            {k: v for k, v in b.items() if k != timing}
        assert a["num_sample_processed"] == n_unique
        assert solo["eval"]["num_sample_processed"] == n_unique
        for key, value in solo["eval"].items():
            if key != timing:
                np.testing.assert_allclose(a[key], value, rtol=1e-5,
                                           atol=1e-7, err_msg=key)


def test_rank0_save_loads_in_one_process(runs):
    from peneo_tpu_torch.config import PEneoConfig
    from peneo_tpu_torch.models.peneo import PEneoModel
    from peneo_tpu_torch.pipeline.infer import load_weights

    out = runs["ce"]["dp_out"]
    dp = runs["ce"]["dp"]
    assert os.path.exists(os.path.join(out, "log.jsonl"))
    assert os.path.exists(os.path.join(out, "log.rank1.jsonl"))
    saved = torch.load(os.path.join(out, "pytorch_model.bin"),
                       weights_only=True)
    assert not any(k.startswith("module.") for k in saved)
    model = PEneoModel(PEneoConfig.from_pretrained(out))
    load_weights(model, out)
    got = {k: float(v.double().sum()) for k, v in model.state_dict().items()}
    assert got == dp[0]["weights"] == dp[1]["weights"]
    with open(os.path.join(out, "checkpoints", f"checkpoint-{STEPS}",
                           "meta.json")) as f:
        assert json.load(f)["step"] == STEPS


@pytest.fixture(scope="module")
def refused(tmp_path_factory, data_dir):
    base = tmp_path_factory.mktemp("dist_refuse")
    model_dir = _write_model(str(base / "model"))
    return _launch("refuse", _argv(model_dir, data_dir, str(base / "out"),
                                   B_RANK, EVAL_RANK), 2)


def test_mismatched_output_dir_raises_on_every_rank(refused):
    assert [r["rank"] for r in refused] == [0, 1]
    for r in refused:
        assert "SAME output_dir" in r["output_dir"]


def test_steps_per_call_refused_under_dp(refused, runs):
    """No longer refused: K = 2 trains under dp, each call logging the
    fp32 mean of the K = 1 run's two losses (the same model and global
    batches), alike on both ranks."""
    k1 = runs["ce"]["dp"][0]["losses"]
    want = [float(torch.tensor(k1[i:i + 2]).mean()) for i in (0, 2)]
    for r in refused:
        assert r["steps_per_call"] == refused[0]["steps_per_call"]
        np.testing.assert_allclose(r["steps_per_call"], want, rtol=1e-6)


@pytest.mark.parametrize("case", ["tp", "fsdp"])
def test_unported_mesh_flags_raise(case, data_dir, tmp_path):
    """tp without a process group raises, naming the launch; ``--fsdp``,
    ported now, trains exactly as without it in one process (JAX's fsdp at
    dp 1); ``--dp 2`` without a group raises."""
    from peneo_tpu_torch import run_rfund

    if case == "tp":
        with pytest.raises(ValueError, match="--tp 2"):
            run_rfund.main(["--output_dir", str(tmp_path), "--device",
                            "cpu", "--tp", "2"])
    else:
        losses, model_dir = [], _write_model(str(tmp_path / "model"))
        for flags in ([], ["--fsdp"]):
            out = str(tmp_path / ("fsdp" if flags else "plain"))
            argv = _argv(model_dir, data_dir, out, 2, 2)
            argv[argv.index("--max_steps") + 1] = "2"
            _, trainer = run_rfund.run(
                run_rfund.build_argparser().parse_args(
                    argv + ["--do_train"] + flags))
            assert not trainer.fsdp and trainer.args.fsdp == bool(flags)
            losses.append(_log_losses(out))
        assert len(losses[0]) == 2 and losses[1] == losses[0]
    with pytest.raises(ValueError, match="--dp 2"):
        run_rfund.main(["--output_dir", str(tmp_path), "--device", "cpu",
                        "--dp", "2"])


def _log_losses(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r["loss/total"] for r in map(json.loads, f)
                if "loss/total" in r]


def test_serve_tp_raises(tmp_path):
    """Without a process group: tp serving needs one process per rank."""
    from peneo_tpu_torch import serve

    with pytest.raises(ValueError, match="--tp 2 .*torchrun"):
        serve.main(["--model_name_or_path", str(tmp_path), "--dir_image",
                    str(tmp_path), "--dir_ocr", str(tmp_path), "--device",
                    "cpu", "--tp", "2"])


# in process ----------------------------------------------------------------

def test_feed_gives_each_rank_its_rows_of_one_global_batch():
    from peneo_tpu_torch.pipeline.loader import DataFeed

    items = list(range(26))
    glob = DataFeed(items, list, batch_size=6, seed=5)
    parts = [DataFeed(items, list, batch_size=3, seed=5, rank=r, world=2)
             for r in range(2)]
    assert len(glob) == len(parts[0]) == len(parts[1]) == 4
    for epoch in range(2):  # a second epoch reshuffles on every rank alike
        whole = list(glob)
        split = list(zip(*parts))
        assert [a + b for a, b in split] == whole
    parts[1].set_state(1, 2)  # resume: global positions
    glob.set_state(1, 2)
    assert list(parts[1]) == [b[3:] for b in glob]


def test_ohem_merge_keeps_the_global_top_k_through_ties():
    """Each rank's share of the global top k (ties at the k-th value handed
    out in rank order): the shares hold k values whose sum is the global
    top k's."""
    from peneo_tpu_torch.parallel.dist import _rank_share

    rng = np.random.default_rng(0)
    for case in range(20):
        world, k = int(rng.integers(2, 5)), int(rng.integers(1, 9))
        # few distinct values: many ties; -inf pads some buffers
        vals = rng.integers(0, 4, (world, k)).astype(np.float32)
        vals[rng.random((world, k)) < 0.2] = -np.inf
        every = torch.from_numpy(-np.sort(-vals, axis=1))
        shares = [_rank_share(every[r], every, r) for r in range(world)]
        kept = torch.stack(shares)
        flat = every.reshape(-1)
        top = torch.topk(flat, k).values
        want = float(top[torch.isfinite(top)].sum())
        got = float(kept[torch.isfinite(kept)].sum())
        assert got == want, case
        assert int(torch.isfinite(kept).sum()) == int(
            torch.isfinite(top).sum()), case


def _tiny(family):
    from peneo_tpu_torch.config import (LayoutLMv3Config, LiltConfig,
                                        PEneoConfig)
    from peneo_tpu_torch.models.peneo import PEneoModel

    common = dict(vocab_size=60, hidden_size=48, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=48, pad_token_id=0,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1)
    if family == "v3":
        name, backbone = "layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=8, shape_size=8, input_size=32, **common)
    else:
        name, backbone = "lilt-infoxlm-base", LiltConfig(**common)
    cfg = PEneoConfig(backbone_name=name, backbone_config=backbone.to_dict(),
                      pair_block_size=16,
                      peneo_category_weights=[1.0, 10.0, 10.0])
    return PEneoModel(cfg).init_weights(torch.Generator().manual_seed(1))


@pytest.mark.parametrize("family", ["v3", "lilt"])
def test_rank_seed_offset_reaches_the_kernel_twin(family, monkeypatch):
    """Kernel #5's (LayoutLMv3) or #2's (LiLT) CPU twin draws its dropout
    bits from each layer's seed: on rank 1 that seed is rank 0's plus
    1000003, for the host-drawn seeds and the device-resident ones, and the
    two ranks' hidden states on one batch differ."""
    from peneo_tpu_torch.models import dropout_seeds as ds
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb

    ops = rb if family == "v3" else ba
    name = ("element_dropout_bits" if family == "v3"
            else "attention_dropout_bits")
    seen = []
    draw = getattr(ops, name)

    def record(seed, *a, **kw):
        seen.append(int(seed))
        return draw(seed, *a, **kw)

    monkeypatch.setattr(ops, name, record)
    model = _tiny(family).train()
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(2, 60, (2, 32)))
    x0 = torch.from_numpy(rng.integers(0, 900, (2, 32)))
    bbox = torch.stack([x0, x0, x0 + 40, x0 + 20], -1)
    spots = torch.tensor([[[1, 5, 1], [31, 31, 0]]] * 2)
    labels = {n: spots for n in ("line_extraction", "ent_linking_h2h",
                                 "ent_linking_t2t", "line_grouping_h2h",
                                 "line_grouping_t2t")}
    image = (torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(
        np.float32)) if family == "v3" else None)
    step = torch.tensor(3)
    sources = {"host": lambda r: ds.HostSeeds(
        torch.Generator().manual_seed(9), r),
               "device": lambda r: ds.StepSeeds(9, step, r)}
    visual = {"image": image} if family == "v3" else {}
    for kind, make in sources.items():
        hidden, seeds = [], []
        for r in (0, 1):
            seen.clear()
            with torch.no_grad():
                out = model(ids, bbox, torch.ones_like(ids), labels=labels,
                            generator=make(r), image=image)
                assert torch.isfinite(out["total"])
                hidden.append(model.backbone(
                    ids, bbox, torch.ones_like(ids), generator=make(r),
                    **visual)["last_hidden_state"])
            seeds.append(list(seen))
        assert len(seeds[0]) == 4, (kind, seeds)  # 2 layers, 2 forwards
        assert seeds[1] == [s + ds.RANK_STRIDE for s in seeds[0]], kind
        assert (hidden[0] - hidden[1]).abs().max() > 1e-3, kind


def test_backend_choice():
    """gloo on the CPU and on a card ranks share, NCCL with a card each; a
    forced NCCL where it cannot run raises, with the way out."""
    from peneo_tpu_torch.parallel.dist import choose_backend

    cpu = torch.device("cpu")
    assert choose_backend(cpu, 2) == "gloo"
    assert choose_backend(cpu, 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        choose_backend(cpu, 1, "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        choose_backend(cpu, 1, "mpi")
