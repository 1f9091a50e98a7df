"""``steps_per_call`` K > 1 in a process group (the trainer's
``MultiTrainStep`` under DDP, sp, tp and fsdp), on gloo CPU ranks, fp32,
against K = 1 on the same ranks.

Two rank processes are spawned as tests/test_torch_dist.py spawns them (a
free local port, the JAX trainer's coordinator flags, a timeout); they run
``run_rfund`` for a sequence of configurations in one process group, with a
tiny LiLT at dropout 0.1 (hidden and attention), 4 steps of 2 rows a dp
index. Checked:

1. at dp 2, sp 2, tp 2 and dp 2 fsdp, K = 2 (each step's gradients
   averaged by ``replica_mean_grads``, or FSDP2) ends on K = 1's (DDP's,
   or FSDP2's) parameters bit for bit, and each call logs the fp32 mean of
   K = 1's two losses and grad norms bit for bit; both ranks log the same
   values (the JAX package's ``tests/test_multiprocess_e2e.py``
   two-process K = 2 case); ``--fsdp`` at tp 2 (dp 1) is the run without
   it;
2. the K steps draw the (dp, tp) shard's attention seeds: at dp 2 rank 1's
   seeds are rank 0's plus 1000003 and its keep flags differ (the
   counterpart of ``tests/test_torch_dist.py``'s K = 1 check) — with the
   seeds of shard 0 on both ranks, or without the gradient mean, check 1
   fails;
3. ``max_steps`` 5 rounds up to 6 at K = 2, and logging, eval and saving
   happen at the JAX ``crossed`` rule's steps on both ranks;
4. a K = 2 checkpoint resumes at K = 1 under dp, and a K = 1 one at K = 2,
   onto the uninterrupted runs' parameters bit for bit.

On the card (``cuda`` marker; skipped here): at NCCL world 1, a K = 2 run
(one CUDA graph a call) against K = 1 eager steps, and ``--fsdp`` (off at
dp 1) against DDP.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from peneo_tpu_torch.models.dropout_seeds import RANK_STRIDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
L = 64
STEPS = 4

torch.set_num_threads(1)

WORKER = r"""
import hashlib, json, os, shutil, sys
repo, spec = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.ops import biacm_attention as ba
from peneo_tpu_torch.parallel import dist as pdist
from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

draws = []
draw_bits = ba.attention_dropout_bits

def record_draw(seed, *a, **kw):
    bits = draw_bits(seed, *a, **kw)
    draws.append([int(seed), int(bits[0].sum()), int(bits[1].sum())])
    return bits

ba.attention_dropout_bits = record_draw
results = {}
for run in spec["runs"]:
    args = run_rfund.build_argparser().parse_args(run["argv"] + spec["coord"])
    run_rfund.init_parallel(args)
    if run.get("copy"):
        if pdist.rank() == 0:
            src, dst, drop = run["copy"]
            shutil.copytree(src, dst)
            shutil.rmtree(os.path.join(dst, "checkpoints", drop))
        pdist.barrier()
    cfg, model, train_ds, eval_ds, collator, tok = run_rfund.setup(args)
    trainer = PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                           train_ds, eval_ds, collator, tokenizer=tok)
    records = []
    log = trainer.log

    def capture(record, log=log):
        records.append(dict(record))
        log(record)

    trainer.log = capture
    draws.clear()
    trainer.train()
    state = trainer._full_model_state()
    results[run["name"]] = {
        "records": records, "step": trainer.step, "draws": list(draws),
        "fsdp": trainer.fsdp, "grad_sync": trainer.grad_sync is not None,
        "digests": {k: hashlib.sha256(v.detach().float().numpy().tobytes())
                    .hexdigest() for k, v in state.items()}}
    del trainer
print("RESULT " + json.dumps({"rank": pdist.rank(), "runs": results}),
      flush=True)
pdist.barrier()
pdist.shutdown()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(runs, logs, nproc=2):
    """The workers' RESULT records in rank order. Their output goes to
    files under ``logs`` (a pipe left unread fills up and stalls a rank in
    a collective); a worker that fails or outlives the timeout fails the
    test, and every worker is killed."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, paths = [], []
    for pid in range(nproc):
        paths.append(os.path.join(logs, f"rank{pid}.log"))
        with open(paths[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, REPO, json.dumps({
                    "runs": runs, "coord": [
                        "--coordinator_address", f"localhost:{port}",
                        "--num_processes", str(nproc), "--process_id",
                        str(pid)]})],
                stdout=log, stderr=subprocess.STDOUT, text=True, env=env))
    results = []
    try:
        for p, path in zip(procs, paths):
            p.wait(timeout=TIMEOUT)
            with open(path) as f:
                out = f.read()
            assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            results.append(json.loads(line[len("RESULT "):])["runs"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _write_model(path, hidden=48, heads=4, dropout=0.1):
    from peneo_tpu_torch.config import LiltConfig, PEneoConfig
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.models.peneo import PEneoModel

    os.makedirs(path)
    tok = ToyTokenizer()
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=tok.vocab_size, pad_token_id=0, hidden_size=hidden,
            num_hidden_layers=2, num_attention_heads=heads,
            intermediate_size=2 * hidden, max_position_embeddings=L + 16,
            hidden_dropout_prob=dropout,
            attention_probs_dropout_prob=dropout,
            initializer_range=0.15).to_dict(),
        pair_block_size=16, initializer_range=0.15,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0)
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(0))
    cfg.save_pretrained(path)
    tok.save_pretrained(path)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return path


def _argv(model_dir, data, out, k, *flags, steps=STEPS, fresh=True):
    return ["--synthetic_data", "--model_name_or_path", model_dir,
            "--data_dir", data, "--output_dir", out, "--device", "cpu",
            "--dtype", "float32", "--max_seq_len", str(L),
            "--max_steps", str(steps), "--logging_steps", "1",
            "--eval_steps", "0", "--save_steps", "2",
            "--save_total_limit", "2", "--learning_rate", "1e-3",
            "--warmup_ratio", "0", "--per_device_train_batch_size", "2",
            "--per_device_eval_batch_size", "2",
            "--metric_for_best_model", "", "--steps_per_call", str(k),
            *flags, *(["--no_resume"] if fresh else [])]


# the layouts of check 1: (name, flags)
LAYOUTS = (("dp2", ["--dp", "2"]), ("sp2", ["--sp", "2"]),
           ("tp2", ["--tp", "2"]), ("dp2_fsdp", ["--dp", "2", "--fsdp"]),
           ("tp2_fsdp", ["--tp", "2", "--fsdp"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset

    base = tmp_path_factory.mktemp("k_dist")
    data = str(base / "data")
    write_rfund_dataset(data, "en", n_train=16, n_val=4, seed=3)
    model = _write_model(str(base / "model"))
    plan = []
    for name, flags in LAYOUTS:
        for k in (1, 2):
            plan.append({"name": f"{name}_k{k}", "argv": _argv(
                model, data, str(base / f"{name}_k{k}"), k, *flags)})
    # the crossed rule: max_steps 5 → 6; log every 3, eval and save every 4
    rule = _argv(model, data, str(base / "rule"), 2, "--dp", "2", steps=5)
    for flag, value in (("--logging_steps", "3"), ("--eval_steps", "4"),
                        ("--save_steps", "4")):
        rule[rule.index(flag) + 1] = value
    plan.append({"name": "rule", "argv": rule})
    # resume across K: each run's step-2 checkpoint, at the other K
    for k, other in ((2, 1), (1, 2)):
        src, dst = str(base / f"dp2_k{k}"), str(base / f"resume_k{k}")
        plan.append({"name": f"resume_k{k}_at_k{other}",
                     "copy": [src, dst, f"checkpoint-{STEPS}"],
                     "argv": _argv(model, data, dst, other, "--dp", "2",
                                   fresh=False)})
    return Runs(_launch(plan, str(base)), str(base))


class Runs(list):
    """Each rank's results by run name, and the runs' directory."""

    def __init__(self, ranks, base):
        super().__init__(ranks)
        self.base = base


def _fp32_mean(values):
    return float(torch.tensor(values, dtype=torch.float32).mean())


def _logged(run, key="loss/total"):
    return [r[key] for r in run["records"] if key in r]


@pytest.mark.parametrize("layout", [name for name, _ in LAYOUTS])
def test_k2_equals_k1_bit_for_bit(runs, layout):
    for rank in runs:
        k1, k2 = rank[f"{layout}_k1"], rank[f"{layout}_k2"]
        assert k1["step"] == k2["step"] == STEPS
        assert k2["digests"] == k1["digests"]
        for key in ("loss/total", "loss/grad_norm"):
            per_step = _logged(k1, key)
            assert len(per_step) == STEPS
            assert _logged(k2, key) == [_fp32_mean(per_step[i:i + 2])
                                        for i in (0, 2)], key
    # both ranks log the same losses
    assert _logged(runs[0][f"{layout}_k2"]) == _logged(
        runs[1][f"{layout}_k2"])


@pytest.mark.parametrize("k", [1, 2])
def test_fsdp_at_dp1_trains_as_without_it(runs, k):
    """``--fsdp`` at dp 1 (tp 2) shards nothing and is off, as JAX's fsdp
    at dp 1: the run is the one without the flag, bit for bit; K = 1 runs
    under DDP, K = 2 with the all-reduce of ``replica_mean_grads``, and at
    dp 2 FSDP2 takes the place of both."""
    for rank in runs:
        got, want = rank[f"tp2_fsdp_k{k}"], rank[f"tp2_k{k}"]
        assert not got["fsdp"] and rank[f"dp2_fsdp_k{k}"]["fsdp"]
        assert got["grad_sync"] == (k > 1) == rank[f"dp2_k{k}"]["grad_sync"]
        assert got["digests"] == want["digests"]
        assert _logged(got) == _logged(want)


def test_k_steps_draw_each_shards_seeds(runs):
    """At dp 2 each rank's attention seeds are offset by its shard (d·tp +
    t), in the K-step loop as at K = 1, and the two ranks' keep flags
    differ."""
    ranks = [r["dp2_k2"]["draws"] for r in runs]
    assert len(ranks[0]) == STEPS * 2  # 2 layers a step
    assert ranks[0] != [] and len(ranks[0]) == len(ranks[1])
    for (s0, *flags0), (s1, *flags1) in zip(*ranks):
        assert s1 == s0 + RANK_STRIDE
        assert flags0 != flags1
    assert [d[0] for d in ranks[0]] == [
        d[0] for d in runs[0]["dp2_k1"]["draws"]]


def test_max_steps_rounds_up_and_intervals_follow_the_crossed_rule(runs):
    for rank in runs:
        rule = rank["rule"]
        assert rule["step"] == 6
        assert [r["step"] for r in rule["records"]
                if "loss/total" in r] == [4, 6]
        assert [r["step"] for r in rule["records"]
                if "eval/f1" in r] == [4]
    assert os.listdir(os.path.join(runs.base, "rule", "checkpoints")) == [
        "checkpoint-4"]


@pytest.mark.parametrize("k,other", [(2, 1), (1, 2)])
def test_checkpoint_resumes_at_the_other_k(runs, k, other):
    for rank in runs:
        resumed = rank[f"resume_k{k}_at_k{other}"]
        events = [r for r in resumed["records"] if r.get("event")
                  == "resumed"]
        assert [e["step"] for e in events] == [2]
        assert resumed["step"] == STEPS
        assert resumed["digests"] == rank[f"dp2_k{k}"]["digests"]


# on the card -----------------------------------------------------------------

@pytest.fixture
def card_model(tmp_path):
    """A LiLT whose heads the CUDA kernels take (text d 64, layout d 16),
    dropout 0, and a corpus; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset

    data = str(tmp_path / "data")
    write_rfund_dataset(data, "en", n_train=16, n_val=4, seed=3)
    return _write_model(str(tmp_path / "model"), hidden=128, heads=2,
                        dropout=0.0), data


def _cuda_run(tmp_path, card_model, *flags):
    """``run_rfund`` of 4 steps at NCCL world 1 on the card, bf16: the
    logged losses."""
    from peneo_tpu_torch import run_rfund

    model_dir, data = card_model
    out = str(tmp_path / ("_".join(f.strip("-") for f in flags) or "base"))
    argv = _argv(model_dir, data, out, 1, *flags)
    for flag in ("--device", "--dtype"):
        i = argv.index(flag)
        del argv[i:i + 2]
    run_rfund.main(argv + [
        "--do_train", "--save_steps", "0", "--coordinator_address",
        f"localhost:{_free_port()}", "--num_processes", "1",
        "--process_id", "0"])
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r["loss/total"] for r in map(json.loads, f)
                if "loss/total" in r]


@pytest.mark.cuda
def test_graph_replay_equals_eager_steps_at_nccl_world1(tmp_path,
                                                        card_model):
    """K = 2: one CUDA graph a call holding the captured gradient mean,
    against K = 1 eager steps under DDP (train_graph_parity's 1e-4)."""
    eager = _cuda_run(tmp_path, card_model)
    graph = _cuda_run(tmp_path, card_model, "--steps_per_call", "2")
    assert len(eager) == STEPS
    np.testing.assert_allclose(graph, [_fp32_mean(eager[i:i + 2])
                                       for i in (0, 2)], rtol=1e-4)


@pytest.mark.cuda
def test_fsdp_equals_ddp_at_nccl_world1(tmp_path, card_model):
    """``--fsdp`` at NCCL world 1 (dp 1) is off: DDP's run."""
    np.testing.assert_allclose(_cuda_run(tmp_path, card_model, "--fsdp"),
                               _cuda_run(tmp_path, card_model), rtol=1e-6)
