"""``steps_per_call`` and ``logging_dir`` in the PyTorch port's trainer end to
end on the CPU (``python -m peneo_tpu_torch.run_rfund --synthetic_data
--synthetic_model tiny --device cpu --steps_per_call 2``, at L=64): the
run counts K steps a call, so ``max_steps`` = 5 rounds up to 6, and it
logs, evaluates and saves at the steps the JAX trainer's rule gives
(``peneo_tpu/pipeline/trainer.py``: an interval is crossed when
``step // every`` grows over a call); a checkpoint written at K = 1 resumes
at K = 2 and the reverse, with the step, the feed position and the
learning-rate schedule's counter carried; ``--logging_dir`` writes
TensorBoard events whose scalars equal ``log.jsonl``'s."""

import json
import os

import numpy as np
import pytest
import torch

from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.pipeline import train as T

torch.set_num_threads(1)
CLI = ["--synthetic_data", "--synthetic_model", "tiny", "--device", "cpu",
       "--max_seq_len", "64", "--per_device_eval_batch_size", "8",
       "--do_train"]
LR = 5e-5  # run_rfund's default learning rate, warmup ratio 0.1


def _records(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _feed(out, step):
    with open(os.path.join(out, "checkpoints", f"checkpoint-{step}",
                           "meta.json")) as f:
        return json.load(f)["feed"]


def _jax_rule(every, k, max_steps, start=0):
    """The steps at which ``peneo_tpu/pipeline/trainer.py`` acts on an
    interval ``every`` in a run of K steps a call."""
    hits, step = [], start
    while step < max_steps:
        prev, step = step, step + k
        if every and step // every > prev // every:
            hits.append(step)
    return hits


@pytest.fixture(scope="module")
def run_k2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("k2"))
    run_rfund.main([*CLI, "--steps_per_call", "2", "--max_steps", "5",
                    "--logging_steps", "3", "--eval_steps", "4",
                    "--save_steps", "2", "--output_dir", out,
                    "--logging_dir", os.path.join(out, "tb")])
    return out


def test_k2_rounds_max_steps_up_and_follows_the_jax_rule(run_k2):
    recs = _records(run_k2)
    logged = [r["step"] for r in recs if "loss/total" in r]
    assert logged == _jax_rule(3, 2, 5) == [4, 6]
    assert all(np.isfinite(r["loss/total"]) for r in recs
               if "loss/total" in r)
    assert [r["nonfinite_loss_steps"] for r in recs
            if "loss/total" in r] == [0, 0]
    evals = [r["step"] for r in recs if "eval/f1" in r]
    assert evals == _jax_rule(4, 2, 5) == [4]
    ckpts = sorted(os.listdir(os.path.join(run_k2, "checkpoints")))
    assert "checkpoint-6" in ckpts  # saves at 2, 4, 6: newest + best kept
    # 6 batches of 4 consumed from epoch 0's order (16 batches an epoch)
    assert _feed(run_k2, 6) == [0, 6]
    # the mean learning rate of steps 4 and 5 (0-based) of a 5-step
    # schedule: the second is past its end
    sched = T.linear_schedule(LR, 5, 0.1)
    np.testing.assert_allclose(recs[[r.get("step") for r in recs].index(6)]
                               ["loss/learning_rate"],
                               (sched(4) + sched(5)) / 2, rtol=1e-6)
    for name in ("config.json", "pytorch_model.bin", "toy_tokenizer.json"):
        assert os.path.exists(os.path.join(run_k2, name)), name


def test_tensorboard_scalars_equal_the_log(run_k2):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(os.path.join(run_k2, "tb"))
    acc.Reload()
    want = {}
    for rec in _records(run_k2):
        if "step" not in rec:
            continue
        for key, value in rec.items():
            if isinstance(value, (int, float)) and key not in ("step",
                                                               "time"):
                want.setdefault(key, []).append((rec["step"], value))
    assert set(acc.Tags()["scalars"]) == set(want)
    for key, values in want.items():
        got = [(e.step, e.value) for e in acc.Scalars(key)]
        assert [s for s, _ in got] == [s for s, _ in values], key
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in values], rtol=1e-6,
                                   err_msg=key)


def _resumed(out):
    events = [r for r in _records(out) if r.get("event") == "resumed"]
    assert len(events) == 1
    return events[0]


def test_k1_checkpoint_resumes_at_k2(tmp_path):
    out = str(tmp_path / "k1")
    run_rfund.main([*CLI, "--max_steps", "3", "--logging_steps", "1",
                    "--eval_steps", "0", "--save_steps", "3",
                    "--output_dir", out])
    assert _feed(out, 3) == [0, 3]
    run_rfund.main([*CLI, "--steps_per_call", "2", "--max_steps", "7",
                    "--logging_steps", "1", "--eval_steps", "0",
                    "--save_steps", "1", "--output_dir", out])
    ev = _resumed(out)
    assert (ev["step"], ev["feed_epoch"], ev["feed_batch"]) == (3, 0, 3)
    recs = _records(out)
    logged = [r["step"] for r in recs if "loss/total" in r]
    assert logged == [1, 2, 3, 5, 7]
    assert _feed(out, 7) == [0, 7]
    # the schedule's counter was restored: steps 3 and 4 of a 7-step run
    sched = T.linear_schedule(LR, 7, 0.1)
    np.testing.assert_allclose(
        [r["loss/learning_rate"] for r in recs if r.get("step") == 5
         and "loss/total" in r], [(sched(3) + sched(4)) / 2], rtol=1e-6)


def test_k2_checkpoint_resumes_at_k1(tmp_path):
    out = str(tmp_path / "k2")
    run_rfund.main([*CLI, "--steps_per_call", "2", "--max_steps", "4",
                    "--logging_steps", "2", "--eval_steps", "0",
                    "--save_steps", "2", "--output_dir", out])
    assert _feed(out, 4) == [0, 4]
    run_rfund.main([*CLI, "--max_steps", "6", "--logging_steps", "1",
                    "--eval_steps", "0", "--save_steps", "1",
                    "--output_dir", out])
    ev = _resumed(out)
    assert (ev["step"], ev["feed_epoch"], ev["feed_batch"]) == (4, 0, 4)
    logged = [r["step"] for r in _records(out) if "loss/total" in r]
    assert logged == [2, 4, 5, 6]
    assert _feed(out, 6) == [0, 6]
    sched = T.linear_schedule(LR, 6, 0.1)
    np.testing.assert_allclose(
        [r["loss/learning_rate"] for r in _records(out)
         if r.get("step") == 5 and "loss/total" in r], [sched(4)], rtol=1e-6)


def _parent_format(path, total_steps):
    """Rewrite a checkpoint's ``state.pt`` as the port wrote it before the
    schedule moved to the device: a ``LambdaLR`` state dict stepped once
    per optimizer step, and float learning rates in the AdamW's groups."""
    state = torch.load(path, weights_only=False)
    count = state["scheduler"]["count"]
    groups = state["optimizer"]["param_groups"]
    params = [torch.nn.Parameter(torch.zeros(1)) for _ in groups]
    opt = torch.optim.AdamW([{"params": [p], "lr": float(g["initial_lr"])}
                             for p, g in zip(params, groups)])
    multiplier = T.linear_schedule(1.0, total_steps, 0.1)
    lambda_lr = torch.optim.lr_scheduler.LambdaLR(opt, multiplier)
    for _ in range(count):
        opt.step()
        lambda_lr.step()
    state["scheduler"] = lambda_lr.state_dict()
    for group, lr in zip(groups, lambda_lr.get_last_lr()):
        group["lr"] = lr
        group["capturable"] = False
    torch.save(state, path)


def test_older_lambda_lr_checkpoint_resumes(tmp_path):
    """A checkpoint in the older format (``LambdaLR`` state, float rates)
    resumes where an uninterrupted run goes on: the schedule's counter is
    the ``LambdaLR``'s ``last_epoch``, and the losses and rates of the
    remaining steps equal the uninterrupted run's."""
    args = [*CLI, "--max_steps", "6", "--logging_steps", "1",
            "--eval_steps", "0", "--save_steps", "3", "--save_total_limit",
            "0"]
    whole = str(tmp_path / "whole")
    run_rfund.main([*args, "--output_dir", whole])
    resumed = str(tmp_path / "resumed")
    src = os.path.join(whole, "checkpoints", "checkpoint-3")
    dst = os.path.join(resumed, "checkpoints", "checkpoint-3")
    os.makedirs(dst)
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as f, \
                open(os.path.join(dst, name), "wb") as g:
            g.write(f.read())
    _parent_format(os.path.join(dst, "state.pt"), 6)
    assert "last_epoch" in torch.load(os.path.join(dst, "state.pt"),
                                      weights_only=False)["scheduler"]
    run_rfund.main([*args, "--output_dir", resumed])
    ev = _resumed(resumed)
    assert (ev["step"], ev["feed_epoch"], ev["feed_batch"]) == (3, 0, 3)

    def after_3(out):
        return {r["step"]: (r["loss/total"], r["loss/learning_rate"])
                for r in _records(out) if "loss/total" in r
                and r["step"] > 3}

    got, want = after_3(resumed), after_3(whole)
    assert sorted(got) == sorted(want) == [4, 5, 6]
    np.testing.assert_allclose([got[s] for s in (4, 5, 6)],
                               [want[s] for s in (4, 5, 6)], rtol=1e-6)
