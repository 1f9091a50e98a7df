"""The PyTorch port's fine-tuning entry point end to end on the CPU
(``python -m peneo_tpu_torch.run_rfund --synthetic_data --synthetic_model
tiny --device cpu``, at L=128 to keep it small): it trains, evaluates,
checkpoints and saves; a second run resumes with the step count and the
feed position of the last checkpoint; ``evaluate()`` on the saved weights
gives the JAX ``PEneoTrainer.evaluate``'s KVPE metrics and losses (fp32,
losses rtol 1e-5; batches of 6 with a ragged, edge-padded last one against
JAX's 8); the saved ``pytorch_model.bin`` loads through the JAX
``load_params`` into arrays equal to the port's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import PEneoConfig as JaxConfig
from peneo_tpu.data.collator import PEneoCollator as JaxCollator
from peneo_tpu.data.datasets import RFUNDDataset as JaxRFUND
from peneo_tpu.data.fetchers import fetch_xlm as jax_fetch
from peneo_tpu.data.synthetic import ToyTokenizer as JaxToy
from peneo_tpu.models.peneo import PEneoModel as JaxModel
from peneo_tpu.pipeline.infer import load_params
from peneo_tpu.pipeline.trainer import PEneoTrainer as JaxTrainer
from peneo_tpu.pipeline.trainer import TrainingArguments as JaxArgs
from peneo_tpu_torch import run_rfund
from peneo_tpu_torch.models.convert import state_dict_to_jax_params
from peneo_tpu_torch.pipeline.trainer import PEneoTrainer, TrainingArguments

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 128
CLI = ["--synthetic_data", "--synthetic_model", "tiny", "--device", "cpu",
       "--eval_steps", "2", "--save_steps", "2", "--max_seq_len", str(L),
       "--per_device_eval_batch_size", "6", "--logging_steps", "1",
       "--do_train"]


def _records(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    res = subprocess.run(
        [sys.executable, "-m", "peneo_tpu_torch.run_rfund", *CLI,
         "--max_steps", "4", "--output_dir", out],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    return out


def test_cli_trains_evaluates_checkpoints_and_saves(trained):
    recs = _records(trained)
    steps = [r for r in recs if "loss/total" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss/total"]) for r in steps)
    assert [r["nonfinite_loss_steps"] for r in steps] == [0, 0, 0, 0]
    evals = [r for r in recs if "eval/f1" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(r["eval/num_sample_processed"] == 16 for r in evals)
    for name in ("config.json", "pytorch_model.bin", "toy_tokenizer.json"):
        assert os.path.exists(os.path.join(trained, name)), name
    ckpts = sorted(os.listdir(os.path.join(trained, "checkpoints")))
    assert "checkpoint-4" in ckpts and len(ckpts) <= 2  # newest + best


def test_resume_continues_steps_and_feed(trained, tmp_path):
    out = str(tmp_path / "resumed")
    import shutil

    shutil.copytree(trained, out)
    run_rfund.main([*CLI, "--max_steps", "6", "--output_dir", out])
    recs = _records(out)
    resumed = [r for r in recs if r.get("event") == "resumed"]
    # 4 batches of 4 consumed from epoch 0's order (64 pages, 16 batches)
    assert len(resumed) == 1 and resumed[0]["step"] == 4
    assert (resumed[0]["feed_epoch"], resumed[0]["feed_batch"]) == (0, 4)
    steps = [r["step"] for r in recs if "loss/total" in r]
    assert steps == [1, 2, 3, 4, 5, 6]
    with open(os.path.join(out, "checkpoints", "checkpoint-6",
                           "meta.json")) as f:
        assert json.load(f)["feed"] == [0, 6]


def test_saved_weights_load_into_jax(trained):
    from peneo_tpu_torch.config import PEneoConfig

    cfg = PEneoConfig.from_pretrained(trained)
    sd = torch.load(os.path.join(trained, "pytorch_model.bin"),
                    weights_only=True)
    ours = state_dict_to_jax_params(sd, cfg)
    theirs = load_params(trained, JaxConfig.from_pretrained(trained))
    flat = dict(jax.tree_util.tree_leaves_with_path(theirs))
    mine = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert set(flat) == set(mine)
    for key, value in flat.items():
        np.testing.assert_array_equal(np.asarray(value), mine[key],
                                      err_msg=jax.tree_util.keystr(key))


def test_evaluate_matches_jax_trainer(trained, tmp_path):
    args = run_rfund.build_argparser().parse_args(
        [*CLI, "--model_name_or_path", trained, "--output_dir",
         str(tmp_path / "port"), "--dtype", "float32"])
    cfg, model, _, eval_ds, collator, _ = run_rfund.setup(args)
    ours = PEneoTrainer(
        cfg, model, TrainingArguments(
            output_dir=str(tmp_path / "port"), per_device_eval_batch_size=6,
            detail_eval=True, device="cpu"),
        eval_dataset=eval_ds, collator=collator).evaluate()

    jcfg = JaxConfig.from_pretrained(trained)
    jcfg.max_seq_len = L
    data = os.path.join(trained, "synthetic_data")
    jds = JaxRFUND(data, "dev", "en", tokenizer=JaxToy(),
                   tokenizer_fetcher=jax_fetch, max_token_len=L - 1,
                   add_cls_token=True)
    theirs = JaxTrainer(
        jcfg, JaxModel(jcfg), JaxArgs(
            output_dir=str(tmp_path / "jax"), per_device_eval_batch_size=1,
            detail_eval=True),  # one row on each of the 8 CPU devices
        eval_dataset=jds,
        collator=JaxCollator(max_seq_len=L, labels_as_spots=True),
        params=load_params(trained, jcfg)).evaluate()

    assert ours["num_sample_processed"] == theirs["num_sample_processed"] == 16
    for key, value in theirs.items():
        if key == "eval_samples_per_second":
            continue
        if key.startswith("loss_"):
            np.testing.assert_allclose(ours[key], value, rtol=1e-5,
                                       err_msg=key)
        else:
            assert ours[key] == value, key


def test_trainer_without_a_device_needs_cuda(tmp_path):
    """No --device and no GPU: the entry point raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_rfund.main(["--synthetic_data", "--synthetic_model", "tiny",
                        "--max_seq_len", "64", "--do_train",
                        "--output_dir", str(tmp_path)])
