"""The PyTorch port's fine-tuning entry point end to end on the CPU
(``python -m peneo_tpu_torch.run_rfund --synthetic_data --synthetic_model
tiny --device cpu``, at L=128 to keep it small): it trains, evaluates,
checkpoints and saves; a second run resumes with the step count and the
feed position of the last checkpoint; ``evaluate()`` on the saved weights
gives the JAX ``PEneoTrainer.evaluate``'s KVPE metrics and losses (fp32,
losses rtol 1e-5; batches of 6 with a ragged, edge-padded last one against
JAX's 8); the saved ``pytorch_model.bin`` loads through the JAX
``load_params`` into arrays equal to the port's. The same entry point
trains, evaluates and saves LayoutLMv3 and LayoutXLM models (rendered page
images), whose saved directories serve a page, and whose evaluation equals
the JAX trainer's."""

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


# ------------------------------------------------------------- LayoutLMv3
V3_CLI = [*CLI, "--backbone_name", "layoutlmv3-base-chinese"]


@pytest.fixture(scope="module")
def trained_v3(tmp_path_factory):
    """The LayoutLMv3 family through the same entry point, in process: the
    synthetic corpus with rendered pages, CLS and SEP, the tiny preset with
    a 64 px image (17 visual tokens)."""
    out = str(tmp_path_factory.mktemp("run_v3"))
    metrics = run_rfund.main([*V3_CLI, "--max_steps", "2", "--do_eval",
                              "--dtype", "float32", "--output_dir", out])
    return out, metrics


def test_v3_cli_trains_evaluates_saves_and_the_directory_serves(trained_v3):
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.pipeline.infer import InferenceService

    out, metrics = trained_v3
    recs = _records(out)
    steps = [r for r in recs if "loss/total" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss/total"]) for r in steps)
    assert steps[-1]["nonfinite_loss_steps"] == 0
    evals = [r for r in recs if "eval/f1" in r]
    assert [r["step"] for r in evals] == [2]
    assert metrics["num_sample_processed"] == 16
    assert np.isfinite(metrics["loss_total"])
    for name in ("config.json", "pytorch_model.bin", "toy_tokenizer.json"):
        assert os.path.exists(os.path.join(out, name)), name
    sd = torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True)
    assert "backbone.encoder.rel_pos_x_bias.weight" in sd
    assert "backbone.patch_embed.proj.weight" in sd

    data = os.path.join(out, "synthetic_data")
    with open(os.path.join(data, "en.val.json")) as f:
        doc = json.load(f)["documents"][0]
    ocr = os.path.join(out, "page.json")
    with open(ocr, "w") as f:
        json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                   for e in doc["entities"] for ln in e["lines"]], f)
    svc = InferenceService(out, tokenizer=ToyTokenizer(), dtype="float32",
                           batch_size=1, max_seq_len=L, device="cpu")
    res = svc.run(os.path.join(data, "images", "en", doc["img"]["fname"]),
                  ocr)
    [record] = res.values()
    assert isinstance(record["kv_pairs"], list)
    assert isinstance(record["lines"], list)


def test_v3_evaluate_matches_jax_trainer(trained_v3, tmp_path):
    """KVPE metrics equal and losses rtol 1e-5 (fp32) on the 16 dev pages
    with their images, SEP inside the decoder's range."""
    from peneo_tpu.data.image_processing import make_image_loader

    trained = trained_v3[0]
    args = run_rfund.build_argparser().parse_args(
        [*V3_CLI, "--model_name_or_path", trained, "--output_dir",
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
                   add_cls_token=True, add_sep_token=True)
    theirs = JaxTrainer(
        jcfg, JaxModel(jcfg), JaxArgs(
            output_dir=str(tmp_path / "jax"), per_device_eval_batch_size=1,
            detail_eval=True),
        eval_dataset=jds,
        collator=JaxCollator(max_seq_len=L, labels_as_spots=True,
                             image_loader=make_image_loader(jcfg)),
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


# ------------------------------------------------------------- LayoutLMv2
V2_CLI = [*CLI, "--backbone_name", "layoutxlm-base"]


@pytest.fixture(scope="module")
def trained_v2(tmp_path_factory):
    """The LayoutXLM family through the same entry point, in process: the
    synthetic corpus with rendered pages, the tiny preset with a 56 px
    image through one block per ResNeXt stage (49 visual tokens)."""
    out = str(tmp_path_factory.mktemp("run_v2"))
    metrics = run_rfund.main([*V2_CLI, "--max_steps", "2", "--do_eval",
                              "--dtype", "float32", "--output_dir", out])
    return out, metrics


def test_v2_cli_trains_evaluates_saves_and_the_directory_serves(trained_v2):
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.pipeline.infer import InferenceService

    out, metrics = trained_v2
    recs = _records(out)
    steps = [r for r in recs if "loss/total" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss/total"]) for r in steps)
    assert steps[-1]["nonfinite_loss_steps"] == 0
    assert [r["step"] for r in recs if "eval/f1" in r] == [2]
    assert metrics["num_sample_processed"] == 16
    assert np.isfinite(metrics["loss_total"])
    with open(os.path.join(out, "config.json")) as f:
        bc = json.load(f)["backbone_config"]
    assert bc["visual_depths"] == [1, 1, 1, 1] and bc["input_size"] == 56
    sd = torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True)
    tower = "backbone.visual.backbone.bottom_up."
    assert "backbone.encoder.layer.1.attention.self.qkv_linear.weight" in sd
    assert tower + "res5.0.conv3.norm.running_var" in sd
    # the frozen norms' statistics stay as they were; their bias trained
    assert torch.equal(sd[tower + "stem.conv1.norm.running_mean"],
                       torch.zeros(64))
    assert sd[tower + "stem.conv1.norm.bias"].abs().max() > 0

    data = os.path.join(out, "synthetic_data")
    with open(os.path.join(data, "en.val.json")) as f:
        doc = json.load(f)["documents"][0]
    ocr = os.path.join(out, "page.json")
    with open(ocr, "w") as f:
        json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                   for e in doc["entities"] for ln in e["lines"]], f)
    svc = InferenceService(out, tokenizer=ToyTokenizer(), dtype="float32",
                           batch_size=1, max_seq_len=L, device="cpu")
    res = svc.run(os.path.join(data, "images", "en", doc["img"]["fname"]),
                  ocr)
    [record] = res.values()
    assert isinstance(record["kv_pairs"], list)
    assert isinstance(record["lines"], list)


def test_v2_evaluate_matches_jax_trainer(trained_v2, tmp_path):
    """KVPE metrics equal and losses rtol 1e-5 (fp32) on the 16 dev pages
    with their images, the JAX trainer on the port's saved weights (its
    torch-checkpoint converter reads only the full-depth tower, so the
    port's ``state_dict_to_jax_params`` carries them)."""
    from peneo_tpu.data.image_processing import make_image_loader
    from peneo_tpu_torch.config import PEneoConfig

    trained = trained_v2[0]
    args = run_rfund.build_argparser().parse_args(
        [*V2_CLI, "--model_name_or_path", trained, "--output_dir",
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
    params = state_dict_to_jax_params(
        torch.load(os.path.join(trained, "pytorch_model.bin"),
                   weights_only=True), PEneoConfig.from_pretrained(trained))
    theirs = JaxTrainer(
        jcfg, JaxModel(jcfg), JaxArgs(
            output_dir=str(tmp_path / "jax"), per_device_eval_batch_size=1,
            detail_eval=True),
        eval_dataset=jds,
        collator=JaxCollator(max_seq_len=L, labels_as_spots=True,
                             image_loader=make_image_loader(jcfg)),
        params=params).evaluate()

    assert ours["num_sample_processed"] == theirs["num_sample_processed"] == 16
    for key, value in theirs.items():
        if key == "eval_samples_per_second":
            continue
        if key.startswith("loss_"):
            np.testing.assert_allclose(ours[key], value, rtol=1e-5,
                                       err_msg=key)
        else:
            assert ours[key] == value, key
