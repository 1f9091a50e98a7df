"""Tensor parallelism of the PyTorch port across spawned processes: the
trainer, its checkpoints and the service at tp 2, on gloo CPU ranks
(tests/test_torch_tensor_parallel.py's harness), fp32, dropout 0, random
biases:

1. ``run_rfund --tp 2`` (CE and OHEM), ``--dp 2 --tp 2`` (OHEM) and ``--tp 2
   --sp 2`` (CE), 4 or 2 steps, reproduce one process's losses (relative
   1e-5) and eval metrics; the seed offsets are (d·tp + t) · 1000003;
2. checkpoints across tp sizes: a checkpoint written at tp 2 resumes at tp
   1 and one written at tp 1 resumes at tp 2, and the next steps' losses
   equal the uninterrupted run's (relative 1e-5); the ``pytorch_model.bin``
   that tp 2 writes holds the full shapes and the one-process values and
   reads into the JAX package through ``peneo_tpu/models/convert.py``;
3. ``serve --tp 2`` writes the records of one process and of the JAX
   package's ``InferenceService(tp=2)`` on tests/test_batch_serving.py's five
   pages.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import LiltConfig, PEneoConfig
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from test_torch_tensor_parallel import _rel, _results, _start

torch.set_num_threads(1)

# run_rfund -----------------------------------------------------------------

LT = 64   # the spawned runs' sequence length
RUN_STEPS = 4


def _write_model(path, ohem=None):
    from peneo_tpu_torch.config import LiltConfig as PortLilt
    from peneo_tpu_torch.data.synthetic import ToyTokenizer

    os.makedirs(path)
    tok = ToyTokenizer()
    kw = {} if ohem is None else dict(peneo_ohem_num_positive=ohem[0],
                                      peneo_ohem_num_negative=ohem[1])
    cfg = PortConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=PortLilt(
            vocab_size=tok.vocab_size, pad_token_id=0, hidden_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=LT + 16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            initializer_range=0.15).to_dict(),
        pair_block_size=16, initializer_range=0.15,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0, **kw)
    model = PortModel(cfg).init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    cfg.save_pretrained(path)
    tok.save_pretrained(path)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return path


def _argv(model_dir, data_dir, out, per_dp, steps=RUN_STEPS, **flags):
    argv = ["--synthetic_data", "--model_name_or_path", model_dir,
            "--data_dir", data_dir, "--output_dir", out, "--device", "cpu",
            "--dtype", "float32", "--max_seq_len", str(LT),
            "--max_steps", str(steps), "--logging_steps", "1",
            "--eval_steps", "0", "--save_steps", "2",
            "--save_total_limit", "3", "--learning_rate", "1e-3",
            "--warmup_ratio", "0", "--per_device_train_batch_size",
            str(per_dp), "--per_device_eval_batch_size", "4",
            "--metric_for_best_model", ""]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def _resume_dir(src, dst, step=2):
    """A fresh output dir holding only ``src``'s step-``step`` checkpoint."""
    import shutil

    os.makedirs(os.path.join(dst, "checkpoints"))
    name = f"checkpoint-{step}"
    shutil.copytree(os.path.join(src, "checkpoints", name),
                    os.path.join(dst, "checkpoints", name))
    return dst


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """CE and OHEM 5/7 at tp 2 and in one process (4 steps of 4, saving at
    steps 2 and 4), then dp 2 × tp 2 (OHEM) and tp 2 × sp 2 (CE) over 2
    steps and both resumes across tp sizes."""
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset

    base = tmp_path_factory.mktemp("tp_runs")
    data = str(base / "data")
    write_rfund_dataset(data, "en", n_train=16, n_val=6, seed=3)
    models = {loss: _write_model(str(base / f"model_{loss}"), ohem)
              for loss, ohem in (("ce", None), ("ohem", (5, 7)))}
    out = {k: str(base / k) for k in ("tp_ce", "tp_ohem", "solo_ce",
                                      "solo_ohem", "dp_tp", "tp_sp",
                                      "to_tp1", "to_tp2")}
    first = {
        "tp_ce": _start("train", _argv(models["ce"], data, out["tp_ce"], 4,
                                       tp=2), 2),
        "tp_ohem": _start("train", _argv(models["ohem"], data,
                                         out["tp_ohem"], 4, tp=2), 2),
        "solo_ce": _start("train", _argv(models["ce"], data, out["solo_ce"],
                                         4), 1),
        "solo_ohem": _start("train", _argv(models["ohem"], data,
                                           out["solo_ohem"], 4), 1)}
    runs = {k: _results(p) for k, p in first.items()}
    second = {
        "dp_tp": _start("train", _argv(models["ohem"], data, out["dp_tp"], 2,
                                       steps=2, dp=2, tp=2), 4),
        "tp_sp": _start("train", _argv(models["ce"], data, out["tp_sp"], 4,
                                       steps=2, tp=2, sp=2), 4),
        "to_tp1": _start("train", _argv(
            models["ce"], data, _resume_dir(out["tp_ce"], out["to_tp1"]),
            4), 1),
        "to_tp2": _start("train", _argv(
            models["ce"], data, _resume_dir(out["solo_ce"], out["to_tp2"]),
            4, tp=2), 2)}
    runs.update({k: _results(p) for k, p in second.items()})
    runs["dirs"] = out
    return runs


def _same_eval(a, b):
    timing = "eval_samples_per_second"
    for key, value in b.items():
        if key != timing:
            np.testing.assert_allclose(a[key], value, rtol=1e-5, atol=1e-7,
                                       err_msg=key)


@pytest.mark.parametrize("loss", ["ce", "ohem"])
def test_run_rfund_tp2_reproduces_one_process(train_runs, loss):
    tp, solo = train_runs[f"tp_{loss}"], train_runs[f"solo_{loss}"][0]
    assert [(r["world"], r["grid"]) for r in tp] == \
        [(2, [0, 0, 0]), (2, [0, 1, 0])]
    # the attention seeds are offset per (dp, tp) shard
    assert [r["seed_offset"] for r in tp] == [0, 1000003]
    assert len(solo["losses"]) == RUN_STEPS
    assert tp[0]["losses"] == tp[1]["losses"]
    np.testing.assert_allclose(tp[0]["losses"], solo["losses"], rtol=1e-5)
    assert solo["losses"][-1] != solo["losses"][0]
    for r in tp:
        assert r["eval"]["num_sample_processed"] == 6
        _same_eval(r["eval"], solo["eval"])


@pytest.mark.parametrize("grid,loss", [("dp_tp", "ohem"), ("tp_sp", "ce")])
def test_four_rank_grids_reproduce_one_process(train_runs, grid, loss):
    ranks = train_runs[grid]
    want = {"dp_tp": [[0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]],
            "tp_sp": [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1]]}[grid]
    assert [r["grid"] for r in ranks] == want
    offsets = {"dp_tp": [0, 1, 2, 3], "tp_sp": [0, 0, 1, 1]}[grid]
    assert [r["seed_offset"] for r in ranks] == [o * 1000003
                                                 for o in offsets]
    solo = train_runs[f"solo_{loss}"][0]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], solo["losses"][:2],
                                   rtol=1e-5)
        assert r["eval"]["num_sample_processed"] == 6


@pytest.mark.parametrize("run", ["to_tp1", "to_tp2"])
def test_checkpoints_resume_across_tp_sizes(train_runs, run):
    solo = train_runs["solo_ce"][0]
    for r in train_runs[run]:
        assert len(r["losses"]) == RUN_STEPS - 2
        np.testing.assert_allclose(r["losses"], solo["losses"][2:],
                                   rtol=1e-5)


def test_tp2_saved_model_is_full_and_reads_into_jax(train_runs):
    from peneo_tpu.models.convert import convert_peneo_checkpoint

    dirs = train_runs["dirs"]
    got = torch.load(os.path.join(dirs["tp_ce"], "pytorch_model.bin"),
                     weights_only=True)
    want = torch.load(os.path.join(dirs["solo_ce"], "pytorch_model.bin"),
                      weights_only=True)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        # a key bias shifts every score of a row alike: its gradient is 0 in
        # exact arithmetic, and Adam scales the rounding left in it to ±lr
        if not key.endswith("key.bias"):
            assert _rel(got[key].numpy(), value.numpy()) <= 1e-5, key
    cfg = PEneoConfig.from_pretrained(dirs["tp_ce"])
    tree = convert_peneo_checkpoint({k: v.numpy() for k, v in got.items()},
                                    cfg)
    ids = np.ones((1, 8), np.int32)
    init = jax.eval_shape(lambda: PEneoModel(cfg).init(
        jax.random.PRNGKey(0), ids, np.zeros((1, 8, 4), np.int32), ids,
        deterministic=True))["params"]
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda x: x.shape, init)


# serve --tp 2 -------------------------------------------------------------

def test_serve_tp2_writes_one_process_and_jax_records(tmp_path):
    from PIL import Image

    from peneo_tpu.data.synthetic import ToyTokenizer as JaxToyTokenizer
    from peneo_tpu.pipeline.infer import InferenceService as JaxService
    from peneo_tpu_torch.data.synthetic import (ToyTokenizer, make_document,
                                                render_page)

    tok = ToyTokenizer()
    wdir = str(tmp_path / "weights")
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=tok.vocab_size, hidden_size=48, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=96, pad_token_id=0,
            max_position_embeddings=LT + 8).to_dict(),
        pair_block_size=16, max_seq_len=LT, max_spots_per_head=LT * LT,
        initializer_range=0.15)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    ids = np.ones((1, LT), np.int32)
    params = jax.device_get(jax.jit(PEneoModel(cfg).init)(
        jax.random.PRNGKey(7), ids, np.zeros((1, LT, 4), np.int32),
        ids)["params"])
    torch.save(jax_params_to_state_dict(
        params, PortConfig.from_dict(cfg.to_dict())),
        os.path.join(wdir, "pytorch_model.bin"))
    img_dir, ocr_dir = tmp_path / "images", tmp_path / "ocr"
    img_dir.mkdir()
    ocr_dir.mkdir()
    rng = random.Random(5)
    for i in range(5):  # tests/test_batch_serving.py's pages
        doc = make_document(rng, f"p{i}.png", n_pairs=3, n_noise=1)
        Image.fromarray(render_page(doc)).save(img_dir / f"p{i}.png")
        with open(ocr_dir / f"p{i}.json", "w") as f:
            json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                       for e in doc["entities"] for ln in e["lines"]], f)

    def argv(out, **flags):
        a = ["--model_name_or_path", wdir, "--dir_image", str(img_dir),
             "--dir_ocr", str(ocr_dir), "--dir_save", str(out),
             "--device", "cpu", "--dtype", "float32", "--batch_size", "2",
             "--max_seq_len", str(LT)]
        for k, v in flags.items():
            a += [f"--{k}", str(v)]
        return a

    procs = _start("serve", argv(tmp_path / "tp.json", tp=2), 2)
    solo = _start("serve", argv(tmp_path / "solo.json"), 1)
    jax_results = JaxService(wdir, tokenizer=JaxToyTokenizer(),
                             dtype="float32", batch_size=2,
                             tp=2).run(str(img_dir), str(ocr_dir))
    ranks, one = _results(procs), _results(solo)[0]
    assert [r["pages"] for r in ranks] == [5, 5] and one["pages"] == 5
    with open(tmp_path / "tp.json") as f:
        got = json.load(f)
    with open(tmp_path / "solo.json") as f:
        want = json.load(f)
    assert list(got) == list(want) == [f"p{i}.png" for i in range(5)]
    for name, record in want.items():  # all but the timing
        for other in (got, jax_results):
            assert other[name]["kv_pairs"] == record["kv_pairs"], name
            assert other[name]["lines"] == record["lines"], name
    assert sum(len(r["lines"]) for r in want.values()) > 5
    assert sum(len(r["kv_pairs"]) for r in want.values()) > 0
