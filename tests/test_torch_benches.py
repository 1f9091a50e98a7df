"""The port's serving and eval benches (``peneo_tpu_torch/bench_serving.py``,
``bench_eval.py``) at tiny sizes on the CPU, and the eval loop's
``PENEO_EVAL_SEQUENTIAL`` switch (``pipeline/trainer.py`` ``evaluate``, the
counterpart of ``peneo_tpu/pipeline/trainer.py:507-510``): the serving
bench prints its JSON line with the JAX tool's keys, ``--dp`` without a
process group raises, both eval modes give identical metrics, and the
switch orders each batch's decode before the next dispatch."""

import json
import os

import pytest
import torch

from peneo_tpu_torch import bench_eval, bench_serving
from peneo_tpu_torch.pipeline import trainer as port_trainer

torch.set_num_threads(1)
TINY = dict(hidden_size=48, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=96, channel_shrink_ratio=4)
JAX_KEYS = {"metric", "value", "unit", "pages", "batch", "L", "workers",
            "buckets", "mixed_lines"}


def test_bench_serving_prints_its_json_line(tmp_path, capsys):
    root = str(tmp_path / "assets")
    bench_serving.build_assets(root, 4, 64, 6, "lilt", geometry=TINY)
    line = bench_serving.main(["--keep_dir", root, "--pages", "4", "--L",
                               "64", "--batch", "2", "--workers", "2",
                               "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert JAX_KEYS <= set(printed)
    assert printed["metric"] == "serving_pages_per_sec_e2e"
    assert printed["pages"] == 4 and printed["value"] > 0
    assert printed["device"] == "cpu" and printed["unit"] == "pages/s"
    assert os.path.isdir(root)  # --keep_dir keeps the assets


def test_bench_serving_dp_needs_a_process_group():
    with pytest.raises(ValueError, match="one process per rank"):
        bench_serving.main(["--dp", "2", "--device", "cpu"])


def test_bench_eval_modes_give_identical_metrics(capsys):
    line, metrics = bench_eval.main(
        ["--pages", "6", "--B", "2", "--L", "64", "--iters", "1",
         "--hidden", "48", "--layers", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(line))
    seq, pipe = metrics["sequential"], metrics["pipelined"]
    assert seq["num_sample_processed"] == 6
    assert {k: v for k, v in seq.items() if "per_second" not in k} \
        == {k: v for k, v in pipe.items() if "per_second" not in k}
    assert "PENEO_EVAL_SEQUENTIAL" not in os.environ


@pytest.mark.parametrize("sequential", [False, True])
def test_eval_sequential_switch_orders_the_loop(sequential, monkeypatch,
                                                 tmp_path):
    """Pipelined: batch 1 is dispatched before batch 0's decode starts.
    Sequential: batch 0's decode ends before batch 1 is dispatched."""
    from peneo_tpu_torch.config import LiltConfig, PEneoConfig
    from peneo_tpu_torch.data.collator import PEneoCollator
    from peneo_tpu_torch.data.datasets import RFUNDDataset
    from peneo_tpu_torch.data.fetchers import fetch_xlm
    from peneo_tpu_torch.data.synthetic import ToyTokenizer, \
        write_rfund_dataset
    from peneo_tpu_torch.models.peneo import PEneoModel

    events = []
    eval_step, decode_batch = port_trainer.T.eval_step, \
        port_trainer.dec.decode_batch

    def dispatch(*a, **kw):
        events.append("dispatch")
        return eval_step(*a, **kw)

    def decode(*a, **kw):
        events.append("decode")
        out = decode_batch(*a, **kw)
        events.append("decoded")
        return out

    monkeypatch.setattr(port_trainer.T, "eval_step", dispatch)
    monkeypatch.setattr(port_trainer.dec, "decode_batch", decode)
    monkeypatch.setenv("PENEO_EVAL_SEQUENTIAL", "1" if sequential else "0")
    root = write_rfund_dataset(str(tmp_path / "data"), n_train=2, n_val=4)
    tok = ToyTokenizer()
    ds = RFUNDDataset(root, "dev", "en", tokenizer=tok,
                      tokenizer_fetcher=fetch_xlm, max_token_len=63,
                      add_cls_token=True)
    cfg = PEneoConfig(backbone_name="lilt-infoxlm-base",
                      backbone_config=LiltConfig(
                          vocab_size=tok.vocab_size,
                          max_position_embeddings=72, **TINY).to_dict(),
                      max_seq_len=64, max_spots_per_head=64, dtype="float32")
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(0))
    port_trainer.PEneoTrainer(
        cfg, model, port_trainer.TrainingArguments(
            output_dir=str(tmp_path / "run"), per_device_eval_batch_size=2,
            device="cpu"),
        eval_dataset=ds, collator=PEneoCollator(max_seq_len=64)).evaluate()
    assert events.count("dispatch") == 2 and events.count("decoded") == 2
    second = events.index("dispatch", 1)
    if sequential:
        assert events[:second] == ["dispatch", "decode", "decoded"]
    else:
        assert events[:2] == ["dispatch", "dispatch"]
