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


# ---------------------------------------------------------------- bench.py
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
V3_TINY = dict({k: v for k, v in TINY.items()
                if k != "channel_shrink_ratio"},
               coordinate_size=8, shape_size=8, input_size=32)
V2_TINY = dict(V3_TINY, input_size=56, visual_depths=[1, 1, 1, 1])


def _bench_lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip()
            .splitlines()]


@pytest.mark.parametrize("backbone,extra,geometry,metric", [
    ("lilt", [], TINY, "pages_per_sec_per_chip_L64_bf16_batch_inference"),
    ("layoutlmv3", [], V3_TINY,
     "pages_per_sec_per_chip_layoutlmv3_L64_bf16_batch_inference"),
    ("layoutlmv2", [], V2_TINY,
     "pages_per_sec_per_chip_layoutlmv2_L64_bf16_batch_inference"),
    ("layoutlmv3", ["--no_image"], V3_TINY,
     "pages_per_sec_per_chip_layoutlmv3_textonly_L64_bf16_batch_inference"),
    ("lilt", ["--L", "512", "--no_fused_biacm", "--int8_pair_head"], TINY,
     "pages_per_sec_per_chip_L512_bf16_batch_inference"),
], ids=["lilt", "v3", "v2", "v3_textonly", "lilt_L512_plain_int8"])
def test_bench_prints_the_jax_line(backbone, extra, geometry, metric,
                                   tmp_path, capsys):
    """The last line has JAX's four keys and JAX's metric name; the
    lines before it give the device, the baseline's source and the run."""
    from peneo_tpu_torch import bench

    cache = tmp_path / "baseline.json"
    cache.write_text(json.dumps({"reference_cpu_pages_per_sec": 0.5}))
    argv = ["--backbone", backbone, "--B", "2", "--iters", "2", "--device",
            "cpu", "--baseline_cache", str(cache)]
    if "--L" not in extra:
        argv += ["--L", "64"]
    line = bench.main(argv + extra,
                      geometry=dict(geometry, vocab_size=120))
    lines = _bench_lines(capsys)
    assert lines[-1] == line and set(line) == BENCH_KEYS
    assert line["metric"] == metric and line["unit"] == "pages/s"
    assert line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.5,
                                                rel=1e-2)
    device, run = lines[0], lines[1]
    assert device["device"] == "cpu"
    assert device["baseline"] == {"source": "cache", "pages_per_s": 0.5}
    assert run["image"] == (backbone != "lilt" and "--no_image" not in extra)
    assert run["attention"] == ("plain" if "--no_fused_biacm" in extra
                                else "kernel")
    assert run["int8_pair_head"] == ("--int8_pair_head" in extra)
    # CPU tensors run the twins: no kernel is launched, no sync is checked
    assert run["launches"] == {"biacm_attention": 0, "bias_attention": 0}
    assert run["host_syncs_per_forward"] is None
    assert run["forward_wall_ms"] > 0 and run["pages_per_s"] > 0
    # 2 warm calls, 3 timed alone, the 2 iterations (no sync check here)
    assert run["forwards"] == 7


def test_bench_baseline_sources(tmp_path):
    """``vs_baseline``'s divisor: the cache file when it exists, else 1.0."""
    from peneo_tpu_torch import bench

    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps({"reference_cpu_pages_per_sec": 0.0346,
                                 "batch": 2, "seq_len": 512}))
    assert bench.reference_pages_per_sec(str(cache)) == (0.0346, "cache")
    missing = tmp_path / "none.json"
    assert bench.reference_pages_per_sec(str(missing)) == (1.0, "fallback")
    assert not missing.exists()
    # the repository's cached figure (the original PEneo on a CPU)
    value, source = bench.reference_pages_per_sec()
    assert source == "cache" and 0 < value < 1


def test_bench_fallback_divides_by_one(tmp_path, capsys):
    from peneo_tpu_torch import bench

    line = bench.main(["--L", "64", "--B", "2", "--iters", "1", "--device",
                       "cpu", "--baseline_cache",
                       str(tmp_path / "missing.json")],
                      geometry=dict(TINY, vocab_size=120))
    assert _bench_lines(capsys)[0]["baseline"]["source"] == "fallback"
    assert line["vs_baseline"] == pytest.approx(line["value"], rel=1e-2)


# ------------------------------------------------------- bench_sp_pair.py
def test_bench_sp_pair_lines_and_spots(capsys):
    """The device line, then JAX's three lines; at k above every candidate
    the bf16 sp spots (one rank's shard at size 1, merged) are the
    one-process decoder's spots exactly, as sets; the int8 line times the
    int8 pair head on the same weights."""
    from peneo_tpu_torch import bench_sp_pair
    from peneo_tpu_torch.models.decoder import HEAD_NAMES
    from peneo_tpu_torch.pipeline.decode import unpack_spots

    L, k = 48, 48 * 48
    out = bench_sp_pair.main(["--L", str(L), "--B", "2", "--iters", "2",
                              "--hidden", "48", "--k", str(k), "--device",
                              "cpu"], reference=True)
    lines = _bench_lines(capsys)
    assert lines[0]["device"] == "cpu" and len(lines) == 4
    for mode, line in zip(("bf16", "int8"), lines[1:3]):
        assert set(line) == {"mode", "L", "B", "ms_per_batch", "pages_per_s"}
        assert line["mode"] == mode and line["L"] == L and line["B"] == 2
        assert line == out[mode][0] and line["ms_per_batch"] > 0
    assert set(lines[3]) == {"L", "B", "int8_speedup"}
    assert lines[3] == out["speedup"] and lines[3]["int8_speedup"] > 0
    got = unpack_spots(*out["bf16"][1])
    want = unpack_spots(*out["one_process"])
    int8 = unpack_spots(*out["int8"][1])
    for name in HEAD_NAMES:
        for b in range(2):
            def spots(x):
                keep = x[name]["spot_score"][b] >= 0
                return sorted(zip(x[name]["spot_idx"][b][keep].tolist(),
                                  x[name]["spot_tag"][b][keep].tolist(),
                                  x[name]["spot_score"][b][keep].tolist()))
            assert len(spots(want)) > 0
            assert spots(got) == spots(want), (name, b)
            assert got[name]["spot_count"][b] == want[name]["spot_count"][b]
            assert int(got[name]["seq_len"][b]) == L
            assert int8[name]["spot_count"][b] > 0


@pytest.mark.parametrize("module", ["bench", "bench_sp_pair"])
def test_benches_need_a_card_without_device_cpu(module, monkeypatch):
    import importlib

    mod = importlib.import_module(f"peneo_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--iters", "1"])
