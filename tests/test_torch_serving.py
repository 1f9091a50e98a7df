"""Serving of the PyTorch port (peneo_tpu_torch/pipeline/infer.py): on one
synthetic page directory and one ``pytorch_model.bin`` written by the port,
the JAX InferenceService and the port's (device="cpu", fp32) return the
same kv pairs and lines; the port's results do not depend on batch size or
pipeline depth; and an entry point with no device on a machine without CUDA
raises instead of running on the CPU. The same parity for a LayoutLMv3
model (page images, CLS and SEP), whose raw uint8 pages normalized by
``device_image_normalize`` equal the host-normalized floats bit for bit, and
for a LayoutLMv2 model (BGR 0-255 pages through a one-block-per-stage
ResNeXt tower). A model directory whose config sets an int8 switch serves
int8 and returns the JAX service's records."""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline.infer import InferenceService as JaxService
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.data.synthetic import ToyTokenizer, make_document, \
    render_page
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.pipeline.infer import InferenceService
from peneo_tpu_torch.serve import main as serve_main

torch.set_num_threads(1)
L = 64


@pytest.fixture(scope="module")
def serving_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    tok = ToyTokenizer()
    wdir = str(root / "weights")
    # every triu spot fits the compact top-k (no truncation ties); decoder
    # init 0.15 makes the random model's decisions far from fp32 rounding
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=tok.vocab_size, hidden_size=48, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=96, pad_token_id=0,
            max_position_embeddings=L + 8).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=L * L,
        initializer_range=0.15)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    ids = np.ones((1, L), np.int32)
    params = jax.device_get(jax.jit(PEneoModel(cfg).init)(
        jax.random.PRNGKey(7), ids, np.zeros((1, L, 4), np.int32),
        ids)["params"])
    torch.save(jax_params_to_state_dict(
        params, PortConfig.from_dict(cfg.to_dict())),
        os.path.join(wdir, "pytorch_model.bin"))

    from PIL import Image

    img_dir = str(root / "images")
    ocr_dir = str(root / "ocr")
    os.makedirs(img_dir)
    os.makedirs(ocr_dir)
    rng = random.Random(5)
    for i in range(5):  # 5 pages, batch 2 → padded tail group
        doc = make_document(rng, f"p{i}.png", n_pairs=3, n_noise=1)
        Image.fromarray(render_page(doc)).save(f"{img_dir}/p{i}.png")
        ocr = [{"text": ln["text"], "bbox": ln["bbox"]}
               for e in doc["entities"] for ln in e["lines"]]
        with open(f"{ocr_dir}/p{i}.json", "w") as f:
            json.dump(ocr, f)
    return wdir, img_dir, ocr_dir, tok


@pytest.fixture(scope="module")
def port_results(serving_setup):
    wdir, img_dir, ocr_dir, tok = serving_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    return svc.run(img_dir, ocr_dir)


@pytest.fixture(scope="module")
def v3_setup(serving_setup, tmp_path_factory):
    """A LayoutLMv3 model directory (32 px image: 5 visual tokens) beside
    the pages of ``serving_setup``."""
    _, img_dir, ocr_dir, tok = serving_setup
    wdir = str(tmp_path_factory.mktemp("serve_v3") / "weights")
    cfg = PEneoConfig(
        backbone_name="layoutlmv3-base-chinese",
        backbone_config=LayoutLMv3Config(
            vocab_size=tok.vocab_size, hidden_size=48, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=96, pad_token_id=0,
            max_position_embeddings=L + 8, coordinate_size=8, shape_size=8,
            input_size=32).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=L * L,
        initializer_range=0.15)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    ids = np.ones((1, L), np.int32)
    params = jax.device_get(jax.jit(
        lambda i, b, img: PEneoModel(cfg).init(
            jax.random.PRNGKey(11), i, b, i, image=img))(
        ids, np.zeros((1, L, 4), np.int32),
        np.zeros((1, 3, 32, 32), np.float32))["params"])
    rng = np.random.default_rng(4)  # zero at init: let the image matter
    for name in ("cls_token", "pos_embed"):
        params["backbone"][name] = (rng.standard_normal(
            params["backbone"][name].shape) * 0.15).astype(np.float32)
    torch.save(jax_params_to_state_dict(
        params, PortConfig.from_dict(cfg.to_dict())),
        os.path.join(wdir, "pytorch_model.bin"))
    return wdir, img_dir, ocr_dir, tok


def test_v3_port_matches_jax_service(v3_setup):
    wdir, img_dir, ocr_dir, tok = v3_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    assert svc.info.add_sep_token and svc.max_token_len == L - 2
    got = svc.run(img_dir, ocr_dir)
    want = JaxService(wdir, tokenizer=tok, dtype="float32",
                      batch_size=2).run(img_dir, ocr_dir)
    assert set(got) == set(want) and len(want) == 5
    assert sum(len(v["lines"]) for v in want.values()) > 0
    assert sum(len(v["kv_pairs"]) for v in want.values()) > 0
    assert _kv_and_lines(got) == _kv_and_lines(want)
    # bucketed batches cut the sequence axis, never the image
    bucketed = InferenceService(wdir, tokenizer=tok, dtype="float32",
                                batch_size=2, device="cpu",
                                bucket_lengths=[32, 48]).run(img_dir, ocr_dir)
    assert _kv_and_lines(bucketed) == _kv_and_lines(got)


def test_v3_raw_and_host_normalized_images_are_bit_identical(v3_setup):
    from peneo_tpu.data.image_processing import layoutlmv3_preprocess
    from peneo_tpu_torch.data.image_processing import (
        device_image_normalize, make_image_loader)

    wdir, img_dir, ocr_dir, tok = v3_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    arrays = svc.preprocess_page(f"{img_dir}/p0.png", f"{ocr_dir}/p0.json")[0]
    raw = arrays["image"]
    assert raw.dtype == np.uint8 and raw.shape == (32, 32, 3)
    on_device = device_image_normalize(torch.from_numpy(raw.copy())[None],
                                       "layoutlmv3")
    host = make_image_loader(svc.cfg)(f"{img_dir}/p0.png")
    assert on_device.dtype == torch.float32 and host.dtype == np.float32
    np.testing.assert_array_equal(on_device[0].numpy(), host)
    np.testing.assert_array_equal(
        host, layoutlmv3_preprocess(f"{img_dir}/p0.png", 32))
    assert len(np.unique(raw)) > 1  # the page is not blank
    # the preprocessor survives pickling (its loader closure is rebuilt)
    import pickle

    prep = pickle.loads(pickle.dumps(svc.page_preprocessor()))
    again = prep(f"{img_dir}/p0.png", f"{ocr_dir}/p0.json")[0]
    np.testing.assert_array_equal(again["image"], raw)


@pytest.fixture(scope="module")
def v2_setup(serving_setup, tmp_path_factory):
    """A LayoutLMv2 model directory (56 px image, ResNeXt depths 1-1-1-1)
    beside the pages of ``serving_setup``: ``pytorch_model.bin`` for the
    port and the same weights as ``params.msgpack`` for the JAX service,
    whose torch-checkpoint converter reads only the full-depth tower."""
    from peneo_tpu.pipeline.checkpoint import save_params_msgpack

    _, img_dir, ocr_dir, tok = serving_setup
    wdir = str(tmp_path_factory.mktemp("serve_v2") / "weights")
    cfg = PEneoConfig(
        backbone_name="layoutxlm-base",
        backbone_config=LayoutLMv2Config(
            vocab_size=tok.vocab_size, hidden_size=48, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=96, pad_token_id=0,
            max_position_embeddings=L + 8, coordinate_size=8, shape_size=8,
            visual_depths=[1, 1, 1, 1], input_size=56).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=L * L,
        initializer_range=0.15)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    ids = np.ones((1, L), np.int32)
    params = jax.device_get(jax.jit(
        lambda i, b, img: PEneoModel(cfg).init(
            jax.random.PRNGKey(13), i, b, i, image=img))(
        ids, np.zeros((1, L, 4), np.int32),
        np.zeros((1, 3, 56, 56), np.float32))["params"])
    save_params_msgpack(params, os.path.join(wdir, "params.msgpack"))
    torch.save(jax_params_to_state_dict(
        params, PortConfig.from_dict(cfg.to_dict())),
        os.path.join(wdir, "pytorch_model.bin"))
    return wdir, img_dir, ocr_dir, tok


def test_v2_port_matches_jax_service(v2_setup):
    wdir, img_dir, ocr_dir, tok = v2_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    assert svc.info.family == "layoutlmv2" and svc.max_token_len == L - 1
    got = svc.run(img_dir, ocr_dir)
    want = JaxService(wdir, tokenizer=tok, dtype="float32",
                      batch_size=2).run(img_dir, ocr_dir)
    assert set(got) == set(want) and len(want) == 5
    assert sum(len(v["lines"]) for v in want.values()) > 0
    assert sum(len(v["kv_pairs"]) for v in want.values()) > 0
    assert _kv_and_lines(got) == _kv_and_lines(want)


def test_v2_raw_and_host_normalized_images_are_bit_identical(v2_setup):
    """The served uint8 RGB page, flipped to BGR on the device, equals the
    host loader's BGR 0-255 floats (the port's and the JAX package's)."""
    from peneo_tpu.data.image_processing import layoutlmv2_preprocess
    from peneo_tpu_torch.data.image_processing import (
        device_image_normalize, make_image_loader)

    wdir, img_dir, ocr_dir, tok = v2_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    raw = svc.preprocess_page(f"{img_dir}/p1.png", f"{ocr_dir}/p1.json")[0][
        "image"]
    assert raw.dtype == np.uint8 and raw.shape == (56, 56, 3)
    on_device = device_image_normalize(torch.from_numpy(raw.copy())[None],
                                       "layoutlmv2")
    host = make_image_loader(svc.cfg)(f"{img_dir}/p1.png")
    assert on_device.dtype == torch.float32 and host.dtype == np.float32
    np.testing.assert_array_equal(on_device[0].numpy(), host)
    np.testing.assert_array_equal(
        host, layoutlmv2_preprocess(f"{img_dir}/p1.png", 56))
    np.testing.assert_array_equal(host[0], raw[..., 2])  # B of RGB first
    assert len(np.unique(raw)) > 1  # the page is not blank


@pytest.mark.parametrize("switch", ["quantize_pair_head",
                                    "quantize_backbone"])
def test_int8_switches_serve_like_jax(serving_setup, tmp_path, switch):
    """A model directory whose config sets an int8 switch: the port serves
    it with int8 matmuls (the CPU twin of the s32 product) and returns the
    JAX service's records on the same directory."""
    import shutil

    wdir, img_dir, ocr_dir, tok = serving_setup
    int8_dir = str(tmp_path / "int8")
    shutil.copytree(wdir, int8_dir)
    cfg = PortConfig.from_pretrained(int8_dir)
    setattr(cfg, switch, "int8")
    cfg.save_pretrained(int8_dir)
    svc = InferenceService(int8_dir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    assert getattr(svc.model.cfg, switch) == "int8"
    got = svc.run(img_dir, ocr_dir)
    jax_svc = JaxService(int8_dir, tokenizer=tok, dtype="float32",
                         batch_size=2)
    assert getattr(jax_svc.cfg, switch) == "int8"
    want = jax_svc.run(img_dir, ocr_dir)
    assert set(got) == set(want) and len(want) == 5
    assert sum(len(v["lines"]) for v in want.values()) > 0
    assert _kv_and_lines(got) == _kv_and_lines(want)


def _kv_and_lines(results):
    return {k: (v["kv_pairs"], v["lines"]) for k, v in results.items()}


def test_port_matches_jax_service(serving_setup, port_results):
    wdir, img_dir, ocr_dir, tok = serving_setup
    jax_results = JaxService(wdir, tokenizer=tok, dtype="float32",
                             batch_size=2).run(img_dir, ocr_dir)
    assert set(port_results) == set(jax_results) and len(jax_results) == 5
    assert sum(len(v["lines"]) for v in jax_results.values()) > 0
    assert sum(len(v["kv_pairs"]) for v in jax_results.values()) > 0
    assert _kv_and_lines(port_results) == _kv_and_lines(jax_results)


@pytest.mark.parametrize("batch_size,depth", [(1, 1), (2, 1), (2, 3)])
def test_port_batch_and_depth_invariance(serving_setup, port_results,
                                         batch_size, depth):
    wdir, img_dir, ocr_dir, tok = serving_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=batch_size, device="cpu")
    got = svc.run(img_dir, ocr_dir, inflight_depth=depth)
    assert _kv_and_lines(got) == _kv_and_lines(port_results)
    assert svc.last_run["pages"] == 5


def test_streaming_service_serves_the_dense_records(serving_setup,
                                                   port_results):
    """``spot_streaming=True`` (each row block reduced to its top-k
    candidates, no dense maps) returns the dense service's records; None
    leaves it off, as JAX's service does."""
    wdir, img_dir, ocr_dir, tok = serving_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu", spot_streaming=True)
    assert svc.cfg.spot_streaming and svc.model.cfg.spot_streaming
    got = svc.run(img_dir, ocr_dir)
    assert _kv_and_lines(got) == _kv_and_lines(port_results)
    off = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    assert not off.cfg.spot_streaming


def test_dispatch_and_collect_match_run(serving_setup, port_results):
    """The two halves of the pipelined loop, called by hand on one padded
    tail batch (one page for batch_size 2), give run()'s records."""
    wdir, img_dir, ocr_dir, tok = serving_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    pages = [svc.preprocess_page(f"{img_dir}/p4.png", f"{ocr_dir}/p4.json")]
    [(kv_pairs, lines)] = svc.collect_batch(svc.dispatch_batch(pages), pages)
    rec = port_results["p4.png"]
    assert [(k, v, list(kb), list(vb)) for k, v, kb, vb in kv_pairs] == [
        (p["key"], p["value"], p["key_box"], p["value_box"])
        for p in rec["kv_pairs"]]
    assert [(t, list(b)) for t, b in lines] == [
        (ln["text"], ln["box"]) for ln in rec["lines"]]


def test_no_device_without_cuda_raises(serving_setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    wdir, _, _, tok = serving_setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceService(wdir, tokenizer=tok)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--model_name_or_path", wdir, "--dir_image", wdir,
                    "--dir_ocr", wdir])


def test_ocr_pairing_by_stem(serving_setup, tmp_path):
    import shutil

    wdir, img_dir, ocr_dir, tok = serving_setup
    svc = InferenceService(wdir, tokenizer=tok, dtype="float32",
                           batch_size=2, device="cpu")
    bad_dir = tmp_path / "ocr_bad"
    shutil.copytree(ocr_dir, bad_dir)
    os.rename(bad_dir / "p3.json", bad_dir / "p3_typo.json")
    with pytest.raises(FileNotFoundError, match="p3"):
        svc.run(img_dir, str(bad_dir))
    dup_dir = tmp_path / "ocr_dup"
    shutil.copytree(ocr_dir, dup_dir)
    shutil.copy(dup_dir / "p3.json", dup_dir / "p3.JSON")
    with pytest.raises(ValueError, match="duplicate"):
        svc.run(img_dir, str(dup_dir))


def test_cli_writes_the_service_results(serving_setup, port_results,
                                        tmp_path):
    wdir, img_dir, ocr_dir, _ = serving_setup
    out = tmp_path / "results.json"
    serve_main(["--model_name_or_path", wdir, "--dir_image", img_dir,
                "--dir_ocr", ocr_dir, "--dir_save", str(out),
                "--batch_size", "2", "--max_seq_len", str(L), "--dtype",
                "float32", "--device", "cpu",
                "--bucket_lengths", "32,48"])
    saved = json.loads(out.read_text())
    assert set(saved) == set(port_results)
    for name, rec in saved.items():
        assert isinstance(rec["kv_pairs"], list)
        assert isinstance(rec["lines"], list)
