"""Serving of the PyTorch port (peneo_tpu_torch/pipeline/infer.py): on one
synthetic page directory and one ``pytorch_model.bin`` written by the port,
the JAX InferenceService and the port's (device="cpu", fp32) return the
same kv pairs and lines; the port's results do not depend on batch size or
pipeline depth; and an entry point with no device on a machine without CUDA
raises instead of running on the CPU."""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import LiltConfig, PEneoConfig
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
