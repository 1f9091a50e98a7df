"""The single-device serving surface of deploy/inference.py in the PyTorch
port, against the JAX package (counterparts of tests/test_batch_serving.py
and tests/test_tesseract_visualize.py): ``run_page`` and ``run_batch``;
``preprocess_procs`` (spawned worker processes: the same records as
threads, no CUDA context in a worker, no torch in a text-only one);
``--apply_ocr`` through tesseract (a stubbed ``pytesseract``, and the
error without it); ``--dir_visualize`` (``draw_page`` pixel for pixel
equal to the JAX package's, one image per page); the new ``serve`` flags."""

import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

import jax

from peneo_tpu.config import LayoutLMv3Config, LiltConfig, PEneoConfig
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline.checkpoint import save_params_msgpack
from peneo_tpu.pipeline.infer import InferenceService as JaxService
from peneo_tpu_torch.data.synthetic import ToyTokenizer, make_document, \
    render_page
from peneo_tpu_torch.pipeline.infer import InferenceService

torch.set_num_threads(1)
L = 64


def _model_dir(root, family, tok):
    """A model directory with the JAX package's params.msgpack."""
    wdir = os.path.join(root, family)
    common = dict(vocab_size=tok.vocab_size, hidden_size=48,
                  num_hidden_layers=1, num_attention_heads=4,
                  intermediate_size=96, pad_token_id=0,
                  max_position_embeddings=L + 8)
    if family == "lilt":
        name, bc, kw = ("lilt-infoxlm-base", LiltConfig(**common).to_dict(),
                        {})
    else:
        name, bc = "layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=8, shape_size=8, input_size=32,
            **common).to_dict()
        kw = {"image": np.zeros((1, 3, 32, 32), np.float32)}
    cfg = PEneoConfig(backbone_name=name, backbone_config=bc,
                      pair_block_size=16, max_seq_len=L,
                      max_spots_per_head=L * L, initializer_range=0.15)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    ids = np.ones((1, L), np.int32)
    params = jax.device_get(jax.jit(
        lambda i, b, **k: PEneoModel(cfg).init(
            jax.random.PRNGKey(29), i, b, i, **k))(
        ids, np.zeros((1, L, 4), np.int32), **kw)["params"])
    save_params_msgpack(params, os.path.join(wdir, "params.msgpack"))
    return wdir


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("surface"))
    tok = ToyTokenizer()
    from PIL import Image

    img_dir, ocr_dir = os.path.join(root, "images"), os.path.join(root, "ocr")
    os.makedirs(img_dir)
    os.makedirs(ocr_dir)
    rng = random.Random(8)
    for i in range(3):
        doc = make_document(rng, f"s{i}.png", n_pairs=3, n_noise=1)
        Image.fromarray(render_page(doc)).save(f"{img_dir}/s{i}.png")
        ocr = [{"text": ln["text"], "bbox": ln["bbox"]}
               for e in doc["entities"] for ln in e["lines"]]
        with open(f"{ocr_dir}/s{i}.json", "w") as f:
            json.dump(ocr, f)
    dirs = {f: _model_dir(root, f, tok) for f in ("lilt", "v3")}
    return dirs, img_dir, ocr_dir, tok


def _service(setup, family="lilt", **kw):
    dirs, _, _, tok = setup
    return InferenceService(dirs[family], tokenizer=tok, dtype="float32",
                            batch_size=2, device="cpu", **kw)


def _records(results):
    return {k: (v["kv_pairs"], v["lines"]) for k, v in results.items()}


def _as_record(kv_pairs, lines):
    return ([{"key": k, "value": v, "key_box": [float(x) for x in kb],
              "value_box": [float(x) for x in vb]}
             for k, v, kb, vb in kv_pairs],
            [{"text": t, "box": [float(x) for x in b]} for t, b in lines])


def test_run_page_and_run_batch_match_run_and_jax(setup):
    dirs, img_dir, ocr_dir, tok = setup
    svc = _service(setup)
    ran = _records(svc.run(img_dir, ocr_dir))
    jax_svc = JaxService(dirs["lilt"], tokenizer=tok, dtype="float32",
                         batch_size=2)
    names = sorted(ran)
    paths = [(os.path.join(img_dir, n),
              os.path.join(ocr_dir, n.replace(".png", ".json")))
             for n in names]
    assert sum(len(ran[n][1]) for n in names) > 0
    for name, (img, ocr) in zip(names, paths):
        got = svc.run_page(img, ocr)
        assert _as_record(*got) == ran[name], name
        assert _as_record(*jax_svc.run_page(img, ocr)) == ran[name], name
    batch = [svc.preprocess_page(*p) for p in paths[:2]]
    for name, res in zip(names[:2], svc.run_batch(batch)):
        assert _as_record(*res) == ran[name], name


@pytest.mark.parametrize("family", ["lilt", "v3"])
def test_preprocess_procs_match_threads(setup, family):
    _, img_dir, ocr_dir, _ = setup
    svc = _service(setup, family)
    threads = _records(svc.run(img_dir, ocr_dir))
    procs = _records(svc.run(img_dir, ocr_dir, preprocess_procs=2))
    assert len(threads) == 3 and procs == threads


@pytest.mark.parametrize("family", ["lilt", "v3"])
def test_worker_has_no_cuda_context(setup, family):
    """A spawned worker, set up as ``run(preprocess_procs=…)`` sets it up
    and after preprocessing a page, has initialized no CUDA; a LiLT worker
    has not even imported torch (a v3 one decodes images without it
    too)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from peneo_tpu_torch.pipeline.preprocess import (_init_worker,
                                                     _preprocess_task,
                                                     _worker_probe)

    _, img_dir, ocr_dir, _ = setup
    svc = _service(setup, family)
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn"),
                             initializer=_init_worker,
                             initargs=(svc.page_preprocessor(),)) as pool:
        page = pool.submit(_preprocess_task,
                           (os.path.join(img_dir, "s0.png"),
                            os.path.join(ocr_dir, "s0.json"))).result()
        has_torch, cuda = pool.submit(_worker_probe).result()
    assert page[3] > 0
    assert not cuda
    assert not has_torch


# word-level tesseract output for two text lines (tests/test_tesseract_
# visualize.py's): "total amount" at y=100, "42 usd" at y=200
_FAKE_DATA = {
    "text": ["total", "amount", "", "42", "usd"],
    "block_num": [1, 1, 1, 1, 1],
    "par_num": [1, 1, 1, 1, 1],
    "line_num": [1, 1, 1, 2, 2],
    "left": [100, 220, 0, 100, 180],
    "top": [100, 102, 0, 200, 201],
    "width": [100, 140, 0, 60, 80],
    "height": [30, 28, 0, 30, 29],
}


def _fake_pytesseract(monkeypatch):
    mod = types.ModuleType("pytesseract")
    mod.Output = types.SimpleNamespace(DICT="dict")
    calls = []

    def image_to_data(im, output_type=None):
        calls.append(im.size)
        return _FAKE_DATA

    mod.image_to_data = image_to_data
    monkeypatch.setitem(sys.modules, "pytesseract", mod)
    return calls


def test_apply_ocr_groups_words_like_jax(monkeypatch, setup, tmp_path):
    from PIL import Image

    from peneo_tpu.pipeline.preprocess import tesseract_ocr as jax_ocr
    from peneo_tpu_torch.pipeline.preprocess import tesseract_ocr
    from peneo_tpu_torch.serve import main as serve_main

    calls = _fake_pytesseract(monkeypatch)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    Image.fromarray(np.full((300, 400, 3), 255, np.uint8)).save(
        img_dir / "page.png")
    page = str(img_dir / "page.png")
    got = tesseract_ocr(page)
    assert got == jax_ocr(page)
    assert got == (["total amount", "42 usd"],
                   [[100, 100, 360, 130], [100, 200, 260, 230]])
    assert calls == [(400, 300), (400, 300)]
    # preprocess packs the tesseract lines' tokens
    texts = _service(setup).preprocess_page(page, None)[1]
    joined = "".join(texts).replace("\u2581", " ")
    assert "total amount" in joined and "42 usd" in joined
    # the CLI path: --apply_ocr, no --dir_ocr
    out = tmp_path / "res.json"
    serve_main(["--model_name_or_path", setup[0]["lilt"], "--dir_image",
                str(img_dir), "--apply_ocr", "--dir_save", str(out),
                "--max_seq_len", str(L), "--dtype", "float32", "--device",
                "cpu"])
    res = json.loads(out.read_text())
    assert set(res) == {"page.png"}
    assert isinstance(res["page.png"]["kv_pairs"], list)
    assert isinstance(res["page.png"]["lines"], list)


def test_apply_ocr_without_pytesseract_raises(monkeypatch, tmp_path):
    from PIL import Image

    from peneo_tpu_torch.pipeline.preprocess import tesseract_ocr

    monkeypatch.setitem(sys.modules, "pytesseract", None)
    img = tmp_path / "page.png"
    Image.fromarray(np.full((64, 64, 3), 255, np.uint8)).save(img)
    with pytest.raises(RuntimeError, match="pytesseract"):
        tesseract_ocr(str(img))


def test_draw_page_equals_jax_pixel_for_pixel(tmp_path):
    from PIL import Image

    from peneo_tpu.utils.visualize import draw_page as jax_draw
    from peneo_tpu_torch.utils.visualize import draw_page

    src = tmp_path / "page.png"
    Image.fromarray(np.full((400, 600, 3), 255, np.uint8)).save(src)
    kv_pairs = [("total", "42 usd", (50, 50, 150, 90), (300, 200, 420, 240))]
    lines = [("total", (50, 50, 150, 90)), ("42 usd", (300, 200, 420, 240))]
    draw_page(str(src), kv_pairs, lines, str(tmp_path / "port.png"))
    jax_draw(str(src), kv_pairs, lines, str(tmp_path / "jax.png"))
    a = np.asarray(Image.open(tmp_path / "port.png"))
    b = np.asarray(Image.open(tmp_path / "jax.png"))
    assert a.shape == b.shape == (400, 600, 3)
    np.testing.assert_array_equal(a, b)
    assert (a != 255).any()


def test_visualize_dir_writes_one_image_per_page(setup, tmp_path):
    _, img_dir, ocr_dir, _ = setup
    viz = tmp_path / "viz"
    results = _service(setup).run(img_dir, ocr_dir, visualize_dir=str(viz))
    assert sorted(os.listdir(viz)) == sorted(results) == [
        "s0.png", "s1.png", "s2.png"]


def test_serve_flags_reach_the_service(monkeypatch, setup, tmp_path):
    import peneo_tpu_torch.pipeline.infer as infer
    from peneo_tpu_torch.serve import main as serve_main

    seen = {}

    class Spy(InferenceService):
        def __init__(self, *a, **kw):
            seen["init"] = kw
            super().__init__(*a, **kw)

        def run(self, *a, **kw):
            seen["run"] = (a, kw)
            return super().run(*a, **kw)

    monkeypatch.setattr(infer, "InferenceService", Spy)
    dirs, img_dir, ocr_dir, _ = setup
    viz = tmp_path / "viz"
    serve_main(["--model_name_or_path", dirs["lilt"], "--dir_image", img_dir,
                "--dir_ocr", ocr_dir, "--dir_save", str(tmp_path / "r.json"),
                "--dir_visualize", str(viz), "--preprocess_procs", "1",
                "--int8_pair_head", "--int8_backbone", "--max_seq_len",
                str(L), "--dtype", "float32", "--device", "cpu"])
    assert seen["init"]["int8_pair_head"] is True
    assert seen["init"]["int8_backbone"] is True
    assert seen["run"][0] == (img_dir, ocr_dir)
    assert seen["run"][1]["preprocess_procs"] == 1
    assert seen["run"][1]["visualize_dir"] == str(viz)
    assert len(os.listdir(viz)) == 3
    serve_main(["--model_name_or_path", dirs["lilt"], "--dir_image", img_dir,
                "--dir_ocr", ocr_dir, "--dir_save", str(tmp_path / "r.json"),
                "--no_int8_pair_head", "--max_seq_len", str(L), "--dtype",
                "float32", "--device", "cpu"])
    assert seen["init"]["int8_pair_head"] is False
    assert seen["init"]["int8_backbone"] is False
    with pytest.raises(SystemExit):  # neither OCR JSON nor --apply_ocr
        serve_main(["--model_name_or_path", dirs["lilt"], "--dir_image",
                    img_dir, "--device", "cpu"])
