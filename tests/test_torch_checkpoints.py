"""Every checkpoint the JAX package reads, read by the PyTorch port:

- serving (``InferenceService``) from a directory whose only weights are a
  ``params.msgpack`` written by the JAX package, for LiLT, LayoutLMv3 and
  LayoutLMv2: the same records as the JAX service on that directory and as
  the port on the same weights in ``pytorch_model.bin`` and in
  ``model.safetensors``; ``params.msgpack`` wins when several files are
  present; a missing parameter raises;
- fine-tuning's start from a ``backbone_params.msgpack``: the backbone's
  weights are the tree's, the decoder keeps its seeded init, a shape
  mismatch raises;
- the weight generator: the JAX tool (``tools/generate_peneo_weights.py``)
  and ``python -m peneo_tpu_torch.generate_peneo_weights`` on one tiny
  HF-style LiLT / LayoutLMv3 directory write equal ``config.json`` and
  ``preprocessor_config.json`` and backbone trees equal leaf for leaf;
  LayoutLMv2 raises in both."""

import importlib.util
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

import flax.serialization as flax_ser
import jax

from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline.checkpoint import save_params_msgpack
from peneo_tpu.pipeline.infer import InferenceService as JaxService
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.data.synthetic import ToyTokenizer, make_document, \
    render_page
from peneo_tpu_torch.models.convert import jax_params_to_state_dict
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.pipeline.infer import InferenceService, load_weights
from peneo_tpu_torch.pipeline.weights_io import write_flax_msgpack

torch.set_num_threads(1)
L = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _backbone(family, tok):
    common = dict(vocab_size=tok.vocab_size, hidden_size=48,
                  num_hidden_layers=1, num_attention_heads=4,
                  intermediate_size=96, pad_token_id=0,
                  max_position_embeddings=L + 8)
    if family == "lilt":
        return "lilt-infoxlm-base", LiltConfig(**common).to_dict(), None
    if family == "v3":
        return ("layoutlmv3-base-chinese", LayoutLMv3Config(
            coordinate_size=8, shape_size=8, input_size=32,
            **common).to_dict(), 32)
    return ("layoutxlm-base", LayoutLMv2Config(
        coordinate_size=8, shape_size=8, visual_depths=[1, 1, 1, 1],
        input_size=56, **common).to_dict(), 56)


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    root = tmp_path_factory.mktemp("pages")
    from PIL import Image

    img_dir, ocr_dir = str(root / "images"), str(root / "ocr")
    os.makedirs(img_dir)
    os.makedirs(ocr_dir)
    rng = random.Random(21)
    for i in range(3):
        doc = make_document(rng, f"c{i}.png", n_pairs=3, n_noise=1)
        Image.fromarray(render_page(doc)).save(f"{img_dir}/c{i}.png")
        ocr = [{"text": ln["text"], "bbox": ln["bbox"]}
               for e in doc["entities"] for ln in e["lines"]]
        with open(f"{ocr_dir}/c{i}.json", "w") as f:
            json.dump(ocr, f)
    return img_dir, ocr_dir


@pytest.fixture(scope="module", params=["lilt", "v3", "v2"])
def jax_dir(request, tmp_path_factory):
    """A model directory whose only weights are the JAX package's
    ``params.msgpack``; returns (dir, params, tokenizer)."""
    tok = ToyTokenizer()
    name, backbone_config, size = _backbone(request.param, tok)
    wdir = str(tmp_path_factory.mktemp(f"ckpt_{request.param}") / "model")
    cfg = PEneoConfig(backbone_name=name, backbone_config=backbone_config,
                      pair_block_size=16, max_seq_len=L,
                      max_spots_per_head=L * L, initializer_range=0.15)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    ids = np.ones((1, L), np.int32)
    kw = {} if size is None else {
        "image": np.zeros((1, 3, size, size), np.float32)}
    params = jax.device_get(jax.jit(
        lambda i, b, **k: PEneoModel(cfg).init(
            jax.random.PRNGKey(17), i, b, i, **k))(
        ids, np.zeros((1, L, 4), np.int32), **kw)["params"])
    if request.param == "v3":  # zero at init: let the image matter
        rng = np.random.default_rng(4)
        for k in ("cls_token", "pos_embed"):
            params["backbone"][k] = (rng.standard_normal(
                params["backbone"][k].shape) * 0.15).astype(np.float32)
    save_params_msgpack(params, os.path.join(wdir, "params.msgpack"))
    return wdir, params, tok


def _serve(wdir, tok, pages):
    return InferenceService(wdir, tokenizer=tok, dtype="float32",
                            batch_size=2, device="cpu").run(*pages)


def _records(results):
    return {k: (v["kv_pairs"], v["lines"]) for k, v in results.items()}


def _state_dict(wdir, params):
    return jax_params_to_state_dict(params, PortConfig.from_pretrained(wdir))


def test_serves_params_msgpack_like_jax(jax_dir, pages, tmp_path):
    wdir, params, tok = jax_dir
    got = _records(_serve(wdir, tok, pages))
    want = _records(JaxService(wdir, tokenizer=tok, dtype="float32",
                               batch_size=2).run(*pages))
    assert len(want) == 3 and sum(len(v[1]) for v in want.values()) > 0
    assert got == want
    # the same weights as pytorch_model.bin, alone in a directory
    bin_dir = str(tmp_path / "bin")
    shutil.copytree(wdir, bin_dir)
    os.remove(os.path.join(bin_dir, "params.msgpack"))
    torch.save(_state_dict(wdir, params),
               os.path.join(bin_dir, "pytorch_model.bin"))
    assert _records(_serve(bin_dir, tok, pages)) == want


def test_serves_model_safetensors(jax_dir, pages, tmp_path):
    from safetensors.torch import save_file

    wdir, params, tok = jax_dir
    st_dir = str(tmp_path / "st")
    shutil.copytree(wdir, st_dir)
    os.remove(os.path.join(st_dir, "params.msgpack"))
    sd = {k: v.contiguous() for k, v in _state_dict(wdir, params).items()}
    save_file(sd, os.path.join(st_dir, "model.safetensors"))
    assert _records(_serve(st_dir, tok, pages)) == _records(
        _serve(wdir, tok, pages))


def test_params_msgpack_comes_first(jax_dir, pages, tmp_path):
    """With all three files present, the msgpack tree is what serves: the
    torch files hold other (zeroed) weights."""
    wdir, params, tok = jax_dir
    both = str(tmp_path / "both")
    shutil.copytree(wdir, both)
    zeros = {k: torch.zeros(v.shape) for k, v in
             _state_dict(wdir, params).items()}
    torch.save(zeros, os.path.join(both, "pytorch_model.bin"))
    from safetensors.torch import save_file

    save_file(zeros, os.path.join(both, "model.safetensors"))
    model = PortModel(PortConfig.from_pretrained(both))
    assert load_weights(model, both) == 0
    want = _state_dict(wdir, params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_missing_parameter_raises_when_serving(jax_dir, tmp_path):
    wdir, params, tok = jax_dir
    bad = str(tmp_path / "bad")
    shutil.copytree(wdir, bad)
    cut = jax.tree_util.tree_map(lambda a: a, params)
    del cut["peneo_decoder"]["shrink_0"]
    save_params_msgpack(cut, os.path.join(bad, "params.msgpack"))
    with pytest.raises(KeyError, match="shrink_0"):
        InferenceService(bad, tokenizer=tok, dtype="float32", device="cpu")


def _backbone_state_dict(family, tok, seed=0):
    """A seeded reference backbone in the HF layout: (HF config dict,
    {prefixed key: tensor})."""
    name, backbone_config, _ = _backbone(family, tok)
    cfg = PortConfig(backbone_name=name, backbone_config=backbone_config)
    model = PortModel(cfg).init_weights(torch.Generator().manual_seed(seed))
    prefix = {"lilt": "lilt.", "v3": "layoutlmv3."}[family]
    sd = {prefix + k[len("backbone."):]: v.clone()
          for k, v in model.state_dict().items() if k.startswith("backbone.")}
    if family == "v3":  # nonzero, so the conversion is seen
        sd["layoutlmv3.pos_embed"].normal_(0, 0.1)
    return name, backbone_config, sd


def _write_hf_dir(root, family, tok):
    name, backbone_config, sd = _backbone_state_dict(family, tok)
    hf_dir = os.path.join(root, name)
    os.makedirs(hf_dir)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(backbone_config, f)
    torch.save(sd, os.path.join(hf_dir, "pytorch_model.bin"))
    tok.save_pretrained(hf_dir)
    return hf_dir, sd


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_peneo_weights",
        os.path.join(REPO, "tools", "generate_peneo_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


@pytest.mark.parametrize("family", ["lilt", "v3"])
def test_generator_matches_jax_tool(tmp_path, family):
    from peneo_tpu_torch.generate_peneo_weights import main as port_main
    from peneo_tpu_torch.pipeline.weights_io import read_flax_msgpack

    tok = ToyTokenizer()
    hf_dir, _ = _write_hf_dir(str(tmp_path), family, tok)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_tool().generate_peneo_weights(hf_dir, jax_out)
    port_main(["--backbone_name_or_path", hf_dir, "--output_dir", port_out])
    for fname in ("config.json", "preprocessor_config.json"):
        with open(os.path.join(jax_out, fname)) as a, \
                open(os.path.join(port_out, fname)) as b:
            assert json.load(a) == json.load(b), fname
    with open(os.path.join(jax_out, "backbone_params.msgpack"), "rb") as f:
        want = _leaves(flax_ser.msgpack_restore(f.read()))
    got = _leaves(read_flax_msgpack(
        os.path.join(port_out, "backbone_params.msgpack")))
    assert set(got) == set(want) and len(want) > 20
    assert all(p[0] == "backbone" for p in want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg="/".join(path))
    assert os.path.exists(os.path.join(port_out, "toy_tokenizer.json"))


def test_generator_refuses_layoutlmv2_like_jax_tool(tmp_path):
    from peneo_tpu_torch.generate_peneo_weights import generate_peneo_weights

    tok = ToyTokenizer()
    name, backbone_config, _ = _backbone("v2", tok)
    hf_dir = str(tmp_path / name)
    os.makedirs(hf_dir)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(backbone_config, f)
    torch.save({"layoutlmv2.embeddings.word_embeddings.weight":
                torch.zeros(4, 48)}, os.path.join(hf_dir, "pytorch_model.bin"))
    with pytest.raises(NotImplementedError):
        _jax_tool().generate_peneo_weights(hf_dir, str(tmp_path / "jax"))
    with pytest.raises(NotImplementedError):
        generate_peneo_weights(hf_dir, str(tmp_path / "port"))


def test_training_starts_from_backbone_params(tmp_path):
    """``run_rfund.setup`` on the generator's output: the backbone is the
    HF checkpoint's, the decoder the seeded init of a run without it."""
    from peneo_tpu_torch.generate_peneo_weights import generate_peneo_weights
    from peneo_tpu_torch.run_rfund import build_argparser, setup

    tok = ToyTokenizer()
    hf_dir, hf_sd = _write_hf_dir(str(tmp_path), "lilt", tok)
    gen = generate_peneo_weights(hf_dir, str(tmp_path / "gen"))
    args = build_argparser().parse_args([
        "--model_name_or_path", gen, "--synthetic_data", "--device", "cpu",
        "--output_dir", str(tmp_path / "out"), "--max_seq_len", str(L),
        "--seed", "3"])
    model = setup(args)[1]
    sd = model.state_dict()
    for k, v in hf_sd.items():
        assert torch.equal(sd["backbone." + k[len("lilt."):]], v), k
    fresh = PortModel(model.cfg).init_weights(
        torch.Generator().manual_seed(3)).state_dict()
    dec = [k for k in sd if k.startswith("peneo_decoder.")]
    assert len(dec) > 10
    for k in dec:
        assert torch.equal(sd[k], fresh[k]), k
    # the decoder's init differs from the loaded backbone's source weights
    assert not torch.equal(
        sd["backbone.embeddings.word_embeddings.weight"],
        fresh["backbone.embeddings.word_embeddings.weight"])


def test_backbone_params_shape_mismatch_raises(tmp_path):
    tok = ToyTokenizer()
    name, backbone_config, _ = _backbone("lilt", tok)
    cfg = PortConfig(backbone_name=name, backbone_config=backbone_config,
                     max_seq_len=L)
    d = str(tmp_path / "m")
    cfg.save_pretrained(d)
    write_flax_msgpack({"backbone": {"embeddings": {"word_embeddings": {
        "embedding": np.zeros((7, 48), np.float32)}}}},
        os.path.join(d, "backbone_params.msgpack"))
    model = PortModel(cfg)
    with pytest.raises(ValueError, match="word_embeddings"):
        load_weights(model, d, train_init=True)
    # a partial tree of the right shapes: the rest keeps its values
    emb = np.random.default_rng(0).standard_normal(
        (tok.vocab_size, 48)).astype(np.float32)
    write_flax_msgpack({"backbone": {"embeddings": {"word_embeddings": {
        "embedding": emb}}}}, os.path.join(d, "backbone_params.msgpack"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kept = load_weights(model, d, train_init=True)
    assert kept == len(before) - 1
    after = model.state_dict()
    np.testing.assert_array_equal(
        after["backbone.embeddings.word_embeddings.weight"].numpy(), emb)
    for k, v in before.items():
        if k != "backbone.embeddings.word_embeddings.weight":
            assert torch.equal(after[k], v), k
