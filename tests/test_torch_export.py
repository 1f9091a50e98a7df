"""The serving artifact of the PyTorch port (``peneo_tpu_torch/
export_artifact.py``, ``inference_artifact.py``, ``check_run_artifact.py``)
against the JAX package's (``tools/export_artifact.py``,
``deploy/inference_artifact.py``) on one ``params.msgpack`` written by the
JAX package, on the CPU in fp32.

- Kernels #1 and #4 are ``torch.library`` operators whose fakes give the
  real outputs' strides and whose backward is the plain twin's
  (``torch.library.opcheck`` on inputs that require gradients, with padded
  key rows and the padded bias rows of ``RelBias``).
- An exported graph holds one ``peneo::`` attention node per layer and no
  plain attention (no einsum; no softmax over the keys).
- LiLT (``tests/test_torch_peneo.py``'s tiny geometry, L = 128, B = 2 with
  a padded row): the port's artifact against JAX's artifact (spot scores
  within 1e-4; spot sets and counts equal where every top-2 softmax margin
  exceeds 1e-4) and against the port's live model (1e-6). LayoutLMv3 with
  its image and LayoutLMv2 with its tower: the artifact against the live
  model (1e-6) and against the JAX live model, as ``test_torch_peneo.py``
  holds them.
- Exporting neither reads nor writes the rel-bias backbones' eager cache
  of shape-only tensors, and assigns no module attribute.
- ``ArtifactInferenceService`` returns the live service's records (LiLT,
  LayoutLMv3), and for LiLT those of JAX's artifact service.
- The entry points raise without a GPU unless the CPU is asked for, and a
  CPU request of a card's artifact raises.
"""

import json
import os
import random
import warnings

import numpy as np
import pytest
import torch

import jax

from deploy.inference_artifact import ArtifactInferenceService as JaxArtifact
from peneo_tpu.models.decoder import compact_spots as jax_compact_spots
from peneo_tpu.config import (LayoutLMv2Config, LayoutLMv3Config,
                              LiltConfig, PEneoConfig)
from peneo_tpu.models.peneo import PEneoModel
from peneo_tpu.pipeline.checkpoint import save_params_msgpack
from peneo_tpu_torch.check_run_artifact import main as check_run
from peneo_tpu_torch.config import LiltConfig as PortLilt
from peneo_tpu_torch.config import PEneoConfig as PortConfig
from peneo_tpu_torch.data.synthetic import ToyTokenizer, make_document, \
    render_page
from peneo_tpu_torch.export_artifact import (export_artifact, load_artifact,
                                             main as export_main)
from peneo_tpu_torch.inference_artifact import (ArtifactInferenceService,
                                                main as serve_artifact_main)
from peneo_tpu_torch.models.convert import state_dict_to_jax_params
from peneo_tpu_torch.models.decoder import HEAD_NAMES
from peneo_tpu_torch.models.peneo import PEneoModel as PortModel
from peneo_tpu_torch.ops.biacm_attention import (biacm_attention_op,
                                                 biacm_attention_reference)
from peneo_tpu_torch.ops.bias_attention import (bias_attention_op,
                                                bias_attention_reference)
from peneo_tpu_torch.pipeline.infer import InferenceService, load_weights
from tools.export_artifact import export_artifact as jax_export
from tools.export_artifact import load_artifact as jax_load

torch.set_num_threads(1)
B, L = 2, 128   # LiLT: tests/test_torch_peneo.py's geometry
LV = 64         # LayoutLMv3 and LayoutLMv2: tests/test_torch_serving.py's
KEYS = {"lilt": L, "v3": LV + 5, "v2": LV + 49}  # text + visual positions
VOCAB = 120
MARGIN = 1e-4
OPS = {"lilt": torch.ops.peneo.biacm_attention.default,
       "v3": torch.ops.peneo.bias_attention.default,
       "v2": torch.ops.peneo.bias_attention.default}


# ------------------------------------------------------------------ opcheck
def _bf(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen).to(dtype)


def _grad_leaf(x):
    return x.detach().requires_grad_(True)


@pytest.mark.parametrize("L_", [5, 37])
def test_biacm_op_passes_opcheck(L_):
    """Two lengths, the second sample's last keys masked; q/k/v as the
    layer passes them: (B, nh, L, d) views of (B, L, nh, d) projections,
    requiring gradients (the operator's backward is the twin's)."""
    g = torch.Generator().manual_seed(L_)
    qkv = [_grad_leaf(_bf((2, L_, 3, d), g)).transpose(1, 2)
           for d in (64, 64, 64, 16, 16, 16)]
    bias = torch.zeros((2, L_))
    bias[1, L_ // 2:] = -1e9
    torch.library.opcheck(biacm_attention_op, (*qkv, bias, 0.125, 0.25))
    ct, cl = biacm_attention_op(*qkv, bias, 0.125, 0.25)
    assert ct.stride() == (L_ * 3 * 64, 64, 3 * 64, 1)
    assert cl.stride() == (L_ * 3 * 16, 16, 3 * 16, 1)
    want = torch.autograd.grad(
        sum(x.sum() for x in biacm_attention_reference(
            *qkv, bias, 0.125, 0.25)), qkv)
    got = torch.autograd.grad(ct.sum() + cl.sum(), qkv)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("L_", [5, 37])
def test_bias_op_passes_opcheck(L_):
    """The bias as ``RelBias`` lays it out: a (B, nh, L, L) view of an (nh,
    B, L, L4) buffer, rows padded to a multiple of 4 floats; q/k/v and the
    bias require gradients."""
    g = torch.Generator().manual_seed(L_)
    q, k, v = (_grad_leaf(_bf((2, L_, 3, 64), g)).transpose(1, 2)
               for _ in range(3))
    L4 = -(-L_ // 4) * 4
    bias = _grad_leaf(_bf((3, 2, L_, L4), g)).permute(1, 0, 2, 3)[..., :L_]
    assert bias.stride(2) == L4 and not bias.is_contiguous()
    mask = torch.zeros((2, L_))
    mask[1, L_ // 2:] = -1e9
    torch.library.opcheck(bias_attention_op, (q, k, v, bias, mask, 0.125))
    ctx = bias_attention_op(q, k, v, bias, mask, 0.125)
    assert ctx.stride() == (L_ * 3 * 64, 64, 3 * 64, 1)
    leaves = (q, k, v, bias)
    want = torch.autograd.grad(
        bias_attention_reference(*leaves, mask, 0.125).sum(), leaves)
    for a, b in zip(torch.autograd.grad(ctx.sum(), leaves), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------- the models
def _lilt_cfg():
    return PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=VOCAB, hidden_size=96, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=L + 16, pad_token_id=0).to_dict(),
        pair_block_size=32, max_seq_len=L, max_spots_per_head=(L - 1) ** 2,
        spot_topk="exact", use_fused_biacm=True, initializer_range=0.15)


def _v3_cfg(layers=1, max_seq_len=LV):
    return PEneoConfig(
        backbone_name="layoutlmv3-base-chinese",
        backbone_config=LayoutLMv3Config(
            vocab_size=VOCAB, hidden_size=48, num_hidden_layers=layers,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=LV + 8, pad_token_id=1,
            coordinate_size=8, shape_size=8, input_size=32).to_dict(),
        pair_block_size=16, max_seq_len=max_seq_len,
        max_spots_per_head=(max_seq_len - 1) ** 2, spot_topk="exact",
        initializer_range=0.15)


def _v2_cfg():
    return PEneoConfig(
        backbone_name="layoutxlm-base",
        backbone_config=LayoutLMv2Config(
            vocab_size=VOCAB, hidden_size=48, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=LV + 8, pad_token_id=1,
            coordinate_size=8, shape_size=8, visual_depths=[1, 1, 1, 1],
            input_size=56).to_dict(),
        pair_block_size=16, max_seq_len=LV, max_spots_per_head=(LV - 1) ** 2,
        spot_topk="exact", initializer_range=0.15)


def _inputs(fam, seed=0):
    """B = 2 rows of ids, boxes and mask (the second padded), and an fp32
    image for the visual families."""
    n = L if fam == "lilt" else LV
    pad = 0 if fam == "lilt" else 1
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, (B, n)).astype(np.int32)
    if fam != "lilt":
        ids[:, 0] = 0  # CLS
    ids[1, -30:] = pad
    attn = (ids != pad).astype(np.int32)
    x0 = rng.integers(0, 900, (B, n))
    y0 = rng.integers(0, 900, (B, n))
    bbox = np.stack([x0, y0, x0 + 40, y0 + 20], -1).astype(np.int32)
    bbox[ids == pad] = 0
    size = {"lilt": 0, "v3": 32, "v2": 56}[fam]
    image = None
    if size:
        image = rng.normal(size=(B, 3, size, size)).astype(np.float32)
        if fam == "v2":  # BGR 0-255
            image = (rng.random((B, 3, size, size)) * 255).astype(np.float32)
    return ids, bbox, attn, image


def _write_model_dir(path, cfg, fam):
    """A seeded init of ``cfg``, written by the JAX package as
    ``params.msgpack`` beside ``config.json`` and a toy tokenizer; returns
    the JAX param tree. Leaves that are zero at init and would hide a path
    (v3's CLS and position tokens, v2's q/v biases) are drawn at 0.1."""
    port_cfg = PortConfig.from_dict(cfg.to_dict())
    model = PortModel(port_cfg).init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(2)
    for key in sd:
        if key.endswith(("cls_token", "pos_embed", "q_bias", "v_bias")):
            sd[key] = torch.randn(sd[key].shape, generator=g) * 0.1
    params = state_dict_to_jax_params(sd, port_cfg)
    os.makedirs(path, exist_ok=True)
    cfg.save_pretrained(path)
    ToyTokenizer(vocab_size=VOCAB).save_pretrained(path)
    save_params_msgpack(params, os.path.join(path, "params.msgpack"))
    return params


def _tensors(fam):
    ids, bbox, attn, image = _inputs(fam)
    image = None if image is None else torch.from_numpy(image)
    return [torch.from_numpy(x) for x in (ids, bbox, attn)], image


def _live(model_dir):
    """The port's live model on the model directory's weights (fp32)."""
    cfg = PortConfig.from_pretrained(model_dir)
    model = PortModel(cfg)
    load_weights(model, model_dir)
    return model.eval()


def _family(tmp_path_factory, fam, cfg):
    root = tmp_path_factory.mktemp(f"export_{fam}")
    model_dir, art = str(root / "model"), str(root / "artifact")
    params = _write_model_dir(model_dir, cfg, fam)
    n = cfg.max_seq_len
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        export_artifact(model_dir, art, batch_size=B, max_seq_len=n,
                        dtype="float32", device="cpu")
    assert not [w for w in caught if "during export" in str(w.message)]
    return {"dir": model_dir, "art": art, "params": params, "cfg": cfg,
            "root": root}


@pytest.fixture(scope="module")
def lilt(tmp_path_factory):
    fam = _family(tmp_path_factory, "lilt", _lilt_cfg())
    fam["jax_art"] = jax_export(fam["dir"], str(fam["root"] / "jax_artifact"),
                                B, L, "float32")
    return fam


@pytest.fixture(scope="module")
def v3(tmp_path_factory):
    return _family(tmp_path_factory, "v3", _v3_cfg())


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    return _family(tmp_path_factory, "v2", _v2_cfg())


def _run_artifact(art, fam):
    call, meta, _ = load_artifact(art, device="cpu")
    inputs, image = _tensors(fam)
    with torch.inference_mode():
        return call(*inputs, image=image), meta


def _assert_equal_to_live(got, model, fam, atol=1e-6):
    inputs, image = _tensors(fam)
    with torch.inference_mode():
        want = model(*inputs, image=image)
    for name in HEAD_NAMES:
        for key, w in want[name].items():
            if key == "spot_score":
                np.testing.assert_allclose(got[name][key].numpy(), w.numpy(),
                                           rtol=0, atol=atol, err_msg=name)
            else:
                np.testing.assert_array_equal(got[name][key].numpy(),
                                              w.numpy(), err_msg=(name, key))


def _margins(logits):
    z = np.asarray(logits, np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _assert_spots_match(got, want, logits, Ld):
    """Per head and row: the (idx, tag) spots at positions whose top-2
    margin exceeds MARGIN are equal, their scores within 1e-4, and the
    counts equal up to the close positions."""
    triu = np.triu(np.ones((Ld, Ld), bool))[None]
    for name in HEAD_NAMES:
        close = _margins(logits[name]) <= MARGIN
        # the comparison covers nearly all of the grid
        assert (~close & triu).sum() > 0.95 * triu.sum() * B, name
        for b in range(B):
            def spots(out):
                keep = np.asarray(out["spot_score"][b]) >= 0
                idx = np.asarray(out["spot_idx"][b])[keep]
                tag = np.asarray(out["spot_tag"][b])[keep]
                score = np.asarray(out["spot_score"][b])[keep]
                return {(int(i), int(t)): float(s)
                        for i, t, s in zip(idx, tag, score)
                        if not close[b, i // Ld, i % Ld]}
            ours = spots({k: v.numpy() for k, v in got[name].items()})
            theirs = spots(want[name])
            assert set(ours) == set(theirs), (name, b)
            np.testing.assert_allclose(
                [ours[k] for k in sorted(ours)],
                [theirs[k] for k in sorted(ours)], rtol=0, atol=1e-4,
                err_msg=name)
            assert abs(int(got[name]["spot_count"][b])
                       - int(want[name]["spot_count"][b])) \
                <= close[b].sum(), name


# ----------------------------------------------------------------- graphs
@pytest.mark.parametrize("fam", ["lilt", "v3", "v2"])
def test_graph_holds_one_kernel_op_per_layer(fam, request):
    art = request.getfixturevalue(fam)["art"]
    program = torch.export.load(os.path.join(art, "forward.pt2"))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    layers = request.getfixturevalue(fam)["cfg"].backbone_config[
        "num_hidden_layers"]
    assert targets.count(OPS[fam]) == layers
    assert not [t for t in targets if "einsum" in str(t)]
    attention_softmax = [
        n for n in program.graph.nodes if "softmax" in str(n.target)
        and n.meta["val"].shape[-1] == KEYS[fam]]
    assert not attention_softmax
    with open(os.path.join(art, "artifact_meta.json")) as f:
        meta = json.load(f)
    assert meta["kernels"] == [OPS[fam]._schema.name]
    assert meta["device"] == "cpu" and meta["has_image"] == (fam != "lilt")
    assert sorted(os.listdir(art)) == sorted(
        ["forward.pt2", "config.json", "artifact_meta.json",
         "toy_tokenizer.json"])


# -------------------------------------------------------------- against JAX
def test_lilt_artifact_matches_jax_artifact_and_live_model(lilt):
    got, meta = _run_artifact(lilt["art"], "lilt")
    assert (meta["batch_size"], meta["max_seq_len"]) == (B, L)
    live = _live(lilt["dir"])
    _assert_equal_to_live(got, live, "lilt")
    call, params, _, _ = jax_load(lilt["jax_art"])
    ids, bbox, attn, _ = _inputs("lilt")
    want = jax.device_get(call(params, ids, bbox, attn))
    inputs, _ = _tensors("lilt")
    with torch.inference_mode():
        dense = live(*inputs, return_logits=True)
    _assert_spots_match(got, want, {n: dense[n]["logits"].numpy()
                                    for n in HEAD_NAMES}, L - 1)


@pytest.mark.parametrize("fam", ["v3", "v2"])
def test_visual_artifact_matches_live_and_jax_models(fam, request):
    """LayoutLMv3 (32 px image) and LayoutLMv2 (56 px image through the
    tower): artifact = live model (1e-6); against the JAX live model
    (its plain XLA attention) as ``test_torch_peneo.py`` holds the live
    model."""
    f = request.getfixturevalue(fam)
    got, _ = _run_artifact(f["art"], fam)
    _assert_equal_to_live(got, _live(f["dir"]), fam)
    ids, bbox, attn, image = _inputs(fam)
    jcfg = PEneoConfig.from_dict(f["cfg"].to_dict())
    jcfg.max_spots_per_head = 0
    dense = jax.device_get(jax.jit(
        lambda p, *a: PEneoModel(jcfg).apply(
            {"params": p}, *a[:3], image=a[3], deterministic=True,
            return_logits=True))(f["params"], ids, bbox, attn, image))
    k = f["cfg"].max_spots_per_head
    want = {n: {key: np.asarray(v) for key, v in jax_compact_spots(
        dense[n]["tags"], dense[n]["scores"], k, "exact").items()}
        for n in HEAD_NAMES}
    _assert_spots_match(got, want, {n: dense[n]["logits"]
                                    for n in HEAD_NAMES}, LV - 1)


def test_int8_config_exports_int8(tmp_path):
    """A config with both int8 switches exports the int8 forward (the
    JAX export honours them too): a one-layer LiLT at L = 32, the artifact
    equal to the live int8 model."""
    cfg = PortConfig(backbone_name="lilt-infoxlm-base",
                     backbone_config=PortLilt(
                         vocab_size=VOCAB, hidden_size=48,
                         num_hidden_layers=1, num_attention_heads=4,
                         intermediate_size=96,
                         max_position_embeddings=40).to_dict(),
                     max_seq_len=32, max_spots_per_head=64,
                     quantize_pair_head="int8", quantize_backbone="int8")
    model = PortModel(cfg).init_weights(torch.Generator().manual_seed(0))
    assert any(m.int8 for m in model.modules() if hasattr(m, "int8"))
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    cfg.save_pretrained(model_dir)
    torch.save(model.state_dict(), os.path.join(model_dir,
                                                "pytorch_model.bin"))
    export_artifact(model_dir, str(tmp_path / "art"), batch_size=B,
                    max_seq_len=32, dtype="float32", device="cpu")
    got = load_artifact(str(tmp_path / "art"), device="cpu")[0]
    ids, bbox, attn, _ = _inputs("lilt")
    inputs = [torch.from_numpy(x[:, :32].copy()) for x in (ids, bbox, attn)]
    with torch.inference_mode():
        out, want = got(*inputs), model.eval()(*inputs)
    for name in HEAD_NAMES:
        for key, w in want[name].items():
            assert torch.equal(out[name][key], w), (name, key)


def test_streaming_config_exports_the_streamed_spots(tmp_path_factory):
    """A LiLT config with ``spot_streaming`` (k = 256 of the 127² cells)
    exports the streamed path, as the JAX export does: no (B, L, L) tag or
    score map in the graph, the live streaming model's spots, and on the
    live slots the dense model's."""
    cfg = _lilt_cfg()
    cfg.spot_streaming, cfg.max_spots_per_head = True, 256
    f = _family(tmp_path_factory, "lilt_streaming", cfg)
    got, _ = _run_artifact(f["art"], "lilt")
    live = _live(f["dir"])
    assert live.cfg.spot_streaming
    _assert_equal_to_live(got, live, "lilt")
    program = torch.export.load(os.path.join(f["art"], "forward.pt2"))
    # the decoder's nodes (the backbone's MLP is 128 = L wide)
    maps = [n for n in program.graph.nodes
            if "peneo_decoder" in str(n.meta.get("nn_module_stack"))
            and isinstance(n.meta.get("val"), torch.Tensor)
            and n.meta["val"].dim() == 3
            and n.meta["val"].dtype in (torch.int32, torch.float32)
            and n.meta["val"].shape[1:] in ((L - 1, L - 1), (L, L))]
    assert not maps, maps[:3]
    live.peneo_decoder.cfg.spot_streaming = False
    inputs, _ = _tensors("lilt")
    with torch.inference_mode():
        dense = live(*inputs)
    for name in HEAD_NAMES:
        g = {k: v.numpy() for k, v in got[name].items()}
        d = {k: v.numpy() for k, v in dense[name].items()}
        np.testing.assert_array_equal(g["spot_count"], d["spot_count"])
        assert (g["spot_count"] > 256).all(), name  # ties decide the cut
        for b in range(B):
            keep = d["spot_score"][b] >= 0
            assert (g["spot_score"][b] >= 0).sum() == keep.sum()
            for key in ("spot_idx", "spot_tag", "spot_score"):
                np.testing.assert_allclose(g[key][b][:keep.sum()],
                                           d[key][b][keep], rtol=0,
                                           atol=1e-6 if key == "spot_score"
                                           else 0, err_msg=(name, key))


# ---------------------------------------------------------------- the cache
def test_export_neither_reads_nor_writes_the_eager_cache():
    """Eager then export: the cache is the same dict of the same tensors
    after the export. Export then eager: the export leaves it empty. Both
    programs and both eager runs agree (a one-layer LayoutLMv3 at 24 text
    positions, random torch init)."""
    cfg = PortConfig.from_dict(_v3_cfg(max_seq_len=24).to_dict())
    a, b = PortModel(cfg), PortModel(cfg)
    a.init_weights(torch.Generator().manual_seed(0))
    b.load_state_dict(a.state_dict())
    for m in (a, b):
        m.eval().requires_grad_(False)
    ids, bbox, attn, image = _inputs("v3")
    inputs = [torch.from_numpy(x[:, :24].copy()) for x in (ids, bbox, attn)]
    image = torch.from_numpy(image)
    with torch.inference_mode():
        eager = a(*inputs, image=image)
    cache = dict(a.backbone._static)
    assert {k[0] for k in cache} == {"bucket", "lut", "visual_bbox"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        after = torch.export.export(a, tuple(inputs), {"image": image},
                                    strict=False)
        first = torch.export.export(b, tuple(inputs), {"image": image},
                                    strict=False)
    assert not [w for w in caught if "during export" in str(w.message)]
    assert a.backbone._static.keys() == cache.keys()
    assert all(a.backbone._static[k] is v for k, v in cache.items())
    assert b.backbone._static == {}
    with torch.inference_mode():
        again = b(*inputs, image=image)
        outs = [p.module()(*inputs, image=image) for p in (after, first)]
    assert b.backbone._static.keys() == cache.keys()
    for out in [again] + outs:
        for name in HEAD_NAMES:
            for key, w in eager[name].items():
                assert torch.equal(out[name][key], w), (name, key)


# ------------------------------------------------------------- the service
def _pages(root, n=5):
    from PIL import Image

    img_dir, ocr_dir = str(root / "images"), str(root / "ocr")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ocr_dir, exist_ok=True)
    rng = random.Random(5)
    for i in range(n):  # 5 pages at batch 2: a padded tail batch
        doc = make_document(rng, f"p{i}.png", n_pairs=3, n_noise=1)
        Image.fromarray(render_page(doc)).save(f"{img_dir}/p{i}.png")
        with open(f"{ocr_dir}/p{i}.json", "w") as f:
            json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                       for e in doc["entities"] for ln in e["lines"]], f)
    return img_dir, ocr_dir


def _records(results):
    return {k: (v["kv_pairs"], v["lines"]) for k, v in results.items()}


@pytest.mark.parametrize("fam", ["lilt", "v3"])
def test_artifact_service_serves_the_live_services_records(fam, request,
                                                           tmp_path):
    f = request.getfixturevalue(fam)
    img_dir, ocr_dir = _pages(tmp_path)
    svc = ArtifactInferenceService(f["art"], device="cpu")
    assert not svc._packed and svc.batch_size == B
    assert svc.raw_image == (fam != "lilt")  # the live service's transport
    got = svc.run(img_dir, ocr_dir)
    want = InferenceService(f["dir"], dtype="float32", batch_size=B,
                            device="cpu").run(img_dir, ocr_dir)
    assert set(got) == set(want) and len(want) == 5
    assert sum(len(v["kv_pairs"]) for v in want.values()) > 0
    assert _records(got) == _records(want)
    if fam == "lilt":
        jax_svc = JaxArtifact(f["jax_art"])
        # deploy/inference_artifact.py builds its service through __new__
        # and misses the mesh attributes that the JAX InferenceService's
        # run and run_page read; give them the one-device values that
        # InferenceService.__init__ sets
        for attr in ("batch_sharding", "mesh"):
            assert not hasattr(jax_svc._svc, attr)
            setattr(jax_svc._svc, attr, None)
        jax_got = jax_svc.run(img_dir, ocr_dir)
        assert _records(got) == _records(jax_got)
        # the CLI writes the same records
        out = str(tmp_path / "out.json")
        serve_artifact_main(["--artifact_dir", f["art"], "--dir_image",
                             img_dir, "--dir_ocr", ocr_dir, "--dir_save", out,
                             "--device", "cpu"])
        with open(out) as fh:
            assert _records(json.load(fh)) == _records(got)


# ------------------------------------------------------------------ errors
def test_check_run_artifact_prints_end(lilt, capsys):
    out = check_run(lilt["art"], device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == "End"
    assert printed[:-1] == [f"{n}: {sorted(out[n])}" for n in out]


def test_device_mismatch_and_no_gpu_raise(lilt, tmp_path):
    meta_path = os.path.join(lilt["art"], "artifact_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    cuda_art = tmp_path / "cuda_art"
    cuda_art.mkdir()
    for name in ("config.json", "toy_tokenizer.json"):
        (cuda_art / name).write_bytes(
            open(os.path.join(lilt["art"], name), "rb").read())
    (cuda_art / "artifact_meta.json").write_text(
        json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="exported for cuda"):
        load_artifact(str(cuda_art), device="cpu")
    if torch.cuda.is_available():
        return
    for call in (
            lambda: export_main(["--model_name_or_path", lilt["dir"],
                                 "--output_dir", str(tmp_path / "x")]),
            lambda: load_artifact(lilt["art"]),
            lambda: ArtifactInferenceService(lilt["art"]),
            lambda: check_run(lilt["art"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "x").exists()
