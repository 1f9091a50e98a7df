"""The port's LayoutLMv3 against the benchmark's plain float32 reference
(``benchmark/reference/layoutlmv3.py`` with ``reference/decoder.py``), at a
tiny size on the CPU (hidden 48, 2 layers of 4 heads, a 32-px image in 8-px
patches: 17 image positions), in float32, on seeded weights named by the
reference's parameter table: the backbone's text and image hidden states,
the pair logits, the reference's page inputs against ``PagePreprocessor``'s
(CLS and SEP, the cut at 510 tokens, the pixels), and the spans and
counters that the page image adds to serving."""

import os

import numpy as np
import pytest
import torch

from benchmark import harness, scans, weights
from benchmark.entries import serve, serve_scans
from benchmark.reference import decoder as ref_decoder
from benchmark.reference import layoutlmv3 as ref_v3
from benchmark.tests.tiny_scans import tiny_config
from peneo_tpu_torch.config import PEneoConfig
from peneo_tpu_torch.data.image_processing import device_image_normalize
from peneo_tpu_torch.models.peneo import PEneoModel
from peneo_tpu_torch.pipeline.infer import InferenceService
from peneo_tpu_torch.utils import tracing

torch.set_num_threads(1)
L, B = 64, 3
IMAGE_COUNTERS = ("preprocess.images", "preprocess.image_bytes",
                  "serve.visual_tokens", "serve.image_bytes")
# Both sides compute in float32 on the CPU, in other orders: the bias is a
# gather of table rows in the program and a one-hot product in the
# reference, and the embedding sum and the attention are grouped otherwise.
# On values up to ~3 the states and logits differ by 1.2-2.1e-6 at most (a
# few ulp); 5e-5 leaves room for other CPUs' kernels, while a swapped or
# transposed image, or a bias left undivided, moves them by 1e-2 or more.
TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    table, zero_rows = serve.param_table(cfg)
    w = weights.make(table, zero_rows, 2024, cfg["initializer_range"],
                     torch.float32, "cpu")
    pc = PEneoConfig(backbone_name=cfg["backbone_name"],
                     backbone_config=harness.backbone_config(cfg),
                     max_seq_len=L, **cfg["peneo"])
    model = PEneoModel(pc)
    model.load_state_dict(w)  # strict: the reference names every tensor
    return cfg, w, model.eval()


def inputs(seed):
    """CLS, tokens, SEP and padding on three rows of different lengths
    (one full), random boxes, random normalised images."""
    g = torch.Generator().manual_seed(seed)
    n = torch.tensor([L, 40, 17])  # real rows, CLS and SEP included
    ids = torch.randint(4, 2000, (B, L), generator=g)
    ids[:, 0] = 1
    ids[torch.arange(B), n - 1] = 2
    mask = (torch.arange(L)[None] < n[:, None]).long()
    ids = ids * mask
    corner = torch.randint(0, 900, (B, L, 2), generator=g)
    size = torch.randint(1, 90, (B, L, 2), generator=g)
    bbox = torch.cat([corner, corner + size], -1) * mask[..., None]
    bbox[:, 0] = 0
    bbox[torch.arange(B), n - 1] = 0
    image = torch.randn(B, 3, 32, 32, generator=g)
    return ids, bbox, mask, image


@pytest.mark.parametrize("seed", [1, 2])
def test_backbone_text_and_image_states_match_the_reference(tiny, seed):
    cfg, w, model = tiny
    ids, bbox, mask, image = inputs(seed)
    with torch.no_grad():
        mine = ref_v3.forward(harness.backbone_config(cfg), w, ids, bbox,
                              mask, image)
        theirs = model.backbone(ids, bbox, mask,
                                image=image)["last_hidden_state"]
    assert mine.shape == theirs.shape == (B, L + 17, 48)
    real = mask.bool()
    torch.testing.assert_close(mine[:, :L][real], theirs[:, :L][real], **TOL)
    torch.testing.assert_close(mine[:, L:], theirs[:, L:], **TOL)


def test_pair_logits_match_the_reference(tiny):
    cfg, w, model = tiny
    ids, bbox, mask, image = inputs(3)
    with torch.no_grad():
        out = model(ids, bbox, mask, image=image, return_logits=True)
        hidden = ref_v3.forward(harness.backbone_config(cfg), w, ids, bbox,
                                mask, image)
        for b in range(B):
            for r, c, logits in ref_decoder.pair_logits(w, hidden[b, 1:L],
                                                        rows=16):
                upper = r[:, None] <= c[None, :]
                for name, _ in ref_decoder.HEADS:
                    got = out[name]["logits"][b][r][:, c]
                    torch.testing.assert_close(logits[name][upper],
                                               got[upper], **TOL)


def test_the_reference_sees_the_image_and_its_layout(tiny):
    # each of the faults the benchmark's check is built to catch moves the
    # reference's text states far beyond the tolerance above
    cfg, w, _ = tiny
    bb = harness.backbone_config(cfg)
    ids, bbox, mask, image = inputs(4)
    with torch.no_grad():
        sound = ref_v3.forward(bb, w, ids, bbox, mask, image)[:, :L]
        for moved in (image.flip(1), image.transpose(2, 3)):
            other = ref_v3.forward(bb, w, ids, bbox, mask, moved)[:, :L]
            assert (other - sound)[mask.bool()].abs().max() > 1e-2


def test_page_inputs_match_the_program(tmp_path):
    from peneo_tpu_torch.data.fetchers import fetch_xlm
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.pipeline.preprocess import PagePreprocessor

    traffic = harness.read_json(os.path.join(
        harness.bench_dir(harness.ROOT), "traffic", "forms_scanned.json"))
    traffic.update(pages_per_job=10, directories=1)
    d = scans.make_directories(str(tmp_path), traffic, 99)[0]
    size, seq = 224, 512
    cfg = PEneoConfig(backbone_name="layoutlmv3-base-chinese",
                      backbone_config={"input_size": size})
    prep = PagePreprocessor(tokenizer=ToyTokenizer(), fetcher=fetch_xlm,
                            max_token_len=seq - 2, max_seq_len=seq,
                            add_cls_token=True, add_sep_token=True,
                            image_cfg=cfg, raw_image=True)
    cut = 0
    for name, line_tokens in sorted(d["lines"].items()):
        img = os.path.join(d["images"], name)
        ocr = os.path.join(d["ocr"], name[:-4] + ".json")
        arrays, texts, boxes, seq_len = prep(img, ocr)
        mine = serve_scans.page_inputs(img, ocr, seq, size)
        for key in ("input_ids", "bbox", "attention_mask"):
            np.testing.assert_array_equal(mine[key], arrays[key])
        assert mine["texts"] == texts
        assert mine["boxes"] == [list(b) for b in boxes]
        assert mine["seq_len"] == seq_len
        assert mine["input_ids"][seq_len] == 2  # the SEP after the tokens
        assert seq_len == scans.served_tokens(line_tokens, seq - 1)
        torch.testing.assert_close(mine["image"], pixels(arrays),
                                   rtol=0, atol=0)
        cut += sum(line_tokens) > seq - 2
    assert cut  # the cut at 510 tokens is exercised
    # a page in colour: the channels differ, so a swap of them would show
    tinted = str(tmp_path / "tinted.png")
    scans.tinted(img, tinted)
    mine = serve_scans.page_inputs(tinted, ocr, seq, size)
    torch.testing.assert_close(mine["image"], pixels(prep(tinted, ocr)[0]),
                               rtol=0, atol=0)
    assert (mine["image"][0] - mine["image"][2]).abs().mean() > 0.05


def pixels(arrays):
    """The program's served pixels of one page, normalized on the device's
    path."""
    return device_image_normalize(
        torch.from_numpy(arrays["image"].copy())[None], "layoutlmv3")[0]


@pytest.fixture(scope="module")
def served_v3(tmp_path_factory, tiny):
    """The tiny model as a served directory, and three inked pages."""
    cfg, _, _ = tiny
    root = str(tmp_path_factory.mktemp("served_v3"))
    model_dir = os.path.join(root, "model")
    serve.write_model_dir(model_dir, cfg, {"max_seq_len": L}, 2024, "cpu")
    traffic = harness.read_json(os.path.join(
        harness.bench_dir(harness.ROOT), "traffic", "forms_scanned.json"))
    traffic.update(pages_per_job=3, directories=1,
                   tokens=dict(traffic["tokens"], median=24, min=4, max=90))
    d = scans.make_directories(os.path.join(root, "pages"), traffic, 5)[0]
    svc = InferenceService(model_dir, batch_size=2, dtype="float32",
                           max_seq_len=L, device="cpu")
    return svc, d


def test_a_page_image_records_its_span_and_counters(served_v3):
    svc, d = served_v3
    tracing.clear()
    try:
        with tracing.recording():
            results = svc.run(d["images"], d["ocr"], workers=2)
        spans = tracing.spans()
    finally:
        tracing.clear()
    assert len(results) == 3
    by_id = {s.id: s for s in spans}
    images = [s for s in spans if s.name == "serve.preprocess.image"]
    assert sorted(s.attrs["page"] for s in images) == [0, 1, 2]
    assert all(by_id[s.parent].name == "serve.preprocess" for s in images)
    files = sum(os.path.getsize(os.path.join(d["images"], n))
                for n in d["lines"])
    rows = 2 * 2  # two batches of batch_size 2, the tail's copy included
    assert {k: svc.last_run[k] for k in IMAGE_COUNTERS} == {
        "preprocess.images": 3, "preprocess.image_bytes": files,
        "serve.visual_tokens": rows * 17,
        "serve.image_bytes": rows * 32 * 32 * 3}
    dispatched = [s for s in spans if s.name == "serve.dispatch"]
    assert sum(s.counts["serve.visual_tokens"] for s in dispatched) == 68
