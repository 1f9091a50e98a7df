"""The page-image cell (``entries/serve_scans.py``) at a tiny size on the
CPU: it runs and its check holds the sound program; the check fails a page
image whose channels are swapped or that is left unnormalized, a patch grid
read transposed, and a relative bias left undivided by √d or dropped; the
inked pages are a function of the seed, carry the forms traffic's text and
dense paper noise; the FLOP and byte counts of the
reference and of kernel #4 against counts made independently; the new
metrics' readers."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, pages, scans, weights
from benchmark.entries import serve
from benchmark.reference import layoutlmv3 as ref_v3
from benchmark.run import run_cell
from benchmark.tests.tiny_scans import CELL, tiny_config, tiny_root

SEED = 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny_scans")))


def run(root, **kw):
    return run_cell(CELL, SEED, 0.3, False, device="cpu", root=root, **kw)


def correct(checks):
    return all(c["ok"] for c in checks.values())


def test_the_program_as_configured_is_correct(root):
    out = run(root)
    assert correct(out["checks"]), out["checks"]
    assert out["checks"]["backbone_rows_compared"]["value"] == 4
    assert out["checks"]["backbone_rel_error"]["value"] < 1e-5
    assert out["checks"]["backbone_colour_rel_error"]["value"] < 1e-5
    assert set(out["metrics"]) == {"serve_pages_per_s", "setup_s"}
    assert out["failed"] == 0 and out["attempted"] >= 8
    # CLS, the tokens and the SEP of every page; 17 image positions a row
    assert all(2 <= n <= 64 for b in out["run"]["batches"] for n in b)
    assert out["last_run"]["serve.visual_tokens"] == 2 * 4 * 17


def _swap(monkeypatch):
    from peneo_tpu_torch.data import image_processing

    normalize = image_processing.device_image_normalize
    monkeypatch.setattr(image_processing, "device_image_normalize",
                        lambda image, family: normalize(image.flip(-1),
                                                        family))


def _unnormalized(monkeypatch):
    from peneo_tpu_torch.data import image_processing

    monkeypatch.setattr(image_processing, "device_image_normalize",
                        lambda image, family: (image.float() / 255.0)
                        .permute(0, 3, 1, 2))


def _transpose(monkeypatch):
    from peneo_tpu_torch.models import layoutlmv3

    monkeypatch.setattr(
        layoutlmv3.PatchEmbed, "forward",
        lambda self, image: self.proj(image).transpose(2, 3).flatten(2)
        .transpose(1, 2))


def _undivided(monkeypatch):
    from peneo_tpu_torch.models import layoutlmv3

    init = layoutlmv3.LayoutLMv3Model.__init__

    def undivided(self, cfg):
        init(self, cfg)
        self.bias_div = 1.0

    monkeypatch.setattr(layoutlmv3.LayoutLMv3Model, "__init__", undivided)


def _dropped(monkeypatch):
    from peneo_tpu_torch.models import layoutlmv3

    rel_bias = layoutlmv3.RelBiasBackbone.rel_bias
    monkeypatch.setattr(layoutlmv3.RelBiasBackbone, "rel_bias",
                        lambda self, *a: torch.zeros_like(rel_bias(self, *a)))


WHOLE = {"spot_error_rms", "backbone_rel_error", "backbone_colour_rel_error"}


# the served pages are grayscale: a swap of the channels shows only in the
# backbone stage's tinted rows
@pytest.mark.parametrize("fault,fails", [
    (_swap, {"backbone_colour_rel_error"}),
    (_unnormalized, WHOLE),
    (_transpose, WHOLE),
    (_undivided, WHOLE),
    (_dropped, WHOLE)])
def test_a_fault_of_the_image_or_the_bias_fails(root, monkeypatch, fault,
                                               fails):
    fault(monkeypatch)
    checks = run(root)["checks"]
    assert {k for k, c in checks.items() if not c["ok"]} == fails, checks


def _traffic(**kw):
    traffic = harness.read_json(os.path.join(
        harness.bench_dir(harness.ROOT), "traffic", "forms_scanned.json"))
    traffic.update(pages_per_job=3, directories=1, **kw)
    return traffic


def test_inked_pages_are_the_forms_pages_drawn_from_the_seed(tmp_path):
    traffic = _traffic()
    made = {}
    for name, seed in (("a", 7), ("b", 7), ("c", 8)):
        made[name] = scans.make_directories(str(tmp_path / name), traffic,
                                            seed)[0]
    plain = pages.make_directories(str(tmp_path / "plain"), traffic, 7)[0]
    assert made["a"]["lines"] == plain["lines"]

    def files(d, sub, name):
        with open(os.path.join(d[sub], name), "rb") as f:
            return f.read()

    names = sorted(plain["lines"])
    for name in names:
        stem = name[:-4] + ".json"
        assert files(made["a"], "ocr", stem) == files(plain, "ocr", stem)
        assert files(made["a"], "images", name) == files(made["b"], "images",
                                                         name)
        assert files(made["a"], "images", name) != files(made["c"], "images",
                                                         name)
    from PIL import Image

    first = os.path.join(made["a"]["images"], names[0])
    with Image.open(first) as im:
        assert im.size == tuple(traffic["page_size"]) and im.mode == "L"
        levels = np.asarray(im)
    with open(os.path.join(made["a"]["ocr"], names[0][:-4] + ".json")) as f:
        x0, y0, x1, y1 = json.load(f)[0]["bbox"]
    inked = (levels[y0:y1, x0:x1] < 128).mean()
    assert inked > 0.05  # the first line is inked
    paper = levels[-traffic["margin"]:]  # the bottom margin: bare paper
    assert (paper != traffic["ink"]["paper"]).mean() > 0.5  # dense noise
    assert abs(paper.std() - traffic["ink"]["noise_sigma"]) < 0.1
    # the tinted copy: the same picture, in channels that differ
    scans.tinted(first, str(tmp_path / "tinted.png"))
    with Image.open(str(tmp_path / "tinted.png")) as im:
        rgb = np.asarray(im.convert("RGB")).astype(np.int16)
    assert abs((rgb[..., 2] - rgb[..., 0]).mean()) > 10
    order = np.argsort(levels[:8].ravel(), kind="stable")
    assert (np.diff(rgb[:8, :, 0].ravel()[order]) >= 0).all()


def test_served_rows_count_the_sep():
    assert scans.served_tokens([300, 200, 20], 511) == 501
    assert scans.served_tokens([300, 210], 511) == 511  # 510 tokens + SEP
    assert scans.served_tokens([300, 211], 511) == 301


def count_flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("n", [1, 9, 30])
def test_forward_flops_match_a_count_of_the_reference(n):
    cfg = tiny_config()
    bb = harness.backbone_config(cfg)
    table, zero_rows = serve.param_table(cfg)
    w = weights.make(table, zero_rows, 5, 0.2, torch.float32, "cpu")
    g = torch.Generator().manual_seed(n)
    ids = torch.randint(4, 2000, (1, n), generator=g)
    corner = torch.randint(0, 900, (1, n, 2), generator=g)
    bbox = torch.cat([corner, corner + 20], -1)
    image = torch.randn(1, 3, 32, 32, generator=g)
    with torch.no_grad():
        counted = count_flops(ref_v3.forward, bb, w, ids, bbox,
                              torch.ones_like(ids), image)
    P = n + 17
    # the bias's one-hot maps: the reference's way to read its tables
    one_hot = 2 * P * P * 4 * (bb["rel_pos_bins"] + 2 * bb["rel_2d_pos_bins"])
    assert counted == ref_v3.forward_flops(bb, n) + one_hot


def test_forward_flops_by_hand():
    bb = harness.backbone_config(tiny_config())
    n, h, inter, layers = 5, 48, 96, 2
    P = n + 17
    patch = 16 * (3 * 8 * 8) * h
    per_layer = P * (4 * h * h + 2 * h * inter) + 2 * P * P * h
    assert ref_v3.forward_flops(bb, n) == 2 * (patch + layers * per_layer)


def test_bias_roofline_counts_by_hand():
    kernel = harness.roofline("bias_fwd")
    bb = harness.backbone_config(tiny_config())  # 4 heads of 12, 17 image
    flops, nbytes = kernel.cost(bb, [3, 5])

    def attention(q, k, v, bias):
        return torch.softmax(q @ k.transpose(-1, -2) + bias, -1) @ v

    counted = 0
    for n in (3, 5):
        q, k, v = (torch.randn(4, n + 17, 12) for _ in range(3))
        counted += count_flops(attention, q, k, v,
                               torch.randn(4, n + 17, n + 17))
    assert flops == counted
    # q, k, v and the output in bf16, the fp32 bias rows, the fp32 key mask
    assert nbytes == sum(4 * 4 * p * 12 * 2 + 4 * p * p * 4 + 4 * p
                         for p in (20, 22))


def test_the_new_readers_read_nothing_without_their_sources():
    from peneo_tpu_torch.utils import tracing

    trace = harness.Trace([], [], 0, 10_000_000)
    for name in ("bias_fwd_roofline", "image_ms_per_page"):
        read = harness.metric_reader(name).read
        assert read({"batches": [[3]], "spans": {}}, None) is None
    read = harness.metric_reader("image_ms_per_page").read
    tracing.clear()
    try:
        assert read({}, trace) is None  # no span: a program without it
        for cpu in (2, 4):
            tracing.RECORDER.add(tracing.Span(
                "serve.preprocess.image", {}, thread=1, start_ns=1_000_000,
                end_ns=9_000_000, cpu_start_ns=0, cpu_end_ns=cpu * 1_000_000))
        assert read({}, trace) == pytest.approx(3.0)
    finally:
        tracing.clear()


def test_the_int8_control_is_not_correct(root):
    sound = run(root)["checks"]
    control = run(root, precision="int8")["checks"]
    assert not correct(control)
    for name in ("backbone_rel_error", "pair_head_rel_error"):
        assert control[name]["value"] > 10 * sound[name]["value"], control
