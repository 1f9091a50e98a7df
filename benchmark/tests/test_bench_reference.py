"""The plain references against the program at a tiny geometry on the CPU,
and the benchmark's FLOP and byte counts against hand counts."""

from __future__ import annotations

import os
import random

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, pages, weights
from benchmark.entries import serve
from benchmark.reference import decoder as ref_decoder
from benchmark.reference import judge
from benchmark.reference import lilt as ref_lilt
from benchmark.reference import pages as ref_pages

L = 64


def tiny_config(std=0.2):
    cfg = harness.read_json(os.path.join(
        harness.bench_dir(harness.ROOT), "configs", "lilt-infoxlm-base.json"))
    cfg.update(hidden_size=48, num_attention_heads=4, intermediate_size=96,
               num_hidden_layers=2, vocab_size=2000, initializer_range=std)
    cfg["peneo"].update(max_spots_per_head=64, pair_block_size=16)
    return cfg


def program_model(cfg, w):
    from peneo_tpu_torch.config import PEneoConfig
    from peneo_tpu_torch.models.peneo import PEneoModel

    pc = PEneoConfig(backbone_name=cfg["backbone_name"],
                     backbone_config=harness.backbone_config(cfg),
                     max_seq_len=L, **cfg["peneo"])
    model = PEneoModel(pc)
    model.load_state_dict(w)
    return model.eval()


def inputs(seed, B=3):
    g = torch.Generator().manual_seed(seed)
    n = torch.tensor([L, 40, 17][:B])
    ids = torch.randint(4, 2000, (B, L), generator=g)
    ids[:, 0] = 1
    mask = (torch.arange(L)[None] < n[:, None]).long()
    ids = ids * mask
    corner = torch.randint(0, 900, (B, L, 2), generator=g)
    size = torch.randint(1, 90, (B, L, 2), generator=g)
    bbox = torch.cat([corner, corner + size], -1) * mask[..., None]
    return ids, bbox, mask


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    table, zero_rows = serve.param_table(cfg)
    w = weights.make(table, zero_rows, 2024, cfg["initializer_range"],
                     torch.float32, "cpu")
    return cfg, w, program_model(cfg, w)


def test_lilt_reference_matches_the_program(tiny):
    cfg, w, model = tiny
    ids, bbox, mask = inputs(1)
    with torch.no_grad():
        mine = ref_lilt.forward(harness.backbone_config(cfg), w, ids, bbox,
                                mask)
        theirs = model.backbone(ids, bbox, mask)["last_hidden_state"]
    torch.testing.assert_close(mine, theirs, rtol=1e-4, atol=1e-4)


def test_decoder_reference_matches_the_program(tiny):
    cfg, w, model = tiny
    ids, bbox, mask = inputs(2)
    with torch.no_grad():
        hidden = model.backbone(ids, bbox, mask)["last_hidden_state"]
        out = model.peneo_decoder(hidden[:, 1:], return_logits=True)
        for b in range(hidden.shape[0]):
            for r, c, logits in ref_decoder.pair_logits(w, hidden[b, 1:],
                                                        rows=16):
                for name, _ in ref_decoder.HEADS:
                    got = out[name]["logits"][b][r][:, c]
                    upper = r[:, None] <= c[None, :]
                    torch.testing.assert_close(logits[name][upper],
                                               got[upper], rtol=1e-4,
                                               atol=1e-6)


def tiny_traffic():
    traffic = harness.read_json(os.path.join(
        harness.bench_dir(harness.ROOT), "traffic", "forms.json"))
    traffic.update(pages_per_job=12, directories=1,
                   tokens=dict(traffic["tokens"], median=40, min=4, max=120))
    return traffic


def test_page_inputs_match_the_program(tmp_path):
    from peneo_tpu_torch.data.fetchers import fetch_xlm
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.pipeline.preprocess import PagePreprocessor

    d = pages.make_directories(str(tmp_path), tiny_traffic(), 99)[0]
    prep = PagePreprocessor(tokenizer=ToyTokenizer(), fetcher=fetch_xlm,
                            max_token_len=L - 1, max_seq_len=L,
                            add_cls_token=True, add_sep_token=False)
    truncated = 0
    for name, line_tokens in sorted(d["lines"].items()):
        img = os.path.join(d["images"], name)
        ocr = os.path.join(d["ocr"], name[:-4] + ".json")
        arrays, texts, boxes, seq_len = prep(img, ocr)
        mine = ref_pages.page_inputs(img, ocr, L, L - 1)
        for key in ("input_ids", "bbox", "attention_mask"):
            np.testing.assert_array_equal(mine[key], arrays[key])
        assert mine["texts"] == texts
        assert mine["boxes"] == [list(b) for b in boxes]
        assert mine["seq_len"] == seq_len
        assert seq_len == pages.served_tokens(line_tokens, L - 1)
        truncated += sum(line_tokens) > L - 1
    assert truncated  # the budget's cut is exercised


def random_heads(rng, n_tokens, grid, k=48):
    """Fetched-spot arrays of one page (B = 1) with dense random spots."""
    out = {}
    for name, classes in ref_decoder.HEADS:
        cells = [(i, j) for i in range(n_tokens) for j in range(i, n_tokens)]
        pick = rng.sample(cells, min(k, len(cells)))
        idx = np.full((1, k), 0, np.int32)
        tag = np.zeros((1, k), np.int8)
        score = np.full((1, k), -1.0, np.float32)
        for s, (i, j) in enumerate(pick):
            idx[0, s] = i * grid + j
            tag[0, s] = rng.randint(1, classes - 1)
            score[0, s] = rng.choice([0.25, 0.5, 0.75, rng.random()])
        out[name] = {"spot_idx": idx, "spot_tag": tag, "spot_score": score,
                     "spot_count": np.array([len(pick)], np.int32),
                     "seq_len": np.array([grid], np.int32)}
    return out


@pytest.mark.parametrize("seed", range(6))
def test_record_reference_matches_the_program(seed):
    from peneo_tpu_torch.pipeline.decode import decode_page_record

    rng = random.Random(seed)
    n_tokens, grid = 14, 20
    texts = [rng.choice(["ab", " cd", "e", " fg"]) for _ in range(n_tokens)]
    boxes = [[rng.randint(0, 50), rng.randint(0, 50), rng.randint(50, 99),
              rng.randint(50, 99)] for _ in range(n_tokens)]
    heads = random_heads(rng, n_tokens + 3, grid)
    theirs = decode_page_record(texts, heads, 0, n_tokens, 0.0, bbox=boxes)
    theirs.pop("seconds")
    spots = {name: serve.page_spots(
        *judge.spots_of_page(heads[name], 0)[:3], grid, n_tokens)
        for name, _ in ref_decoder.HEADS}
    assert ref_pages.record(texts, boxes, spots) == theirs
    assert theirs["lines"]  # the decode has something to compare


def count_flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("n", [1, 7, 30])
def test_forward_flops_match_a_count_of_the_reference(tiny, n):
    cfg, w, _ = tiny
    bb = harness.backbone_config(cfg)
    ids, bbox, mask = (t[:1, :n] for t in inputs(3, B=1))
    mask = torch.ones_like(mask)
    with torch.no_grad():
        counted = count_flops(ref_lilt.forward, bb, w, ids, bbox, mask)
        assert counted == ref_lilt.forward_flops(bb, n)
        hidden = torch.randn(n, ref_lilt.output_width(bb))
        counted = count_flops(
            lambda h: list(ref_decoder.pair_logits(w, h, rows=1)), hidden)
    assert counted == ref_decoder.forward_flops(
        bb, ref_lilt.output_width(bb), n)


def test_forward_flops_by_hand():
    cfg = tiny_config()
    bb = harness.backbone_config(cfg)
    n, h, lh, inter, layers = 5, 48, 12, 96, 2
    per_layer = 2 * n * (4 * h * h + 2 * h * inter + 4 * lh * lh
                         + 2 * lh * inter // 4) + 4 * 4 * n * n * (12 + 3)
    assert ref_lilt.forward_flops(bb, n) == 2 * n * 48 * lh \
        + layers * per_layer
    m, dec = 4, 24
    pairs = m * (m + 1) // 2
    assert ref_decoder.forward_flops(bb, 60, m) == 2 * (
        m * (60 * 48 + 48 * dec + 2 * dec * dec)
        + pairs * (5 * dec * dec + dec * (2 + 3 * 4)))


def test_biacm_roofline_counts_by_hand():
    kernel = harness.roofline("biacm_fwd")
    bb = harness.backbone_config(tiny_config())  # 4 heads of 12 + 3
    flops, nbytes = kernel.cost(bb, [3, 5])
    q = [torch.randn(4, n, d) for n in (3, 5) for d in (12, 3)]

    def attention(qt, ql):
        p = torch.softmax(qt @ qt.transpose(-1, -2)
                          + ql @ ql.transpose(-1, -2), -1)
        return p @ qt, p @ ql

    counted = sum(count_flops(attention, q[i], q[i + 1]) for i in (0, 2))
    assert flops == counted
    # q, k, v and the output of both streams in bf16, the fp32 key mask
    assert nbytes == sum(4 * 4 * n * (12 + 3) * 2 + 4 * n for n in (3, 5))


def _served(logits, grid, k, noise, seed, lowest=False):
    """The top (or, as a fault, the lowest) ``k`` nonzero-tag cells of the
    upper triangle by a score read ``noise`` low, as rounding in a logit
    that every cell shares moves them all, and a tenth of that apart."""
    g = torch.Generator().manual_seed(seed)
    p = torch.softmax(logits, -1)
    best_p, best = p.max(-1)
    score = best_p - noise * (1 + 0.1 * torch.randn(best_p.shape,
                                                 generator=g))
    upper = torch.ones(grid, grid, dtype=torch.bool).triu()
    flat = torch.arange(grid * grid).view(grid, grid)[upper & (best != 0)]
    pick = score[upper & (best != 0)]
    top = torch.topk(-pick if lowest else pick, k).indices
    f = flat[top]
    return f, best.view(-1)[f], score.view(-1)[f]


@pytest.mark.parametrize("crowd", [0.0, 1e-6])
def test_the_judge_reads_rounding_however_the_top_scores_crowd(crowd):
    # a head whose cells differ by a spread of 1e-2 or, crowded, of less
    # than the rounding: thousands of cells left out then pass the lowest
    # served score, each by rounding's amount, and the judge still reads
    # about the rounding (1e-6)
    grid, k = 96, 64
    g = torch.Generator().manual_seed(7)
    spread = crowd or 1e-2
    logits = spread * torch.randn(grid, grid, 3, generator=g)
    logits[..., 1] += 0.05  # tag 1 leads everywhere, by about the spread
    f, t, s = _served(logits, grid, k, 1e-6, 8)
    sq, n = judge.head_errors([(torch.arange(grid), torch.arange(grid),
                                logits)], f, t, s, k, grid)
    assert 2e-7 < (sq / n) ** 0.5 < 3e-6


def test_the_judge_fails_spots_that_are_not_the_top():
    grid, k = 96, 64
    logits = 1e-2 * torch.randn(grid, grid, 3,
                                generator=torch.Generator().manual_seed(7))
    f, t, s = _served(logits, grid, k, 0.0, 8, lowest=True)
    sq, n = judge.head_errors([(torch.arange(grid), torch.arange(grid),
                                logits)], f, t, s, k, grid)
    assert (sq / n) ** 0.5 > 1e-4
