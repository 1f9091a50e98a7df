"""``peneo_tpu_torch/utils/tracing.py`` and the spans and counters of
``PageServer.run``, on the CPU: nothing is recorded unless a
``recording()`` block or a profiler asks; every page's spans chain under
one page id; the counters equal counts made independently of them (the
pages' tokens, the pair cells the decoder's row blocks compute, the lines
the token limit cuts, the fetched spot counts); one spot-overflow warning a
call; a span starts on the profiler's clock; the bounded buffer counts
what it drops; the chrome trace loads."""

import json
import os
import random
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from peneo_tpu_torch.config import LiltConfig, PEneoConfig
from peneo_tpu_torch.data.synthetic import ToyTokenizer, make_document
from peneo_tpu_torch.models.peneo import PEneoModel
from peneo_tpu_torch.pipeline import decode as dec
from peneo_tpu_torch.pipeline.infer import InferenceService
from peneo_tpu_torch.pipeline.preprocess import deploy_text_cleanup, \
    read_ocr_json
from peneo_tpu_torch.utils import tracing

torch.set_num_threads(1)
L, K, B = 64, 8, 2
PAGES = 5  # two full batches and a tail batch of one


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny LiLT model directory and five pages: some past the token
    limit, every one past ``max_spots_per_head``."""
    root = str(tmp_path_factory.mktemp("tracing"))
    tok = ToyTokenizer()
    model_dir = os.path.join(root, "model")
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=L + 8).to_dict(),
        pair_block_size=16, max_seq_len=L, max_spots_per_head=K,
        initializer_range=0.15)
    cfg.save_pretrained(model_dir)
    tok.save_pretrained(model_dir)
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), os.path.join(model_dir,
                                                "pytorch_model.bin"))
    img_dir, ocr_dir = os.path.join(root, "images"), os.path.join(root, "ocr")
    os.makedirs(img_dir)
    os.makedirs(ocr_dir)
    from PIL import Image

    rng = random.Random(11)
    for i in range(PAGES):
        doc = make_document(rng, f"p{i}.png", n_pairs=1 + 3 * i, n_noise=1)
        Image.new("RGB", (100, 140), "white").save(f"{img_dir}/p{i}.png")
        with open(f"{ocr_dir}/p{i}.json", "w") as f:
            json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                       for e in doc["entities"] for ln in e["lines"]], f)
    svc = InferenceService(model_dir, tokenizer=tok, dtype="float32",
                           batch_size=B, device="cpu")
    svc.model_dir = model_dir
    return svc, img_dir, ocr_dir


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def serve(served, how=None):
    svc, img_dir, ocr_dir = served
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if how == "recording":
            with tracing.recording():
                results = svc.run(img_dir, ocr_dir, workers=3)
        elif how == "profiler":
            with profile(activities=[ProfilerActivity.CPU]):
                results = svc.run(img_dir, ocr_dir, workers=3)
        else:
            results = svc.run(img_dir, ocr_dir, workers=3)
    return results, [w for w in caught
                     if "exceed max_spots_per_head" in str(w.message)]


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_is_recorded_when_off(served):
    results, _ = serve(served)
    assert len(results) == PAGES
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert tracing.span("x") is tracing.span("y")  # the shared no-op
    # the counters stay on
    assert served[0].last_run["serve.token_slots"] == 3 * B * L


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_spans_are_recorded_when_asked(served, how):
    serve(served, how)
    names = by_name(tracing.spans())
    assert len(names["serve.run"]) == 1
    assert names["serve.run"][0].attrs["pages"] == PAGES
    for name in ("serve.wait_page", "serve.preprocess", "serve.decode",
                 "serve.preprocess.read", "serve.preprocess.order",
                 "serve.preprocess.tokenize", "serve.preprocess.pack"):
        assert len(names[name]) == PAGES, name
    for name in ("serve.dispatch", "serve.fetch"):
        assert len(names[name]) == 3, name
    serving = names["serve.run"][0].thread
    assert {s.thread for s in names["serve.wait_page"]
            + names["serve.dispatch"] + names["serve.fetch"]} == {serving}
    assert serving not in {s.thread for s in names["serve.preprocess"]}
    assert all(s.end_ns >= s.start_ns and s.cpu_ns >= 0
               for s in tracing.spans())


def test_a_text_only_page_records_no_image(served):
    serve(served, "recording")
    assert not [s for s in tracing.spans()
                if s.name == "serve.preprocess.image"]
    image_counters = ("preprocess.images", "preprocess.image_bytes",
                      "serve.visual_tokens", "serve.image_bytes")
    assert not set(image_counters) & set(tracing.counters())
    assert all(served[0].last_run[k] == 0 for k in image_counters)


def test_every_page_has_its_chain(served):
    serve(served, "recording")
    names = by_name(tracing.spans())
    job = names["serve.run"][0].attrs["job"]
    ids = {s.id: s for s in tracing.spans()}
    dispatch = {s.attrs["batch"]: s for s in names["serve.dispatch"]}
    fetch = {s.attrs["batch"]: s for s in names["serve.fetch"]}
    prep = {s.attrs["page"]: s for s in names["serve.preprocess"]}
    decode = {s.attrs["page"]: s for s in names["serve.decode"]}
    assert sorted(prep) == sorted(decode) == list(range(PAGES))
    for page in range(PAGES):
        p, d = prep[page], decode[page]
        dp, f = dispatch[d.attrs["batch"]], fetch[d.attrs["batch"]]
        assert {p.attrs["job"], d.attrs["job"], dp.attrs["job"],
                f.attrs["job"]} == {job}
        assert p.end_ns <= dp.start_ns <= dp.end_ns <= f.start_ns
        assert f.end_ns <= d.start_ns
        assert d.attrs["batch"] == page // B
        for child in names["serve.preprocess.read"]:
            if child.attrs["page"] == page:
                assert ids[child.parent] is p
    # a tail batch of one page
    assert dispatch[2].attrs["pages"] == 1 and dispatch[2].attrs["L"] == L


def test_counters_equal_independent_counts(served, monkeypatch):
    svc, img_dir, ocr_dir = served
    cells, fetched = [], []
    pair_block = svc.model.peneo_decoder.pair_block

    def counted_block(a_blk, b_cols):
        cells.append(a_blk.shape[0] * a_blk.shape[1] * b_cols.shape[1])
        return pair_block(a_blk, b_cols)

    monkeypatch.setattr(svc.model.peneo_decoder, "pair_block",
                        counted_block)
    record = dec.decode_page_record

    def capture(texts, out, i, *args):
        fetched.append((out, i))
        return record(texts, out, i, *args)

    monkeypatch.setattr(dec, "decode_page_record", capture)
    _, warned = serve(served, "recording")
    run = svc.last_run
    tok = svc.tokenizer
    lengths, cut = [], 0
    for name in sorted(os.listdir(ocr_dir)):
        texts, _ = read_ocr_json(os.path.join(ocr_dir, name))
        n = [len(tok.tokenize(deploy_text_cleanup(t))) for t in texts]
        # a page is cut where its lines' tokens pass the limit
        page = svc.preprocess_page(os.path.join(img_dir, name[:-5] + ".png"),
                                   os.path.join(ocr_dir, name))
        lengths.append(int(page[0]["attention_mask"].sum()) - 1)
        cut += sum(n) > svc.max_token_len
    assert 0 < cut < PAGES
    assert run["preprocess.pages_cut"] == cut
    assert run["serve.tokens_real"] == sum(n + 1 for n in lengths)
    assert run["serve.token_slots"] == 3 * B * L
    assert run["serve.pair_cells_real"] == sum(n * (n + 1) // 2
                                               for n in lengths)
    assert run["serve.pair_cells_computed"] == sum(cells)
    assert run["serve.pair_cells_computed"] > run["serve.pair_cells_real"]
    assert len(fetched) == PAGES
    total = 0
    for head in dec.HEAD_NAMES:
        found = [int(out[head]["spot_count"][i]) for out, i in fetched]
        dropped = sum(max(0, c - K) for c in found)
        assert run[f"decode.spots_found.{head}"] == sum(found)
        assert run[f"decode.spots_dropped.{head}"] == dropped
        total += dropped
    assert total > 0 and len(warned) == 1
    assert str(warned[0].message).startswith(f"{total} spots over {PAGES} ")
    # the window's dispatch spans carry the same counts
    spans = by_name(tracing.spans())["serve.dispatch"]
    assert sum(s.counts["serve.pair_cells_real"] for s in spans) == \
        run["serve.pair_cells_real"]


def evaluate(tmp_path):
    """``PEneoTrainer.evaluate`` of a tiny model over 4 synthetic pages →
    the spot-overflow warnings it gave."""
    from peneo_tpu_torch.data.collator import PEneoCollator
    from peneo_tpu_torch.data.datasets import RFUNDDataset
    from peneo_tpu_torch.data.fetchers import fetch_xlm
    from peneo_tpu_torch.data.synthetic import write_rfund_dataset
    from peneo_tpu_torch.pipeline import trainer

    root = write_rfund_dataset(str(tmp_path / "data"), n_train=2, n_val=4)
    tok = ToyTokenizer()
    ds = RFUNDDataset(root, "dev", "en", tokenizer=tok,
                      tokenizer_fetcher=fetch_xlm, max_token_len=L - 1,
                      add_cls_token=True)
    cfg = PEneoConfig(backbone_name="lilt-infoxlm-base",
                      backbone_config=LiltConfig(
                          vocab_size=tok.vocab_size, hidden_size=32,
                          num_hidden_layers=1, num_attention_heads=4,
                          intermediate_size=64,
                          max_position_embeddings=L + 8).to_dict(),
                      max_seq_len=L, max_spots_per_head=K, dtype="float32")
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.PEneoTrainer(
            cfg, model, trainer.TrainingArguments(
                output_dir=str(tmp_path / "run"),
                per_device_eval_batch_size=3, device="cpu"),
            eval_dataset=ds, collator=PEneoCollator(max_seq_len=L)).evaluate()
    return [w for w in caught if "exceed max_spots_per_head" in
            str(w.message)]


@pytest.mark.parametrize("api", ["run", "run_batch", "evaluate"])
def test_one_spot_overflow_warning_a_call(served, api, tmp_path):
    svc, img_dir, ocr_dir = served
    if api == "run":
        _, warned = serve(served)
        pages = PAGES
    elif api == "evaluate":
        warned = evaluate(tmp_path)
        pages = 4
    else:
        names = sorted(os.listdir(img_dir))[:B]
        batch = [svc.preprocess_page(os.path.join(img_dir, n),
                                     os.path.join(ocr_dir, n[:-4] + ".json"))
                 for n in names]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            svc.run_batch(batch)
        warned = [w for w in caught
                  if "exceed max_spots_per_head" in str(w.message)]
        pages = B
    assert len(warned) == 1
    message = str(warned[0].message)
    assert f"over {pages} page(s) exceed max_spots_per_head={K}" in message
    dropped = sum(n for k, n in tracing.counters().items()
                  if k.startswith("decode.spots_dropped."))
    assert message.startswith(f"{dropped} spots")


def test_a_span_starts_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with tracing.recording():
            with tracing.span("probe") as span, record_function("probe"):
                torch.ones(4).sum()
    event = next(e for e in prof.profiler.kineto_results.events()
                 if e.name() == "probe")
    assert abs(event.start_ns() - span.start_ns) < 1_000_000
    assert tracing.spans()[0] is span


@pytest.mark.parametrize("capacity,spans", [(4, 3), (4, 4), (4, 11)])
def test_the_buffer_counts_what_it_drops(monkeypatch, capacity, spans):
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity))
    with tracing.recording():
        for i in range(spans):
            with tracing.span("s", page=i):
                pass
    kept = tracing.spans()
    assert tracing.dropped() == max(0, spans - capacity)
    assert [s.attrs["page"] for s in kept] == \
        list(range(max(0, spans - capacity), spans))


def test_children_inherit_ids_and_counts_land_in_their_span():
    with tracing.recording():
        with tracing.span("outer", job=7, page=3) as outer:
            tracing.count("n", 2)
            with tracing.span("inner") as inner:
                tracing.count("n", 5)
    assert inner.parent == outer.id and inner.attrs == {"job": 7, "page": 3}
    assert outer.counts == {"n": 2} and inner.counts == {"n": 5}
    assert tracing.counters() == {"n": 7}


def test_counts_stay_exact_under_threads():
    threads, per, before = 16, 2000, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            tracing.count("c") for _ in range(per)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counters()["c"] == threads * per


def test_the_chrome_trace_loads(served, tmp_path):
    serve(served, "recording")
    spans = tracing.spans()
    path = str(tmp_path / "spans.json")
    assert tracing.write_chrome_trace(path, base_ns=spans[0].start_ns) == \
        len(spans)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) == len(spans)
    assert sorted(e["args"]["span_id"] for e in complete) == \
        sorted(s.id for s in spans)
    assert min(e["ts"] for e in complete) == 0
    counters = [e for e in events if e["ph"] == "C"
                and e["name"] == "serve.token_slots"]
    assert counters[-1]["args"]["serve.token_slots"] == 3 * B * L
    assert np.isclose(sum(e["dur"] for e in complete if e["name"]
                          == "serve.run"),
                      by_name(spans)["serve.run"][0].wall_ns / 1e3)


def test_serve_trace_out_writes_the_spans(served, tmp_path, capsys):
    from peneo_tpu_torch import serve as serve_cli

    svc, img_dir, ocr_dir = served
    path = str(tmp_path / "spans.json")
    with pytest.warns(UserWarning, match="exceed max_spots_per_head"):
        serve_cli.main([
            "--model_name_or_path", svc.model_dir, "--dir_image", img_dir,
            "--dir_ocr", ocr_dir, "--dir_save", str(tmp_path / "out.json"),
            "--batch_size", str(B), "--max_seq_len", str(L), "--dtype",
            "float32", "--device", "cpu", "--trace_out", path])
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"]
    assert names.count("serve.run") == 1
    assert names.count("serve.preprocess") == PAGES
    line = capsys.readouterr().out
    counts = json.loads(line[line.index("counters ") + 9:].strip())
    assert counts["serve.token_slots"] == 3 * B * L
    assert not tracing.active()
