"""The serving forward as CUDA-graph replays (``pipeline/graphs.py``).

On the CPU, with a stand-in for the capture (its "replay" runs the body
again and writes into the captured outputs, as a replay writes into a
graph's): the graphed callable keys by shape, reads its arguments from the
static buffers, and returns outputs that later calls do not overwrite; the
hooks on the backbone, the decoder and its combine fire once per served
batch with that batch's values; every route that must not replay runs
eagerly and counts so; and the per-layer metric that reads the counters.
On the card (``cuda`` marker; ``python -m pytest --noconftest -m cuda
tests/test_torch_serving_graphs.py``, this file imports no JAX): graphed
against eager spots bit for bit, and a batch's spots unchanged by the next
replay."""

import json
import os
import random

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from peneo_tpu_torch.config import LiltConfig, PEneoConfig
from peneo_tpu_torch.data.synthetic import ToyTokenizer, make_document
from peneo_tpu_torch.models.decoder import pack_spots
from peneo_tpu_torch.models.peneo import PEneoModel
from peneo_tpu_torch.parallel.tensor_parallel import TpShard
from peneo_tpu_torch.pipeline import graphs
from peneo_tpu_torch.pipeline.infer import InferenceService, stack_rows
from peneo_tpu_torch.utils import tracing

L, K, B = 64, 8, 2
PAGES = 5  # two full batches and a tail batch of one
COUNTERS = (graphs.REPLAY, graphs.CAPTURE, graphs.EAGER)


class StandIn:
    """The capture's stand-in on the CPU: a replay runs the body again on
    the static arguments and copies its outputs into the captured ones."""

    def __init__(self):
        self.warmed = self.captured = self.replayed = 0

    def warm(self, body):
        self.warmed += 1
        return body()

    def capture(self, body):
        self.captured += 1
        out = body()

        def replay():
            self.replayed += 1
            for dst, src in zip(tree_leaves(out), tree_leaves(body())):
                dst.copy_(src)

        return replay, out


def write_model(root, tok, device_ready=False, **cfg_kw):
    """A tiny LiLT model directory; ``device_ready``: widths the CUDA
    kernel takes (text heads of 64, layout heads of 16)."""
    width = (dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=256) if device_ready else
             dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                  intermediate_size=64))
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(vocab_size=tok.vocab_size,
                                   max_position_embeddings=L + 8,
                                   **width).to_dict(),
        pair_block_size=16, max_seq_len=L, initializer_range=0.15,
        **{"max_spots_per_head": K, **cfg_kw})
    cfg.save_pretrained(root)
    tok.save_pretrained(root)
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), os.path.join(root, "pytorch_model.bin"))
    return root


def write_pages(root, n):
    img_dir, ocr_dir = os.path.join(root, "images"), os.path.join(root, "ocr")
    os.makedirs(img_dir)
    os.makedirs(ocr_dir)
    from PIL import Image

    rng = random.Random(11)
    for i in range(n):
        doc = make_document(rng, f"p{i}.png", n_pairs=1 + 3 * i, n_noise=1)
        Image.new("RGB", (100, 140), "white").save(f"{img_dir}/p{i}.png")
        with open(f"{ocr_dir}/p{i}.json", "w") as f:
            json.dump([{"text": ln["text"], "bbox": ln["bbox"]}
                       for e in doc["entities"] for ln in e["lines"]], f)
    return img_dir, ocr_dir


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graphs"))
    tok = ToyTokenizer()
    model_dir = write_model(os.path.join(root, "model"), tok)
    dense_dir = write_model(os.path.join(root, "dense"), tok,
                            max_spots_per_head=0)
    img_dir, ocr_dir = write_pages(root, PAGES)
    return tok, model_dir, dense_dir, img_dir, ocr_dir


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def service(site, stand_in=None, model_dir=None, monkeypatch=None):
    """A CPU service; with ``stand_in`` its forwards go through the graphed
    route with the stand-in capture."""
    tok, path = site[0], model_dir or site[1]
    if stand_in is not None:
        monkeypatch.setattr(graphs, "capture_for", lambda device: stand_in)
    svc = InferenceService(path, tokenizer=tok, dtype="float32",
                           batch_size=B, device="cpu")
    if stand_in is not None:
        monkeypatch.undo()
    return svc


def records(results):
    """The records without their timings."""
    return {name: {k: v for k, v in rec.items() if k != "seconds"}
            for name, rec in results.items()}


def counted():
    now = tracing.counters()
    return {name: now.get(name, 0) for name in COUNTERS}


# ----------------------------------------------------------- the mechanism
def test_graphed_callable_keys_by_shape_and_reads_its_static_inputs():
    cap = StandIn()
    fn = graphs.GraphedCallable(
        lambda x, y, scale: {"sum": x + y * scale, "rows": (x > 0).sum(1),
                             "pair": (x.to(torch.bfloat16),
                                      y.to(torch.int8))}, cap)
    gen = torch.Generator().manual_seed(0)
    calls = [(torch.randn(3, 5, generator=gen), torch.randn(3, 5,
                                                            generator=gen), 2)
             for _ in range(3)]
    calls.append((torch.randn(4, 5, generator=gen),
                  torch.randn(4, 5, generator=gen), 2))
    calls.append((calls[0][0], calls[0][1], 3))  # a plain value keys too
    lasts = []
    for x, y, scale in calls:
        out = fn(x, y, scale)
        lasts.append(fn.last)
        torch.testing.assert_close(out["sum"], x + y * scale, rtol=0, atol=0)
        assert torch.equal(out["rows"], (x > 0).sum(1))
        assert out["pair"][0].dtype == torch.bfloat16
        assert torch.equal(out["pair"][1], y.to(torch.int8))
    assert lasts == ["capture", "replay", "replay", "capture", "capture"]
    assert fn.captures == 3 and cap.captured == 3 and cap.warmed == 3
    assert cap.replayed == 2


def test_graphed_outputs_do_not_alias_across_calls():
    fn = graphs.GraphedCallable(
        lambda x: {"a": x * 2, "b": x.sum(-1).to(torch.int64),
                   "c": (x > 0)}, StandIn())
    x1, x2, x3 = (torch.full((2, 3), v) for v in (1.0, 2.0, -3.0))
    fn(x1)  # the capture
    first = fn(x1)
    kept = {k: v.clone() for k, v in first.items()}
    second = fn(x2)
    fn(x3)
    for k in kept:
        assert torch.equal(first[k], kept[k]), k
        assert first[k].data_ptr() != second[k].data_ptr()
    assert torch.equal(second["a"], x2 * 2)


def test_packed_outputs_keep_every_dtype_and_shape():
    leaves = [torch.arange(3, dtype=torch.int8),
              torch.tensor([1.5, -2.0], dtype=torch.float64),
              torch.tensor([[True, False]]),
              torch.tensor(7, dtype=torch.int32),
              torch.randn(2, 3).to(torch.bfloat16), torch.randn(4, 1),
              torch.arange(6, dtype=torch.int32).view(2, 3)]
    flat, layout = graphs._pack(leaves)
    assert flat.dtype == torch.uint8
    assert [d for d, *_ in layout] == [torch.float64, torch.int32,
                                       torch.float32, torch.bfloat16,
                                       torch.int8, torch.bool]
    assert layout[1][3] == [3, 6]  # one run of int32, in the leaves' order
    for t, got in zip(leaves, graphs._unpack(flat.clone(), layout)):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got, t)


@pytest.mark.parametrize("shape,dtype", [((L,), np.int32),
                                         ((L, 4), np.int32),
                                         ((224, 224, 3), np.uint8)])
def test_stack_rows_is_np_stack(shape, dtype):
    rng = np.random.default_rng(7)
    rows = [rng.integers(0, 250, size=shape).astype(dtype)
            for _ in range(B + 3)]
    rows[1] = rows[1][::-1].copy()
    got = stack_rows([r[:40] for r in rows] if len(shape) > 1 else rows)
    want = np.stack([r[:40] for r in rows] if len(shape) > 1 else rows)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and got.flags.writeable
    with pytest.raises(ValueError, match="do not stack"):
        stack_rows([rows[0], rows[1][:-1]])


# ------------------------------------------------------------- the service
def test_hooks_fire_once_per_served_batch_with_its_values(site,
                                                          monkeypatch):
    eager = service(site)
    cap = StandIn()
    svc = service(site, cap, monkeypatch=monkeypatch)
    seen = {"backbone": [], "decoder": [], "combine": []}
    model = svc.model

    def keep(name):
        def hook(module, args, out):
            seen[name].append(([a.clone() for a in args],
                               [t.clone() for t in tree_leaves(out)]))
        return hook

    hooks = [model.backbone.register_forward_hook(keep("backbone")),
             model.peneo_decoder.register_forward_hook(keep("decoder")),
             model.peneo_decoder.handshaking_kernel.register_forward_hook(
                 keep("combine"))]
    try:
        got = svc.run(site[3], site[4], workers=2)
    finally:
        for h in hooks:
            h.remove()
    assert records(got) == records(eager.run(site[3], site[4], workers=2))
    n_batches = -(-PAGES // B)
    assert {k: len(v) for k, v in seen.items()} == {
        "backbone": n_batches, "decoder": n_batches, "combine": n_batches}
    # every batch is full (the tail batch is padded to B rows): the first
    # captured, the others replayed
    assert svc.last_run[graphs.CAPTURE] == 1
    assert svc.last_run[graphs.REPLAY] == n_batches - 1
    assert svc.last_run[graphs.EAGER] == 0
    assert cap.captured == 2 and cap.replayed == 2 * (n_batches - 1)
    # each hook saw its own batch: the eager modules on a hook's inputs
    # give what it saw returned, and each module's input is the batch's
    # output of the one before it
    ref = eager.model
    with torch.inference_mode():
        for name, module in (("backbone", ref.backbone),
                             ("decoder", ref.peneo_decoder),
                             ("combine",
                              ref.peneo_decoder.handshaking_kernel)):
            for args, outs in seen[name]:
                want = tree_leaves(module(*args))
                assert len(want) == len(outs)
                assert all(torch.equal(w, o) for w, o in zip(want, outs))
        for (bb_args, bb_out), (dec_args, _), (comb_args, _) in zip(
                seen["backbone"], seen["decoder"], seen["combine"]):
            hidden = bb_out[0][:, 1:bb_args[0].shape[1]]  # last_hidden_state
            assert torch.equal(dec_args[0], hidden)
            assert torch.equal(comb_args[0], ref.peneo_decoder.
                               shrink_projection(hidden))
    assert len({tuple(args[0].flatten().tolist())
                for args, _ in seen["backbone"]}) == n_batches


def test_graphed_and_eager_services_give_the_same_records(site,
                                                          monkeypatch):
    svc = service(site, StandIn(), monkeypatch=monkeypatch)
    eager = service(site)
    for _ in range(2):
        assert records(svc.run(site[3], site[4])) == records(
            eager.run(site[3], site[4]))
    assert svc.last_run[graphs.REPLAY] == -(-PAGES // B)
    assert eager.last_run[graphs.EAGER] == -(-PAGES // B)


def _forward_counts(svc, **kwargs):
    """One forward of a full batch through the service's route →
    the three counters it added."""
    ids = torch.randint(1, 50, (B, L))
    ids[:, -9:] = 0
    bbox = torch.randint(0, 1000, (B, L, 4)).sort(-1).values
    before = counted()
    with torch.inference_mode():
        svc.graphs(ids, bbox, (ids != 0).long(), None, **kwargs)
    return {k: v - before[k] for k, v in counted().items()}


EAGER_ONE = {graphs.REPLAY: 0, graphs.CAPTURE: 0, graphs.EAGER: 1}


@pytest.mark.parametrize("route", ["cpu", "tp", "sp", "dense_logits",
                                   "dense_service", "labels", "short_batch",
                                   "training"])
def test_routes_that_must_not_replay_run_eagerly(site, monkeypatch, route):
    cap = StandIn()
    svc = (service(site) if route == "cpu" else
           service(site, cap, model_dir=site[2], monkeypatch=monkeypatch)
           if route == "dense_service" else
           service(site, cap, monkeypatch=monkeypatch))
    kwargs = {}
    if route == "tp":
        svc.model.peneo_decoder.tp = TpShard(0, 2)
    elif route == "sp":
        svc.model.set_sequence_parallel(0, 2)
    elif route == "dense_logits":
        kwargs["return_logits"] = True
    elif route == "labels":
        kwargs["labels"] = {n: torch.zeros((B, L - 1, L - 1),
                                           dtype=torch.int8)
                            for n in ("line_extraction", "ent_linking_h2h",
                                      "ent_linking_t2t", "line_grouping_h2h",
                                      "line_grouping_t2t")}
    elif route == "training":
        svc.model.train()
    if route == "short_batch":
        before = counted()
        svc.run_page(os.path.join(site[3], "p0.png"),
                     os.path.join(site[4], "p0.json"))
        got = {k: v - before[k] for k, v in counted().items()}
    else:
        got = _forward_counts(svc, **kwargs)
    assert got == EAGER_ONE
    assert cap.captured == cap.replayed == 0
    if route in ("cpu", "tp", "sp", "dense_service"):
        svc.model.eval()
        svc.run(site[3], site[4])
        assert svc.last_run[graphs.EAGER] == -(-PAGES // B)
        assert svc.last_run[graphs.REPLAY] == svc.last_run[
            graphs.CAPTURE] == 0


def test_a_replaying_service_counts_inside_dispatch(site, monkeypatch):
    svc = service(site, StandIn(), monkeypatch=monkeypatch)
    assert _forward_counts(svc) == {graphs.REPLAY: 0, graphs.CAPTURE: 1,
                                    graphs.EAGER: 0}
    assert _forward_counts(svc) == {graphs.REPLAY: 1, graphs.CAPTURE: 0,
                                    graphs.EAGER: 0}
    svc.run(site[3], site[4])  # the pages' dtypes: a capture of their own
    assert svc.last_run[graphs.CAPTURE] == 1
    with tracing.recording():
        svc.run(site[3], site[4])
    dispatched = [s for s in tracing.spans() if s.name == "serve.dispatch"]
    assert len(dispatched) == -(-PAGES // B)
    assert all(s.counts.get(graphs.REPLAY) == 1 for s in dispatched)


# -------------------------------------------------------------- the metric
def test_graph_replay_share_reads_the_dispatch_counters(monkeypatch):
    from benchmark import harness

    ms = 1_000_000
    read = harness.metric_reader("graph_replay_share.serve").read
    trace = harness.Trace([], [], 1 * ms, 11 * ms)
    for start, counts in [(0.5, {graphs.EAGER: 1}),      # before the window
                          (2, {graphs.CAPTURE: 1}),
                          (3, {graphs.REPLAY: 1}), (4, {graphs.REPLAY: 1}),
                          (5, {graphs.REPLAY: 1}), (6, {graphs.EAGER: 1})]:
        tracing.RECORDER.add(tracing.Span(
            "serve.dispatch", {}, thread=1, start_ns=int(start * ms),
            end_ns=int(start * ms) + ms // 2, counts=counts))
    assert read({}, trace) == pytest.approx(75.0)
    assert read({}, None) is None
    tracing.clear()
    tracing.RECORDER.add(tracing.Span("serve.dispatch", {}, thread=1,
                                      start_ns=2 * ms, end_ns=3 * ms,
                                      counts={"serve.tokens_real": 4}))
    assert read({}, trace) is None  # a program that counts no forwards


# ----------------------------------------------------------------- the card
@pytest.mark.cuda
def test_graphed_spots_equal_eager_spots_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs replay on the card")
    tok = ToyTokenizer()
    model_dir = write_model(str(tmp_path / "model"), tok, device_ready=True)
    svc = InferenceService(model_dir, tokenizer=tok, batch_size=4,
                           dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)

    def batch(n_real):
        ids = torch.randint(1, 200, (4, L), generator=gen)
        ids[:, n_real:] = 0
        bbox = torch.randint(0, 1000, (4, L, 4), generator=gen).sort(
            -1).values
        return [t.cuda() for t in (ids, bbox, (ids != 0).long())]

    batches = [batch(n) for n in (40, 64, 23)]
    with torch.inference_mode():
        # the same model, its segments not armed: the eager forward
        eager = [[t.cpu() for t in pack_spots(svc.model(*b))]
                 for b in batches]
        fetched = []
        for b in batches:
            out = svc._forward(*b, None)
            fetched.append((out, [t.cpu() for t in out]))
        torch.cuda.synchronize()
    assert svc.graphs.segments[0].captures == 1
    for (out, at_fetch), want in zip(fetched, eager):
        for got, kept, w in zip(out, at_fetch, want):
            # bit for bit, and the first batches' outputs are not
            # overwritten by the replays after them
            assert torch.equal(kept, w)
            assert torch.equal(got.cpu(), w)
    # weights moved after the capture: captured again, not read where they
    # were
    with torch.no_grad():
        for w in (svc.model.backbone.encoder.layer[0].output.dense.weight,
                  svc.model.peneo_decoder.line_extraction_fc[0].weight):
            w.data = w.data * 1.5
    with torch.inference_mode():
        want = [t.cpu() for t in pack_spots(svc.model(*batches[0]))]
        got = [t.cpu() for t in svc._forward(*batches[0], None)]
    assert svc.graphs.segments[0].last == "capture"
    assert all(map(torch.equal, got, want))


def test_a_module_moved_after_its_capture_is_captured_again(site,
                                                            monkeypatch):
    """A graph reads the parameters where they were at its capture: once a
    module's tensors move (``module.to``, a ``.data`` assignment), the next
    forward captures again, and serves what the eager model gives."""
    cap = StandIn()
    svc = service(site, cap, monkeypatch=monkeypatch)
    eager = service(site)
    assert _forward_counts(svc)[graphs.CAPTURE] == 1
    assert _forward_counts(svc)[graphs.REPLAY] == 1
    for model in (svc.model, eager.model):
        for w in (model.backbone.encoder.layer[0].output.dense.weight,
                  model.peneo_decoder.line_extraction_fc[0].weight):
            w.data = w.data * 1.5
    assert _forward_counts(svc)[graphs.CAPTURE] == 1
    assert cap.captured == 4
    assert _forward_counts(svc)[graphs.REPLAY] == 1
    assert records(svc.run(site[3], site[4])) == records(
        eager.run(site[3], site[4]))


def test_a_graphed_service_goes_with_its_last_reference(site, monkeypatch):
    """No reference cycle holds the model, its segments (and on the card
    their graphs and memory pool) once the service is dropped. The
    capture here keeps no reference to the body, as a CUDA graph keeps
    none."""
    import gc
    import weakref

    class Keepless(StandIn):
        def capture(self, body):
            return (lambda: None), body()

    svc = service(site, Keepless(), monkeypatch=monkeypatch)
    svc.run(site[3], site[4])
    kept = [weakref.ref(x) for x in (svc.model, *svc.graphs.segments)]
    gc.disable()
    try:
        del svc
        assert [r() for r in kept] == [None] * 3
    finally:
        gc.enable()
