"""Serving cells: directories of pages through ``InferenceService.run``.

Set-up writes the traffic's page directories and a model directory (the
configuration, the stand-in tokenizer and seeded weights in the served
type) under ``TMPDIR``, builds the service from that directory as a user
does, and serves a directory of one batch of pages (with no length buckets
every batch has the one shape). The window
then runs jobs back to back, one client, each a whole directory, cycling
through the directories, until ``seconds`` have passed; it spans the first
job's start to the last job's end, and ``serve_pages_per_s`` is every page
returned with a record over all of it.

The output check runs once the window has closed and the service is freed,
in two parts (``reference/judge.py`` judges spots against logits):

- the whole path: a sample of the window's pages drawn from the seed, the
  longest among them, goes through the plain float32 reference
  (``reference/``) from the same page files and weights; each page's
  served spots are held against the reference's logits, and its record
  against the reference's decode of those spots;
- the pair stage: one forward of the window, drawn from the seed, leaves
  the pair head's inputs (the combine's two halves) and the decoder's spots
  of its whole batch; the reference's pair head, in float32 from those
  inputs, judges the spots, each row and head against the scale of its
  logits. The bfloat16 rounding of the backbone and the shrink MLP, which
  sets most of the whole path's error, stays out of it, so that a pair head
  in a lower precision shows.

``precision`` is for the readings that set the limits, never a timed run:
``int8`` serves through the program's int8 pair head and backbone (its own
lower precision), ``int8_pair_head`` through its int8 pair head alone, and
``fp8`` puts the reference's pair head in float8 (``reference/control.py``)
in the program's place at the pair stage.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import random
import shutil
import statistics
import tempfile
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from .. import harness, pages, weights
from ..reference import control as ref_control
from ..reference import decoder as ref_decoder
from ..reference import judge
from ..reference import pages as ref_pages

PRECISIONS = {None: (False, False), "int8": (True, True),
              "int8_pair_head": (True, False), "fp8": (False, False)}


def param_table(config: Dict):
    bb = harness.backbone_config(config)
    ref = harness.reference_module(config["family"])
    d_in = ref.output_width(bb)
    return ref.param_table(bb) + ref_decoder.param_table(bb, d_in), \
        ref.zero_rows(bb)


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    table, zero_rows = param_table(config)
    return weights.make(table, zero_rows, seed, config["initializer_range"],
                        getattr(torch, config["served"]["dtype"]), device)


def write_model_dir(path: str, config: Dict, cell: Dict, seed: int,
                    device) -> None:
    """The model directory a user would serve: ``config.json`` (the
    program's format: the backbone's keys nested under the decoder's),
    ``toy_tokenizer.json`` and ``pytorch_model.bin``."""
    os.makedirs(path)
    program_config = dict(config["peneo"],
                          backbone_name=config["backbone_name"],
                          backbone_config=harness.backbone_config(config),
                          max_seq_len=cell["max_seq_len"],
                          dtype=config["served"]["dtype"])
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(program_config, f)
    with open(os.path.join(path, "toy_tokenizer.json"), "w") as f:
        json.dump({"vocab_size": ref_pages.TOKENIZER["vocab_size"],
                   "piece_len": ref_pages.TOKENIZER["piece_len"]}, f)
    w = make_weights(config, seed, device)
    torch.save({k: v.cpu() for k, v in w.items()},
               os.path.join(path, "pytorch_model.bin"))


def warm_directory(path: str, d: Dict, n: int) -> Dict:
    """A directory of links to the first ``n`` pages of directory ``d``."""
    names = sorted(d["lines"])[:n]
    for sub, ext in (("images", ".png"), ("ocr", ".json")):
        os.makedirs(os.path.join(path, sub))
        for name in names:
            stem = os.path.splitext(name)[0] + ext
            os.symlink(os.path.join(d[sub], stem),
                       os.path.join(path, sub, stem))
    return {"images": os.path.join(path, "images"),
            "ocr": os.path.join(path, "ocr")}


class Spans:
    """Per-call seconds of the benchmark's wrappers around program calls:
    the calling thread's CPU time (a thread waiting for the interpreter lock
    or for I/O spends none)."""

    def __init__(self) -> None:
        self.seconds: Dict[str, List[float]] = {}

    def timed(self, name: str, fn):
        out = self.seconds.setdefault(name, [])

        def call(*args, **kwargs):
            t0 = time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                out.append(time.thread_time() - t0)

        return call


class ModuleRange:
    """A profiler range of the given name around each forward of a module,
    so that the trace can tell the module's device operations."""

    def __init__(self, module, name: str) -> None:
        self.name, self.open = name, []
        self.handles = [module.register_forward_pre_hook(self._pre),
                        module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        rf = torch.autograd.profiler.record_function(self.name)
        rf.__enter__()
        self.open.append(rf)

    def _post(self, module, args, out):
        self.open.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class PairStage:
    """The pair head's inputs and the decoder's spots of one forward,
    drawn from ``seed`` among all the forwards made while it is installed
    (a reservoir of one: each is kept with the same chance). Forward hooks
    on the decoder's combine and on the decoder keep device copies; nothing
    waits for the device. ``kept`` stays None if no forward ran through
    both."""

    def __init__(self, decoder, seed: int) -> None:
        self.rng = random.Random(seed * 7907 + 29)
        self.calls, self.halves, self.kept = 0, None, None
        self.handles = [
            decoder.handshaking_kernel.register_forward_hook(self._halves),
            decoder.register_forward_hook(self._spots)]

    def _halves(self, module, args, out):
        self.halves = out

    def _spots(self, module, args, out):
        halves, self.halves = self.halves, None
        self.calls += 1
        if halves is None or self.rng.random() * self.calls >= 1:
            return
        self.kept = {"a": halves[0].detach().clone(),
                     "b": halves[1].detach().clone(),
                     "spots": {name: {k: v.detach().clone()
                                      for k, v in head.items()}
                               for name, head in out.items()}}

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


@contextlib.contextmanager
def captured_decodes(log: List):
    """Every page record the serving decode makes, logged with the spots it
    was decoded from: (image path, fetched spot arrays, batch row)."""
    from peneo_tpu_torch.pipeline import decode

    original = decode.decode_page_record

    def capture(texts, out, i, seq_len, dt, img_path=None, *args, **kwargs):
        rec = original(texts, out, i, seq_len, dt, img_path, *args, **kwargs)
        log.append((img_path, out, i))
        return rec

    decode.decode_page_record = capture
    try:
        yield
    finally:
        decode.decode_page_record = original


def run(ctx: Dict) -> Dict:
    """One run of a serving cell. ``ctx``: ``spec`` (the resolved cell),
    ``seed``, ``seconds``, ``trace``, ``device``, ``t_process`` (the
    process's start, ``time.time()``), and optionally ``precision``."""
    spec, seed = ctx["spec"], ctx["seed"]
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    device = torch.device(ctx["device"])
    root = tempfile.mkdtemp(prefix="bench_serve_")
    try:
        return _run(ctx, cell, config, traffic, seed, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, cell, config, traffic, seed, device, root):
    from peneo_tpu_torch.pipeline.infer import InferenceService

    # random weights tag most cells of every page, so every page overflows
    # its spot slots; the program's warning of it would print per page
    warnings.filterwarnings("ignore", message=".*exceed max_spots_per_head")
    phases = {"imports": time.time() - ctx["t_process"]}
    t = time.perf_counter()
    dirs = pages.make_directories(os.path.join(root, "pages"), traffic, seed)
    phases["pages"] = time.perf_counter() - t
    model_dir = os.path.join(root, "model")
    t = time.perf_counter()
    write_model_dir(model_dir, config, cell, seed, device)
    phases["weights"] = time.perf_counter() - t
    precision = ctx.get("precision")
    int8_head, int8_backbone = PRECISIONS[precision]
    t = time.perf_counter()
    svc = InferenceService(model_dir, batch_size=cell["batch_size"],
                           dtype=config["served"]["dtype"],
                           max_seq_len=cell["max_seq_len"], device=device,
                           int8_pair_head=int8_head,
                           int8_backbone=int8_backbone)
    job = dict(workers=cell["workers"], decode_workers=cell["decode_workers"],
               inflight_depth=cell["inflight_depth"])
    log: List = []
    spans = Spans()
    ranges, prof = [], None
    phases["service"] = time.perf_counter() - t
    warm = warm_directory(os.path.join(root, "warm"), dirs[0],
                          cell["batch_size"])
    with captured_decodes(log):
        t = time.perf_counter()
        svc.run(warm["images"], warm["ocr"], **job)
        if device.type == "cuda":
            torch.cuda.synchronize()
        phases["warm_up"] = time.perf_counter() - t
        log.clear()
        if ctx["trace"]:
            prof = _instrument(svc, spans, ranges)
        stage = PairStage(svc.model.peneo_decoder, seed)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - ctx["t_process"]
        jobs = []
        if prof is not None:
            prof.start()
            trace_start = time.time_ns()
        t_start = time.perf_counter()
        while True:
            d = dirs[len(jobs) % len(dirs)]
            first = len(log)
            t_job = time.perf_counter()
            with torch.autograd.profiler.record_function("bench.job"):
                results = svc.run(d["images"], d["ocr"], **job)
            jobs.append({"dir": d, "results": results,
                         "decodes": log[first:],
                         "seconds": time.perf_counter() - t_job})
            if time.perf_counter() - t_start >= ctx["seconds"]:
                break
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        stage.remove()
        trace = None
        if prof is not None:
            trace_end = time.time_ns()
            prof.stop()
            # the profiler stamps its events in wall-clock nanoseconds
            trace = harness.Trace.from_profiler(prof, trace_start, trace_end)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    last_run = dict(svc.last_run)
    for r in ranges:
        r.remove()
    del svc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    attempted = sum(len(j["dir"]["lines"]) for j in jobs)
    served = sum(len(j["results"]) for j in jobs)
    window_s = t_end - t_start
    budget = cell["max_seq_len"] - 1
    batches = []
    for j in jobs:
        names = sorted(j["dir"]["lines"])
        lengths = [1 + pages.served_tokens(j["dir"]["lines"][n], budget)
                   for n in names]
        batches += [lengths[i:i + cell["batch_size"]]
                    for i in range(0, len(lengths), cell["batch_size"])]
    t = time.perf_counter()
    checks = check_outputs(cell, config, jobs, stage.kept, seed, device,
                           precision)
    phases["check"] = time.perf_counter() - t
    checks["pages_without_record"] = {
        "value": attempted - served, "limit": 0,
        "ok": attempted - served == 0}
    return {
        "attempted": attempted, "failed": attempted - served,
        "end_to_end": {"serve_pages_per_s": served / window_s,
                       "setup_s": setup_s},
        "memory_peak": memory_peak, "checks": checks, "trace": trace,
        "window_s": window_s, "jobs": [j["seconds"] for j in jobs],
        "last_run": last_run,
        "phases": phases,
        "run": {"spans": spans.seconds,
                "batches": batches, "config": config, "cell": cell,
                "pages": served, "window_s": window_s},
    }


def _instrument(svc, spans: Spans, ranges: List):
    """Spans around each page's preprocess and decode, profiler ranges
    around each fetch, dispatch, backbone and decoder, and a profiler for
    the window."""
    from torch.profiler import ProfilerActivity, profile

    from peneo_tpu_torch.pipeline import decode

    make_prep = svc.page_preprocessor

    def timed_preprocessor():
        return spans.timed("preprocess", make_prep())

    svc.page_preprocessor = timed_preprocessor
    decode.decode_page_record = spans.timed("decode",
                                            decode.decode_page_record)
    fetch, dispatch = svc._fetch, svc.dispatch_batch

    def traced(name, fn):
        def call(*args, **kwargs):
            with torch.autograd.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    svc._fetch = traced("bench.fetch", fetch)
    svc.dispatch_batch = traced("bench.dispatch", dispatch)
    ranges.append(ModuleRange(svc.model.backbone, "bench.backbone"))
    ranges.append(ModuleRange(svc.model.peneo_decoder, "bench.decoder"))
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


# ------------------------------------------------------------ output check
def sample_pages(jobs: List[Dict], cell: Dict, seed: int):
    """(job, image path, served tokens) of the pages the check reads: the
    ``longest`` pages of the window and then pages drawn at random, from the
    seed, ``sample_pages`` in all."""
    budget = cell["max_seq_len"] - 1
    every = []
    for j, job in enumerate(jobs):
        for img, _, _ in job["decodes"]:
            name = os.path.basename(img)
            every.append((j, img, pages.served_tokens(
                job["dir"]["lines"][name], budget)))
    rng = random.Random(seed * 7919 + 17)
    rng.shuffle(every)
    check = cell["check"]
    by_length = sorted(every, key=lambda p: -p[2])
    picked = by_length[:check["longest"]]
    rest = [p for p in every if p not in picked]
    return picked + rest[:check["sample_pages"] - len(picked)]


def check_outputs(cell, config, jobs, kept, seed, device,
                  precision=None) -> Dict:
    """The numbers the output check compares, each with its limit and
    whether it holds: the whole path's (:func:`check_pages`) and the pair
    stage's (:func:`check_pair_stage`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {k: v.float() for k, v in make_weights(config, seed, device).items()}
    checks = check_pages(cell, config, jobs, w, seed, device)
    checks.update(check_pair_stage(cell, config, kept, w, precision))
    return checks


def check_pages(cell, config, jobs, w, seed, device) -> Dict:
    """The served spots' error against the reference (its root mean square
    over the sampled pages' heads, ``reference/judge.py``), the sampled
    pages whose record differs from the reference's decode of their spots,
    and how many pages were compared: fewer than the sample asks for, or no
    spot at all, fails."""
    bb = harness.backbone_config(config)
    ref = harness.reference_module(config["family"])
    sample = sample_pages(jobs, cell, seed)
    L = cell["max_seq_len"]
    k = config["peneo"]["max_spots_per_head"]
    squares, claims, mismatches = 0.0, 0, 0
    for start in range(0, len(sample), cell["check"]["reference_batch"]):
        part = sample[start:start + cell["check"]["reference_batch"]]
        inputs = []
        for j, img, _ in part:
            ocr = os.path.join(jobs[j]["dir"]["ocr"],
                               os.path.splitext(os.path.basename(img))[0]
                               + ".json")
            inputs.append(ref_pages.page_inputs(img, ocr, L, L - 1))
        batch = {key: torch.from_numpy(np.stack([p[key] for p in inputs]))
                 .to(device)
                 for key in ("input_ids", "bbox", "attention_mask")}
        with torch.no_grad():
            hidden = ref.forward(bb, w, **batch)
            for (j, img, _), page, h in zip(part, inputs, hidden):
                blocks = list(ref_decoder.pair_logits(w, h[1:L]))
                _, out, row = next(d for d in jobs[j]["decodes"]
                                   if d[0] == img)
                spots = {}
                for name, _classes in ref_decoder.HEADS:
                    flat, tag, score, grid, _ = judge.spots_of_page(
                        out[name], row)
                    sq, n = judge.head_errors(
                        ((r, c, lg[name]) for r, c, lg in blocks),
                        torch.as_tensor(flat, device=device),
                        torch.as_tensor(tag, device=device),
                        torch.as_tensor(score, device=device), k, grid)
                    squares += sq
                    claims += n
                    spots[name] = page_spots(flat, tag, score, grid,
                                             page["seq_len"])
                mine = ref_pages.record(page["texts"], page["boxes"], spots)
                served = dict(jobs[j]["results"][os.path.basename(img)])
                served.pop("seconds", None)
                mismatches += int(served != mine)
    rms = (squares / max(claims, 1)) ** 0.5
    limit = cell["check"]["spot_error_rms"]
    want = cell["check"]["sample_pages"]
    return {"pages_compared": {"value": len(sample), "limit": want,
                               "ok": len(sample) >= want},
            "spot_error_rms": {"value": rms, "limit": limit,
                               "ok": claims > 0 and rms <= limit},
            "record_mismatches": {"value": mismatches, "limit": 0,
                                  "ok": mismatches == 0}}


def check_pair_stage(cell, config, kept, w, precision=None) -> Dict:
    """The kept forward's spots, every row of its batch, against the
    reference's pair head in float32 from the program's own combine halves.
    Per row and head, the root mean square error of ``reference/judge.py``
    over the rms of the reference's logits there (rounding goes with their
    scale, which differs from head to head and seed to seed); compared: the
    median over the rows and heads, which a few heads whose numbers swing
    (a crowd of near ties, a logit that cancels) do not move. With
    ``precision`` ``fp8`` the spots judged are the float8 control's from
    the same halves. None compared fails."""
    k = config["peneo"]["max_spots_per_head"]
    limit = cell["check"]["pair_head_rel_error"]
    rel = []
    if kept is not None:
        A, Bm = kept["a"].float(), kept["b"].float()
        fetched = {name: {key: v.cpu().numpy() for key, v in head.items()}
                   for name, head in kept["spots"].items()}
        with torch.no_grad():
            for row in range(A.shape[0]):
                blocks = list(ref_decoder.pair_blocks(w, A[row], Bm[row]))
                if precision == "fp8":
                    ctl = ref_control.spots(ref_decoder.pair_blocks(
                        w, A[row], Bm[row],
                        hidden_linear=ref_control.fp8_linear),
                        A.shape[1], k)
                for name, _classes in ref_decoder.HEADS:
                    flat, tag, score, grid, _ = judge.spots_of_page(
                        fetched[name], row)
                    flat, tag, score = (torch.as_tensor(x, device=A.device)
                                        for x in (flat, tag, score))
                    if precision == "fp8":
                        flat, tag, score = ctl[name]
                    cells = [(r, c, lg[name]) for r, c, lg in blocks]
                    sq, n = judge.head_errors(cells, flat, tag, score, k,
                                              grid)
                    scale = judge.logit_rms(cells)
                    rel.append((sq / max(n, 1)) ** 0.5 / scale
                               if scale > 0 else float(sq > 0))
    rows = len(rel) // len(ref_decoder.HEADS)
    value = statistics.median(rel) if rel else 0.0
    want = cell["batch_size"]
    return {"pair_rows_compared": {"value": rows, "limit": want,
                                   "ok": rows >= want},
            "pair_head_rel_error": {"value": value, "limit": limit,
                                    "ok": bool(rel) and value <= limit}}


def page_spots(flat, tag, score, grid: int, seq_len: int):
    """Served spots of one head → (i, j, tag, score) inside the page's
    tokens, in row-major order."""
    order = sorted(range(len(flat)), key=lambda s: int(flat[s]))
    out = []
    for s in order:
        i, j = divmod(int(flat[s]), grid)
        if i < seq_len and j < seq_len:
            out.append((i, j, int(tag[s]), float(score[s])))
    return out
