"""Serving: page image + line-level OCR JSON (or tesseract) → key/value pairs.

Counterpart of ``peneo_tpu/pipeline/infer.py:39-589`` for one device and the
LiLT, LayoutLMv3 and LayoutLMv2/LayoutXLM families (reference:
deploy/inference.py:110-464).
A model directory's weights are ``params.msgpack`` (the JAX package's param
tree), ``model.safetensors`` or ``pytorch_model.bin`` (reference torch
keys), tried in that order, as the JAX service does (:func:`load_weights`).
Pages are preprocessed on a thread pool (or in spawned worker processes,
``preprocess_procs``), stacked ``batch_size`` at a time,
and run through :class:`~peneo_tpu_torch.models.peneo.PEneoModel`, whose
attention is a CUDA kernel on the card (BiACM for LiLT, rel-bias for
LayoutLMv3 and LayoutLMv2). PyTorch launches asynchronously, so keeping ``inflight_depth``
batches dispatched before fetching the oldest one (``.cpu()`` of two packed
int32 tensors) overlaps host preprocessing, host decode (a separate thread
pool) and device work. A visual backbone's page images travel as resized
uint8 (H, W, 3) arrays and are normalized on the device. ``int8_pair_head``
/ ``int8_backbone`` run the pair head's hidden layers / the backbone's
projections and MLPs as s8×s8→s32 products (``ops/quant.py``); off unless
asked for, as the JAX service is off a TPU. :meth:`InferenceService.run_page`
and :meth:`~InferenceService.run_batch` are the single-page and one-batch
API; ``run(visualize_dir=…)`` also draws each page's predictions.

The host side (preprocessing, batching, the pipelined dispatch and
collect, the host decode) is :class:`PageServer`, which
``inference_artifact.ArtifactInferenceService`` shares: there the forward
is an exported program instead of the model.

The service runs on ``cuda`` unless ``device="cpu"`` is passed; with no
GPU and no explicit device it raises. On the card a forward of
``batch_size`` rows replays CUDA graphs of the backbone and of the pair
grid, one set per batch shape, captured at its first batch of that shape
(``pipeline/graphs.py``); other forwards run eagerly.

In a process group of ``dp × tp × sp`` ranks (``InferenceService(dp=,
tp=, sp=)``; ``peneo_tpu/pipeline/infer.py:186-205,242-270``) each dp index
serves every dp-th page of the directory; its tp × sp ranks preprocess the
same pages and run the same batches: the tp ranks through the shards of a
Megatron-split model (``parallel/tensor_parallel.py``: the service loads
the full weights, then keeps its shard), the sp ranks over their rows of
the pair grid (``parallel/seq_parallel.py``), and only the rank with t = 0
and s = 0 decodes. :meth:`InferenceService.run` then gathers every dp
index's records and returns them all, on every rank, in the order one
process returns them.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..config import PEneoConfig
from ..models.decoder import pair_grid_cells
from ..models.peneo import PEneoModel
from ..parallel import dist as pdist
from ..registry import get_backbone_info
from ..utils import tracing
from . import decode as dec
from . import graphs
from .preprocess import PagePreprocessor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the counters of utils/tracing.py that PageServer.run reports in last_run
RUN_COUNTERS = ("serve.tokens_real", "serve.token_slots",
                "serve.pair_cells_real", "serve.pair_cells_computed",
                graphs.REPLAY, graphs.CAPTURE, graphs.EAGER,
                "serve.visual_tokens", "serve.image_bytes",
                "preprocess.pages_cut", "preprocess.images",
                "preprocess.image_bytes") + tuple(
    f"decode.spots_{kind}.{head}" for kind in ("found", "dropped")
    for head in dec.HEAD_NAMES)


def visual_positions(cfg: PEneoConfig) -> int:
    """The attention positions LayoutLMv3's page image adds to each row:
    its patch grid and its CLS; 0 for any other backbone."""
    bb = cfg.backbone()
    if cfg.backbone_family() == "layoutlmv3" and bb.visual_embed:
        return (bb.input_size // bb.patch_size) ** 2 + 1
    return 0


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``, raising when no GPU is present; an explicit
    ``"cpu"`` (or any device string) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def load_family_kernel(device: torch.device, family: str) -> None:
    """Register the attention operators (loading an exported program needs
    them) and, on the card, build the family's serving kernel now: a build
    failure shows at construction, not mid-run."""
    from ..ops import biacm_attention, bias_attention

    if device.type == "cuda":
        (biacm_attention if family == "lilt" else bias_attention).load_kernel()


# the files a model directory's weights are read from, in the JAX order
# (``peneo_tpu/pipeline/infer.py:564-589``); training also reads the weight
# generator's backbone-only tree (``start/run_rfund.py:332-345``)
SERVE_FILES = ("params.msgpack", "model.safetensors", "pytorch_model.bin")
TRAIN_FILES = ("params.msgpack", "backbone_params.msgpack",
               "model.safetensors", "pytorch_model.bin")


def read_checkpoint(path: str, cfg: PEneoConfig, names=SERVE_FILES,
                    partial: bool = False):
    """The first of ``names`` under ``path`` → (state dict in the port's
    keys, file). A msgpack param tree goes through
    ``jax_params_to_state_dict`` (with ``partial`` it may hold a subset);
    safetensors and torch files carry the reference's torch keys."""
    from .weights_io import read_flax_msgpack, read_safetensors

    for name in names:
        fp = os.path.join(path, name)
        if not os.path.exists(fp):
            continue
        if name.endswith(".msgpack"):
            from ..models.convert import jax_params_to_state_dict

            return jax_params_to_state_dict(read_flax_msgpack(fp), cfg,
                                            partial=partial), fp
        if name.endswith(".safetensors"):
            return {k: torch.from_numpy(v) for k, v in
                    read_safetensors(fp).items()}, fp
        return torch.load(fp, map_location="cpu", weights_only=True,
                          mmap=True), fp
    raise FileNotFoundError(f"no {' / '.join(names)} under {path}")


def load_weights(model: PEneoModel, path: str, train_init: bool = False) -> int:
    """Load a model directory's weights (:data:`SERVE_FILES`, in order).
    Keys the model does not have are ignored; a missing one raises.

    ``train_init`` (fine-tuning's start, :data:`TRAIN_FILES`): a msgpack
    tree may be partial (``backbone_params.msgpack``) and is overlaid on the
    model's own init as ``merge_params`` does: a shape mismatch raises, an
    absent entry keeps its init. Returns how many of the model's state-dict
    keys kept their values."""
    sd, fp = read_checkpoint(path, model.cfg,
                             TRAIN_FILES if train_init else SERVE_FILES,
                             partial=train_init)
    want = model.state_dict()
    if train_init and fp.endswith(".msgpack"):
        bad = {k: (tuple(v.shape), tuple(want[k].shape))
               for k, v in sd.items() if k in want
               and tuple(v.shape) != tuple(want[k].shape)}
        if bad:
            raise ValueError(f"{fp}: shape mismatch (file, model): {bad}")
        picked = {k: v for k, v in sd.items() if k in want}
        model.load_state_dict(picked, strict=False)
        return len(want) - len(picked)
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{fp} lacks {len(missing)} of the model's "
                       f"parameters, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in want})
    return 0


class PageServer:
    """The host side of serving, shared by :class:`InferenceService` (a
    live model) and ``inference_artifact.ArtifactInferenceService`` (an
    exported program): page preprocessing, batching, the pipelined
    dispatch and collect of :meth:`run`, and the host decode. A subclass
    sets ``_packed`` and provides :meth:`_forward` on the device tensors of
    one batch. The process grid (``dp``, ``tp``, ``sp``) is one process
    unless a subclass sets it."""

    dp = tp = sp = 1

    def __init__(self, cfg: PEneoConfig, device: torch.device, tokenizer,
                 batch_size: int, score_thresh: float, raw_image: bool,
                 bucket_lengths=None) -> None:
        """``raw_image``: a visual backbone's pages travel as resized uint8
        and are normalized on the device (else as host-normalized fp32)."""
        self.cfg, self.device = cfg, device
        self.info = get_backbone_info(cfg.backbone_name)
        self.max_token_len = min(
            self.info.max_token_len,
            cfg.max_seq_len - int(self.info.add_cls_token)
            - int(self.info.add_sep_token))
        self.score_thresh = score_thresh
        self.batch_size = batch_size
        # Length-bucketed serving: a page is padded only to the smallest
        # bucket that holds its real rows (the pair grid is O(L²)). The
        # CUDA kernel takes any L, so buckets need no alignment.
        self.bucket_lengths = None
        if bucket_lengths:
            bl = sorted({int(b) for b in bucket_lengths
                         if 0 < int(b) <= cfg.max_seq_len})
            if not bl:
                raise ValueError(
                    f"bucket_lengths {bucket_lengths!r} has no entry in "
                    f"(0, max_seq_len={cfg.max_seq_len}]")
            if bl[-1] != cfg.max_seq_len:
                bl.append(cfg.max_seq_len)  # overflow bucket
            self.bucket_lengths = bl
        self.tokenizer = tokenizer
        self.raw_image = raw_image and self.info.has_visual_embeds
        self.image_loader = None
        self.visual_positions = visual_positions(cfg)
        if self.info.has_visual_embeds:
            from ..data.image_processing import make_image_loader

            self.image_loader = make_image_loader(cfg, raw=self.raw_image)
        from ..native import load_decode_lib

        load_decode_lib()  # the host decoder's g++ build, up front
        self.last_run: Dict[str, float] = {}

    def _forward(self, input_ids, bbox, attention_mask, image):
        """One batch's device outputs: the packed spots when ``_packed``,
        else the heads' dicts."""
        raise NotImplementedError

    # ------------------------------------------------------------- preprocess
    def page_preprocessor(self) -> PagePreprocessor:
        return PagePreprocessor(
            tokenizer=self.tokenizer, fetcher=self.info.tokenizer_fetcher,
            max_token_len=self.max_token_len,
            max_seq_len=self.cfg.max_seq_len,
            add_cls_token=self.info.add_cls_token,
            add_sep_token=self.info.add_sep_token,
            image_cfg=self.cfg if self.image_loader is not None else None,
            raw_image=self.raw_image, _image_loader=self.image_loader)

    def preprocess_page(self, image_path: str, ocr_path: Optional[str]):
        """One page → (arrays dict, fetched token texts, per-token orig
        boxes, seq_len); ``ocr_path`` None runs tesseract."""
        return self.page_preprocessor()(image_path, ocr_path)

    # ------------------------------------------------------------- one page
    def run_page(self, image_path: str, ocr_path: Optional[str]):
        """One page through a forward of its own (batch 1) → (kv_pairs,
        lines), as the JAX service's ``run_page``."""
        page = self.preprocess_page(image_path, ocr_path)
        return self.collect_batch(self._dispatch([page]), [page])[0]

    def run_batch(self, page_inputs):
        """Synchronous forward over up to ``batch_size`` preprocessed pages
        → [(kv_pairs, lines)] per page (see dispatch/collect for the
        pipelined form the directory runner uses)."""
        return self.collect_batch(self.dispatch_batch(page_inputs),
                                  page_inputs)

    # --------------------------------------------------------------- pipeline
    def _bucket_for(self, n_rows: int) -> int:
        """Smallest configured bucket covering ``n_rows`` real token rows
        (CLS/SEP included); the top bucket is always max_seq_len."""
        for b in self.bucket_lengths:
            if n_rows <= b:
                return b
        return self.bucket_lengths[-1]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pinned staging keeps the copy asynchronous to the host
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def dispatch_batch(self, page_inputs, bucket: Optional[int] = None):
        """Stack up to ``batch_size`` preprocessed pages (the tail batch is
        padded by repeating its last page) and launch the forward. Returns
        the device outputs without waiting for them; pair with
        :meth:`collect_batch`. ``bucket`` cuts the sequence axis to that
        length (preprocess pads at the tail); a page image is never cut."""
        n = len(page_inputs)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} pages for batch_size {self.batch_size}")
        return self._dispatch(list(page_inputs)
                              + [page_inputs[-1]] * (self.batch_size - n),
                              bucket)

    def _dispatch(self, pages, bucket: Optional[int] = None):
        """Stack ``pages`` as they are and launch the forward."""
        stacked = {k: stack_rows([p[0][k][:bucket] if bucket else p[0][k]
                                  for p in pages])
                   for k in ("input_ids", "bbox", "attention_mask")}
        ids, bbox, attn = (self._to_device(stacked[k]) for k in
                           ("input_ids", "bbox", "attention_mask"))
        with torch.inference_mode():
            image = None
            if "image" in pages[0][0]:
                image = self._to_device(stack_rows([p[0]["image"]
                                                    for p in pages]))
                if image.dtype == torch.uint8:
                    from ..data.image_processing import device_image_normalize

                    image = device_image_normalize(image, self.info.family)
            return self._forward(ids, bbox, attn, image)

    def _fetch(self, out_device, done=None):
        """Device outputs → host numpy in the decoders' format (waits).
        ``done``: a CUDA event recorded after this batch's forward, waited
        for first (span ``serve.fetch.own``) when spans are recorded."""
        if done is not None:
            with tracing.span("serve.fetch.own"):
                done.synchronize()
        if self._packed:
            big, small = out_device
            return dec.unpack_spots(big.cpu().numpy(), small.cpu().numpy())
        return {name: {k: v.cpu().numpy() for k, v in head.items()}
                for name, head in out_device.items()}

    def collect_batch(self, out_device, page_inputs):
        """Fetch a dispatched forward and host-decode its pages (padded rows
        are discarded). Returns [(kv_pairs, lines)] per page."""
        out = self._fetch(out_device)
        spots = {}
        dec.count_spots(out, slice(0, len(page_inputs)), spots)
        dec.warn_spots_dropped(spots, len(page_inputs),
                               self.cfg.max_spots_per_head)
        results = []
        for i, (_, texts, orig_bbox, seq_len) in enumerate(page_inputs):
            kv_pairs, lines, *_ = dec.decode_pred_sample(
                texts, out, i, seq_len, bbox=orig_bbox,
                score_thresh=self.score_thresh)
            results.append((kv_pairs, lines))
        return results

    def _count_batch(self, pages, L: int) -> None:
        """The dispatch counters of one batch of ``batch_size`` rows at
        sequence length ``L``, ``pages`` real (see ``utils/tracing.py``)."""
        add_cls = int(self.info.add_cls_token)
        seq = [p[3] for p in pages]
        tracing.count("serve.tokens_real", sum(n + add_cls for n in seq))
        tracing.count("serve.token_slots", self.batch_size * L)
        tracing.count("serve.pair_cells_real",
                      sum(n * (n + 1) // 2 for n in seq))
        tracing.count("serve.pair_cells_computed", self.batch_size
                      * pair_grid_cells(L - add_cls,
                                        self.cfg.pair_block_size))
        if "image" in pages[0][0]:
            tracing.count("serve.visual_tokens",
                          self.batch_size * self.visual_positions)
            tracing.count("serve.image_bytes",
                          self.batch_size * pages[0][0]["image"].nbytes)

    def run(self, image_dir: str, ocr_dir: Optional[str] = None,
            visualize_dir: Optional[str] = None, workers: int = 4,
            decode_workers: int = 2, preprocess_procs: int = 0,
            inflight_depth: int = 2) -> Dict[str, Dict]:
        """Batch inference over a directory of page images, each paired with
        the OCR JSON of the same basename stem in ``ocr_dir`` (or one OCR
        file for a single image; None: tesseract reads each page). Returns
        {image basename: record}; with ``visualize_dir`` each page is also
        drawn there with its predictions.

        Pages are preprocessed on ``workers`` threads, or with
        ``preprocess_procs`` > 0 in that many spawned worker processes
        (``pipeline/preprocess.py``: no CUDA context, no torch for a
        text-only model; the heavy per-page work is a visual backbone's
        image decode and resize). The main thread only dispatches forwards
        and fetches outputs, keeping ``inflight_depth`` batches in flight;
        per-page decode runs on its own pool so it never blocks the next
        dispatch. Afterwards ``self.last_run`` holds the page count, the
        wall time, the pages and time after the first batch's fetch (the
        warm rate), the time the preprocessing pool took to start, and
        what the job added to the counters of ``utils/tracing.py`` (tokens
        and pair cells, real and computed; pages cut; spots found and
        dropped per head), under the counters' names. Spots dropped past
        ``max_spots_per_head`` give one warning a call, with the totals.
        Its spans (``serve.*``, ``utils/tracing.py``) are recorded when a
        ``tracing.recording()`` block is open or a torch profiler is active
        on the calling thread, as decided at the call's start.

        With ``dp × tp × sp`` > 1 every rank of the process group calls
        it: the dp indices serve every dp-th page each, and the records of
        all of them come back on every rank (``last_run`` counts this
        rank's)."""
        image_paths = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)) \
            if os.path.isdir(image_dir) else [image_dir]
        all_paths = image_paths
        if ocr_dir is None:
            ocr_paths = [None] * len(image_paths)  # apply_ocr: tesseract
        elif os.path.isdir(ocr_dir):
            # pair by basename stem: a missing or duplicate stem is an error
            by_stem = {}
            for f in os.listdir(ocr_dir):
                stem = os.path.splitext(f)[0]
                if stem in by_stem:
                    raise ValueError(
                        f"duplicate OCR stem '{stem}' in {ocr_dir}: "
                        f"{by_stem[stem]} vs {f}")
                by_stem[stem] = f
            stems = [os.path.splitext(os.path.basename(p))[0]
                     for p in image_paths]
            missing = [s for s in stems if s not in by_stem]
            if missing:
                raise FileNotFoundError(
                    f"no OCR JSON for image(s) {missing[:5]} in {ocr_dir} "
                    "(matched by basename stem)")
            ocr_paths = [os.path.join(ocr_dir, by_stem[s]) for s in stems]
        elif len(image_paths) == 1:
            ocr_paths = [ocr_dir]
        else:
            raise ValueError("a directory of images needs a directory of "
                             "OCR JSONs")
        if self.dp > 1:  # this dp index's pages
            image_paths = image_paths[pdist.dp_index()::self.dp]
            ocr_paths = ocr_paths[pdist.dp_index()::self.dp]
        # the tp × sp ranks of a dp index run its batches; t = s = 0 decodes
        decodes = pdist.sp_index() == 0 and pdist.tp_index() == 0

        rec = tracing.recorder()  # decided once, on the serving thread
        job = tracing.new_job()
        with rec.span("serve.run", job=job, pages=len(image_paths),
                      batch_size=self.batch_size, L=self.cfg.max_seq_len):
            return self._run_pages(rec, job, image_paths, ocr_paths,
                                   all_paths, decodes, visualize_dir, workers,
                                   decode_workers, preprocess_procs,
                                   inflight_depth)

    def _run_pages(self, rec, job, image_paths, ocr_paths, all_paths,
                   decodes, visualize_dir, workers, decode_workers,
                   preprocess_procs, inflight_depth):
        """:meth:`run` once its pages are known; ``rec`` records the spans
        of job ``job`` or is the no-op."""
        counted = tracing.counters()
        results = {}
        pending = []  # (basename, future) in input order
        inflight = deque()  # (device_out, pages, paths, ids, batch, done, t)
        bufs: Dict[Optional[int], tuple] = {}
        spots: Dict[str, list] = {}
        t_first_fetch, n_first = None, 0
        t_start = time.perf_counter()
        if preprocess_procs > 0:
            import multiprocessing as mp

            from .preprocess import _init_worker, _preprocess_task, prespawn

            pool = ProcessPoolExecutor(
                max_workers=preprocess_procs,
                mp_context=mp.get_context("spawn"),
                initializer=_init_worker,
                initargs=(self.page_preprocessor(),))
            prespawn(pool, preprocess_procs)
            prep_map = lambda pairs: pool.map(  # noqa: E731
                _preprocess_task, pairs, chunksize=2)
        else:
            pool = ThreadPoolExecutor(max_workers=workers)
            prep = self.page_preprocessor()

            def prep_page(pid, pair):
                with rec.span("serve.preprocess", job=job, page=pid):
                    return prep(*pair)

            prep_map = lambda pairs: pool.map(  # noqa: E731
                prep_page, itertools.count(), pairs)
        t_pool = time.perf_counter() - t_start
        batches = itertools.count()
        with pool, ThreadPoolExecutor(max_workers=decode_workers) as dpool:

            def collect():
                nonlocal t_first_fetch, n_first
                out_dev, pages, paths, ids, batch, done, t0 = \
                    inflight.popleft()
                if not decodes:
                    t_first_fetch = t_first_fetch or time.perf_counter()
                    return
                with rec.span("serve.fetch", job=job, batch=batch):
                    out = self._fetch(out_dev, done)
                now = time.perf_counter()
                if t_first_fetch is None:
                    t_first_fetch, n_first = now, len(pages)
                dec.count_spots(out, slice(0, len(pages)), spots)
                dt = (now - t0) / len(pages)
                for i, (img, page, pid) in enumerate(zip(paths, pages, ids)):
                    _, texts, orig_bbox, seq_len = page
                    fut = dpool.submit(
                        _in_span, rec.span("serve.decode", job=job, page=pid,
                                           batch=batch),
                        dec.decode_page_record, texts, out, i, seq_len, dt,
                        img, visualize_dir, self.score_thresh, orig_bbox)
                    pending.append((os.path.basename(img), fut))

            def flush(bucket):
                # launch this batch, then fetch the oldest in-flight one
                # while the device works
                pages, paths, ids = bufs.get(bucket, ((), (), ()))
                if not pages:
                    return
                batch = next(batches)
                L = bucket or self.cfg.max_seq_len
                with rec.span("serve.dispatch", job=job, batch=batch,
                              pages=len(pages), L=L):
                    self._count_batch(pages, L)
                    out_dev = self.dispatch_batch(pages, bucket=bucket)
                done = None
                if rec.on and self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                inflight.append((out_dev, list(pages), list(paths), list(ids),
                                 batch, done, time.perf_counter()))
                pages.clear()
                paths.clear()
                ids.clear()
                if len(inflight) > max(1, inflight_depth):
                    collect()

            add_cls = int(self.info.add_cls_token)
            prepped = iter(prep_map(zip(image_paths, ocr_paths)))
            for pid, img in enumerate(image_paths):
                with rec.span("serve.wait_page", job=job, page=pid):
                    page = next(prepped)
                # page[3] is seq_len (CLS excluded) — real rows add the CLS
                bucket = (self._bucket_for(page[3] + add_cls)
                          if self.bucket_lengths else None)
                pages, paths, ids = bufs.setdefault(bucket, ([], [], []))
                pages.append(page)
                paths.append(img)
                ids.append(pid)
                if len(pages) == self.batch_size:
                    flush(bucket)
            for bucket in sorted(bufs, key=lambda b: b or 0):
                flush(bucket)
            while inflight:
                collect()
            for name, fut in pending:
                results[name] = fut.result()
        if self.dp * self.tp * self.sp > 1:  # every dp index's, in order
            merged = {}
            for part in pdist.gather_objects(results):
                merged.update(part)
            results = {os.path.basename(p): merged[os.path.basename(p)]
                       for p in all_paths}
        t_end = time.perf_counter()
        dec.warn_spots_dropped(spots, len(image_paths),
                               self.cfg.max_spots_per_head)
        now = tracing.counters()
        self.last_run = {
            "pages": len(image_paths),
            "seconds": t_end - t_start,
            "warm_pages": len(image_paths) - n_first,
            "warm_seconds": t_end - t_first_fetch if t_first_fetch else 0.0,
            "pool_start_seconds": t_pool,  # spawning the workers, if any
            **{k: now.get(k, 0) - counted.get(k, 0) for k in RUN_COUNTERS},
        }
        return results


def stack_rows(arrays) -> np.ndarray:
    """``np.stack`` of equal arrays, copied while holding the interpreter
    lock: numpy releases it for each copy of more than 500 elements, and
    with the preprocess and decode pools running each release costs the
    serving thread a wait to win it back (~0.5 ms a page at B 32 on the
    H100 host, PERF.md §5)."""
    first = arrays[0]
    for a in arrays:
        if a.shape != first.shape or a.dtype != first.dtype:
            raise ValueError(f"rows of {a.shape} {a.dtype} and "
                             f"{first.shape} {first.dtype} do not stack")
    data = bytearray().join(a.tobytes() for a in arrays)
    return np.frombuffer(data, first.dtype).reshape(len(arrays),
                                                    *first.shape)


def _in_span(span, fn, *args):
    """``fn(*args)`` inside the recorded ``span`` (on a pool thread)."""
    with span:
        return fn(*args)


class InferenceService(PageServer):
    """Load a trained PEneo model (LiLT, LayoutLMv3 or LayoutLMv2 backbone)
    and run page → kv-pair extraction."""

    def __init__(
        self,
        model_name_or_path: str,
        tokenizer=None,
        max_seq_len: Optional[int] = None,
        batch_size: int = 1,
        dtype: str = "bfloat16",
        score_thresh: float = 0.0,
        int8_pair_head: Optional[bool] = None,
        int8_backbone: bool = False,
        bucket_lengths=None,
        device=None,
        dp: int = 1,
        sp: int = 1,
        tp: int = 1,
        spot_streaming: Optional[bool] = None,
    ) -> None:
        """``int8_pair_head`` None (auto) is off, as the JAX service's auto
        is off any backend but a TPU; True or ``int8_backbone`` set the
        config's ``quantize_pair_head`` / ``quantize_backbone`` (a config
        that sets them serves int8 already). ``spot_streaming`` is set on
        the config (None: off, as JAX's): each row block of the pair grid
        reduced to its top-k spot candidates, no dense (B, L, L) maps;
        the sp path does not read it. ``dp × tp × sp`` > 1 needs a
        process group of that many ranks (``parallel/dist.py``
        ``init_distributed``); each rank then runs on its own device."""
        self.dp, self.tp, self.sp = dp, tp, sp
        n = dp * tp * sp
        if n > 1:
            if pdist.world() != n:
                raise ValueError(
                    f"dp {dp} × tp {tp} × sp {sp} serving needs a process "
                    f"group of {n} ranks, not {pdist.world()}: torchrun "
                    f"--nproc_per_node {n} -m peneo_tpu_torch.serve "
                    f"--distributed --dp {dp} --tp {tp} --sp {sp} ..., or "
                    f"one command per rank with --coordinator_address "
                    f"host:port --num_processes {n} --process_id i")
            pdist.grid(dp, tp, sp)
            device = pdist.rank_device(device)
        else:
            device = resolve_device(device)
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[dtype]
        if device.type == "cuda" and self.dtype != torch.bfloat16:
            raise ValueError("the CUDA attention kernels (BiACM, rel-bias) "
                             "take bfloat16; serve with dtype='bfloat16'")
        cfg = PEneoConfig.from_pretrained(model_name_or_path)
        if int8_pair_head:
            cfg.quantize_pair_head = "int8"
        if int8_backbone:
            cfg.quantize_backbone = "int8"
        if max_seq_len:
            cfg.max_seq_len = max_seq_len
        cfg.spot_streaming = bool(spot_streaming)
        if tokenizer is None:
            from ..registry import load_tokenizer

            tokenizer = load_tokenizer(get_backbone_info(cfg.backbone_name),
                                       model_name_or_path)
        # live serving ships resized uint8 pages and normalizes on the
        # device: no host float conversion, a quarter of the upload
        super().__init__(cfg, device, tokenizer, batch_size, score_thresh,
                         raw_image=True, bucket_lengths=bucket_lengths)

        model = PEneoModel(self.cfg)
        load_weights(model, model_name_or_path)
        if sp > 1:
            if self.cfg.max_spots_per_head <= 0:
                raise ValueError("sp serving returns compact spots: "
                                 "max_spots_per_head must be > 0")
            model.set_sequence_parallel(pdist.sp_index(), sp,
                                        pdist.sp_group())
        if tp > 1:  # the full weights are loaded: keep this rank's shard
            model.set_tensor_parallel(pdist.tp_index(), tp, pdist.tp_group())
        self.model = model.cast(self.dtype).to(self.device).eval()
        load_family_kernel(self.device, self.info.family)
        self._packed = self.cfg.max_spots_per_head > 0
        # the forwards of full batches as CUDA-graph replays on the card
        self.graphs = graphs.ServingGraphs(self.model, batch_size,
                                           graphs.capture_for(self.device))

    def _forward(self, input_ids, bbox, attention_mask, image):
        return self.graphs(input_ids, bbox, attention_mask, image,
                           pack=self._packed)
