"""Serving: page image + line-level OCR JSON → key/value pairs.

Counterpart of ``peneo_tpu/pipeline/infer.py:39-589`` for one device and the
LiLT, LayoutLMv3 and LayoutLMv2/LayoutXLM families (reference:
deploy/inference.py:110-464).
Pages are preprocessed on a thread pool, stacked ``batch_size`` at a time,
and run through :class:`~peneo_tpu_torch.models.peneo.PEneoModel`, whose
attention is a CUDA kernel on the card (BiACM for LiLT, rel-bias for
LayoutLMv3 and LayoutLMv2). PyTorch launches asynchronously, so keeping ``inflight_depth``
batches dispatched before fetching the oldest one (``.cpu()`` of two packed
int32 tensors) overlaps host preprocessing, host decode (a separate thread
pool) and device work. A visual backbone's page images travel as resized
uint8 (H, W, 3) arrays and are normalized on the device.

The service runs on ``cuda`` unless ``device="cpu"`` is passed; with no
GPU and no explicit device it raises.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..config import PEneoConfig
from ..models.decoder import pack_spots
from ..models.peneo import PEneoModel
from ..registry import get_backbone_info
from . import decode as dec
from .preprocess import PagePreprocessor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def load_weights(model: PEneoModel, path: str) -> None:
    """Load ``<path>/pytorch_model.bin`` (reference torch key names). Keys
    the model does not have are ignored; a missing one raises."""
    fp = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(fp):
        raise FileNotFoundError(f"no pytorch_model.bin under {path}")
    sd = torch.load(fp, map_location="cpu", weights_only=True, mmap=True)
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{fp} lacks {len(missing)} of the model's "
                       f"parameters, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in want})


class InferenceService:
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
        bucket_lengths=None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[dtype]
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise ValueError("the CUDA attention kernels (BiACM, rel-bias) "
                             "take bfloat16; serve with dtype='bfloat16'")
        self.cfg = PEneoConfig.from_pretrained(model_name_or_path)
        if max_seq_len:
            self.cfg.max_seq_len = max_seq_len
        self.info = get_backbone_info(self.cfg.backbone_name)
        self.max_token_len = min(
            self.info.max_token_len,
            self.cfg.max_seq_len - int(self.info.add_cls_token)
            - int(self.info.add_sep_token))
        self.score_thresh = score_thresh
        self.batch_size = batch_size
        # Length-bucketed serving: a page is padded only to the smallest
        # bucket that holds its real rows (the pair grid is O(L²)). The
        # CUDA kernel takes any L, so buckets need no alignment.
        self.bucket_lengths = None
        if bucket_lengths:
            bl = sorted({int(b) for b in bucket_lengths
                         if 0 < int(b) <= self.cfg.max_seq_len})
            if not bl:
                raise ValueError(
                    f"bucket_lengths {bucket_lengths!r} has no entry in "
                    f"(0, max_seq_len={self.cfg.max_seq_len}]")
            if bl[-1] != self.cfg.max_seq_len:
                bl.append(self.cfg.max_seq_len)  # overflow bucket
            self.bucket_lengths = bl

        if tokenizer is None:
            from ..registry import load_tokenizer

            tokenizer = load_tokenizer(self.info, model_name_or_path)
        self.tokenizer = tokenizer

        # live serving ships resized uint8 pages and normalizes on the
        # device: no host float conversion, a quarter of the upload
        self.raw_image = self.info.has_visual_embeds
        self.image_loader = None
        if self.info.has_visual_embeds:
            from ..data.image_processing import make_image_loader

            self.image_loader = make_image_loader(self.cfg, raw=True)

        model = PEneoModel(self.cfg)
        load_weights(model, model_name_or_path)
        self.model = model.cast(self.dtype).to(self.device).eval()
        if self.device.type == "cuda":
            # build the family's kernel now: fail at construction, not mid-run
            if self.info.family == "lilt":
                from ..ops.biacm_attention import load_kernel
            else:
                from ..ops.bias_attention import load_kernel
            load_kernel()
        from ..native import load_decode_lib

        load_decode_lib()  # the host decoder's g++ build, also up front
        self._packed = self.cfg.max_spots_per_head > 0
        self.last_run: Dict[str, float] = {}

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

    def preprocess_page(self, image_path: str, ocr_path: str):
        """One page → (arrays dict, fetched token texts, per-token orig
        boxes, seq_len)."""
        return self.page_preprocessor()(image_path, ocr_path)

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
        pages = list(page_inputs) + [page_inputs[-1]] * (self.batch_size - n)
        stacked = {k: np.stack([p[0][k][:bucket] if bucket else p[0][k]
                                for p in pages])
                   for k in ("input_ids", "bbox", "attention_mask")}
        ids, bbox, attn = (self._to_device(stacked[k]) for k in
                           ("input_ids", "bbox", "attention_mask"))
        with torch.inference_mode():
            image = None
            if "image" in pages[0][0]:
                image = self._to_device(np.stack([p[0]["image"]
                                                  for p in pages]))
                if image.dtype == torch.uint8:
                    from ..data.image_processing import device_image_normalize

                    image = device_image_normalize(image, self.info.family)
            out = self.model(ids, bbox, attn, image=image)
            return pack_spots(out) if self._packed else out

    def _fetch(self, out_device):
        """Device outputs → host numpy in the decoders' format (waits)."""
        if self._packed:
            big, small = out_device
            return dec.unpack_spots(big.cpu().numpy(), small.cpu().numpy())
        return {name: {k: v.cpu().numpy() for k, v in head.items()}
                for name, head in out_device.items()}

    def collect_batch(self, out_device, page_inputs):
        """Fetch a dispatched forward and host-decode its pages (padded rows
        are discarded). Returns [(kv_pairs, lines)] per page."""
        out = self._fetch(out_device)
        results = []
        for i, (_, texts, orig_bbox, seq_len) in enumerate(page_inputs):
            kv_pairs, lines, *_ = dec.decode_pred_sample(
                texts, out, i, seq_len, bbox=orig_bbox,
                score_thresh=self.score_thresh)
            results.append((kv_pairs, lines))
        return results

    def run(self, image_dir: str, ocr_dir: str, workers: int = 4,
            decode_workers: int = 2, inflight_depth: int = 2) -> Dict[str, Dict]:
        """Batch inference over a directory of page images, each paired with
        the OCR JSON of the same basename stem in ``ocr_dir`` (or one OCR
        file for a single image). Returns {image basename: record}.

        The main thread only dispatches forwards and fetches outputs,
        keeping ``inflight_depth`` batches in flight; per-page decode runs
        on its own pool so it never blocks the next dispatch. Afterwards
        ``self.last_run`` holds the page count, the wall time, and the pages
        and time after the first batch's fetch (the warm rate)."""
        image_paths = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)) \
            if os.path.isdir(image_dir) else [image_dir]
        if os.path.isdir(ocr_dir):
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

        prep = self.page_preprocessor()
        results = {}
        pending = []  # (basename, future) in input order
        inflight = deque()  # (device_out, pages, paths, t_dispatch)
        bufs: Dict[Optional[int], tuple] = {}
        t_first_fetch, n_first = None, 0
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=workers) as pool, \
                ThreadPoolExecutor(max_workers=decode_workers) as dpool:

            def collect():
                nonlocal t_first_fetch, n_first
                out_dev, pages, paths, t0 = inflight.popleft()
                out = self._fetch(out_dev)
                now = time.perf_counter()
                if t_first_fetch is None:
                    t_first_fetch, n_first = now, len(pages)
                dt = (now - t0) / len(pages)
                for i, (img, page) in enumerate(zip(paths, pages)):
                    _, texts, orig_bbox, seq_len = page
                    fut = dpool.submit(dec.decode_page_record, texts, out, i,
                                       seq_len, dt, self.score_thresh,
                                       orig_bbox)
                    pending.append((os.path.basename(img), fut))

            def flush(bucket):
                # launch this batch, then fetch the oldest in-flight one
                # while the device works
                pages, paths = bufs.get(bucket, ((), ()))
                if not pages:
                    return
                out_dev = self.dispatch_batch(pages, bucket=bucket)
                inflight.append((out_dev, list(pages), list(paths),
                                 time.perf_counter()))
                pages.clear()
                paths.clear()
                if len(inflight) > max(1, inflight_depth):
                    collect()

            add_cls = int(self.info.add_cls_token)
            prepped = pool.map(lambda pair: prep(*pair),
                               zip(image_paths, ocr_paths))
            for img, page in zip(image_paths, prepped):
                # page[3] is seq_len (CLS excluded) — real rows add the CLS
                bucket = (self._bucket_for(page[3] + add_cls)
                          if self.bucket_lengths else None)
                pages, paths = bufs.setdefault(bucket, ([], []))
                pages.append(page)
                paths.append(img)
                if len(pages) == self.batch_size:
                    flush(bucket)
            for bucket in sorted(bufs, key=lambda b: b or 0):
                flush(bucket)
            while inflight:
                collect()
            for name, fut in pending:
                results[name] = fut.result()
        t_end = time.perf_counter()
        self.last_run = {
            "pages": len(image_paths),
            "seconds": t_end - t_start,
            "warm_pages": len(image_paths) - n_first,
            "warm_seconds": t_end - t_first_fetch if t_first_fetch else 0.0,
        }
        return results
