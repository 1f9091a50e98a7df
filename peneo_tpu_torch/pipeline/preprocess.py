"""Host-side page preprocessing for serving — imports no torch.

The port's copy of ``peneo_tpu/pipeline/preprocess.py``: the OCR-JSON and
tesseract readers, the deploy-mode text cleanup, and ``PagePreprocessor``
— the tokenize → fetch → pack → pad pipeline one page goes through before
the forward (reference: deploy/inference.py:205-373). OCR JSON accepts
``text|ocr`` and ``bbox|box`` keys (4- or 8-point boxes); lines are sorted
in reading order, cleaned, tokenized per line and truncated at
``max_token_len`` with a strict ``>`` check; empty lines are skipped. For a
visual backbone the page image is decoded and resized too (``image_cfg``);
the loader is a closure, rebuilt lazily from the config after unpickling.

``InferenceService.run(preprocess_procs=N)`` runs ``PagePreprocessor`` in N
spawned worker processes (never forked: the parent holds a CUDA context).
A worker imports this module and numpy/PIL/the tokenizer only: no worker
creates a CUDA context, and a text-only (LiLT) worker imports no torch
(:func:`_worker_probe`).
"""

from __future__ import annotations

import json
import os
import sys
from concurrent import futures
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..data.box_utils import box_two_point_convert, normalize_bbox, \
    sort_boxes, string_f2h
from ..utils import tracing

_DEPLOY_REPLACEMENTS = (
    ("☐", ""), ("☑", ""), ("", ""), ("", ""),
    ("Tοpic", "Topic"),
    ("á", "a"), ("é", "e"), ("í", "i"), ("ó", "o"), ("ú", "u"), ("ü", "u"),
    ("–", "-"), ("‘", "'"), ("’", "'"), ("“", '"'), ("—", "-"),
    ("™", "TM"), ("§", ""), ("¢", ""),
)


# Consecutive single-char replacements merge into C-level str.translate
# scans (a measured serving-preprocess hotspot vs 18 sequential str.replace
# passes). Phase ORDER preserves the sequential semantics around the one
# multi-char rule: the checkbox/PUA deletions run BEFORE "Tοpic" → "Topic"
# (deleting an embedded glyph can create a new match for it, e.g.
# "T☐οpic"), and within a merged phase simultaneous == sequential because
# no destination contains a later rule's source char.
_DEPLOY_PHASES: list = []
for _s, _d in _DEPLOY_REPLACEMENTS:
    if len(_s) == 1:
        if _DEPLOY_PHASES and isinstance(_DEPLOY_PHASES[-1], dict):
            _DEPLOY_PHASES[-1][ord(_s)] = _d
        else:
            _DEPLOY_PHASES.append({ord(_s): _d})
    else:
        _DEPLOY_PHASES.append((_s, _d))


def deploy_text_cleanup(text: str) -> str:
    for phase in _DEPLOY_PHASES:
        if isinstance(phase, dict):
            text = text.translate(phase)
        elif phase[0] in text:
            text = text.replace(phase[0], phase[1])
    return string_f2h(text)


def tesseract_ocr(image_path: str) -> Tuple[List[str], List[List[float]]]:
    """Line-level OCR through tesseract (reference: apply_ocr mode through
    the HF image processor, deploy/inference.py:243-252): words grouped by
    (block, paragraph, line), a line's box the union of its words'. Raises
    a clear error when pytesseract or the tesseract binary is absent."""
    try:
        import pytesseract
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "apply_ocr requires pytesseract + the tesseract binary; install "
            "them or provide OCR JSON via --dir_ocr") from e
    with Image.open(image_path) as im:
        data = pytesseract.image_to_data(
            im.convert("RGB"), output_type=pytesseract.Output.DICT)
    lines: dict = {}
    for i, word in enumerate(data["text"]):
        if not word.strip():
            continue
        key = (data["block_num"][i], data["par_num"][i], data["line_num"][i])
        l, t = data["left"][i], data["top"][i]
        r, b = l + data["width"][i], t + data["height"][i]
        if key in lines:
            text, (l0, t0, r0, b0) = lines[key]
            lines[key] = (text + " " + word, (min(l0, l), min(t0, t),
                                              max(r0, r), max(b0, b)))
        else:
            lines[key] = (word, (l, t, r, b))
    texts = [v[0] for v in lines.values()]
    boxes = [list(v[1]) for v in lines.values()]
    return texts, boxes


def read_ocr_json(path: str) -> Tuple[List[str], List[List[float]]]:
    with open(path, encoding="utf-8") as f:
        ocr = json.load(f)
    if isinstance(ocr, dict) and "texts" in ocr:
        ocr = ocr["texts"]
    texts, boxes = [], []
    for line in ocr:
        texts.append(line.get("ocr", line.get("text")))
        boxes.append(box_two_point_convert(line.get("bbox", line.get("box"))))
    return texts, boxes


@dataclass
class PagePreprocessor:
    """One page → (arrays dict, fetched token texts, per-token orig boxes,
    valid seq_len). Pure host work (PIL + tokenizer + numpy); picklable, so
    serving can fan it out over worker processes. ``ocr_path`` None runs
    :func:`tesseract_ocr` on the image."""

    tokenizer: object
    fetcher: Optional[Callable]
    max_token_len: int
    max_seq_len: int
    add_cls_token: bool
    add_sep_token: bool
    # config to build the image loader from (visual backbones)
    image_cfg: Optional[object] = None
    # raw=True emits uint8 (H, W, 3) RGB and leaves normalize/transpose to
    # the device (data/image_processing.device_image_normalize)
    raw_image: bool = False
    _image_loader: Optional[Callable] = field(
        default=None, repr=False, compare=False)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_image_loader"] = None  # rebuilt from image_cfg where needed
        return state

    def image_loader(self) -> Optional[Callable]:
        if self._image_loader is None and self.image_cfg is not None:
            from ..data.image_processing import make_image_loader

            self._image_loader = make_image_loader(self.image_cfg,
                                                   raw=self.raw_image)
        return self._image_loader

    def __call__(self, image_path: str, ocr_path: Optional[str]):
        from PIL import Image

        with tracing.span("serve.preprocess.read"):
            with Image.open(image_path) as im:
                image_w, image_h = im.size
            if ocr_path is None:
                line_texts, line_boxes = tesseract_ocr(image_path)
            else:
                line_texts, line_boxes = read_ocr_json(ocr_path)
        loader = self.image_loader()
        img = None
        if loader is not None:
            with tracing.span("serve.preprocess.image"):
                tracing.count("preprocess.images")
                tracing.count("preprocess.image_bytes",
                              os.path.getsize(image_path))
                img = loader(image_path)

        with tracing.span("serve.preprocess.order"):
            order = sort_boxes(line_boxes)
        texts: List[str] = []
        input_ids: List[int] = []
        bbox: List[List[int]] = []
        orig_bbox: List[List[float]] = []
        cursor = 0
        with tracing.span("serve.preprocess.tokenize"):
            for idx in order:
                text = deploy_text_cleanup(line_texts[idx])
                tokens = self.tokenizer.tokenize(text)
                if len(tokens) == 0:
                    continue
                n = len(tokens)
                if cursor + n > self.max_token_len:  # deploy uses strict >
                    tracing.count("preprocess.pages_cut")
                    break
                cursor += n
                fetched = (self.fetcher(text, tokens) if self.fetcher
                           else tokens)
                norm = normalize_bbox(line_boxes[idx], (image_w, image_h))
                orig_bbox.extend([list(line_boxes[idx])] * n)
                bbox.extend([norm] * n)
                texts.extend(fetched)
                input_ids.extend(self.tokenizer.convert_tokens_to_ids(tokens))

        with tracing.span("serve.preprocess.pack"):
            if self.add_cls_token:
                input_ids.insert(0, self.tokenizer.cls_token_id)
                bbox.insert(0, [0, 0, 0, 0])
                orig_bbox.insert(0, [0, 0, 0, 0])
            if self.add_sep_token:
                input_ids.append(self.tokenizer.sep_token_id)
                bbox.append([0, 0, 0, 0])
                orig_bbox.append([0, 0, 0, 0])

            L = self.max_seq_len
            n = len(input_ids)
            pad_id = self.tokenizer.pad_token_id or 0
            ids_arr = np.full((L,), pad_id, dtype=np.int32)
            ids_arr[:n] = input_ids
            bbox_arr = np.zeros((L, 4), dtype=np.int32)
            bbox_arr[:n] = bbox
            attn_arr = np.zeros((L,), dtype=np.int32)
            attn_arr[:n] = 1
            arrays = {"input_ids": ids_arr, "bbox": bbox_arr,
                      "attention_mask": attn_arr}
            if img is not None:
                arrays["image"] = (img if self.raw_image
                                   else img.astype(np.float32))
        seq_len = n - int(self.add_cls_token)
        return arrays, texts, orig_bbox[1 if self.add_cls_token else 0:], \
            seq_len


# ------------------------------------------------------- process-pool hooks
_WORKER_PREP: Optional[PagePreprocessor] = None


def _init_worker(prep: PagePreprocessor) -> None:
    global _WORKER_PREP
    _WORKER_PREP = prep


def _preprocess_task(pair):
    return _WORKER_PREP(*pair)


def _noop():
    return None


def _worker_probe():
    """(torch imported?, CUDA initialized?) inside a worker, read without
    importing torch: the test hook of the worker rules above."""
    torch = sys.modules.get("torch")
    return (torch is not None,
            bool(torch is not None and torch.cuda.is_initialized()))


def prespawn(pool, n: int) -> None:
    """Start all ``n`` workers now, not at the first real submit
    (mid-pipeline)."""
    futures.wait([pool.submit(_noop) for _ in range(n)])
