"""Host-side page preprocessing for serving.

The port's copy of ``peneo_tpu/pipeline/preprocess.py`` (OCR-JSON path):
the OCR-JSON reader, the deploy-mode text cleanup, and ``PagePreprocessor``
— the tokenize → fetch → pack → pad pipeline one page goes through before
the forward (reference: deploy/inference.py:205-373). OCR JSON accepts
``text|ocr`` and ``bbox|box`` keys (4- or 8-point boxes); lines are sorted
in reading order, cleaned, tokenized per line and truncated at
``max_token_len`` with a strict ``>`` check; empty lines are skipped.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..data.box_utils import box_two_point_convert, normalize_bbox, \
    sort_boxes, string_f2h

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
    valid seq_len). Pure host work (PIL for the page size + tokenizer +
    numpy)."""

    tokenizer: object
    fetcher: Optional[Callable]
    max_token_len: int
    max_seq_len: int
    add_cls_token: bool
    add_sep_token: bool

    def __call__(self, image_path: str, ocr_path: str):
        from PIL import Image

        with Image.open(image_path) as im:
            image_w, image_h = im.size
        line_texts, line_boxes = read_ocr_json(ocr_path)

        order = sort_boxes(line_boxes)
        texts: List[str] = []
        input_ids: List[int] = []
        bbox: List[List[int]] = []
        orig_bbox: List[List[float]] = []
        cursor = 0
        for idx in order:
            text = deploy_text_cleanup(line_texts[idx])
            tokens = self.tokenizer.tokenize(text)
            if len(tokens) == 0:
                continue
            n = len(tokens)
            if cursor + n > self.max_token_len:  # deploy uses strict >
                break
            cursor += n
            fetched = self.fetcher(text, tokens) if self.fetcher else tokens
            norm = normalize_bbox(line_boxes[idx], (image_w, image_h))
            orig_bbox.extend([list(line_boxes[idx])] * n)
            bbox.extend([norm] * n)
            texts.extend(fetched)
            input_ids.extend(self.tokenizer.convert_tokens_to_ids(tokens))

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
        seq_len = n - int(self.add_cls_token)
        return arrays, texts, orig_bbox[1 if self.add_cls_token else 0:], \
            seq_len
