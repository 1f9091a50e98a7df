"""RFUND / SIBR datasets: OCR-line annotations → packed token sequences +
pair-label spots (the port's copy of ``peneo_tpu/data/datasets.py:93-374``).
Pure host-side python — the output feeds the fixed-shape batcher in
data/collator.py.

Behavioral parity targets:
- RFUND  (reference: data/datasets/rfund.py:25-471) — 8 languages, splits
  train/dev/test (dev/test both read ``{lang}.val.json``), per-line special
  text replacement + full-width folding, leading space on continuation lines
  for non-CJK languages.
- SIBR   (reference: data/datasets/sibr.py:25-460) — file list from
  ``{split}.txt``, one JSON per image under ``converted_label/``, no text
  cleanup, int-cast bboxes.

Both share one document parser: entities → non-empty lines → reading-order
sort (data_utils.sort_boxes) → greedy packing until ``max_token_len`` (strict
``>=`` break, rfund.py:243-245; overflow lines and relations touching them are
dropped) → spot labels for the five pair heads with tag-2 flip for
lower-triangle links (rfund.py:326-419).

Quirk note: the reference marks an entity "empty" only when the *global* line
list is still empty (rfund.py:195-197); for entities whose lines are all
empty this leaves stale entries in its last-line map which are unreachable
downstream. We use the per-entity definition — observable behavior matches.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .box_utils import box_augmentation, normalize_bbox, sort_boxes, string_f2h

RFUND_LANGS = ("en", "zh", "ja", "es", "fr", "de", "it", "pt")
ENTITY_LABELS = ("other", "header", "question", "answer")


@dataclass
class LineRecord:
    coords: List[float]
    token_ids: List[int]
    fetched: List[str]
    category: str
    entity_id: object
    line_id: object
    start_token: Optional[int] = None
    end_token: Optional[int] = None


@dataclass
class ParsedDoc:
    fname: str
    image_path: str
    input_ids: List[int] = field(default_factory=list)
    bbox: List[List[int]] = field(default_factory=list)
    orig_bbox: List[List[float]] = field(default_factory=list)
    text: List[str] = field(default_factory=list)
    relations: List[Dict[str, str]] = field(default_factory=list)
    spots: Dict[str, List] = field(default_factory=dict)

    def to_feature(self) -> Dict:
        """Reference-compatible feature dict (rfund.py:458-471)."""
        return {
            "fname": self.fname,
            "image_path": self.image_path,
            "input_ids": self.input_ids,
            "bbox": self.bbox,
            "orig_bbox": self.orig_bbox,
            "text": self.text,
            "relations": self.relations,
            "line_extraction_matrix_spots": self.spots["line_extraction"],
            "ent_linking_head_rel_matrix_spots": self.spots["ent_linking_h2h"],
            "ent_linking_tail_rel_matrix_spots": self.spots["ent_linking_t2t"],
            "line_grouping_head_rel_matrix_spots": self.spots["line_grouping_h2h"],
            "line_grouping_tail_rel_matrix_spots": self.spots["line_grouping_t2t"],
        }


def rfund_text_cleanup(line_text: str) -> str:
    """RFUND per-line text normalization (rfund.py:95-109): strip checkbox
    glyphs/private-use chars, fold common accents and the en-dash, fix the
    'Tοpic' OCR artifact, then full-width → half-width."""
    for ch in ("☐", "☑", "", ""):
        line_text = line_text.replace(ch, "")
    line_text = line_text.replace("Tοpic", "Topic")
    for src, dst in (("á", "a"), ("é", "e"), ("í", "i"), ("ó", "o"), ("ú", "u"),
                     ("ü", "u"), ("–", "-")):
        line_text = line_text.replace(src, dst)
    return string_f2h(line_text)


def parse_document(
    document_info: Dict,
    image_path: str,
    tokenizer,
    tokenizer_fetcher: Optional[Callable],
    max_token_len: int,
    add_cls_token: bool,
    add_sep_token: bool,
    continuation_space: bool,
    text_cleanup: Optional[Callable[[str], str]],
    int_cast_bbox: bool = False,
    apply_box_aug: bool = False,
    box_aug_quirk: bool = False,
) -> ParsedDoc:
    """Shared RFUND/SIBR document → features pipeline.

    ``box_aug_quirk=True`` reproduces the reference's always-shift-down
    vertical jitter (data/data_utils.py:155-160) so an aug-enabled run draws
    byte-identical training boxes — use it when fine-tuning converted
    reference checkpoints or comparing against reference training runs; the
    default honors the drawn direction (the intended behavior)."""
    img = document_info["img"]
    image_w, image_h = img["width"], img["height"]

    lines: List[LineRecord] = []
    boxes: List[List[float]] = []
    empty_lines, empty_entities = set(), set()
    entity_text: Dict[object, str] = {}
    entity_first_line: Dict[object, object] = {}
    entity_last_line: Dict[object, object] = {}
    line_entity: Dict[object, object] = {}

    for ent in document_info["entities"]:
        first = True
        texts_of_entity = []
        last_line_id = None
        for ln in ent["lines"]:
            text = ln["text"]
            if not first and continuation_space:
                text = " " + text
            if text_cleanup is not None:
                text = text_cleanup(text)
            tokens = tokenizer.tokenize(text)
            fetched = tokenizer_fetcher(text, tokens) if tokenizer_fetcher else tokens
            if len(fetched) == 0:
                empty_lines.add(ln["id"])
                continue
            texts_of_entity.append(text)
            l, t, r, b = ln["bbox"]
            if int_cast_bbox:
                l, t, r, b = int(l), int(t), int(r), int(b)
            if apply_box_aug:
                l, t, r, b = box_augmentation((l, t, r, b), image_w, image_h,
                                              reference_quirk=box_aug_quirk)
                # repair degenerate boxes after jitter (rfund.py:162-171)
                if l >= r:
                    l, r = (0, 1) if r == 0 else (r - 1, r)
                if t >= b:
                    t, b = (0, 1) if b == 0 else (b - 1, b)
            lines.append(LineRecord([l, t, r, b], tokenizer.convert_tokens_to_ids(tokens),
                                    fetched, ent["label"], ent["id"], ln["id"]))
            boxes.append([l, t, r, b])
            if first:
                entity_first_line[ent["id"]] = ln["id"]
            first = False
            last_line_id = ln["id"]
            line_entity[ln["id"]] = ent["id"]
        if last_line_id is None:
            empty_entities.add(ent["id"])
            continue
        entity_last_line[ent["id"]] = last_line_id
        entity_text[ent["id"]] = "".join(texts_of_entity)

    order = sort_boxes(boxes)
    sorted_lines = [lines[i] for i in order]

    doc = ParsedDoc(fname=img["fname"], image_path=image_path)
    spots = {name: [] for name in ("line_extraction", "ent_linking_h2h",
                                   "ent_linking_t2t", "line_grouping_h2h",
                                   "line_grouping_t2t")}
    line_pos: Dict[object, LineRecord] = {}
    in_scope_entities, in_scope_lines = set(), set()
    cursor = 0
    for rec in sorted_lines:
        line_pos[rec.line_id] = rec
        n = len(rec.token_ids)
        if cursor + n >= max_token_len:
            break  # strict: the overflowing line and everything after drop
        in_scope_entities.add(rec.entity_id)
        in_scope_lines.add(rec.line_id)
        norm = normalize_bbox(rec.coords, (image_w, image_h))
        doc.orig_bbox.extend([rec.coords] * n)
        doc.bbox.extend([norm] * n)
        doc.text.extend(rec.fetched)
        doc.input_ids.extend(rec.token_ids)
        rec.start_token = cursor
        cursor += n
        rec.end_token = cursor
        if rec.category in ("question", "answer"):
            spots["line_extraction"].append((rec.start_token, rec.end_token - 1, 1))

    def _directed_spot(bucket: str, a: int, b: int):
        """Store link a→b as (min, max, tag): tag 1 forward, tag 2 flipped."""
        if a < b:
            spots[bucket].append((a, b, 1))
        else:
            spots[bucket].append((b, a, 2))

    for rel in document_info["relations"]["kv_entity"]:
        q, a = rel["from_id"], rel["to_id"]
        if q in empty_entities or a in empty_entities:
            continue
        if q not in in_scope_entities or a not in in_scope_entities:
            continue
        endpoints = (entity_first_line[q], entity_last_line[q],
                     entity_first_line[a], entity_last_line[a])
        if any(lid not in in_scope_lines for lid in endpoints):
            continue
        q_first, q_last, a_first, a_last = (line_pos[lid] for lid in endpoints)
        _directed_spot("ent_linking_h2h", q_first.start_token, a_first.start_token)
        _directed_spot("ent_linking_t2t", q_last.end_token - 1, a_last.end_token - 1)

    for rel in document_info["relations"]["line_grouping"]:
        src, dst = rel["from_id"], rel["to_id"]
        if src in empty_lines or dst in empty_lines:
            continue
        if (line_entity.get(src, -1) not in in_scope_entities
                or line_entity.get(dst, -1) not in in_scope_entities):
            continue
        if src not in in_scope_lines or dst not in in_scope_lines:
            continue
        s_rec, d_rec = line_pos[src], line_pos[dst]
        if None in (s_rec.start_token, s_rec.end_token, d_rec.start_token,
                    d_rec.end_token):
            continue
        _directed_spot("line_grouping_h2h", s_rec.start_token, d_rec.start_token)
        _directed_spot("line_grouping_t2t", s_rec.end_token - 1, d_rec.end_token - 1)

    for rel in document_info["relations"]["kv_entity"]:
        q, a = rel["from_id"], rel["to_id"]
        if (q not in entity_text or a not in entity_text
                or q in empty_entities or a in empty_entities
                or q not in in_scope_entities or a not in in_scope_entities):
            continue
        doc.relations.append({"key": entity_text[q], "value": entity_text[a]})

    if add_cls_token:
        doc.input_ids.insert(0, tokenizer.cls_token_id)
        doc.bbox.insert(0, [0, 0, 0, 0])
        doc.orig_bbox.insert(0, [0, 0, 0, 0])
    if add_sep_token:
        doc.input_ids.append(tokenizer.sep_token_id)
        doc.bbox.append([0, 0, 0, 0])
        doc.orig_bbox.append([0, 0, 0, 0])

    assert len(doc.input_ids) == len(doc.bbox) == len(doc.orig_bbox)
    assert len(spots["ent_linking_h2h"]) == len(spots["ent_linking_t2t"])
    assert len(spots["line_grouping_h2h"]) == len(spots["line_grouping_t2t"])
    doc.spots = spots
    return doc


class RFUNDDataset:
    """Map-style RFUND dataset (reference: data/datasets/rfund.py:25-471)."""

    SPLITS = ("train", "dev", "test")

    def __init__(
        self,
        data_root: str,
        split: str,
        language: str,
        tokenizer,
        tokenizer_fetcher: Optional[Callable] = None,
        max_token_len: int = 511,
        add_cls_token: bool = False,
        add_sep_token: bool = False,
        apply_box_aug: bool = False,
        box_aug_quirk: bool = False,
        **_: object,
    ) -> None:
        assert language in RFUND_LANGS, f"unsupported language {language}"
        assert split in self.SPLITS, f"unsupported split {split}"
        self.language = language
        self.tokenizer = tokenizer
        self.tokenizer_fetcher = tokenizer_fetcher
        self.max_token_len = max_token_len
        self.add_cls_token = add_cls_token
        self.add_sep_token = add_sep_token
        self.apply_box_aug = apply_box_aug
        self.box_aug_quirk = box_aug_quirk
        self.image_root = os.path.join(data_root, "images", language)
        fsplit = "val" if split in ("dev", "test") else split
        with open(os.path.join(data_root, f"{language}.{fsplit}.json"),
                  encoding="utf-8") as f:
            self.annotation = json.load(f)["documents"]

    @property
    def deterministic(self) -> bool:
        """True when repeated __getitem__ returns identical items — the
        loader's cross-epoch item cache keys on this (pipeline/loader.py)."""
        return not self.apply_box_aug

    def __len__(self) -> int:
        return len(self.annotation)

    def __getitem__(self, index: int) -> Dict:
        info = self.annotation[index]
        doc = parse_document(
            info,
            image_path=os.path.join(self.image_root, info["img"]["fname"]),
            tokenizer=self.tokenizer,
            tokenizer_fetcher=self.tokenizer_fetcher,
            max_token_len=self.max_token_len,
            add_cls_token=self.add_cls_token,
            add_sep_token=self.add_sep_token,
            continuation_space=self.language not in ("zh", "ja"),
            text_cleanup=rfund_text_cleanup,
            apply_box_aug=self.apply_box_aug,
            box_aug_quirk=self.box_aug_quirk,
        )
        return doc.to_feature()


class SIBRDataset:
    """Map-style SIBR dataset (reference: data/datasets/sibr.py:25-460)."""

    SPLITS = ("train", "test")

    def __init__(
        self,
        data_root: str,
        split: str,
        tokenizer,
        tokenizer_fetcher: Optional[Callable] = None,
        max_token_len: int = 511,
        add_cls_token: bool = False,
        add_sep_token: bool = False,
        apply_box_aug: bool = False,
        box_aug_quirk: bool = False,
        **_: object,
    ) -> None:
        assert split in self.SPLITS, f"unsupported split {split}"
        self.tokenizer = tokenizer
        self.tokenizer_fetcher = tokenizer_fetcher
        self.max_token_len = max_token_len
        self.add_cls_token = add_cls_token
        self.add_sep_token = add_sep_token
        self.apply_box_aug = apply_box_aug
        self.box_aug_quirk = box_aug_quirk
        self.image_root = os.path.join(data_root, "images")
        self.annotation_root = os.path.join(data_root, "converted_label")
        with open(os.path.join(data_root, f"{split}.txt")) as f:
            self.fnames = [os.path.basename(x.strip()) for x in f.readlines()]

    @property
    def deterministic(self) -> bool:
        """See RFUNDDataset.deterministic."""
        return not self.apply_box_aug

    def __len__(self) -> int:
        return len(self.fnames)

    def __getitem__(self, index: int) -> Dict:
        with open(os.path.join(self.annotation_root, self.fnames[index]),
                  encoding="utf-8") as f:
            info = json.load(f)
        doc = parse_document(
            info,
            image_path=os.path.join(self.image_root, info["img"]["fname"]),
            tokenizer=self.tokenizer,
            tokenizer_fetcher=self.tokenizer_fetcher,
            max_token_len=self.max_token_len,
            add_cls_token=self.add_cls_token,
            add_sep_token=self.add_sep_token,
            continuation_space=False,
            text_cleanup=None,
            int_cast_bbox=True,
            apply_box_aug=self.apply_box_aug,
            box_aug_quirk=self.box_aug_quirk,
        )
        return doc.to_feature()
