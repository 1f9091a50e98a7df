"""Fixed-shape batcher: feature dicts → static (B, L) arrays + labels (the
port's copy of ``peneo_tpu/data/collator.py:37-153``).

Replacement for the reference's DataCollatorForPEneo
(data/collator.py:10-230). Differences by design:

- pads every batch to the static ``max_seq_len`` (the reference's
  padding="max_length" mode, data/collator.py:74-80) instead of
  longest-in-batch ×8: every batch has one shape, and the loss
  normalization matches the reference's max_length mode exactly (extra
  all-background triu positions enter both the CE numerator and weight
  denominator identically).
- labels are dense (B, Ld, Ld) int32 matrices over Ld = L - int(cls) taggable
  positions (the SEP, when present, stays inside the taggable range exactly
  like the reference's collator, data/collator.py:156-158).
- labels are compact (B, S, 3) spot arrays (``labels_as_spots``) that the
  decoder scatters on the device, or dense int8 matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .tagging import batch_spots_to_matrix

MAX_LABEL_SPOTS = 512  # label spots shipped per head and page

LABEL_KEYS = {
    "line_extraction": "line_extraction_matrix_spots",
    "ent_linking_h2h": "ent_linking_head_rel_matrix_spots",
    "ent_linking_t2t": "ent_linking_tail_rel_matrix_spots",
    "line_grouping_h2h": "line_grouping_head_rel_matrix_spots",
    "line_grouping_t2t": "line_grouping_tail_rel_matrix_spots",
}


@dataclass
class Batch:
    """One training/eval batch. Arrays are numpy; device placement happens in
    the trainer (pipeline/loader.py ``batch_to_device``)."""

    input_ids: np.ndarray          # (B, L) int32
    bbox: np.ndarray               # (B, L, 4) int32, [0, 1000]
    orig_bbox: np.ndarray          # (B, L, 4) float32, pixel space
    attention_mask: np.ndarray     # (B, L) int32
    labels: Dict[str, np.ndarray]  # head → (B, Ld, Ld) int32
    seq_len: np.ndarray            # (B,) true taggable length per sample
    image: Optional[np.ndarray] = None   # (B, C, H, W) float32
    texts: Optional[List[List[str]]] = None
    relations: Optional[List[List[Dict]]] = None
    fnames: Optional[List[str]] = None

    def model_inputs(self) -> Dict[str, np.ndarray]:
        out = {"input_ids": self.input_ids, "bbox": self.bbox,
               "attention_mask": self.attention_mask}
        if self.image is not None:
            out["image"] = self.image
        return out


class PEneoCollator:
    """features (datasets.py output) → :class:`Batch`.

    ``pad_token_id`` pads input_ids; bboxes pad with zeros; labels are built
    over the taggable range Ld = max_seq_len - int(add_cls_token)
    (reference: data/collator.py:156-169). ``image_loader`` (path → CHW
    float32, data/image_processing.py) adds the stacked page images of a
    visual backbone.
    """

    def __init__(
        self,
        max_seq_len: int = 512,
        pad_token_id: int = 0,
        add_cls_token: bool = True,
        labels_as_spots: bool = False,
        image_loader: Optional[Callable[[str], np.ndarray]] = None,
    ) -> None:
        self.image_loader = image_loader
        self.max_seq_len = max_seq_len
        self.pad_token_id = pad_token_id
        self.add_cls_token = add_cls_token
        # spots mode ships (B, S, 3) spot arrays (a few KB) instead of dense
        # (B, Ld, Ld) matrices; the decoder scatters them on device
        self.labels_as_spots = labels_as_spots

    @property
    def taggable_len(self) -> int:
        return self.max_seq_len - (1 if self.add_cls_token else 0)

    def __call__(self, features: Sequence[Dict]) -> Batch:
        B, L = len(features), self.max_seq_len
        Ld = self.taggable_len
        input_ids = np.full((B, L), self.pad_token_id, dtype=np.int32)
        bbox = np.zeros((B, L, 4), dtype=np.int32)
        orig_bbox = np.zeros((B, L, 4), dtype=np.float32)
        attn = np.zeros((B, L), dtype=np.int32)
        seq_len = np.zeros((B,), dtype=np.int32)

        for i, f in enumerate(features):
            ids = f["input_ids"][:L]
            n = len(ids)
            input_ids[i, :n] = ids
            bbox[i, :n] = np.asarray(f["bbox"][:L], dtype=np.int32).reshape(n, 4)
            orig_bbox[i, :n] = np.asarray(f["orig_bbox"][:L],
                                          dtype=np.float32).reshape(n, 4)
            attn[i, :n] = 1
            # taggable positions exclude only the CLS (SEP included, like the
            # reference); decoding later slices [:seq_len].
            seq_len[i] = n - (1 if self.add_cls_token else 0)

        if self.labels_as_spots:
            S = MAX_LABEL_SPOTS
            labels = {}
            for name, key in LABEL_KEYS.items():
                arr = np.full((B, S, 3), [Ld, Ld, 0], dtype=np.int32)
                for i, f in enumerate(features):
                    spots = f[key][:S]
                    if len(f[key]) > S:
                        import warnings

                        warnings.warn(
                            f"{name}: {len(f[key])} label spots exceed "
                            f"{S} per head; extra spots dropped")
                    if spots:
                        arr[i, :len(spots)] = spots
                labels[name] = arr
        else:
            # int8 labels: tags are 0..2 and the five dense (B, Ld, Ld)
            # matrices dominate host→device bytes (4x smaller than int32)
            labels = {
                name: batch_spots_to_matrix(
                    [f[key] for f in features], Ld).astype(np.int8)
                for name, key in LABEL_KEYS.items()
            }

        image = None
        if self.image_loader is not None:
            image = np.stack([self.image_loader(f["image_path"])
                              for f in features])

        return Batch(
            input_ids=input_ids,
            bbox=bbox,
            orig_bbox=orig_bbox,
            attention_mask=attn,
            labels=labels,
            seq_len=seq_len,
            image=image,
            texts=[list(f["text"]) for f in features],
            relations=[f.get("relations", []) for f in features],
            fnames=[f.get("fname", str(i)) for i, f in enumerate(features)],
        )
