"""Bounding-box geometry utilities (host-side, numpy; the port's copy of
``peneo_tpu/data/box_utils.py``).

Behavioral parity targets (reference: data/data_utils.py):
- ``box_two_point_convert``  :7-28
- ``normalize_bbox``         :31-59
- ``merge_bbox``             :62-76
- ``sort_boxes``             :79-119  (reading order; parity-critical — packing
  order determines token indices and therefore every label)
- ``box_augmentation``       :122-170 (train-time jitter; the reference's
  vertical branch always moves DOWN regardless of direction draw — a quirk
  fixed here by honoring the drawn direction, gated by ``reference_quirk``)
- ``string_f2h``             :173-195
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


def box_two_point_convert(box: Union[Sequence[float], Dict[str, float]]) -> List[float]:
    """Convert a 4-value ltrb or 8-value quad box to ltrb."""
    if isinstance(box, (list, tuple)) and len(box) == 4:
        return list(box)
    if len(box) != 8:
        raise ValueError("Box must contain 4 or 8 values")
    if isinstance(box, dict):
        xs = {v for k, v in box.items() if "x" in k}
        ys = {v for k, v in box.items() if "x" not in k}
    else:
        xs = {v for i, v in enumerate(box) if i % 2 == 0}
        ys = {v for i, v in enumerate(box) if i % 2 == 1}
    return [min(xs), min(ys), max(xs), max(ys)]


def normalize_bbox(box: Sequence[float], size: Tuple[float, float]) -> List[int]:
    """Normalize an ltrb box to the [0, 1000] grid with clipping."""
    w, h = size
    x0 = min(max(int((box[0] / w) * 1000), 0), 1000)
    y0 = min(max(int((box[1] / h) * 1000), 0), 1000)
    x1 = min(max(int((box[2] / w) * 1000), 0), 1000)
    y1 = min(max(int((box[3] / h) * 1000), 0), 1000)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"degenerate bbox after normalization: {box}")
    return [x0, y0, x1, y1]


def merge_bbox(bbox_list: Sequence[Sequence[float]]) -> List[float]:
    """Union of a list of ltrb boxes."""
    arr = np.asarray(bbox_list)
    return [arr[:, 0].min(), arr[:, 1].min(), arr[:, 2].max(), arr[:, 3].max()]


def sort_boxes(boxes: Sequence[Sequence[float]]) -> List[int]:
    """Reading-order sort: indices of boxes top-to-bottom, rows left-to-right.

    Rows are formed greedily on the y-center-sorted order: a box joins the
    current row when its y-center is within half the mean box height of the
    previous box's y-center. Must match the reference byte-for-byte (including
    argsort tie behavior) because token packing order defines all labels.
    """
    if len(boxes) == 0:
        return []
    arr = np.asarray(boxes, dtype=np.float64)
    cx = (arr[:, 0] + arr[:, 2]) / 2.0
    cy = (arr[:, 1] + arr[:, 3]) / 2.0
    half_mean_h = float(np.sum(arr[:, 3] - arr[:, 1])) / (2.0 * len(boxes))

    order = np.argsort(cy)  # same default (introsort) as the reference
    row_id = np.empty(len(order), dtype=np.int64)
    row_id[0] = 0
    rid = 0
    for i in range(1, len(order)):
        if (cy[order[i]] - cy[order[i - 1]]) >= half_mean_h:
            rid += 1
        row_id[i] = rid
    for r in range(rid + 1):
        sel = np.where(row_id == r)[0]
        start, end = sel[0], sel[0] + len(sel)
        order[start:end] = order[start:end][np.argsort(cx[order[start:end]])]
    return order.tolist()


def box_augmentation(
    bbox: Sequence[float],
    image_w: int,
    image_h: int,
    reference_quirk: bool = False,
) -> Tuple[int, int, int, int]:
    """Random translation jitter: up to 10% of width in x, 30% of height in y.

    ``reference_quirk=True`` reproduces data/data_utils.py:155-160, where both
    vertical branches shift downward; the default honors the drawn direction.
    """
    left, top, right, bot = bbox
    x_dir = random.randint(0, 1)
    y_dir = random.randint(0, 1)
    dx = (right - left) * (random.randint(0, 10) / 100)
    dy = (bot - top) * (random.randint(0, 30) / 100)

    if not x_dir:
        dx = -dx
    if reference_quirk:
        pass  # always shift down
    elif not y_dir:
        dy = -dy

    new_left = min(max(left + dx, 0), image_w)
    new_right = min(max(right + dx, 0), image_w)
    new_top = min(max(top + dy, 0), image_h)
    new_bot = min(max(bot + dy, 0), image_h)
    return (
        int(round(new_left)),
        int(round(new_top)),
        int(round(new_right)),
        int(round(new_bot)),
    )


# full-width → half-width map (U+FF01..U+FF5E and ideographic space);
# str.translate runs the scan in C — the per-char python loop this replaces
# was a measured serving-preprocess hotspot (reference semantics:
# data/data_utils.py:173-195)
_F2H_TABLE = {0x3000: " "}
_F2H_TABLE.update({c: chr(c - 0xFEE0) for c in range(0xFF01, 0xFF5F)})


def string_f2h(text: str) -> str:
    """Convert full-width characters to half-width (U+FF01..U+FF5E and ideographic space)."""
    return text.translate(_F2H_TABLE)
