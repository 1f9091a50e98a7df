"""Host-side decoding: pair-head outputs → key/value pairs.

The port's copy of ``peneo_tpu/pipeline/decode.py`` (the prediction path,
and the ground-truth half of eval: ``spots_from_label_matrices`` and
``decode_batch``, ``:447-483``). The
device half of decoding (softmax/argmax/score over the (L, L) pair grids and
the top-k spot compaction) runs in the model (models/decoder.py). This
module takes those small integer/float arrays and runs the inherently
sequential graph-walk on the host.

Behavioral parity targets (reference: pipeline/decode.py):
- ``build_link_map``     ↔ parse_matrix_spots             :9-69
  (tie behavior: first-seen wins on equal scores; top-score mode enforces a
  bijection head↔tail by resolving collisions on score)
- ``decode_sample``      ↔ sample_decode_peneo            :72-378
  (line map, grouping maps, entity-linking chain walk with the LE/LG
  cross-validation and the tail-to-tail final check)

Known reference quirks preserved: empty samples are *not* skipped (the
reference's guard tests the batch list, pipeline/decode.py:471); duplicate
(key, value) pairs may be appended once per h2h spot.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.box_utils import merge_bbox
from ..data.tagging import matrix_to_spots

HEAD_NAMES = (
    "line_extraction",
    "ent_linking_h2h",
    "ent_linking_t2t",
    "line_grouping_h2h",
    "line_grouping_t2t",
)

Spot = Tuple[int, int, int, float]  # (head, tail, tag, score)

_MAX_CHAIN = 1000  # runaway-chain guard (reference: pipeline/decode.py:260-261)


def build_link_map(
    spots: Sequence[Spot],
    top_score_only: bool = False,
    triu_mode: bool = False,
    score_thresh: float = 0.0,
) -> Dict[int, object]:
    """Spots → head→tail map.

    - ``triu_mode``: tag 2 marks a flipped (lower-triangle) link; un-flip it.
    - ``top_score_only=False``: head → list of tails (append order = spot order).
    - ``top_score_only=True``: bijective head → tail. Per head keep the
      best-scoring tail, then per tail keep the best-scoring head; ties keep
      the first seen (strict > comparisons).
    """
    if not top_score_only:
        out: Dict[int, List[int]] = {}
        for h, t, tag, score in spots:
            if tag == 0 or score < score_thresh:
                continue
            if triu_mode and tag == 2:
                h, t = t, h
            out.setdefault(h, []).append(t)
        return out

    best_tail: Dict[int, Tuple[int, float]] = {}
    for h, t, tag, score in spots:
        if tag == 0 or score < score_thresh:
            continue
        if triu_mode and tag == 2:
            h, t = t, h
        if h not in best_tail or score > best_tail[h][1]:
            best_tail[h] = (t, score)
    best_head: Dict[int, Tuple[int, float]] = {}
    for h, (t, s) in best_tail.items():
        if t not in best_head or s > best_head[t][1]:
            best_head[t] = (h, s)
    return {h: t for t, (h, _) in best_head.items()}


def _walk_chain(
    first_head: int,
    first_tail: int,
    text: Sequence[str],
    le_map: Dict[int, int],
    lg_head_map: Dict[int, int],
    lg_tail_map: Dict[int, int],
    bbox: Optional[Sequence[Sequence[float]]],
):
    """Follow the line-grouping chain from an entity's first line.

    Each hop requires agreement between line extraction (tail of the next
    head) and line grouping (t2t successor of the current tail) — reference:
    pipeline/decode.py:258-296. Returns the collected text pieces, merged
    boxes, and the final line's head/tail indices.
    """
    pieces = [("".join(text[first_head:first_tail + 1]))]
    boxes = [merge_bbox(bbox[first_head:first_tail + 1])] if bbox is not None else None
    cur_head, cur_tail = first_head, first_tail
    nxt = lg_head_map.get(cur_head)
    hops = 0
    while nxt is not None:
        hops += 1
        if hops > _MAX_CHAIN or nxt == cur_head:
            break
        le_tail = le_map.get(nxt)
        if le_tail is None or lg_tail_map.get(cur_tail) != le_tail:
            break
        pieces.append("".join(text[nxt:le_tail + 1]))
        if boxes is not None:
            boxes.append(merge_bbox(bbox[nxt:le_tail + 1]))
        cur_head, cur_tail = nxt, le_tail
        nxt = lg_head_map.get(cur_head)
    return pieces, boxes, cur_head, cur_tail


def decode_sample(
    text: Sequence[str],
    spots: Dict[str, Sequence[Spot]],
    bbox: Optional[Sequence[Sequence[float]]] = None,
    decode_gt: bool = False,
    score_thresh: float = 0.0,
) -> Tuple:
    """Decode one sample's five spot lists into kv pairs + lines + link maps.

    Returns the same 7-tuple as the reference sample_decode_peneo:
    (kv_pairs, lines, le_map, el_head_map, el_tail_map, lg_head_map,
    lg_tail_map). With ``bbox`` given, lines are (text, box) and kv pairs are
    (key_text, value_text, key_box, value_box).
    """
    top = not decode_gt
    le_map = build_link_map(spots["line_extraction"], top, False, score_thresh)
    lg_tail_map = build_link_map(spots["line_grouping_t2t"], top, True, score_thresh)
    lg_head_map = build_link_map(spots["line_grouping_h2h"], top, True, score_thresh)
    if decode_gt:
        # gt path builds list maps then keeps the first entry
        le_map = {k: v[0] for k, v in le_map.items()}
        lg_tail_map = {k: v[0] for k, v in lg_tail_map.items()}
        lg_head_map = {k: v[0] for k, v in lg_head_map.items()}

    lines = []
    for start, end in le_map.items():
        line_text = "".join(text[start:end + 1])
        if bbox is not None:
            lines.append((line_text, merge_bbox(bbox[start:end + 1])))
        else:
            lines.append(line_text)

    el_tail_map = build_link_map(spots["ent_linking_t2t"], False, True, score_thresh)
    el_head_map: Dict[int, List[int]] = {}
    kv_pairs = []
    for h, t, tag, score in spots["ent_linking_h2h"]:
        if tag == 0 or score < score_thresh:
            continue
        key_head, value_head = (t, h) if tag == 2 else (h, t)
        el_head_map.setdefault(key_head, []).append(value_head)

        key_first_tail = le_map.get(key_head)
        value_first_tail = le_map.get(value_head)
        if key_first_tail is None or value_first_tail is None:
            continue

        key_pieces, key_boxes, _, key_last_tail = _walk_chain(
            key_head, key_first_tail, text, le_map, lg_head_map, lg_tail_map, bbox)
        val_pieces, val_boxes, _, val_last_tail = _walk_chain(
            value_head, value_first_tail, text, le_map, lg_head_map, lg_tail_map, bbox)

        # final cross-check: entity-linking t2t must connect the two chain tails
        valid_tails = el_tail_map.get(key_last_tail)
        if valid_tails is not None and val_last_tail in valid_tails:
            key_text = "".join(key_pieces).strip()
            value_text = "".join(val_pieces).strip()
            if bbox is not None:
                kv_pairs.append((key_text, value_text,
                                 merge_bbox(key_boxes), merge_bbox(val_boxes)))
            else:
                kv_pairs.append((key_text, value_text))

    return kv_pairs, lines, le_map, el_head_map, el_tail_map, lg_head_map, lg_tail_map


def unpack_spots(big, small) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of models/decoder.pack_spots: the two fetched int32 arrays
    (numpy) → the per-head compact-spot dict the decoders consume. Score bits
    are re-viewed as float32 (bit-exact — pack used a bitcast, not a
    convert)."""
    big = np.asarray(big)
    small = np.asarray(small)
    out = {}
    for hi, name in enumerate(HEAD_NAMES):
        out[name] = {
            "spot_idx": big[hi, 0],
            "spot_tag": big[hi, 1].astype(np.int8),
            "spot_score": np.ascontiguousarray(big[hi, 2]).view(np.float32),
            "spot_count": small[hi, 0],
            "seq_len": small[hi, 1],
        }
    return out


def spot_arrays_from_device_outputs(
    head_outputs: Dict[str, Dict[str, np.ndarray]],
    sample_idx: int,
    seq_len: int,
) -> Optional[Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]:
    """Compact device outputs → per-head ``(i, j, tag, score)`` numpy arrays
    in row-major (flat-index) order, restricted to ``seq_len``. Returns None
    for dense tag/score maps (those take the python path)."""
    if "spot_idx" not in head_outputs[HEAD_NAMES[0]]:
        return None
    out = {}
    for name in HEAD_NAMES:
        head = head_outputs[name]
        idx = np.asarray(head["spot_idx"][sample_idx])
        tag = np.asarray(head["spot_tag"][sample_idx])
        score = np.asarray(head["spot_score"][sample_idx])
        grid = int(np.asarray(head["seq_len"][sample_idx]))
        count = int(np.asarray(head["spot_count"][sample_idx]))
        if count > len(idx):
            import warnings

            warnings.warn(
                f"{name}: {count} spots exceed max_spots_per_head="
                f"{len(idx)}; lowest-scoring spots dropped")
        keep = score >= 0
        idx, tag, score = idx[keep], tag[keep], score[keep]
        ii = idx // grid
        jj = idx % grid
        in_range = (ii < seq_len) & (jj < seq_len)
        order = np.argsort(idx[in_range], kind="stable")
        out[name] = (
            np.ascontiguousarray(ii[in_range][order], np.int32),
            np.ascontiguousarray(jj[in_range][order], np.int32),
            np.ascontiguousarray(tag[in_range][order], np.int8),
            np.ascontiguousarray(score[in_range][order], np.float32),
        )
    return out


def spots_from_device_outputs(
    head_outputs: Dict[str, Dict[str, np.ndarray]],
    sample_idx: int,
    seq_len: int,
) -> Dict[str, List[Spot]]:
    """Extract per-head spot lists for one sample from the device outputs,
    restricted to ``seq_len``. Accepts either the dense argmax/score maps or
    the compact top-k spot format (models/decoder.py compact_spots); compact
    spots are re-sorted by flat index to restore the row-major shaking order
    the reference parsers depend on."""
    arrays = spot_arrays_from_device_outputs(head_outputs, sample_idx, seq_len)
    if arrays is not None:
        return {
            name: [(int(i), int(j), int(t), float(s))
                   for i, j, t, s in zip(*arrays[name])]
            for name in HEAD_NAMES
        }
    out = {}
    for name in HEAD_NAMES:
        head = head_outputs[name]
        tags = np.asarray(head["tags"][sample_idx])[:seq_len, :seq_len]
        scores = np.asarray(head["scores"][sample_idx])[:seq_len, :seq_len]
        out[name] = matrix_to_spots(tags, scores)
    return out


def decode_sample_native(
    text: Sequence[str],
    arrays: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    bbox: Optional[Sequence[Sequence[float]]] = None,
    score_thresh: float = 0.0,
) -> Optional[Tuple]:
    """Native (C++) decode of one prediction sample from compact spot arrays.
    Returns the same 7-tuple as :func:`decode_sample` (identical outputs —
    randomized equivalence test), or None when the native library is
    unavailable (caller falls back to python)."""
    import ctypes

    from ..native import load_decode_lib

    lib = load_decode_lib()
    if lib is None:
        return None

    def ptrs(name):
        i, j, t, s = arrays[name]
        return (i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                j.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                t.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(i))

    n_le = len(arrays["line_extraction"][0])
    n_elh = len(arrays["ent_linking_h2h"][0])
    n_elt = len(arrays["ent_linking_t2t"][0])
    n_lgh = len(arrays["line_grouping_h2h"][0])
    n_lgt = len(arrays["line_grouping_t2t"][0])

    def buf(n):
        return np.empty((max(n, 1),), np.int32)

    le_items, lgh_items, lgt_items = buf(2 * n_le), buf(2 * n_lgh), buf(2 * n_lgt)
    elt_pairs, elh_pairs, kv_meta = buf(2 * n_elt), buf(2 * n_elh), buf(4 * n_elh)
    # per kv pair: two chains, each ≤ 1 + min(MAX_CHAIN, n_lgh) segments of 2
    seg_cap = max(4, 4 * (1 + min(_MAX_CHAIN, n_lgh)) * max(n_elh, 1))
    segs = buf(seg_cap)
    sizes = np.zeros((7,), np.int32)

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.peneo_decode_sample(
        *ptrs("line_extraction"), *ptrs("ent_linking_h2h"),
        *ptrs("ent_linking_t2t"), *ptrs("line_grouping_h2h"),
        *ptrs("line_grouping_t2t"),
        ctypes.c_float(score_thresh),
        p32(le_items), p32(lgh_items), p32(lgt_items), p32(elt_pairs),
        p32(elh_pairs), p32(kv_meta), p32(segs), seg_cap, p32(sizes))
    if rc != 0:
        return None

    n_le_o, n_lgh_o, n_lgt_o, n_elt_o, n_elh_o, n_kv, n_seg = (
        int(x) for x in sizes)
    # bulk-convert once: per-element numpy scalar indexing costs ~100 ns each
    le_l = le_items[:2 * n_le_o].tolist()
    lgh_l = lgh_items[:2 * n_lgh_o].tolist()
    lgt_l = lgt_items[:2 * n_lgt_o].tolist()
    elt_l = elt_pairs[:2 * n_elt_o].tolist()
    elh_l = elh_pairs[:2 * n_elh_o].tolist()
    kv_l = kv_meta[:4 * n_kv].tolist()
    seg_l = segs[:n_seg].tolist()

    le_map = dict(zip(le_l[0::2], le_l[1::2]))
    lg_head_map = dict(zip(lgh_l[0::2], lgh_l[1::2]))
    lg_tail_map = dict(zip(lgt_l[0::2], lgt_l[1::2]))
    el_tail_map: Dict[int, List[int]] = {}
    for h, t in zip(elt_l[0::2], elt_l[1::2]):
        el_tail_map.setdefault(h, []).append(t)
    el_head_map: Dict[int, List[int]] = {}
    for h, t in zip(elh_l[0::2], elh_l[1::2]):
        el_head_map.setdefault(h, []).append(t)

    lines = []
    for start, end in le_map.items():
        line_text = "".join(text[start:end + 1])
        if bbox is not None:
            lines.append((line_text, merge_bbox(bbox[start:end + 1])))
        else:
            lines.append(line_text)

    kv_pairs = []
    cursor = 0

    def read_chain(n_segs):
        nonlocal cursor
        ss = seg_l[cursor:cursor + 2 * n_segs:2]
        ee = seg_l[cursor + 1:cursor + 2 * n_segs:2]
        cursor += 2 * n_segs
        pieces = ["".join(text[s:e + 1]) for s, e in zip(ss, ee)]
        boxes = ([merge_bbox(bbox[s:e + 1]) for s, e in zip(ss, ee)]
                 if bbox is not None else None)
        return pieces, boxes

    for k in range(n_kv):
        key_pieces, key_boxes = read_chain(kv_l[4 * k + 2])
        val_pieces, val_boxes = read_chain(kv_l[4 * k + 3])
        key_text = "".join(key_pieces).strip()
        value_text = "".join(val_pieces).strip()
        if bbox is not None:
            kv_pairs.append((key_text, value_text,
                             merge_bbox(key_boxes), merge_bbox(val_boxes)))
        else:
            kv_pairs.append((key_text, value_text))

    return (kv_pairs, lines, le_map, el_head_map, el_tail_map, lg_head_map,
            lg_tail_map)


def decode_pred_sample(
    text: Sequence[str],
    head_outputs: Dict[str, Dict[str, np.ndarray]],
    sample_idx: int,
    seq_len: int,
    bbox: Optional[Sequence[Sequence[float]]] = None,
    score_thresh: float = 0.0,
) -> Tuple:
    """Prediction-path decode for one sample: native C++ fast path on compact
    spot outputs, python fallback otherwise (identical results)."""
    arrays = spot_arrays_from_device_outputs(head_outputs, sample_idx, seq_len)
    if arrays is not None:
        res = decode_sample_native(text, arrays, bbox=bbox,
                                   score_thresh=score_thresh)
        if res is not None:
            return res
        spots = {name: [(int(i), int(j), int(t), float(s))
                        for i, j, t, s in zip(*arrays[name])]
                 for name in HEAD_NAMES}
    else:
        spots = spots_from_device_outputs(head_outputs, sample_idx, seq_len)
    return decode_sample(text, spots, bbox=bbox, score_thresh=score_thresh)


def decode_page_record(
    texts: Sequence[str],
    head_outputs: Dict[str, Dict[str, np.ndarray]],
    sample_idx: int,
    seq_len: int,
    dt: float,
    img_path: Optional[str] = None,
    visualize_dir: Optional[str] = None,
    score_thresh: float = 0.0,
    bbox: Optional[Sequence[Sequence[float]]] = None,
):
    """One serving page's host decode → JSON-ready result record (kv pairs,
    line records and seconds; reference deploy/inference.py:407-447), and
    with ``visualize_dir`` the page drawn with its predictions there under
    its own basename. Runs on the serving decode thread pool."""
    kv_pairs, lines, *_ = decode_pred_sample(
        texts, head_outputs, sample_idx, seq_len, bbox=bbox,
        score_thresh=score_thresh)
    record = {
        "kv_pairs": [
            {"key": k, "value": v,
             "key_box": [float(x) for x in kb],
             "value_box": [float(x) for x in vb]}
            for k, v, kb, vb in kv_pairs
        ],
        "lines": [{"text": t, "box": [float(x) for x in b]}
                  for t, b in lines],
        "seconds": dt,
    }
    if visualize_dir:
        import os

        from ..utils.visualize import draw_page

        os.makedirs(visualize_dir, exist_ok=True)
        draw_page(img_path, kv_pairs, lines,
                  os.path.join(visualize_dir, os.path.basename(img_path)))
    return record


def spots_from_label_matrices(
    labels: Dict[str, np.ndarray], sample_idx: int, seq_len: int
) -> Dict[str, List[Spot]]:
    """Ground-truth spot lists (score = 1) from dense (Ld, Ld) label matrices
    or compact (S, 3) spot arrays (collator labels_as_spots mode)."""
    out = {}
    for name in HEAD_NAMES:
        m = np.asarray(labels[name][sample_idx])
        if m.ndim == 2 and m.shape[-1] == 3 and m.shape[0] != m.shape[1]:
            keep = (m[:, 2] != 0) & (m[:, 0] < seq_len) & (m[:, 1] < seq_len)
            kept = m[keep]
            order = np.lexsort((kept[:, 1], kept[:, 0]))  # row-major
            out[name] = [(int(i), int(j), int(t), 1.0)
                         for i, j, t in kept[order]]
        else:
            out[name] = matrix_to_spots(m[:seq_len, :seq_len])
    return out


def decode_batch(
    texts: Sequence[Sequence[str]],
    pred_outputs: Dict[str, Dict[str, np.ndarray]],
    gt_labels: Dict[str, np.ndarray],
    seq_lens: Sequence[int],
    fnames: Sequence[str],
    score_thresh: float = 0.0,
):
    """Decode predictions and ground truth for a batch (reference decode_peneo,
    pipeline/decode.py:381-511). Returns (pred_results, gt_results, fnames)."""
    all_pred, all_gt, all_fnames = [], [], []
    for i, (text, seq_len, fname) in enumerate(zip(texts, seq_lens, fnames)):
        gt_spots = spots_from_label_matrices(gt_labels, i, seq_len)
        all_pred.append(decode_pred_sample(text, pred_outputs, i, seq_len,
                                           score_thresh=score_thresh))
        all_gt.append(decode_sample(text, gt_spots, decode_gt=True))
        all_fnames.append(fname)
    return all_pred, all_gt, all_fnames
