"""Plain host side of serving a page, as the benchmark's yardstick: the
page's OCR lines → the model's inputs, and a page's spots → its record.

Written from the semantics of PEneo's deployment script (reference
``deploy/inference.py``): lines in reading order (rows by y-centre, then
left to right), each line tokenized and the tokens given the line's box on
the 0-1000 grid, a CLS token first, cut before the first line that would
pass the token budget; the spots of the five heads decoded into lines
(line extraction, each start token kept with its best end and each end with
its best start) and key/value pairs (an entity-linking head-to-head spot
whose key and value chains, followed through line grouping, end in an
entity-linking tail-to-tail spot).

The tokenizer is the benchmark's stand-in (``TOKENIZER`` below): a
whitespace tokenizer cutting words into pieces of four characters, the
first marked with ``▁``, each piece hashed into the vocabulary's first rows.

Imports numpy and PIL only.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

TOKENIZER = {"vocab_size": 2000, "piece_len": 4, "pad": 0, "cls": 1,
             "sep": 2, "first_id": 4}
MAX_CHAIN = 1000


def tokenize(text: str) -> List[str]:
    out = []
    n = TOKENIZER["piece_len"]
    for word in text.split(" "):
        if word:
            pieces = [word[i:i + n] for i in range(0, len(word), n)]
            out += ["▁" + pieces[0]] + pieces[1:]
    return out


def token_id(tok: str) -> int:
    h = 0
    room = TOKENIZER["vocab_size"] - TOKENIZER["first_id"]
    for ch in tok:
        h = (h * 131 + ord(ch)) % room
    return TOKENIZER["first_id"] + h


def token_texts(text: str, tokens: Sequence[str]) -> List[str]:
    """The substring of ``text`` each token covers: a token's characters
    are matched in order (``▁`` is a space), a character the text lacks is
    skipped, and the last token takes what is left."""
    out, ptr = [], 0
    for i, tok in enumerate(tokens):
        sub = ""
        for ch in tok.replace("▁", " "):
            if ptr < len(text) and ch == text[ptr]:
                sub += ch
                ptr += 1
        if i == len(tokens) - 1:
            sub, ptr = sub + text[ptr:], len(text)
        out.append(sub)
    return out


def reading_order(boxes: np.ndarray) -> List[int]:
    """Rows formed on the y-centre order (a new row where the centre moves
    by half the mean box height or more), each row left to right."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
    cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
    half = float(np.sum(boxes[:, 3] - boxes[:, 1])) / (2.0 * len(boxes))
    by_y = np.argsort(cy)
    rows, row = [], [by_y[0]]
    for a, b in zip(by_y[:-1], by_y[1:]):
        if cy[b] - cy[a] >= half:
            rows.append(row)
            row = []
        row.append(b)
    rows.append(row)
    return [int(i) for r in rows for i in np.asarray(r)[np.argsort(cx[r])]]


def page_inputs(image_path: str, ocr_path: str, max_seq_len: int,
                max_tokens: int) -> Dict:
    """One page → ``input_ids``, ``bbox``, ``attention_mask`` (padded to
    ``max_seq_len``), the text of each token, the OCR box of each token and
    ``seq_len`` (tokens without the CLS)."""
    from PIL import Image

    with Image.open(image_path) as im:
        width, height = im.size
    with open(ocr_path, encoding="utf-8") as f:
        lines = json.load(f)
    boxes = np.asarray([ln["bbox"] for ln in lines], dtype=np.float64)
    ids, grid, texts, orig = [TOKENIZER["cls"]], [[0, 0, 0, 0]], [], []
    for i in reading_order(boxes):
        text, box = lines[i]["text"], lines[i]["bbox"]
        toks = tokenize(text)
        if not toks:
            continue
        if len(texts) + len(toks) > max_tokens:
            break
        g = [min(max(int(box[k] / (width, height)[k % 2] * 1000), 0), 1000)
             for k in range(4)]
        ids += [token_id(t) for t in toks]
        grid += [g] * len(toks)
        texts += token_texts(text, toks)
        orig += [list(box)] * len(toks)
    n = len(ids)
    input_ids = np.full((max_seq_len,), TOKENIZER["pad"], np.int64)
    input_ids[:n] = ids
    bbox = np.zeros((max_seq_len, 4), np.int64)
    bbox[:n] = grid
    mask = np.zeros((max_seq_len,), np.int64)
    mask[:n] = 1
    return {"input_ids": input_ids, "bbox": bbox, "attention_mask": mask,
            "texts": texts, "boxes": orig, "seq_len": n - 1}


# --------------------------------------------------------------- decoding
Spot = Tuple[int, int, int, float]


def _links(spots: Sequence[Spot], best: bool, flip: bool) -> Dict:
    """Spots → start → end links: every end in spot order, or (``best``)
    one end per start and one start per end, each kept by the higher score
    (the earlier spot on a tie). ``flip``: tag 2 marks a reversed link."""
    pairs = []
    for h, t, tag, score in spots:
        if tag == 0:
            continue
        pairs.append(((t, h) if flip and tag == 2 else (h, t), score))
    if not best:
        out: Dict[int, List[int]] = {}
        for (h, t), _ in pairs:
            out.setdefault(h, []).append(t)
        return out
    tail: Dict[int, Tuple[int, float]] = {}
    for (h, t), s in pairs:
        if h not in tail or s > tail[h][1]:
            tail[h] = (t, s)
    head: Dict[int, Tuple[int, float]] = {}
    for h, (t, s) in tail.items():
        if t not in head or s > head[t][1]:
            head[t] = (h, s)
    return {h: t for t, (h, _) in head.items()}


def _union(boxes: Sequence[Sequence[float]]) -> List[float]:
    a = np.asarray(boxes, dtype=np.float64)
    return [float(a[:, 0].min()), float(a[:, 1].min()),
            float(a[:, 2].max()), float(a[:, 3].max())]


def _chain(start, end, texts, boxes, lines, next_head, next_tail):
    """An entity's lines from its first: the next line's start must be the
    line-grouping successor of this line's start, and its end the successor
    of this line's end."""
    pieces = ["".join(texts[start:end + 1])]
    parts = [_union(boxes[start:end + 1])]
    hops = 0
    nxt = next_head.get(start)
    while nxt is not None:
        hops += 1
        if hops > MAX_CHAIN or nxt == start:
            break
        nxt_end = lines.get(nxt)
        if nxt_end is None or next_tail.get(end) != nxt_end:
            break
        pieces.append("".join(texts[nxt:nxt_end + 1]))
        parts.append(_union(boxes[nxt:nxt_end + 1]))
        start, end = nxt, nxt_end
        nxt = next_head.get(start)
    return "".join(pieces).strip(), _union(parts), end


def record(texts: Sequence[str], boxes: Sequence[Sequence[float]],
           spots: Dict[str, Sequence[Spot]]) -> Dict:
    """A page's spots (each head's in row-major order, inside the page's
    tokens) → its record: ``kv_pairs`` and ``lines`` with their boxes."""
    lines = _links(spots["line_extraction"], True, False)
    next_tail = _links(spots["line_grouping_t2t"], True, True)
    next_head = _links(spots["line_grouping_h2h"], True, True)
    tails = _links(spots["ent_linking_t2t"], False, True)
    kv = []
    for h, t, tag, _ in spots["ent_linking_h2h"]:
        if tag == 0:
            continue
        key, value = (t, h) if tag == 2 else (h, t)
        if key not in lines or value not in lines:
            continue
        k_text, k_box, k_end = _chain(key, lines[key], texts, boxes, lines,
                                      next_head, next_tail)
        v_text, v_box, v_end = _chain(value, lines[value], texts, boxes,
                                      lines, next_head, next_tail)
        if v_end in tails.get(k_end, ()):
            kv.append({"key": k_text, "value": v_text, "key_box": k_box,
                       "value_box": v_box})
    return {"kv_pairs": kv,
            "lines": [{"text": "".join(texts[s:e + 1]),
                       "box": _union(boxes[s:e + 1])}
                      for s, e in lines.items()]}
