"""Synthetic RFUND-schema document generator + toy tokenizer (the port's
copy of ``peneo_tpu/data/synthetic.py`` without the dataset writers).

No RFUND/SIBR data ships with this environment, so tests, the end-to-end
training demo, and the benchmark run on generated documents that follow the
exact annotation schema the reference datasets read
(data/datasets/rfund.py:111-130: ``{"img": {...}, "entities": [{"id", "label",
"lines": [{"id", "text", "bbox"}]}], "relations": {"kv_entity": [...],
"line_grouping": [...]}}``).

Documents are form-like: key/value entity pairs laid out in rows, some
entities spanning multiple lines (exercising line grouping), plus 'other' and
'header' noise lines.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

WORDS = (
    "date name total amount address phone invoice number company tax item "
    "price quantity order city street account code status type email id "
    "description payment balance due from until signature department file"
).split()


class ToyTokenizer:
    """SentencePiece-flavored whitespace tokenizer: '▁' marks a leading space.

    Implements the tokenizer surface the data plane needs
    (``tokenize`` / ``convert_tokens_to_ids`` / cls/sep/pad ids), compatible
    with fetchers.fetch_xlm. Long words split into 4-char pieces so multi-token
    lines exist.
    """

    def __init__(self, vocab_size: int = 2000, piece_len: int = 4):
        self.vocab_size = vocab_size
        self.piece_len = piece_len
        self.pad_token_id = 0
        self.cls_token_id = 1
        self.sep_token_id = 2
        self.unk_token_id = 3
        self.cls_token = "<s>"
        self.sep_token = "</s>"
        self.pad_token = "<pad>"
        self.padding_side = "right"

    def save_pretrained(self, directory: str) -> None:
        """Self-describing tokenizer file so a synthetic-data train output dir
        is servable (registry.load_tokenizer recognizes it)."""
        import json
        import os

        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "toy_tokenizer.json"), "w") as f:
            json.dump({"vocab_size": self.vocab_size,
                       "piece_len": self.piece_len}, f)

    @classmethod
    def from_pretrained(cls, directory: str) -> "ToyTokenizer":
        import json
        import os

        with open(os.path.join(directory, "toy_tokenizer.json")) as f:
            meta = json.load(f)
        return cls(vocab_size=meta["vocab_size"], piece_len=meta["piece_len"])

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in text.split(" "):
            if not word:
                continue
            pieces = [word[i:i + self.piece_len]
                      for i in range(0, len(word), self.piece_len)]
            out.append("▁" + pieces[0])
            out.extend(pieces[1:])
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        # stable hash into the vocab, avoiding special ids
        def tid(tok: str) -> int:
            h = 0
            for ch in tok:
                h = (h * 131 + ord(ch)) % (self.vocab_size - 4)
            return 4 + h

        return [tid(t) for t in tokens]


def _rand_text(rng: random.Random, n_words: int) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(n_words))


def make_document(
    rng: random.Random,
    fname: str,
    n_pairs: int = 6,
    n_noise: int = 3,
    multiline_prob: float = 0.35,
    image_size: Tuple[int, int] = (1000, 1400),
) -> Dict:
    """One synthetic form page in RFUND annotation schema."""
    W, H = image_size
    entities, kv_rel, lg_rel = [], [], []
    eid = 0
    lid = 0
    y = 40

    def add_entity(label: str, n_lines: int, x: int) -> Tuple[int, List[int]]:
        nonlocal eid, lid, y
        lines = []
        line_ids = []
        yy = y
        for _ in range(n_lines):
            w_count = rng.randint(1, 4)
            text = _rand_text(rng, w_count)
            width = 14 * len(text) + rng.randint(0, 20)
            lines.append({
                "id": lid,
                "text": text,
                "bbox": [x, yy, min(x + width, W - 1), yy + 24],
            })
            line_ids.append(lid)
            lid += 1
            yy += 30
        entities.append({"id": eid, "label": label, "lines": lines})
        this_id = eid
        eid += 1
        return this_id, line_ids

    for _ in range(n_pairs):
        q_lines = 2 if rng.random() < multiline_prob else 1
        a_lines = 2 if rng.random() < multiline_prob else 1
        q_id, q_line_ids = add_entity("question", q_lines, x=rng.randint(30, 80))
        a_id, a_line_ids = add_entity("answer", a_lines, x=rng.randint(450, 520))
        kv_rel.append({"from_id": q_id, "to_id": a_id})
        for ids in (q_line_ids, a_line_ids):
            for a, b in zip(ids, ids[1:]):
                lg_rel.append({"from_id": a, "to_id": b})
        y += 34 * max(q_lines, a_lines) + rng.randint(4, 16)

    for _ in range(n_noise):
        add_entity(rng.choice(["other", "header"]), 1, x=rng.randint(100, 700))
        y += 34

    return {
        "img": {"fname": fname, "width": W, "height": H},
        "entities": entities,
        "relations": {"kv_entity": kv_rel, "line_grouping": lg_rel},
    }


def render_page(doc: Dict):
    """Rasterize a synthetic page: white background, dark line boxes — enough
    visual signal for image-tower smoke tests."""
    import numpy as np

    W, H = doc["img"]["width"], doc["img"]["height"]
    img = np.full((H, W, 3), 255, dtype=np.uint8)
    for ent in doc["entities"]:
        for ln in ent["lines"]:
            l, t, r, b = (int(v) for v in ln["bbox"])
            img[t:b, l:r] = (90, 90, 90)
    return img
