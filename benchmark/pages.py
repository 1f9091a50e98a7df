"""The page generator: a traffic file of page directories (``traffic/*.json``
with ``"kind": "page_directories"``) and a seed → directories of page
images and their line OCR.

Every seed gets the same set of page sizes: the token counts are the
quantiles of the traffic's distribution, one per page, and the seed only
deals them out over the directories and draws the words and the layout. So
two seeds ask for the same work in another order, and a seed always asks for
the same pages.

A page is a grid of OCR lines in reading order (``columns`` across,
``row_pitch`` apart), each line one to ``line_words`` words of the
traffic's vocabulary, until the page holds its token count. The token count
is the benchmark's stand-in tokenizer's (``reference/pages.py``). Every page
image is the same blank page of the traffic's size: a text-only model reads
an image's size and none of its pixels.
"""

from __future__ import annotations

import io
import json
import math
import os
import random
from statistics import NormalDist
from typing import Dict, List

from .reference.pages import tokenize


def token_counts(traffic: Dict) -> List[int]:
    """One token count per page of all directories, in quantile order."""
    t = traffic["tokens"]
    n = traffic["pages_per_job"] * traffic["directories"]
    if t["distribution"] != "lognormal":
        raise ValueError(f"token distribution {t['distribution']!r}")
    z = NormalDist()
    mu = math.log(t["median"])
    return [min(t["max"], max(t["min"], round(math.exp(
        mu + t["sigma"] * z.inv_cdf((i + 0.5) / n))))) for i in range(n)]


def vocabulary(traffic: Dict) -> List[str]:
    """The traffic's words, the same for every seed."""
    rng = random.Random(traffic["vocabulary_seed"])
    lo, hi = traffic["word_letters"]
    letters = "abcdefghijklmnopqrstuvwxyz"
    return ["".join(rng.choice(letters) for _ in range(rng.randint(lo, hi)))
            for _ in range(traffic["vocabulary"])]


def page_lines(rng: random.Random, words: List[str], tokens: int,
               traffic: Dict) -> List[Dict]:
    """OCR lines of one page holding at least ``tokens`` tokens, in reading
    order."""
    width, height = traffic["page_size"]
    margin, pitch = traffic["margin"], traffic["row_pitch"]
    cols = traffic["columns"]
    col_w = (width - 2 * margin) // cols
    rows = (height - 2 * margin) // pitch
    lines, have = [], 0
    for slot in range(rows * cols):
        if have >= tokens:
            break
        row, col = divmod(slot, cols)
        text = " ".join(rng.choice(words)
                        for _ in range(rng.randint(*traffic["line_words"])))
        x0 = margin + col * col_w + rng.randint(0, traffic["jitter"])
        y0 = margin + row * pitch
        x1 = min(x0 + traffic["char_width"] * len(text),
                 margin + (col + 1) * col_w - 4)
        lines.append({"text": text,
                      "bbox": [x0, y0, x1, y0 + traffic["line_height"]]})
        have += len(tokenize(text))
    if have < tokens:
        raise ValueError(f"a {width}x{height} page holds {have} of "
                         f"{tokens} tokens: enlarge the grid")
    return lines


def blank_png(traffic: Dict) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", tuple(traffic["page_size"]), (255, 255, 255)).save(
        buf, format="PNG", compress_level=1)
    return buf.getvalue()


def make_directories(root: str, traffic: Dict, seed: int) -> List[Dict]:
    """Write the traffic's directories under ``root``: ``d<i>/images`` and
    ``d<i>/ocr``, page ``p<j>`` in each. Returns per directory its paths
    and, by page image name, the token count of each of its lines."""
    rng = random.Random(seed)
    counts = token_counts(traffic)
    rng.shuffle(counts)
    words = vocabulary(traffic)
    png = blank_png(traffic)
    per = traffic["pages_per_job"]
    dirs = []
    for d in range(traffic["directories"]):
        img_dir = os.path.join(root, f"d{d}", "images")
        ocr_dir = os.path.join(root, f"d{d}", "ocr")
        os.makedirs(img_dir)
        os.makedirs(ocr_dir)
        lines = {}
        for j in range(per):
            name = f"p{j:04d}"
            page = page_lines(rng, words, counts[d * per + j], traffic)
            with open(os.path.join(img_dir, name + ".png"), "wb") as f:
                f.write(png)
            with open(os.path.join(ocr_dir, name + ".json"), "w") as f:
                json.dump(page, f)
            lines[name + ".png"] = [len(tokenize(ln["text"])) for ln in page]
        dirs.append({"images": img_dir, "ocr": ocr_dir, "lines": lines})
    return dirs


def served_tokens(line_tokens: List[int], budget: int) -> int:
    """Tokens a page serves: its lines in reading order up to the first
    that would pass ``budget``."""
    have = 0
    for n in line_tokens:
        if have + n > budget:
            break
        have += n
    return have
