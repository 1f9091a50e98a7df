"""Inked page images for the page-directory traffic: each page of
:func:`benchmark.pages.make_directories` redrawn from its own OCR lines, so
that a model that reads pixels reads a page whose ink lies where its text
is.

A traffic file's ``ink`` block sets the look. Every character of a line is
a glyph of ``strokes`` dark strokes, one of ``glyphs`` drawn once from the
traffic's ``vocabulary_seed`` (a font of the benchmark's own, the same in
every run), ``char_width`` wide and ``glyph_height`` high, set in the
line's OCR box from its left edge, centred in its height and cut at its
right edge, at the grey level ``ink`` on a paper of level ``paper``. Every
pixel then takes paper noise: normal(0, ``noise_sigma``) grey levels,
rounded. The noise is one field of the page's size plus ``noise_margin``
pixels each way, drawn once from the run's seed; each page reads it at an
offset of its own, drawn from the seed too, so that a page costs the same
few whole-array passes in every run. The file is an 8-bit grayscale PNG.

:func:`write_png` writes the PNG itself (each row unfiltered, the image
data deflated by Huffman codes alone): some four times faster than PIL's
writer on a noisy page, which keeps the set-up short. :func:`tinted` maps a
page's grey levels onto two colours, for a check that has to tell the
channels of an image apart, which the grayscale pages cannot.

The text, the boxes and the token counts are those of
:func:`benchmark.pages.make_directories` for the same traffic and seed.
:func:`served_tokens` counts what LayoutLMv3's page holds after its CLS:
its lines up to one token less than the budget, then the SEP.
"""

from __future__ import annotations

import json
import os
import random
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from . import pages

WRITERS = 4
# the colours of :func:`tinted`: grey level 0 → blue-black, 255 → cream
TINT = ((24, 32, 88), (250, 244, 226))


def glyphs(traffic: Dict) -> np.ndarray:
    """(glyphs, height, width) ink levels of the traffic's characters."""
    ink = traffic["ink"]
    rng = np.random.default_rng(traffic["vocabulary_seed"])
    h, w = ink["glyph_height"], traffic["char_width"]
    out = np.zeros((ink["glyphs"], h, w), np.uint8)
    lo, hi = ink["strokes"]
    for g in out:
        for _ in range(rng.integers(lo, hi + 1)):
            if rng.random() < 0.5:  # a horizontal stroke
                y = rng.integers(1, h - 1)
                x0, x1 = sorted(rng.integers(0, w - 1, 2))
                g[y:y + 2, x0:x1 + 2] = 255
            else:
                x = rng.integers(1, w - 2)
                y0, y1 = sorted(rng.integers(0, h - 1, 2))
                g[y0:y1 + 2, x:x + 2] = 255
    return out


def noise_fields(traffic: Dict, rng: np.random.Generator):
    """(paper, ink): (height + 2·margin, width + 2·margin) uint8 grey levels
    of bare paper and of inked paper, one noise field added to both."""
    width, height = traffic["page_size"]
    m, ink = traffic["ink"]["noise_margin"], traffic["ink"]
    noise = np.rint(rng.normal(0.0, ink["noise_sigma"],
                               (height + 2 * m, width + 2 * m)))
    return tuple(np.clip(ink[k] + noise, 0, 255).astype(np.uint8)
                 for k in ("paper", "ink"))


def draw(lines: List[Dict], font: np.ndarray, traffic: Dict,
         paper: np.ndarray, dark: np.ndarray) -> np.ndarray:
    """(height, width) grey levels of one page of OCR ``lines``: ``dark``
    where a glyph inks the page, else ``paper`` (the page's windows of
    :func:`noise_fields`)."""
    width, height = traffic["page_size"]
    inked = np.zeros((height, width), bool)
    gh, gw = font.shape[1:]
    blank = len(font)
    strip_font = np.concatenate([font, np.zeros((1, gh, gw), np.uint8)]) > 0
    for ln in lines:
        x0, y0, x1, y1 = (int(v) for v in ln["bbox"])
        codes = np.frombuffer(ln["text"].encode("utf-32-le"), np.uint32)
        idx = np.where(codes == ord(" "), blank, codes % blank)
        strip = strip_font[idx].transpose(1, 0, 2).reshape(gh, -1)
        top = y0 + (y1 - y0 - gh) // 2
        cut = strip[:, :max(0, min(x1 - x0, width - x0))]
        inked[top:top + gh, x0:x0 + cut.shape[1]] = cut
    return np.where(inked, dark, paper)


def write_png(path: str, levels: np.ndarray,
              colours: Optional[np.ndarray] = None) -> None:
    """An 8-bit PNG of (height, width) ``levels``: grayscale, or indexed
    into ``colours`` (256, 3) uint8 when given, synced to the disk."""
    h, w = levels.shape
    rows = np.zeros((h, w + 1), np.uint8)  # filter byte 0 (none) a row
    rows[:, 1:] = levels
    deflate = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    data = deflate.compress(rows) + deflate.flush()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if colours is None else 3,
                         0, 0, 0)
    parts = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", header)]
    if colours is not None:
        parts.append(chunk(b"PLTE", np.asarray(colours, np.uint8).tobytes()))
    parts += [chunk(b"IDAT", data), chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))
        # on the disk before the window, as a deployment's scans are: the
        # kernel would otherwise write the set-up's pages back during it
        f.flush()
        os.fsync(f.fileno())


def tinted(src: str, dst: str) -> None:
    """The grayscale page ``src`` written to ``dst`` with its grey levels
    mapped from :data:`TINT`'s first colour (level 0) to its second (255)."""
    from PIL import Image

    with Image.open(src) as im:
        levels = np.asarray(im.convert("L"))
    dark, light = (np.asarray(c, np.float64) for c in TINT)
    t = np.arange(256)[:, None] / 255.0
    write_png(dst, levels, np.rint(dark + (light - dark) * t))


def make_directories(root: str, traffic: Dict, seed: int) -> List[Dict]:
    """:func:`benchmark.pages.make_directories`, then every page image
    redrawn from its OCR lines, with paper noise from ``seed``."""
    dirs = pages.make_directories(root, traffic, seed)
    font = glyphs(traffic)
    todo = [(d, name) for d in dirs for name in sorted(d["lines"])]
    rng = np.random.default_rng(random.Random(seed).getrandbits(64))
    paper, dark = noise_fields(traffic, rng)
    width, height = traffic["page_size"]
    m = traffic["ink"]["noise_margin"]
    offsets = rng.integers(0, 2 * m + 1, (len(todo), 2))

    def redraw(page, offset):
        d, name = page
        stem = os.path.splitext(name)[0]
        with open(os.path.join(d["ocr"], stem + ".json")) as f:
            lines = json.load(f)
        window = np.s_[offset[0]:offset[0] + height,
                       offset[1]:offset[1] + width]
        write_png(os.path.join(d["images"], name),
                  draw(lines, font, traffic, paper[window], dark[window]))

    # numpy's whole-array passes and deflate let the interpreter lock go
    with ThreadPoolExecutor(max_workers=WRITERS) as pool:
        list(pool.map(redraw, todo, offsets))
    return dirs


def served_tokens(line_tokens: List[int], budget: int) -> int:
    """Rows a page serves after its CLS within ``budget`` rows: its lines
    in reading order up to the first that would pass ``budget - 1`` tokens,
    and the SEP."""
    return pages.served_tokens(line_tokens, budget - 1) + 1
