"""Prediction visualization: draw line boxes, kv boxes, text labels and
key→value link lines on the page image (reference: deploy/inference.py:79-107).

The port's copy of ``peneo_tpu/utils/visualize.py``: key box red / value box
green with the key/value *text* drawn just above each box, a link line from
the key box's bottom-right corner to the value box's top-left corner, and
detected text lines as thin inset gray rectangles. The reference bundles a
TTF font (``deploy/Deng.ttf``, looked up from the working directory); without
it DejaVuSans, else PIL's default bitmap font.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _load_font(size: int = 10):
    from PIL import ImageFont

    for name in ("deploy/Deng.ttf", "DejaVuSans.ttf"):
        try:
            return ImageFont.truetype(name, size)
        except Exception:
            continue
    return ImageFont.load_default()


def draw_page(image_path: str, kv_pairs: Sequence[Tuple], lines: Sequence[Tuple],
              out_path: str) -> None:
    from PIL import Image, ImageDraw

    font = _load_font(10)
    with Image.open(image_path) as im:
        im = im.convert("RGB")
        drw = ImageDraw.Draw(im)
        for item in kv_pairs:
            k, v, kb, vb = item[:4]
            drw.rectangle([kb[0], kb[1], kb[2], kb[3]], outline="red", width=2)
            drw.rectangle([vb[0], vb[1], vb[2], vb[3]], outline="green", width=2)
            drw.text((kb[0], kb[1] - 12), str(k), fill="red", font=font)
            drw.text((vb[0], vb[1] - 12), str(v), fill="green", font=font)
            # the reference links key bottom-right -> value top-left
            drw.line([(kb[2], kb[3]), (vb[0], vb[1])], fill="blue", width=2)
        for text, box in lines:
            drw.rectangle([box[0] + 2, box[1] + 2, box[2] - 2, box[3] - 2],
                          outline="gray", width=1)
        im.save(out_path)
