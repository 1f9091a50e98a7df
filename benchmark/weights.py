"""Seeded random weights of a configuration, made on the device.

The parameter table comes from the configuration's plain reference (name,
shape, init): matrices and tables are drawn normal(0, std) in one call on
the card into one buffer of the served type, biases are zero, LayerNorm
gains one, and the padding rows of the token and position tables zero, as
the published init leaves them. The same seed gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(table: List[Tuple[str, Tuple[int, ...], str]],
         zero_rows: List[Tuple[str, int]], seed: int, std: float,
         dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} on ``device`` in ``dtype``; the normal draws are views
    of one buffer, filled by one call from a generator on the device."""
    sizes = [(name, shape, init, math.prod(shape))
             for name, shape, init in table]
    total = sum(n for _, _, init, n in sizes if init == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, std, generator=gen)
    out, at = {}, 0
    for name, shape, init, n in sizes:
        if init == "normal":
            out[name] = buf[at:at + n].view(shape)
            at += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    for name, row in zero_rows:
        out[name][row].zero_()
    return out

