"""The control of a bfloat16 serving cell's pair stage: the reference's pair
head put in the program's place, with its classifiers' hidden products
taken in float8 (e4m3), the precision below bfloat16 that a faster pair head
would reach for. Each input row and each output channel of the weight is
scaled by its absolute maximum onto e4m3's largest value (448), rounded to
e4m3, multiplied in float32 and scaled back: a float8 GEMM with per-row and
per-channel scales.

:func:`spots` compacts the control's logits as the program serves them: per
head the top-k cells of the upper triangle whose argmax tag is not 0, by
score.

Imports torch only.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

E4M3_MAX = 448.0


def _e4m3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) float32 → (its rows rounded to e4m3 at one scale a row, as
    float32; the (N, 1) scales)."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float(), scale


def fp8_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """``x · Wᵀ + b`` with both factors in e4m3: (..., K) → (..., F)."""
    xq, sx = _e4m3(x.reshape(-1, x.shape[-1]).float())
    wq, sw = _e4m3(weight.float())
    y = (xq @ wq.t()) * sx * sw.t() + bias.float()
    return y.reshape(*x.shape[:-1], weight.shape[0])


def spots(blocks: Iterable, grid: int,
          k: int) -> Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]:
    """Row blocks of logits (``decoder.pair_blocks``) of a ``grid``² pair
    grid → per head (flat index i·grid + j, tag, score) of its top ``k``
    cells."""
    found: Dict[str, list] = {}
    for r, c, logits in blocks:
        upper = r[:, None] <= c[None, :]
        flat = (r[:, None] * grid + c[None, :])[upper]
        for name, lg in logits.items():
            score, tag = torch.softmax(lg.float(), -1)[upper].max(-1)
            keep = tag != 0
            found.setdefault(name, []).append(
                (flat[keep], tag[keep], score[keep]))
    out = {}
    for name, parts in found.items():
        flat, tag, score = (torch.cat(x) for x in zip(*parts))
        top = torch.topk(score, min(k, score.numel())).indices
        out[name] = (flat[top], tag[top], score[top])
    return out
