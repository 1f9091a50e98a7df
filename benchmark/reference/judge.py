"""How far a page's served spots lie from the plain reference's.

A head's spots are its top-k cells of the upper triangle whose argmax tag is
not 0, by score (the argmax class's softmax probability). Each served spot
claims a score for its cell and tag, and the cells left out are claimed to
score no higher than the lowest served score (every cell whose tag is not 0,
where slots are to spare). Given the reference's float32 logits of every
cell, the error of a claim is, in probability:

- a served spot: its score less the reference's probability of its tag at
  its cell (a wrong tag or a wrong cell reads the spread of the model's
  class probabilities; rounding reads rounding);
- a cell left out whose reference score lies above the lowest served score
  (with slots to spare: whose reference tag is not 0): by how much;
- a spot served outside the upper triangle of the grid: 1.

:func:`head_errors` returns the sum of the squared errors and the number of
claims they were read from: every served spot, and every cell left out that
passes the lowest served score; the check compares their pooled root mean
square over the sampled pages and heads. Cells left out count only where
they err: where a head's scores crowd together (a random model can give a
head whose top scores lie within rounding of one another over tens of
thousands of cells), rounding swaps many of them across the floor, each by
rounding's amount, and their sum alone would grow with the crowd.

Imports torch and numpy only.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch


def head_errors(cells: Iterable[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]],
                flat: torch.Tensor, tag: torch.Tensor, score: torch.Tensor,
                k: int, grid: int) -> Tuple[float, int]:
    """One head of one page → (sum of squared errors, claims read: served
    spots and cells left out that err).
    ``cells`` yields (row indices (r,), column indices (c,), logits (r, c,
    C)) blocks covering the upper triangle of the ``grid``² pair grid
    (cells below the diagonal are ignored); ``flat``, ``tag``, ``score`` the
    served spots (flat index i·grid + j, empty slots dropped); ``k`` the
    number of slots."""
    dev = flat.device
    flat = flat.long()
    i, j = flat // grid, flat % grid
    misplaced = int(((flat < 0) | (i > j) | (j >= grid)).sum())
    ok = (flat >= 0) & (i <= j) & (j < grid)
    flat, tag, score = flat[ok], tag[ok].long(), score[ok].float()
    n = grid * grid
    served_tag = torch.zeros(n, dtype=torch.long, device=dev)
    served_tag[flat] = tag
    served_score = torch.zeros(n, dtype=torch.float32, device=dev)
    served_score[flat] = score
    full = flat.numel() + misplaced >= k
    floor = score.min() if full and score.numel() else None
    total = torch.zeros((), dtype=torch.float64, device=dev)
    wrong_out = torch.zeros((), dtype=torch.long, device=dev)
    for r, c, logits in cells:
        upper = r[:, None] <= c[None, :]
        idx = (r[:, None] * grid + c[None, :])[upper]
        p = torch.softmax(logits.float(), -1)[upper]
        best_p, best = p.max(-1)
        t = served_tag[idx]
        mine = t != 0
        p_t = p.gather(1, t[:, None])[:, 0]
        total += ((served_score[idx] - p_t)[mine].double() ** 2).sum()
        left = (~mine) & (best != 0)
        over = (best_p - floor) if floor is not None else (best_p - p[:, 0])
        over = over[left]
        total += (over.clamp_min(0).double() ** 2).sum()
        wrong_out += (over > 0).sum()
    return (float(total) + misplaced,
            int(flat.numel()) + misplaced + int(wrong_out))


def logit_rms(cells: Iterable[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]) -> float:
    """The root mean square of the reference's logits over the upper
    triangle (every class): the scale that rounding in them goes with."""
    total, count = 0.0, 0
    for r, c, logits in cells:
        upper = r[:, None] <= c[None, :]
        lg = logits.float()[upper]
        total += float((lg.double() ** 2).sum())
        count += lg.numel()
    return (total / max(count, 1)) ** 0.5


def spots_of_page(head, row: int):
    """A head's fetched spot arrays (numpy, ``spot_idx``/``spot_tag``/
    ``spot_score`` (B, k), ``seq_len`` (B,)) → (flat, tag, score, grid, k)
    of batch row ``row``, empty slots (score < 0) dropped."""
    score = np.asarray(head["spot_score"][row], dtype=np.float32)
    keep = score >= 0
    return (np.asarray(head["spot_idx"][row])[keep].astype(np.int64),
            np.asarray(head["spot_tag"][row])[keep].astype(np.int64),
            score[keep], int(np.asarray(head["seq_len"][row])), len(score))
