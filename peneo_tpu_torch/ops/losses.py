"""Classification losses of the pair heads (fp32).

Counterpart of ``peneo_tpu/ops/losses.py`` (reference:
model/custom_loss.py):

- class-weighted CE (:189-202): per-element CE on logits upcast to fp32, the
  torch "weighted mean" ``sum(w[t]·ce) / sum(w[t])`` over the positions a
  mask selects, and its ``(num, den)`` parts so a caller can sum them over
  the pair grid's row blocks (and over data-parallel ranks);
- OHEM (:234-288), dense and streaming: per-element *weighted* CE, positives
  (t != 0) and negatives (t == 0) kept apart, the k hardest of each kept,
  the mean over the total kept count. The reference re-indexes its sorted
  array with indices into the unsorted one (custom_loss.py:262-263,272-273)
  and keeps a scrambled subset; the JAX package implements the intended
  top-k, and so does this module: a group keeps ``min(k, #selected)``
  elements, a group with ``k <= 0`` keeps all of its elements. ``torch.topk``
  carries the gradient to the kept elements;
- random-sample CE (:9-101) and the sigmoid focal loss (:291-340), which the
  reference pipeline never calls (capability parity).

The JAX package picks the target log-probability and the class weight with
select chains (a TPU fusion choice); a gather and an index give the same
values exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _per_element_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Unweighted per-element cross-entropy, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)


def class_weight_lookup(class_weights: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """``class_weights[targets]`` in fp32."""
    return class_weights.float().to(targets.device)[targets.long()]


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           return_sum_and_weight: bool = False):
    """Class-weighted mean CE with torch semantics: the mean divides by the
    sum of the selected positions' class weights, not their count. ``mask``
    selects the positions (e.g. the upper triangle of the pair grid)."""
    ce = _per_element_ce(logits, targets)
    w = class_weight_lookup(class_weights, targets)
    if mask is not None:
        w = w * mask.float()
    num = (ce * w).sum()
    den = w.sum()
    if return_sum_and_weight:
        return num, den
    return num / den.clamp_min(1e-12)


def _weighted_ce(logits, targets, class_weights):
    return _per_element_ce(logits, targets) \
        * class_weight_lookup(class_weights, targets)


def _groups(targets: torch.Tensor, mask: Optional[torch.Tensor]):
    """(positives, negatives) masks: targets != 0 / == 0 among ``mask``."""
    valid = (torch.ones_like(targets, dtype=torch.bool) if mask is None
             else mask.bool())
    return (targets != 0) & valid, (targets == 0) & valid


def _top_k_sum(values: torch.Tensor, mask: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the k largest masked values and the kept count
    ``min(k, #selected)`` (reference custom_loss.py:258,268)."""
    flat = torch.where(mask, values, float("-inf")).reshape(-1)
    top = torch.topk(flat, min(k, flat.numel())).values
    kept = torch.clamp(mask.sum(), max=top.numel())
    return torch.where(torch.isfinite(top), top, 0.0).sum(), kept


def ohem_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                       class_weights: torch.Tensor,
                       mask: Optional[torch.Tensor],
                       num_hard_positive: int,
                       num_hard_negative: int) -> torch.Tensor:
    """Online hard example mining CE: the weighted CE of the
    ``num_hard_positive`` hardest positives and ``num_hard_negative``
    hardest negatives, averaged over the kept count. A group whose k is
    ``<= 0`` keeps all of its elements."""
    ce_w = _weighted_ce(logits, targets, class_weights)
    sums, counts = [], []
    for gmask, k in zip(_groups(targets, mask),
                        (num_hard_positive, num_hard_negative)):
        if k is None or k <= 0:
            s, n = torch.where(gmask, ce_w, 0.0).sum(), gmask.sum()
        else:
            s, n = _top_k_sum(ce_w, gmask, k)
        sums.append(s)
        counts.append(n)
    return (sums[0] + sums[1]) / torch.clamp_min(counts[0] + counts[1],
                                                 1).float()


# streaming OHEM --------------------------------------------------------------
# The state of one head is {"pos": group, "neg": group}; a group is
# {"sum", "count"} when it keeps all of its elements and {"best", "count"}
# (the k hardest values so far, sorted, -inf where fewer were seen) when it
# keeps k. ``count`` is the number of the group's elements seen.

def ohem_stream_init(num_hard_positive: int, num_hard_negative: int,
                     device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Streaming OHEM accumulator (one per head): the decoder folds each row
    block of the pair grid in with :func:`ohem_stream_update` and never holds
    the full (B, L, L, C) logits; the state is O(k). Equals
    :func:`ohem_cross_entropy` on the concatenated logits."""
    def group(k):
        count = torch.zeros((), dtype=torch.int64, device=device)
        if k is None or k <= 0:  # keep-all group: a plain sum
            return {"sum": torch.zeros((), device=device), "count": count}
        return {"best": torch.full((k,), float("-inf"), device=device),
                "count": count}

    return {"pos": group(num_hard_positive), "neg": group(num_hard_negative)}


def ohem_stream_update(state, logits, targets, class_weights, mask):
    """Fold one block's weighted CE into the running state: the block's
    values are concatenated with ``best`` and the top k taken again, so the
    gradient reaches each block's CE through the kept elements."""
    ce_w = _weighted_ce(logits, targets, class_weights)
    new = {}
    for key, gmask in zip(("pos", "neg"), _groups(targets, mask)):
        g = state[key]
        count = g["count"] + gmask.sum()
        if "sum" in g:
            new[key] = {"sum": g["sum"] + torch.where(gmask, ce_w, 0.0).sum(),
                        "count": count}
            continue
        vals = torch.where(gmask, ce_w, float("-inf")).reshape(-1)
        merged = torch.cat([g["best"], vals])
        new[key] = {"best": torch.topk(merged, g["best"].numel()).values,
                    "count": count}
    return new


def ohem_stream_final(state) -> torch.Tensor:
    """Running state → OHEM loss: the kept values' sum over
    ``max(kept, 1)``, kept = ``min(count, k)`` for a top-k group."""
    total, kept = 0.0, 0
    for key in ("pos", "neg"):
        g = state[key]
        if "sum" in g:
            total, kept = total + g["sum"], kept + g["count"]
            continue
        best = g["best"]
        total = total + torch.where(torch.isfinite(best), best, 0.0).sum()
        kept = kept + torch.clamp(g["count"], max=best.numel())
    return total / torch.clamp_min(torch.as_tensor(kept), 1).float()


# the two losses the reference pipeline never calls --------------------------

def random_sample_mean(ce: torch.Tensor, targets: torch.Tensor,
                       noise: torch.Tensor, num_background: int,
                       num_foreground: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of ``ce`` over at most ``num_background`` background
    (t == 0) and ``num_foreground`` foreground (t != 0) elements, each group
    sampled by its ``noise`` values (uniform [0, 1), the shape of ``ce``):
    the elements of the largest noise are kept."""
    fg, bg = _groups(targets, mask)
    total, kept = 0.0, 0
    for gmask, k in ((bg, num_background), (fg, num_foreground)):
        k = min(k, ce.numel())
        sel = torch.where(gmask, noise, -1.0).reshape(-1)
        idx = torch.topk(sel, k).indices
        chosen = ce.reshape(-1)[idx]
        ok = gmask.reshape(-1)[idx]
        total = total + torch.where(ok, chosen, 0.0).sum()
        kept = kept + torch.clamp(gmask.sum(), max=k)
    return total / torch.clamp_min(kept, 1).float()


def random_sample_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                generator: Optional[torch.Generator],
                                num_background: int, num_foreground: int,
                                class_weights: Optional[torch.Tensor] = None,
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """CE averaged over a random subsample of the background and foreground
    elements (reference: CrossEntropyLossRandomSample): the noise is drawn
    from ``generator`` (on the logits' device), then
    :func:`random_sample_mean`. The JAX package draws from its own key, so
    the two packages sample different elements, as their dropout does."""
    ce = _per_element_ce(logits, targets)
    if class_weights is not None:
        ce = ce * class_weight_lookup(class_weights, targets)
    noise = torch.rand(ce.shape, generator=generator, device=ce.device)
    return random_sample_mean(ce, targets, noise, num_background,
                              num_foreground, mask)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "none") -> torch.Tensor:
    """RetinaNet focal loss (reference: model/custom_loss.py:291-340)."""
    p = torch.sigmoid(logits.float())
    t = targets.float()
    ce = -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def peneo_head_loss(logits: torch.Tensor, targets: torch.Tensor,
                    class_weights: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    num_hard_positive: int = -1,
                    num_hard_negative: int = -1) -> torch.Tensor:
    """Plain weighted CE, or OHEM unless both k are -1
    (CrossEntropyLossOHEM.forward, reference custom_loss.py:189-210)."""
    if num_hard_positive == -1 and num_hard_negative == -1:
        return weighted_cross_entropy(logits, targets, class_weights, mask)
    return ohem_cross_entropy(logits, targets, class_weights, mask,
                              num_hard_positive, num_hard_negative)
