"""Class-weighted cross-entropy of the pair heads (fp32).

Counterpart of ``peneo_tpu/ops/losses.py:28-76`` (reference:
model/custom_loss.py:189-202): per-element CE on logits upcast to fp32, the
torch "weighted mean" ``sum(w[t]·ce) / sum(w[t])`` over the positions a
mask selects, and its ``(num, den)`` parts so a caller can sum them over the
pair grid's row blocks. The JAX package picks the target log-probability and
the class weight with select chains (a TPU fusion choice); a gather and an
index give the same values exactly. This is the default configuration
(``peneo_ohem_num_positive/negative = -1``); OHEM, random-sample CE and
focal loss are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


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
