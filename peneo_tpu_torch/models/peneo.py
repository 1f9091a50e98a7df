"""PEneoModel: LiLT backbone + PEneo decoder (inference).

Counterpart of ``peneo_tpu/models/peneo.py:28-131`` for the LiLT family
(reference: model/modeling_peneo.py:41-175). The wrapper runs the backbone,
strips the CLS position per the family flags (modeling_peneo.py:138-163)
and runs the decoder. Inputs are padded to a static L; the decoder works on
Ld = L - 1 positions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PEneoConfig
from .decoder import PEneoDecoder
from .lilt import LiltModel, init_module_weights

# per-family structural flags (reference: model/backbone_mapping.py:276-349)
FAMILY_FLAGS = {
    "lilt": dict(add_cls_token=True, has_visual_embeds=False),
}


class PEneoModel(nn.Module):
    def __init__(self, cfg: PEneoConfig):
        super().__init__()
        fam = cfg.backbone_family()
        if fam not in FAMILY_FLAGS:
            raise NotImplementedError(
                f"backbone family {fam!r} is not ported yet (LiLT only)")
        self.cfg = cfg
        self.flags = FAMILY_FLAGS[fam]
        self.backbone = LiltModel(cfg.backbone())
        self.peneo_decoder = PEneoDecoder(cfg)

    def set_attention_impl(self, attention_impl: str) -> None:
        self.backbone.set_attention_impl(attention_impl)

    def cast(self, dtype: torch.dtype) -> "PEneoModel":
        """Cast to the compute dtype (text embeddings stay fp32)."""
        self.to(dtype)
        self.backbone.cast(dtype)
        return self

    def init_weights(self, generator: torch.Generator) -> "PEneoModel":
        """Random init from ``generator`` (normal(initializer_range))."""
        self.backbone.init_weights(generator, self.backbone.cfg.initializer_range)
        init_module_weights(self.peneo_decoder, generator,
                            self.cfg.initializer_range)
        return self

    def forward(self, input_ids, bbox, attention_mask: Optional[torch.Tensor] = None,
                return_logits: bool = False):
        out = self.backbone(input_ids, bbox, attention_mask)
        hidden = out["last_hidden_state"]
        if self.flags["add_cls_token"]:
            hidden = hidden[:, 1:]
        return self.peneo_decoder(hidden, return_logits=return_logits)
