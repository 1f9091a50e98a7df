"""PEneoModel: a switchable backbone (LiLT, LayoutLMv3 or LayoutLMv2 /
LayoutXLM) and the PEneo decoder.

Counterpart of ``peneo_tpu/models/peneo.py:28-131`` (reference:
model/modeling_peneo.py:41-175). The wrapper runs the backbone, strips the
visual tokens and the CLS position per the family flags
(modeling_peneo.py:138-163), applies hidden dropout (training mode) and runs
the decoder. Inputs are padded to a static L; the decoder works on
Ld = L - 1 positions, and labels are (B, Ld, Ld) dense matrices or (B, S, 3)
spot arrays. A visual backbone's image tokens come after the text tokens
and are dropped before the decoder. The int8 switches of the config
(``quantize_pair_head``, ``quantize_backbone``) run the pair head's hidden
layers and the backbone's projections and MLPs as s8×s8→s32 products
(``ops/quant.py``) on forwards outside training, as the JAX package does on
deterministic ones; training is unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import PEneoConfig
from ..ops.quant import keep_int8_weights_fp32, set_int8
from .decoder import PEneoDecoder
from .lilt import LiltModel, init_module_weights

# per-family structural flags (reference: model/backbone_mapping.py:276-349)
FAMILY_FLAGS = {
    "lilt": dict(add_cls_token=True, has_visual_embeds=False),
    "layoutlmv3": dict(add_cls_token=True, has_visual_embeds=True),
    "layoutlmv2": dict(add_cls_token=True, has_visual_embeds=True),
}


def build_backbone(cfg: PEneoConfig) -> nn.Module:
    fam = cfg.backbone_family()
    if fam == "lilt":
        return LiltModel(cfg.backbone())
    if fam == "layoutlmv3":
        from .layoutlmv3 import LayoutLMv3Model

        return LayoutLMv3Model(cfg.backbone())
    if fam == "layoutlmv2":
        from .layoutlmv2 import LayoutLMv2Model

        return LayoutLMv2Model(cfg.backbone())
    raise NotImplementedError(f"backbone family {fam!r} is not ported")


class PEneoModel(nn.Module):
    def __init__(self, cfg: PEneoConfig):
        super().__init__()
        self.backbone = build_backbone(cfg)
        # the text encoder's projections and MLPs (v2's tower stays float)
        set_int8(self.backbone, cfg.quantize_backbone == "int8")
        self.cfg = cfg
        self.flags = FAMILY_FLAGS[cfg.backbone_family()]
        self.backbone.gradient_checkpointing = cfg.gradient_checkpointing
        self.peneo_decoder = PEneoDecoder(cfg)

    def set_attention_impl(self, attention_impl: str) -> None:
        self.backbone.set_attention_impl(attention_impl)

    def set_data_parallel(self, enabled: bool) -> None:
        """Reduce the losses over the default process group's ranks (each
        holding its slice of one global batch), as the JAX package reduces
        them over its dp mesh axis (``parallel/dist.py``)."""
        self.peneo_decoder.data_parallel = enabled

    def cast(self, dtype: torch.dtype) -> "PEneoModel":
        """Cast to the compute dtype (the backbone keeps its embeddings, the
        rel-bias families their bucket tables, the int8 layers their weights,
        in fp32)."""
        self.to(dtype)
        self.backbone.cast(dtype)
        keep_int8_weights_fp32(self)
        return self

    def init_weights(self, generator: torch.Generator) -> "PEneoModel":
        """Random init from ``generator`` (normal(initializer_range))."""
        self.backbone.init_weights(generator, self.backbone.cfg.initializer_range)
        init_module_weights(self.peneo_decoder, generator,
                            self.cfg.initializer_range)
        return self

    def forward(self, input_ids, bbox, attention_mask: Optional[torch.Tensor] = None,
                return_logits: bool = False,
                labels: Optional[Dict[str, torch.Tensor]] = None,
                also_decode: bool = False,
                label_row_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                image: Optional[torch.Tensor] = None):
        """Inference outputs, or with ``labels`` the losses (and with
        ``also_decode`` the pair ``(losses, outputs)``). ``generator`` draws
        the attention-dropout seeds in training mode; ``image`` (B, 3, S, S)
        goes to a visual backbone."""
        visual = {"image": image} if self.flags["has_visual_embeds"] else {}
        out = self.backbone(input_ids, bbox, attention_mask,
                            generator=generator, **visual)
        # the text positions after CLS; visual tokens follow them
        first = int(self.flags["add_cls_token"])
        hidden = out["last_hidden_state"][:, first:input_ids.shape[1]]
        drop = (self.cfg.backbone_config or {}).get("hidden_dropout_prob", 0.1)
        hidden = F.dropout(hidden, drop, self.training)
        return self.peneo_decoder(hidden, return_logits=return_logits,
                                  labels=labels, also_decode=also_decode,
                                  label_row_mask=label_row_mask)
