"""Configuration system of the PyTorch port.

The port's own copy of ``peneo_tpu/config.py``: plain dataclasses + JSON,
wire-compatible with the reference's HF-style ``config.json`` (reference:
model/configuration_peneo.py:6-37 and tools/generate_peneo_weights.py:63-74 —
nested ``backbone_config`` dict). Every field of the JAX package's config is
kept, so one ``config.json`` is read and written identically by both
packages; fields the port does not act on (the TPU kernel switches,
``spot_topk`` — the port's top-k is always exact) round-trip unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _filtered_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class LiltConfig:
    """LiLT backbone config (reference: model/backbone/lilt/configuration_lilt.py:6-47)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_embedding_type: str = "absolute"
    channel_shrink_ratio: int = 4
    max_2d_position_embeddings: int = 1024
    model_type: str = "lilt"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LiltConfig":
        return cls(**_filtered_kwargs(cls, d))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class LayoutLMv3Config:
    """LayoutLMv3 backbone config (reference: model/backbone/layoutlmv3/configuration_layoutlmv3.py)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    max_2d_position_embeddings: int = 1024
    coordinate_size: int = 128
    shape_size: int = 128
    has_relative_attention_bias: bool = True
    rel_pos_bins: int = 32
    max_rel_pos: int = 128
    has_spatial_attention_bias: bool = True
    rel_2d_pos_bins: int = 64
    max_rel_2d_pos: int = 256
    visual_embed: bool = True
    input_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    model_type: str = "layoutlmv3"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LayoutLMv3Config":
        return cls(**_filtered_kwargs(cls, d))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class LayoutLMv2Config:
    """LayoutLMv2/LayoutXLM backbone config (reference imports HF transformers
    ``LayoutLMv2Config``; reference: model/backbone_mapping.py:19-24)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    max_2d_position_embeddings: int = 1024
    coordinate_size: int = 128
    shape_size: int = 128
    has_relative_attention_bias: bool = True
    rel_pos_bins: int = 32
    max_rel_pos: int = 128
    has_spatial_attention_bias: bool = True
    rel_2d_pos_bins: int = 64
    max_rel_2d_pos: int = 256
    fast_qkv: bool = True
    image_feature_pool_shape: List[int] = field(default_factory=lambda: [7, 7, 256])
    # visual-tower geometry (detectron2 layoutlmv2 = ResNeXt-101 (3,4,23,3)
    # on 224px inputs; lighter settings for synthetic/CI runs)
    visual_depths: List[int] = field(default_factory=lambda: [3, 4, 23, 3])
    input_size: int = 224
    # detectron2 pixel normalization (BGR order, matching the BGR 0-255 input
    # from data/image_processing.layoutlmv2_preprocess)
    pixel_mean: List[float] = field(
        default_factory=lambda: [103.530, 116.280, 123.675])
    pixel_std: List[float] = field(
        default_factory=lambda: [57.375, 57.120, 58.395])
    model_type: str = "layoutlmv2"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LayoutLMv2Config":
        return cls(**_filtered_kwargs(cls, d))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


BACKBONE_CONFIG_CLASSES = {
    "lilt": LiltConfig,
    "layoutlmv3": LayoutLMv3Config,
    "layoutlmv2": LayoutLMv2Config,
}


@dataclass
class PEneoConfig:
    """Top-level model config (reference: model/configuration_peneo.py:6-37).

    ``backbone_config`` is stored as a plain dict (wire format identical to the
    reference's nested dict); use :meth:`backbone` for the typed view.
    """

    backbone_name: Optional[str] = None
    backbone_config: Optional[Dict[str, Any]] = None
    initializer_range: float = 0.02
    peneo_decoder_shrink: bool = True
    peneo_classifier_num_layers: int = 2
    peneo_loss_ratio: List[float] = field(default_factory=lambda: [1.0] * 5)
    peneo_category_weights: List[float] = field(default_factory=lambda: [1.0] * 3)
    peneo_ohem_num_positive: int = -1
    peneo_ohem_num_negative: int = -1
    peneo_downstream_speedup_ratio: float = 1.0
    inference_mode: bool = False
    # extensions absent from the reference, shared with peneo_tpu's config
    max_seq_len: int = 512          # static padded sequence length incl. CLS/SEP
    pair_block_size: int = 128      # row-block size for the blockwise pair head
    dtype: str = "bfloat16"         # compute dtype
    # switches of the JAX package's TPU kernels and options; the port reads
    # and writes them unchanged and does not act on them (its attention is
    # chosen by ``PEneoModel.set_attention_impl`` instead)
    use_flash_attention: bool = False
    use_fused_biacm: bool = False
    use_fused_biacm_train: bool = False
    use_fused_bias_attention: bool = False
    use_fused_bias_attention_train: bool = False
    gradient_checkpointing: bool = False
    # inference: ship only the top-k nonzero triu spots per head to host
    # (0 = dense (L, L) tag/score maps, used by tests/parity)
    max_spots_per_head: int = 512
    # "approx" | "exact"; the port's top-k (torch.topk) is always exact
    spot_topk: str = "approx"
    # streaming spot extraction: each pair-grid row block reduced to its
    # own top-k candidates as it is produced and merged once
    # (models/decoder.py StreamedSpots), the dense (B, L, L) tag/score
    # maps never written; off by default, as the JAX package's
    spot_streaming: bool = False
    # None | "int8": the pair head's hidden layers / the backbone's
    # projections and MLPs as s8×s8→s32 products outside training
    # (ops/quant.py)
    quantize_pair_head: Optional[str] = None
    quantize_backbone: Optional[str] = None
    model_type: str = "peneo"

    def __post_init__(self):
        if self.peneo_loss_ratio is not None:
            assert len(self.peneo_loss_ratio) == 5, "loss_ratio must have 5 elements"
        if self.peneo_category_weights is not None:
            assert len(self.peneo_category_weights) == 3, "category_weights must have 3 elements"
        assert self.spot_topk in ("exact", "approx"), self.spot_topk
        assert self.quantize_pair_head in (None, "int8"), \
            self.quantize_pair_head
        assert self.quantize_backbone in (None, "int8"), \
            self.quantize_backbone

    # --- typed backbone view -------------------------------------------------
    def backbone_family(self) -> str:
        name = (self.backbone_name or "").lower()
        if "lilt" in name:
            return "lilt"
        if "layoutlmv3" in name:
            return "layoutlmv3"
        if "layoutxlm" in name or "layoutlmv2" in name:
            return "layoutlmv2"
        bt = (self.backbone_config or {}).get("model_type", "")
        if bt in BACKBONE_CONFIG_CLASSES:
            return bt
        raise ValueError(f"cannot infer backbone family from {self.backbone_name!r}")

    def backbone(self):
        cls = BACKBONE_CONFIG_CLASSES[self.backbone_family()]
        return cls.from_dict(self.backbone_config or {})

    # --- (de)serialization ----------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PEneoConfig":
        return cls(**_filtered_kwargs(cls, d))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_pretrained(cls, path: str) -> "PEneoConfig":
        cfg_path = path if path.endswith(".json") else os.path.join(path, "config.json")
        with open(cfg_path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, ensure_ascii=False)

    # --- derived quantities ---------------------------------------------------
    def downstream_input_size(self) -> int:
        """Decoder input width (reference: model/modeling_peneo.py:93-100).

        LiLT returns concat(semantic, layout) = H + H//shrink (e.g. 768+192=960).
        """
        bc = self.backbone_config or {}
        h = bc.get("hidden_size", 768)
        if self.backbone_family() == "lilt":
            return h + h // bc.get("channel_shrink_ratio", 4)
        return h

    def decoder_hidden_size(self) -> int:
        bc = self.backbone_config or {}
        h = bc.get("hidden_size", 768)
        return h // 2 if self.peneo_decoder_shrink else self.downstream_input_size()
