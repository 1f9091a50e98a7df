"""Backbone registry (the port's copy of ``peneo_tpu/registry.py``): one
place that tells every layer how to treat a backbone (reference:
model/backbone_mapping.py:260-349 BACKBONE_MAPPING).

Tokenizer/image-processor classes are referenced lazily by name so the
registry imports without transformers and works offline with local tokenizer
files.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .data.fetchers import fetch_layoutlmv3, fetch_roberta, fetch_wordpiece, fetch_xlm


@dataclass(frozen=True)
class BackboneInfo:
    family: str                     # "lilt" | "layoutlmv3" | "layoutlmv2"
    hf_name: str                    # upstream hub id (for weight generation)
    tokenizer_class: str            # transformers class name (lazy)
    max_token_len: int              # text-token budget before CLS/SEP
    add_cls_token: bool
    add_sep_token: bool
    has_visual_embeds: bool
    tokenizer_fetcher: Optional[Callable]
    image_size: int = 224


# ! Key order matters for weight generation's substring matching
# (reference: tools/generate_peneo_weights.py:26-55, backbone_mapping.py:274).
BACKBONE_REGISTRY = {
    "lilt-infoxlm-base": BackboneInfo(
        family="lilt",
        hf_name="SCUT-DLVCLab/lilt-infoxlm-base",
        tokenizer_class="LayoutXLMTokenizerFast",
        max_token_len=511,
        add_cls_token=True,
        add_sep_token=False,
        has_visual_embeds=False,
        tokenizer_fetcher=fetch_xlm,
    ),
    "lilt-roberta-en-base": BackboneInfo(
        family="lilt",
        hf_name="SCUT-DLVCLab/lilt-roberta-en-base",
        tokenizer_class="RobertaTokenizerFast",
        max_token_len=511,
        add_cls_token=True,
        add_sep_token=False,
        has_visual_embeds=False,
        tokenizer_fetcher=fetch_roberta,
    ),
    "layoutxlm-base": BackboneInfo(
        family="layoutlmv2",
        hf_name="microsoft/layoutxlm-base",
        tokenizer_class="LayoutXLMTokenizerFast",
        max_token_len=511,
        add_cls_token=True,
        add_sep_token=False,
        has_visual_embeds=True,
        tokenizer_fetcher=fetch_xlm,
    ),
    "layoutlmv2-base-uncased": BackboneInfo(
        family="layoutlmv2",
        hf_name="microsoft/layoutlmv2-base-uncased",
        tokenizer_class="LayoutLMv2TokenizerFast",
        max_token_len=511,
        add_cls_token=True,
        add_sep_token=False,
        has_visual_embeds=True,
        tokenizer_fetcher=fetch_wordpiece,
    ),
    "layoutlmv3-base-chinese": BackboneInfo(
        family="layoutlmv3",
        hf_name="microsoft/layoutlmv3-base-chinese",
        tokenizer_class="XLMRobertaTokenizerFast",
        max_token_len=510,
        add_cls_token=True,
        add_sep_token=True,
        has_visual_embeds=True,
        tokenizer_fetcher=fetch_xlm,
    ),
    "layoutlmv3-base": BackboneInfo(
        family="layoutlmv3",
        hf_name="microsoft/layoutlmv3-base",
        tokenizer_class="RobertaTokenizerFast",
        max_token_len=510,
        add_cls_token=True,
        add_sep_token=True,
        has_visual_embeds=True,
        tokenizer_fetcher=fetch_layoutlmv3,
    ),
}


def get_backbone_info(name: str) -> BackboneInfo:
    if name in BACKBONE_REGISTRY:
        return BACKBONE_REGISTRY[name]
    # substring match, same as weight generation (generate_peneo_weights.py:26-32)
    for key, info in BACKBONE_REGISTRY.items():
        if key in name:
            return info
    raise KeyError(f"unknown backbone {name!r}; known: {list(BACKBONE_REGISTRY)}")


def load_tokenizer(info: BackboneInfo, name_or_path: str):
    """Load the tokenizer for a backbone from a local path or the hub.
    A dir containing ``toy_tokenizer.json`` (synthetic-data training output)
    loads the self-describing ToyTokenizer instead of an HF class, without
    importing ``transformers``."""
    import os

    if os.path.isdir(name_or_path) and os.path.exists(
            os.path.join(name_or_path, "toy_tokenizer.json")):
        from .data.synthetic import ToyTokenizer

        return ToyTokenizer.from_pretrained(name_or_path)
    import transformers

    cls = getattr(transformers, info.tokenizer_class)
    return cls.from_pretrained(name_or_path)
