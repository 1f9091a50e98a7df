"""Build a PEneo model directory from a local pretrained backbone checkpoint.

Counterpart of ``tools/generate_peneo_weights.py:20-110`` (reference:
tools/generate_peneo_weights.py:13-147), the documented first step before
fine-tuning:

    python -m peneo_tpu_torch.generate_peneo_weights \
        --backbone_name_or_path /local/lilt-infoxlm-base \
        --output_dir /path/to/peneo-lilt-infoxlm-base

The backbone is matched by substring against the registry (order-sensitive);
``config.json`` is a PEneo config with the shipped defaults (category
weights [1, 10, 10], downstream speedup 30×) around the backbone's own
config; the backbone's ``model.safetensors`` or ``pytorch_model.bin`` (its
base prefix, e.g. ``lilt.``, stripped) is written as
``backbone_params.msgpack`` = ``{"backbone": <the JAX package's param
tree>}``, so the directory starts fine-tuning in both packages (the decoder
keeps its seeded init); the tokenizer files are copied, and
``preprocessor_config.json`` written. LiLT and LayoutLMv3 only: LayoutLMv2
raises ``NotImplementedError``, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "sentencepiece.bpe.model",
    "vocab.json", "vocab.txt", "merges.txt", "special_tokens_map.json",
    "added_tokens.json", "toy_tokenizer.json",
)
BASE_PREFIXES = {"lilt": "lilt.", "layoutlmv3": "layoutlmv3.",
                 "layoutlmv2": "layoutlmv2."}


def load_backbone_state_dict(path: str):
    """A backbone directory's ``model.safetensors`` (numpy arrays) or
    ``pytorch_model.bin`` (tensors)."""
    from .pipeline.weights_io import read_safetensors

    for name in ("model.safetensors", "pytorch_model.bin"):
        fp = os.path.join(path, name)
        if not os.path.exists(fp):
            continue
        if name.endswith(".safetensors"):
            return read_safetensors(fp)
        import torch

        return torch.load(fp, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights under {path}")


def strip_base_prefix(sd, family: str):
    """Remove the backbone's own base prefix (e.g. 'lilt.') if present
    (reference: tools/generate_peneo_weights.py:84-88)."""
    pref = BASE_PREFIXES.get(family)
    if pref and any(k.startswith(pref) for k in sd):
        return {k[len(pref):] if k.startswith(pref) else k: v
                for k, v in sd.items()}
    return sd


def generate_peneo_weights(backbone_name_or_path: str, output_dir: str,
                           backbone_name: str = None) -> str:
    from .config import PEneoConfig
    from .models.convert import state_dict_to_jax_params
    from .pipeline.weights_io import write_flax_msgpack
    from .registry import BACKBONE_REGISTRY

    base = os.path.basename(backbone_name_or_path.rstrip("/"))
    name = backbone_name
    if name is None:
        for key in BACKBONE_REGISTRY:  # order-sensitive substring match
            if key in base or key in backbone_name_or_path:
                name = key
                break
    if name is None:
        raise KeyError(f"cannot match backbone for {backbone_name_or_path}")
    info = BACKBONE_REGISTRY[name]

    with open(os.path.join(backbone_name_or_path, "config.json")) as f:
        backbone_config = json.load(f)
    cfg = PEneoConfig(
        backbone_name=name,
        backbone_config=backbone_config,
        peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0,
    )
    if info.family not in ("lilt", "layoutlmv3"):
        raise NotImplementedError(info.family)
    os.makedirs(output_dir, exist_ok=True)
    cfg.save_pretrained(output_dir)

    sd = strip_base_prefix(load_backbone_state_dict(backbone_name_or_path),
                           info.family)
    tree = state_dict_to_jax_params(
        {"backbone." + k: v for k, v in sd.items()}, cfg, backbone_only=True)
    write_flax_msgpack(tree, os.path.join(output_dir,
                                          "backbone_params.msgpack"))

    for fname in TOKENIZER_FILES:
        src = os.path.join(backbone_name_or_path, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, fname))
    with open(os.path.join(output_dir, "preprocessor_config.json"), "w") as f:
        json.dump({"apply_ocr": False, "size": info.image_size}, f, indent=2)
    print(f"[peneo] wrote PEneo weights for {name} to {output_dir}")
    return output_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone_name_or_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--backbone_name", default=None)
    a = p.parse_args(argv)
    return generate_peneo_weights(a.backbone_name_or_path, a.output_dir,
                                  a.backbone_name)


if __name__ == "__main__":
    main()
