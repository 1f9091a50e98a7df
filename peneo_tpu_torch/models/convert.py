"""Weight bridge between the JAX package's PEneoModel param tree and the
port's ``state_dict`` (LiLT and LayoutLMv3 families).

The port's parameter names are the reference's torch keys, the same ones
``peneo_tpu/models/convert.py:49-127`` reads, so a ``pytorch_model.bin``
written by the port loads unchanged in both packages. Layout rules (the
inverse of that converter):

- flax Dense ``kernel`` (in, out) ↔ torch Linear ``weight`` (out, in);
- flax Embed ``embedding`` ↔ Embedding ``weight``;
- flax LayerNorm ``{scale, bias}`` ↔ ``{weight, bias}``;
- flax ``comb_a`` (+ bias) and ``comb_b`` (no bias) ↔ the reference's one
  ``handshaking_kernel.combine_fc`` (H, 2H) acting on cat(h_i, h_j);
- LayoutLMv3: flax Conv ``kernel`` (kh, kw, C, H) ↔ Conv2d ``weight``
  (H, C, kh, kw); the bucket tables (bins, heads) ↔ bias-free Linear
  ``weight`` (heads, bins); ``cls_token`` / ``pos_embed`` as they are.

Both functions work on numpy arrays (``jax_params_to_state_dict`` returns
torch tensors); neither imports JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import PEneoConfig
from .decoder import HEAD_NAMES

# (torch key prefix, flax path, kind); kind ∈ linear | ln | emb | conv |
# table (full key ↔ transposed leaf) | raw (full key ↔ leaf)
Entry = Tuple[str, Tuple[str, ...], str]


def _lilt_entries(n_layers: int) -> List[Entry]:
    e: List[Entry] = []
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        e.append((f"embeddings.{n}", ("embeddings", n), "emb"))
    e.append(("embeddings.LayerNorm", ("embeddings", "LayerNorm"), "ln"))
    lay = "layout_embeddings"
    for c in ("x", "y", "h", "w"):
        e.append((f"{lay}.{c}_position_embeddings",
                  (lay, f"{c}_position_embeddings"), "emb"))
    e.append((f"{lay}.box_position_embeddings",
              (lay, "box_position_embeddings"), "emb"))
    e.append((f"{lay}.box_linear_embeddings", (lay, "box_linear_embeddings"),
              "linear"))
    e.append((f"{lay}.LayerNorm", (lay, "LayerNorm"), "ln"))
    for i in range(n_layers):
        src, dst = f"encoder.layer.{i}.", (f"layer_{i}",)
        for n in ("query", "key", "value", "layout_query", "layout_key",
                  "layout_value"):
            e.append((src + f"attention.self.{n}", dst + ("self_attn", n),
                      "linear"))
        for t, j in (("output", "attn_output"),
                     ("layout_output", "layout_attn_output")):
            e.append((src + f"attention.{t}.dense", dst + (j, "dense"), "linear"))
            e.append((src + f"attention.{t}.LayerNorm", dst + (j, "LayerNorm"),
                      "ln"))
        for pre, mlp in (("", "mlp"), ("layout_", "layout_mlp")):
            e.append((src + f"{pre}intermediate.dense",
                      dst + (mlp, "intermediate_dense"), "linear"))
            e.append((src + f"{pre}output.dense", dst + (mlp, "output", "dense"),
                      "linear"))
            e.append((src + f"{pre}output.LayerNorm",
                      dst + (mlp, "output", "LayerNorm"), "ln"))
    return [("backbone." + k, ("backbone",) + p, kind) for k, p, kind in e]


def _layoutlmv3_entries(n_layers: int, bc) -> List[Entry]:
    e: List[Entry] = []
    emb = "embeddings"
    for n in ("word_embeddings", "token_type_embeddings",
              "position_embeddings", "x_position_embeddings",
              "y_position_embeddings", "h_position_embeddings",
              "w_position_embeddings"):
        e.append((f"{emb}.{n}", (emb, n), "emb"))
    e.append((f"{emb}.LayerNorm", (emb, "LayerNorm"), "ln"))
    if bc.visual_embed:
        e.append(("patch_embed.proj", ("patch_proj",), "conv"))
        e.append(("cls_token", ("cls_token",), "raw"))
        e.append(("pos_embed", ("pos_embed",), "raw"))
        e.append(("norm", ("visual_norm",), "ln"))
        e.append(("LayerNorm", ("post_concat_LayerNorm",), "ln"))
    if bc.has_relative_attention_bias:
        e.append(("encoder.rel_pos_bias.weight", ("rel_pos_bias",), "table"))
    if bc.has_spatial_attention_bias:
        for n in ("rel_pos_x_bias", "rel_pos_y_bias"):
            e.append((f"encoder.{n}.weight", (n,), "table"))
    for i in range(n_layers):
        src, dst = f"encoder.layer.{i}.", (f"layer_{i}",)
        for n in ("query", "key", "value"):
            e.append((src + f"attention.self.{n}", dst + (n,), "linear"))
        e.append((src + "attention.output.dense",
                  dst + ("attention_output_dense",), "linear"))
        e.append((src + "attention.output.LayerNorm",
                  dst + ("attention_output_LayerNorm",), "ln"))
        e.append((src + "intermediate.dense", dst + ("intermediate",),
                  "linear"))
        e.append((src + "output.dense", dst + ("output_dense",), "linear"))
        e.append((src + "output.LayerNorm", dst + ("output_LayerNorm",), "ln"))
    return [("backbone." + k, ("backbone",) + p, kind) for k, p, kind in e]


def _decoder_entries(cfg: PEneoConfig) -> List[Entry]:
    p, d = "peneo_decoder.", ("peneo_decoder",)
    e: List[Entry] = []
    if cfg.peneo_decoder_shrink:
        e.append((p + "shrink_projection.0", d + ("shrink_0",), "linear"))
        e.append((p + "shrink_projection.3", d + ("shrink_1",), "linear"))
    n = cfg.peneo_classifier_num_layers
    for name in HEAD_NAMES:
        src, dst = p + f"{name}_fc", d + ("heads", f"{name}_fc")
        if n == 1:
            e.append((src, dst + ("fc_out",), "linear"))
            continue
        for i in range(n - 1):
            e.append((src + f".{3 * i}", dst + (f"fc_{i}",), "linear"))
        e.append((src + f".{3 * (n - 1)}", dst + ("fc_out",), "linear"))
    return e


def _entries(cfg: PEneoConfig) -> List[Entry]:
    fam, bc = cfg.backbone_family(), cfg.backbone()
    if fam == "lilt":
        backbone = _lilt_entries(bc.num_hidden_layers)
    elif fam == "layoutlmv3":
        backbone = _layoutlmv3_entries(bc.num_hidden_layers, bc)
    else:
        raise NotImplementedError(
            f"the weight bridge does not cover the {fam!r} family yet")
    return backbone + _decoder_entries(cfg)


_COMBINE = "peneo_decoder.handshaking_kernel.combine_fc"


def _get(tree: Dict, path) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _set(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = np.asarray(value)


def jax_params_to_state_dict(params: Dict, cfg: PEneoConfig) -> Dict[str, torch.Tensor]:
    """JAX PEneoModel param tree (numpy leaves) → the port's state_dict."""
    sd: Dict[str, np.ndarray] = {}
    for key, path, kind in _entries(cfg):
        if kind == "emb":
            sd[key + ".weight"] = _get(params, path + ("embedding",))
        elif kind == "ln":
            sd[key + ".weight"] = _get(params, path + ("scale",))
            sd[key + ".bias"] = _get(params, path + ("bias",))
        elif kind == "table":
            sd[key] = _get(params, path).T
        elif kind == "raw":
            sd[key] = _get(params, path)
        elif kind == "conv":
            sd[key + ".weight"] = _get(params, path + ("kernel",)).transpose(
                3, 2, 0, 1)
            sd[key + ".bias"] = _get(params, path + ("bias",))
        else:
            sd[key + ".weight"] = _get(params, path + ("kernel",)).T
            sd[key + ".bias"] = _get(params, path + ("bias",))
    dec = ("peneo_decoder",)
    sd[_COMBINE + ".weight"] = np.concatenate(
        [_get(params, dec + ("comb_a", "kernel")).T,
         _get(params, dec + ("comb_b", "kernel")).T], axis=1)
    sd[_COMBINE + ".bias"] = _get(params, dec + ("comb_a", "bias"))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def state_dict_to_jax_params(sd: Dict, cfg: PEneoConfig) -> Dict:
    """The port's state_dict (tensors or numpy) → JAX PEneoModel param tree
    of float32 numpy arrays."""
    def arr(k):
        v = sd[k]
        if isinstance(v, torch.Tensor):
            v = v.detach().to("cpu", torch.float32).numpy()
        return np.asarray(v, dtype=np.float32)

    params: Dict = {}
    for key, path, kind in _entries(cfg):
        if kind == "emb":
            _set(params, path + ("embedding",), arr(key + ".weight"))
        elif kind == "ln":
            _set(params, path + ("scale",), arr(key + ".weight"))
            _set(params, path + ("bias",), arr(key + ".bias"))
        elif kind == "table":
            _set(params, path, arr(key).T.copy())
        elif kind == "raw":
            _set(params, path, arr(key))
        elif kind == "conv":
            _set(params, path + ("kernel",),
                 arr(key + ".weight").transpose(2, 3, 1, 0).copy())
            _set(params, path + ("bias",), arr(key + ".bias"))
        else:
            _set(params, path + ("kernel",), arr(key + ".weight").T.copy())
            _set(params, path + ("bias",), arr(key + ".bias"))
    w = arr(_COMBINE + ".weight")
    h = w.shape[0]
    dec = ("peneo_decoder",)
    _set(params, dec + ("comb_a", "kernel"), w[:, :h].T.copy())
    _set(params, dec + ("comb_a", "bias"), arr(_COMBINE + ".bias"))
    _set(params, dec + ("comb_b", "kernel"), w[:, h:].T.copy())
    return params
