"""Weight bridge between the JAX package's PEneoModel param tree and the
port's ``state_dict`` (LiLT, LayoutLMv3 and LayoutLMv2/LayoutXLM).

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
- LayoutLMv2: ``qkv_linear`` has a kernel only, ``q_bias`` / ``v_bias``
  are (1, 1, H) as they are; a detectron2 conv with its frozen norm
  (``<conv>.weight``, ``<conv>.norm.{weight,bias,running_mean,
  running_var}``) ↔ the flax ``conv`` of a ``ConvNoBN``: toward JAX the
  norm is folded into kernel and bias in float64
  (:func:`fold_conv_frozen_bn`, the JAX converter's arithmetic), toward the
  port the norm is written as the identity (weight 1, mean 0, var
  ``1 − 1e-5``: ``s`` is exactly 1 in fp32) with the flax bias as its
  ``bias``. The FPN's lateral and output convs are biased convs; a
  reference state dict may give them a frozen norm instead, which is folded
  the same way.

Both functions work on numpy arrays (``jax_params_to_state_dict`` returns
torch tensors); neither imports JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import PEneoConfig
from .decoder import HEAD_NAMES

# (torch key prefix, flax path, kind); kind ∈ linear | kernel (a Linear
# without bias) | ln | emb | conv | frozen_conv (a conv and its frozen
# norm) | table (full key ↔ transposed leaf) | raw (full key ↔ leaf)
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


def _embedding_entries() -> List[Entry]:
    """The word / position / token-type / spatial tables and their LayerNorm
    of the rel-bias families."""
    e: List[Entry] = [(f"embeddings.{n}", ("embeddings", n), "emb") for n in (
        "word_embeddings", "token_type_embeddings", "position_embeddings",
        "x_position_embeddings", "y_position_embeddings",
        "h_position_embeddings", "w_position_embeddings")]
    e.append(("embeddings.LayerNorm", ("embeddings", "LayerNorm"), "ln"))
    return e


def _rel_bias_encoder_entries(n_layers: int, bc, projections) -> List[Entry]:
    """The bucket tables and the layers of a rel-bias encoder (LayoutLMv3,
    LayoutLMv2); ``projections(src, dst)`` gives a layer's q/k/v entries."""
    e: List[Entry] = []
    if bc.has_relative_attention_bias:
        e.append(("encoder.rel_pos_bias.weight", ("rel_pos_bias",), "table"))
    if bc.has_spatial_attention_bias:
        for n in ("rel_pos_x_bias", "rel_pos_y_bias"):
            e.append((f"encoder.{n}.weight", (n,), "table"))
    for i in range(n_layers):
        src, dst = f"encoder.layer.{i}.", (f"layer_{i}",)
        e += projections(src + "attention.self.", dst)
        e.append((src + "attention.output.dense",
                  dst + ("attention_output_dense",), "linear"))
        e.append((src + "attention.output.LayerNorm",
                  dst + ("attention_output_LayerNorm",), "ln"))
        e.append((src + "intermediate.dense", dst + ("intermediate",),
                  "linear"))
        e.append((src + "output.dense", dst + ("output_dense",), "linear"))
        e.append((src + "output.LayerNorm", dst + ("output_LayerNorm",), "ln"))
    return e


def _qkv_entries(src, dst) -> List[Entry]:
    return [(src + n, dst + (n,), "linear") for n in ("query", "key", "value")]


def _layoutlmv3_entries(n_layers: int, bc) -> List[Entry]:
    e = _embedding_entries()
    if bc.visual_embed:
        e.append(("patch_embed.proj", ("patch_proj",), "conv"))
        e.append(("cls_token", ("cls_token",), "raw"))
        e.append(("pos_embed", ("pos_embed",), "raw"))
        e.append(("norm", ("visual_norm",), "ln"))
        e.append(("LayerNorm", ("post_concat_LayerNorm",), "ln"))
    e += _rel_bias_encoder_entries(n_layers, bc, _qkv_entries)
    return [("backbone." + k, ("backbone",) + p, kind) for k, p, kind in e]


def _tower_entries(depths) -> List[Entry]:
    """detectron2's ResNeXt-FPN keys ↔ the flax ``ResNeXtFPN`` tree."""
    src, dst = "visual.backbone.", ("visual_backbone",)
    e: List[Entry] = [(src + "bottom_up.stem.conv1", dst + ("stem", "conv"),
                       "frozen_conv")]
    for stage, depth in enumerate(depths):
        for blk in range(depth):
            s = f"{src}bottom_up.res{stage + 2}.{blk}."
            d = dst + (f"res{stage + 2}_{blk}",)
            # a stage's first block changes the width (res2) or the stride
            convs = ("conv1", "conv2", "conv3") + (
                ("shortcut",) if blk == 0 else ())
            e += [(s + c, d + (c, "conv"), "frozen_conv") for c in convs]
    for i in range(len(depths)):
        e.append((src + f"fpn_lateral{i + 2}",
                   dst + (f"fpn_lateral{i + 2}", "conv"), "conv"))
    e.append((src + "fpn_output2", dst + ("fpn_output2", "conv"), "conv"))
    return e


def _layoutlmv2_entries(n_layers: int, bc) -> List[Entry]:
    e = _embedding_entries()
    e.append(("visual_proj", ("visual_proj",), "linear"))
    e.append(("visual_LayerNorm", ("visual_LayerNorm",), "ln"))

    def projections(src, dst):
        if not bc.fast_qkv:
            return _qkv_entries(src, dst)
        return [(src + "qkv_linear", dst + ("qkv_linear",), "kernel"),
                (src + "q_bias", dst + ("q_bias",), "raw"),
                (src + "v_bias", dst + ("v_bias",), "raw")]

    e += _rel_bias_encoder_entries(n_layers, bc, projections)
    e += _tower_entries(bc.visual_depths)
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
        backbone = _layoutlmv2_entries(bc.num_hidden_layers, bc)
    return backbone + _decoder_entries(cfg)


_COMBINE = "peneo_decoder.handshaking_kernel.combine_fc"
BN_EPS = 1e-5  # detectron2's FrozenBatchNorm2d


def fold_conv_frozen_bn(conv_w, bn_w, bn_b, bn_mean, bn_var,
                        eps: float = BN_EPS):
    """``y = FrozenBN(conv(x))`` as one biased conv: the flax (kh, kw, C,
    O) kernel and the bias, in float32, from float64 arithmetic (the JAX
    package's ``convert_layoutlmv2.fold_conv_frozen_bn``)."""
    conv_w = np.asarray(conv_w, dtype=np.float64)
    s = np.asarray(bn_w, np.float64) / np.sqrt(
        np.asarray(bn_var, np.float64) + eps)
    kernel = (conv_w * s[:, None, None, None]).transpose(2, 3, 1, 0)
    bias = np.asarray(bn_b, np.float64) - np.asarray(bn_mean, np.float64) * s
    return kernel.astype(np.float32), bias.astype(np.float32)


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
        elif kind in ("conv", "frozen_conv"):
            sd[key + ".weight"] = _get(params, path + ("kernel",)).transpose(
                3, 2, 0, 1)
            bias = _get(params, path + ("bias",))
            if kind == "conv":
                sd[key + ".bias"] = bias
                continue
            n = key + ".norm."
            sd[n + "weight"] = np.ones_like(bias)
            sd[n + "bias"] = bias
            sd[n + "running_mean"] = np.zeros_like(bias)
            sd[n + "running_var"] = np.full_like(bias, 1.0 - BN_EPS)
        else:
            sd[key + ".weight"] = _get(params, path + ("kernel",)).T
            if kind == "linear":
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
        elif kind == "frozen_conv" or (kind == "conv"
                                       and key + ".norm.weight" in sd):
            n = key + ".norm."
            kernel, bias = fold_conv_frozen_bn(
                arr(key + ".weight"), arr(n + "weight"), arr(n + "bias"),
                arr(n + "running_mean"), arr(n + "running_var"))
            _set(params, path + ("kernel",), kernel)
            _set(params, path + ("bias",), bias)
        elif kind == "conv":
            w = arr(key + ".weight")
            _set(params, path + ("kernel",), w.transpose(2, 3, 1, 0).copy())
            _set(params, path + ("bias",),
                 arr(key + ".bias") if key + ".bias" in sd
                 else np.zeros(w.shape[0], np.float32))
        else:
            _set(params, path + ("kernel",), arr(key + ".weight").T.copy())
            if kind == "linear":
                _set(params, path + ("bias",), arr(key + ".bias"))
    w = arr(_COMBINE + ".weight")
    h = w.shape[0]
    dec = ("peneo_decoder",)
    _set(params, dec + ("comb_a", "kernel"), w[:, :h].T.copy())
    _set(params, dec + ("comb_a", "bias"), arr(_COMBINE + ".bias"))
    _set(params, dec + ("comb_b", "kernel"), w[:, h:].T.copy())
    return params
