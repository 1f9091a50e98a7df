"""Plain float32 LiLT (Wang et al., ACL 2022, "LiLT: A Simple yet Effective
Language-Independent Layout Transformer"), as the benchmark's yardstick.

Written from the published architecture: a text stream and a layout stream,
each a transformer encoder; the two streams share one score matrix per head
(BiACM: ``q_t·k_t/√d + q_l·k_l/√(d/r)``, one softmax), and each applies it to
its own values. The parameter names are those of the public checkpoints
(``backbone.*`` below), so one weight dict serves this module and the
program under test. Everything runs in float32 with TF32 off; no kernel, no
cache, no batching trick. Dropout is absent: this is the serving forward.

Imports torch only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

PREFIX = "backbone."


def layout_width(cfg: Dict) -> int:
    return cfg["hidden_size"] // cfg["channel_shrink_ratio"]


def output_width(cfg: Dict) -> int:
    """Width of the concatenated text + layout output."""
    return cfg["hidden_size"] + layout_width(cfg)


def param_table(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter; init is ``normal`` (matrices
    and tables), ``zeros`` (biases) or ``ones`` (LayerNorm gains)."""
    h, lh = cfg["hidden_size"], layout_width(cfg)
    inter, r = cfg["intermediate_size"], cfg["channel_shrink_ratio"]
    sixth, n2d = h // 6, cfg["max_2d_position_embeddings"]
    npos = cfg["max_position_embeddings"]
    out = []

    def linear(name, d_in, d_out):
        out.append((f"{name}.weight", (d_out, d_in), "normal"))
        out.append((f"{name}.bias", (d_out,), "zeros"))

    def norm(name, d):
        out.append((f"{name}.weight", (d,), "ones"))
        out.append((f"{name}.bias", (d,), "zeros"))

    e = PREFIX + "embeddings."
    out.append((e + "word_embeddings.weight", (cfg["vocab_size"], h),
                "normal"))
    out.append((e + "position_embeddings.weight", (npos, h), "normal"))
    out.append((e + "token_type_embeddings.weight",
                (cfg["type_vocab_size"], h), "normal"))
    norm(e + "LayerNorm", h)
    le = PREFIX + "layout_embeddings."
    for axis in "xyhw":
        out.append((f"{le}{axis}_position_embeddings.weight", (n2d, sixth),
                    "normal"))
    linear(le + "box_linear_embeddings", 6 * sixth, lh)
    out.append((le + "box_position_embeddings.weight", (npos, lh), "normal"))
    norm(le + "LayerNorm", lh)
    for i in range(cfg["num_hidden_layers"]):
        p = f"{PREFIX}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            linear(f"{p}attention.self.{name}", h, h)
        for name in ("layout_query", "layout_key", "layout_value"):
            linear(f"{p}attention.self.{name}", lh, lh)
        linear(p + "attention.output.dense", h, h)
        norm(p + "attention.output.LayerNorm", h)
        linear(p + "attention.layout_output.dense", lh, lh)
        norm(p + "attention.layout_output.LayerNorm", lh)
        linear(p + "intermediate.dense", h, inter)
        linear(p + "output.dense", inter, h)
        norm(p + "output.LayerNorm", h)
        linear(p + "layout_intermediate.dense", lh, inter // r)
        linear(p + "layout_output.dense", inter // r, lh)
        norm(p + "layout_output.LayerNorm", lh)
    return out


def zero_rows(cfg: Dict) -> List[Tuple[str, int]]:
    """Table rows that the published init zeroes: the padding index of the
    tables indexed by token or position."""
    pad = cfg["pad_token_id"]
    return [(PREFIX + "embeddings.word_embeddings.weight", pad),
            (PREFIX + "embeddings.position_embeddings.weight", pad),
            (PREFIX + "layout_embeddings.box_position_embeddings.weight", pad)]


def _lin(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def _norm(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], eps)


def _act(cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["hidden_act"] != "gelu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not written")
    return F.gelu(x)


def forward(cfg: Dict, w: Dict[str, torch.Tensor], input_ids: torch.Tensor,
            bbox: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) ids, (B, L, 4) boxes on the 0-1000 grid, (B, L) mask →
    (B, L, H + H/r) float32: the text stream and the layout stream side by
    side."""
    eps = cfg["layer_norm_eps"]
    pad = cfg["pad_token_id"]
    ids, box = input_ids.long(), bbox.long()
    # RoBERTa's positions: running count of non-pad tokens, after the pad id
    real = (ids != pad).long()
    pos = torch.cumsum(real, 1) * real + pad
    e = PREFIX + "embeddings."
    text = (w[e + "word_embeddings.weight"][ids]
            + w[e + "token_type_embeddings.weight"][0]
            + w[e + "position_embeddings.weight"][pos])
    text = _norm(w, e + "LayerNorm", text, eps)
    le = PREFIX + "layout_embeddings."

    def table(axis, idx):
        return w[f"{le}{axis}_position_embeddings.weight"][idx]

    spatial = torch.cat([table("x", box[..., 0]), table("y", box[..., 1]),
                         table("x", box[..., 2]), table("y", box[..., 3]),
                         table("h", box[..., 3] - box[..., 1]),
                         table("w", box[..., 2] - box[..., 0])], -1)
    layout = (_lin(w, le + "box_linear_embeddings", spatial)
              + w[le + "box_position_embeddings.weight"][pos])
    layout = _norm(w, le + "LayerNorm", layout, eps)

    B, L = ids.shape
    nh = cfg["num_attention_heads"]
    d_t = cfg["hidden_size"] // nh
    d_l = d_t // cfg["channel_shrink_ratio"]
    key_bias = (1.0 - attention_mask.float())[:, None, None, :] \
        * torch.finfo(torch.float32).min
    for i in range(cfg["num_hidden_layers"]):
        p = f"{PREFIX}encoder.layer.{i}."
        a = p + "attention.self."

        def heads(name, x, d):
            return _lin(w, a + name, x).view(B, L, nh, d).transpose(1, 2)

        q_t, k_t, v_t = (heads(n, text, d_t)
                         for n in ("query", "key", "value"))
        q_l, k_l, v_l = (heads(n, layout, d_l) for n in
                         ("layout_query", "layout_key", "layout_value"))
        scores = (q_t @ k_t.transpose(-1, -2) / math.sqrt(d_t)
                  + q_l @ k_l.transpose(-1, -2) / math.sqrt(d_l))
        probs = torch.softmax(scores + key_bias, -1)
        ctx_t = (probs @ v_t).transpose(1, 2).reshape(B, L, nh * d_t)
        ctx_l = (probs @ v_l).transpose(1, 2).reshape(B, L, nh * d_l)
        text = _norm(w, p + "attention.output.LayerNorm",
                     _lin(w, p + "attention.output.dense", ctx_t) + text, eps)
        layout = _norm(w, p + "attention.layout_output.LayerNorm",
                       _lin(w, p + "attention.layout_output.dense", ctx_l)
                       + layout, eps)
        mid = _act(cfg, _lin(w, p + "intermediate.dense", text))
        text = _norm(w, p + "output.LayerNorm",
                     _lin(w, p + "output.dense", mid) + text, eps)
        mid = _act(cfg, _lin(w, p + "layout_intermediate.dense", layout))
        layout = _norm(w, p + "layout_output.LayerNorm",
                       _lin(w, p + "layout_output.dense", mid) + layout, eps)
    return torch.cat([text, layout], -1)


def forward_flops(cfg: Dict, n: int) -> int:
    """Multiply-add FLOPs (2 a product) of the matrix products one page of
    ``n`` real tokens needs, the attention's over its ``n`` keys; padding,
    table lookups, norms and activations are not counted."""
    h, lh = cfg["hidden_size"], layout_width(cfg)
    inter, r = cfg["intermediate_size"], cfg["channel_shrink_ratio"]
    nh = cfg["num_attention_heads"]
    d = h // nh + h // nh // r
    per_layer = (4 * h * h + 2 * h * inter          # text q, k, v, out; MLP
                 + 4 * lh * lh + 2 * lh * (inter // r))  # layout stream
    embed = 6 * (h // 6) * lh                       # box_linear_embeddings
    attention = 2 * nh * n * n * d * 2              # scores and p·v, both
    return 2 * n * (embed + cfg["num_hidden_layers"] * per_layer) \
        + cfg["num_hidden_layers"] * attention
