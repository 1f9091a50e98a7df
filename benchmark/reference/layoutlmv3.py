"""Plain float32 LayoutLMv3 (Huang et al., ACM MM 2022, "LayoutLMv3:
Pre-training for Document AI with Unified Text and Image Masking",
arXiv:2204.08387), as the benchmark's yardstick.

Written from the published architecture: one transformer encoder over the
text tokens followed by the page image's patches. A text token's embedding
is the sum of its word, position (RoBERTa's: a running count of non-pad
tokens after the pad id) and type rows and of its box's x0, y0, x1, y1,
height and width rows, then a LayerNorm. The image is cut into
``patch_size`` patches by a linear map of each patch's pixels (a
convolution of stride ``patch_size``), a learned CLS row is put first, the
learned position rows are added and a LayerNorm (eps 1e-6) follows. The two
sequences, text then image, pass one more LayerNorm together. Each layer is
post-LN attention and a GELU MLP; its scores get a learned per-head bias,
the same in every layer: the 1D relative position of two tokens (text and
image each numbered from 0) and the x0 and the y1 distances of their boxes
(an image patch's box is its cell of the page's 0-1000 grid, the image
CLS's ``[1, 1, 999, 999]``), each put in a T5 log-scaled bucket, made a
one-hot vector and mapped to the heads by a linear map without bias,
summed, and divided by √d as the scores are. Padding keys are masked; the
image's positions are never padding.

Departures, each the same function: CogView's PB-Relax softmax (scores
scaled down by a constant and its maximum taken out before the softmax) is
written as a plain softmax; dropout is left out (the serving forward); TF32
is off wherever the benchmark runs this. Parameter names are those of the
public checkpoints under the PEneo model's ``backbone.`` prefix, so one
weight dict serves this module and the program under test.

:func:`page_image` is the image side of LayoutLMv3's image processor: RGB,
a bilinear resize to ``input_size`` square, /255, then (x − 0.5) / 0.5.

Imports torch, numpy and PIL only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PREFIX = "backbone."
VISUAL_NORM_EPS = 1e-6
# the relative bias's three tables: 1D, x, y
BIAS_TABLES = tuple(f"{PREFIX}encoder.{name}.weight" for name in
                    ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias"))


def grid(cfg: Dict) -> int:
    """Patches along each side of the page image."""
    return cfg["input_size"] // cfg["patch_size"]


def visual_positions(cfg: Dict) -> int:
    """The image's positions: its patches and its CLS."""
    return grid(cfg) ** 2 + 1


def output_width(cfg: Dict) -> int:
    return cfg["hidden_size"]


def param_table(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter; init is ``normal`` (matrices,
    tables, the patch map, the image's CLS and position rows), ``zeros``
    (biases) or ``ones`` (LayerNorm gains)."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    n2d, nh = cfg["max_2d_position_embeddings"], cfg["num_attention_heads"]
    p = cfg["patch_size"]
    out = []

    def linear(name, d_in, d_out, bias=True):
        out.append((f"{name}.weight", (d_out, d_in), "normal"))
        if bias:
            out.append((f"{name}.bias", (d_out,), "zeros"))

    def norm(name, d):
        out.append((f"{name}.weight", (d,), "ones"))
        out.append((f"{name}.bias", (d,), "zeros"))

    e = PREFIX + "embeddings."
    out.append((e + "word_embeddings.weight", (cfg["vocab_size"], h),
                "normal"))
    out.append((e + "token_type_embeddings.weight",
                (cfg["type_vocab_size"], h), "normal"))
    out.append((e + "position_embeddings.weight",
                (cfg["max_position_embeddings"], h), "normal"))
    for axis, width in (("x", "coordinate_size"), ("y", "coordinate_size"),
                        ("h", "shape_size"), ("w", "shape_size")):
        out.append((f"{e}{axis}_position_embeddings.weight",
                    (n2d, cfg[width]), "normal"))
    norm(e + "LayerNorm", h)
    out.append((PREFIX + "patch_embed.proj.weight",
                (h, cfg["num_channels"], p, p), "normal"))
    out.append((PREFIX + "patch_embed.proj.bias", (h,), "zeros"))
    out.append((PREFIX + "cls_token", (1, 1, h), "normal"))
    out.append((PREFIX + "pos_embed", (1, visual_positions(cfg), h),
                "normal"))
    norm(PREFIX + "norm", h)
    norm(PREFIX + "LayerNorm", h)
    enc = PREFIX + "encoder."
    linear(enc + "rel_pos_bias", cfg["rel_pos_bins"], nh, bias=False)
    linear(enc + "rel_pos_x_bias", cfg["rel_2d_pos_bins"], nh, bias=False)
    linear(enc + "rel_pos_y_bias", cfg["rel_2d_pos_bins"], nh, bias=False)
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{enc}layer.{i}."
        for name in ("query", "key", "value"):
            linear(f"{lp}attention.self.{name}", h, h)
        linear(lp + "attention.output.dense", h, h)
        norm(lp + "attention.output.LayerNorm", h)
        linear(lp + "intermediate.dense", h, inter)
        linear(lp + "output.dense", inter, h)
        norm(lp + "output.LayerNorm", h)
    return out


def zero_rows(cfg: Dict) -> List[Tuple[str, int]]:
    """Table rows that the published init zeroes: the padding index of the
    word and position tables."""
    pad = cfg["pad_token_id"]
    return [(PREFIX + "embeddings.word_embeddings.weight", pad),
            (PREFIX + "embeddings.position_embeddings.weight", pad)]


def page_image(path: str, size: int) -> torch.Tensor:
    """A page image file → (3, size, size) float32, as LayoutLMv3's image
    processor makes it."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = im.convert("RGB").resize((size, size), Image.BILINEAR)
        pixels = torch.from_numpy(np.asarray(rgb, dtype=np.uint8).copy())
    x = pixels.permute(2, 0, 1).float() / 255.0
    return (x - 0.5) / 0.5


def _lin(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def _norm(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], eps)


def _act(cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["hidden_act"] != "gelu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not written")
    return F.gelu(x)


def bucket(rel: torch.Tensor, bins: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucket of each relative distance: half the bins
    for distances to the right; within a half, one bin a distance below a
    quarter of the bins, then log-spaced bins up to ``max_distance``."""
    half = bins // 2
    exact = half // 2
    n = rel.abs()
    far = exact + (torch.log(n.float() / exact)
                   / math.log(max_distance / exact)
                   * (half - exact)).long()
    far = far.clamp(max=half - 1)
    return (rel > 0).long() * half + torch.where(n < exact, n, far)


def visual_boxes(cfg: Dict, device) -> torch.Tensor:
    """(1 + grid², 4) boxes of the image's CLS and of its patches in
    row-major order, on the 0-1000 grid."""
    g = grid(cfg)
    edges = torch.div(torch.arange(0, 1000 * (g + 1), 1000, device=device),
                      g, rounding_mode="floor")
    y, x = torch.meshgrid(torch.arange(g, device=device),
                          torch.arange(g, device=device), indexing="ij")
    cells = torch.stack([edges[x], edges[y], edges[x + 1], edges[y + 1]],
                        -1).view(-1, 4)
    cls = torch.tensor([[1, 1, 999, 999]], device=device)
    return torch.cat([cls, cells])


def rel_bias(cfg: Dict, w: Dict[str, torch.Tensor], box: torch.Tensor,
             text_len: int) -> torch.Tensor:
    """(B, nh, P, P) bias of the P = text + image positions, before its
    division by √d: bucket, one-hot, linear map, for the 1D positions and
    for the x0 and y1 of the boxes ``box`` (B, P, 4)."""
    B, P = box.shape[:2]
    dev = box.device
    pos = torch.cat([torch.arange(text_len, device=dev),
                     torch.arange(P - text_len, device=dev)])
    enc = PREFIX + "encoder."

    def mapped(rel, bins, far, table):
        onehot = F.one_hot(bucket(rel, bins, far), bins).float()
        return _lin(w, enc + table, onehot).permute(0, 3, 1, 2)

    one_d = mapped((pos[None, :] - pos[:, None])[None],
                   cfg["rel_pos_bins"], cfg["max_rel_pos"], "rel_pos_bias")
    bins, far = cfg["rel_2d_pos_bins"], cfg["max_rel_2d_pos"]
    x, y = box[:, :, 0], box[:, :, 3]
    return (one_d
            + mapped(x[:, None, :] - x[:, :, None], bins, far,
                     "rel_pos_x_bias")
            + mapped(y[:, None, :] - y[:, :, None], bins, far,
                     "rel_pos_y_bias"))


def forward(cfg: Dict, w: Dict[str, torch.Tensor], input_ids: torch.Tensor,
            bbox: torch.Tensor, attention_mask: torch.Tensor,
            image: torch.Tensor) -> torch.Tensor:
    """(B, L) ids, (B, L, 4) boxes on the 0-1000 grid, (B, L) mask, (B, 3,
    S, S) normalised page images → (B, L + 1 + (S/p)², H) float32: the text
    positions, then the image's CLS and patches."""
    eps = cfg["layer_norm_eps"]
    pad = cfg["pad_token_id"]
    ids, box = input_ids.long(), bbox.long()
    B, L = ids.shape
    real = (ids != pad).long()
    pos = torch.cumsum(real, 1) * real + pad
    e = PREFIX + "embeddings."

    def table(name, idx):
        return w[f"{e}{name}.weight"][idx]

    text = (table("word_embeddings", ids) + table("token_type_embeddings", 0)
            + table("position_embeddings", pos)
            + torch.cat([table("x_position_embeddings", box[..., 0]),
                         table("y_position_embeddings", box[..., 1]),
                         table("x_position_embeddings", box[..., 2]),
                         table("y_position_embeddings", box[..., 3]),
                         table("h_position_embeddings",
                               (box[..., 3] - box[..., 1]).clamp(0, 1023)),
                         table("w_position_embeddings",
                               (box[..., 2] - box[..., 0]).clamp(0, 1023))],
                        -1))
    text = _norm(w, e + "LayerNorm", text, eps)
    patches = F.conv2d(image.float(), w[PREFIX + "patch_embed.proj.weight"],
                       w[PREFIX + "patch_embed.proj.bias"],
                       stride=cfg["patch_size"]).flatten(2).transpose(1, 2)
    vis = torch.cat([w[PREFIX + "cls_token"].expand(B, -1, -1), patches], 1)
    vis = _norm(w, PREFIX + "norm", vis + w[PREFIX + "pos_embed"],
                VISUAL_NORM_EPS)
    x = _norm(w, PREFIX + "LayerNorm", torch.cat([text, vis], 1), eps)
    P = x.shape[1]
    mask = torch.cat([attention_mask.float(),
                      attention_mask.new_ones((B, P - L)).float()], 1)
    box = torch.cat([box, visual_boxes(cfg, box.device)[None].expand(
        B, -1, -1)], 1)

    nh = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // nh
    bias = rel_bias(cfg, w, box, L) / math.sqrt(d) \
        + (1.0 - mask)[:, None, None, :] * torch.finfo(torch.float32).min
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{PREFIX}encoder.layer.{i}."
        a = lp + "attention.self."

        def heads(name):
            return _lin(w, a + name, x).view(B, P, nh, d).transpose(1, 2)

        q, k, v = heads("query"), heads("key"), heads("value")
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d) + bias,
                              -1)
        ctx = (probs @ v).transpose(1, 2).reshape(B, P, nh * d)
        x = _norm(w, lp + "attention.output.LayerNorm",
                  _lin(w, lp + "attention.output.dense", ctx) + x, eps)
        mid = _act(cfg, _lin(w, lp + "intermediate.dense", x))
        x = _norm(w, lp + "output.LayerNorm",
                  _lin(w, lp + "output.dense", mid) + x, eps)
    return x


def forward_flops(cfg: Dict, n: int) -> int:
    """Multiply-add FLOPs (2 a product) of the matrix products one page of
    ``n`` real text tokens needs at its P = n + 1 + grid² positions: the
    patch map over the patches, each layer's projections and MLP, and the
    attention's over P keys. Padding, table lookups, norms, activations and
    the bias's one-hot maps (the program gathers table rows instead) are
    not counted."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    P = n + visual_positions(cfg)
    patch = (grid(cfg) ** 2) * cfg["num_channels"] * cfg["patch_size"] ** 2 \
        * h
    per_layer = 4 * h * h + 2 * h * inter
    attention = 2 * P * P * h                       # scores and p·v
    return 2 * (patch + cfg["num_hidden_layers"] * (P * per_layer
                                                    + attention))
