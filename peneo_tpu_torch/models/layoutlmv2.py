"""LayoutLMv2 / LayoutXLM backbone in PyTorch — a single-stream transformer
over [text tokens ‖ 49 visual tokens] with T5-style 1D + 2D relative
attention biases, its visual tokens pooled from a ResNeXt-101-FPN tower.

Counterpart of ``peneo_tpu/models/layoutlmv2.py``. Module and parameter
names are the reference's torch keys (HF ``LayoutLMv2Model`` with its
detectron2 tower), the ones ``peneo_tpu/models/convert_layoutlmv2.py``
reads: ``embeddings.*``, ``visual_proj``, ``visual_LayerNorm``,
``encoder.layer.N.attention.self.{qkv_linear, q_bias, v_bias}`` (or
``query/key/value`` without ``fast_qkv``), ``encoder.rel_pos_bias`` /
``rel_pos_x_bias`` / ``rel_pos_y_bias`` (bias-free Linears of weight
(heads, bins)), and the tower under ``visual.backbone.``:
``bottom_up.stem.conv1``, ``bottom_up.res{2-5}.{i}.{conv1,conv2,conv3,
shortcut}`` (each a bias-free conv with a ``norm``), ``fpn_lateral{2-5}``
and ``fpn_output2`` (biased convs).

The tower (:class:`ResNeXtFPN`): detectron2's ResNeXt with caffe-style
bottlenecks (the stride in the first 1×1), grouped 3×3 convs, projection
shortcuts on a change of stride or width, frozen batch norms, and an FPN
whose p2 map (stride 4, 256 channels) is average-pooled to the 7×7 grid.
A frozen norm is a per-channel affine: :class:`ConvFrozenBN` folds it into
the conv's weights on every call (``w·s`` and ``b − mean·s``, ``s =
weight/√(var + 1e-5)``, in fp32, then cast), so no pass over the
activations is added. The JAX package folds once at conversion and trains
the folded kernel and bias; here the conv weight and ``norm.bias`` are
Parameters and ``norm.weight`` / ``running_mean`` / ``running_var`` are
buffers, so the trained set is the JAX package's, and where ``s = 1`` (the
JAX weights bridged by ``models/convert.py``) a step's gradients are JAX's.
The FPN's top-down upsampling is ``jax.image.resize(..., "nearest")`` to
the lateral's shape, which is ``nearest-exact`` in torch (the two agree
only on exact 2x steps).

Attention: ``softmax(q·kᵀ/√d + rel_bias + key_mask)·v`` — unlike
LayoutLMv3, the relative bias is added unscaled. It runs through the same
rel-bias kernels as LayoutLMv3 (#4 in eval mode, #5/#6 in training), the
layer loop, the bias build and the shape-only tensor cache being
:class:`~peneo_tpu_torch.models.layoutlmv3.RelBiasBackbone`'s. Unlike
LayoutLMv3 the visual tokens are always there, 49 of them with no cls box,
built from zero features when no image is given, and the text position ids
are a plain ``arange``.

The embedding sums and their LayerNorms run in fp32 and only the outputs
are cast to the compute dtype (:meth:`LayoutLMv2Model.cast`).

Under tensor parallelism a rank runs ``nh / tp`` heads, as LayoutLMv3's
layers do. The fused ``qkv_linear`` with ``q_bias``/``v_bias`` matches no
split rule (JAX ``layoutlmv2.py:214``) and stays replicated: a rank takes
the rows of its heads of the q, k and v thirds (its product equals those
columns of the whole one) through ``copy_to_tp``, so that the gradients of
the replicated weight and biases are summed over the group. The tower is
replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import LayoutLMv2Config
from ..ops.quant import QuantLinear
from ..parallel.tensor_parallel import copy_to_tp
from .layoutlmv3 import LayoutLMv3Encoder, RelBiasBackbone, \
    RelBiasSelfAttention
from .lilt import init_module_weights, key_mask_bias, word_lookup

BN_EPS = 1e-5  # detectron2's FrozenBatchNorm2d
# norm.weight of each residual branch's last conv at random init: the
# branches of the 33 blocks add onto the shortcut with no live
# normalisation, so a small gain keeps p2 of order 1 (detectron2's
# zero-init-residual idea, not quite zero)
RESIDUAL_GAIN = 0.1


# --------------------------------------------------------------------- visual
class FrozenBatchNorm(nn.Module):
    """detectron2's ``FrozenBatchNorm2d`` keys. ``bias`` is trained (the JAX
    package trains the folded bias); ``weight``, ``running_mean`` and
    ``running_var`` are buffers. The default is the identity: ``s`` = 1
    exactly in fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.full((channels,),
                                                       1.0 - BN_EPS))


class ConvFrozenBN(nn.Conv2d):
    """A bias-free conv followed by a frozen batch norm, run as one biased
    conv on weights folded in fp32 (JAX ``ConvNoBN``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, groups=groups, bias=False)
        self.norm = FrozenBatchNorm(cout)

    def folded(self):
        """The fp32 (weight, bias) of the conv with its norm folded in."""
        n = self.norm
        s = n.weight.float() / torch.sqrt(n.running_var.float() + BN_EPS)
        return (self.weight.float() * s[:, None, None, None],
                n.bias.float() - n.running_mean.float() * s)

    def forward(self, x):
        w, b = self.folded()
        return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), self.stride,
                        self.padding, 1, self.groups)


class ResNeXtBlock(nn.Module):
    """Bottleneck 1×1 (stride here, caffe style) → grouped 3×3 → 1×1, plus
    a projection shortcut on a change of stride or width."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int = 1,
                 groups: int = 32):
        super().__init__()
        self.shortcut = (ConvFrozenBN(cin, cout, 1, stride)
                         if stride != 1 or cin != cout else None)
        self.conv1 = ConvFrozenBN(cin, bottleneck, 1, stride)
        self.conv2 = ConvFrozenBN(bottleneck, bottleneck, 3, groups=groups)
        self.conv3 = ConvFrozenBN(bottleneck, cout, 1)

    def forward(self, x):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + shortcut)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvFrozenBN(3, 64, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


class _BottomUp(nn.Module):
    """The stem and the stages ``res2`` … of detectron2's ResNet."""

    def __init__(self, depths: Sequence[int], groups: int,
                 width_per_group: int):
        super().__init__()
        self.stem = _Stem()
        self.n_stages = len(depths)
        cin, cout, bottleneck = 64, 256, groups * width_per_group
        for stage, depth in enumerate(depths):
            blocks = []
            for blk in range(depth):
                stride = 2 if (blk == 0 and stage > 0) else 1
                blocks.append(ResNeXtBlock(cin, bottleneck, cout, stride,
                                           groups))
                cin = cout
            setattr(self, f"res{stage + 2}", nn.Sequential(*blocks))
            cout *= 2
            bottleneck *= 2

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for stage in range(self.n_stages):
            x = getattr(self, f"res{stage + 2}")(x)
            outs.append(x)
        return outs


class ResNeXtFPN(nn.Module):
    """ResNeXt-FPN producing the p2 map (stride 4, ``fpn_channels``) of an
    NCHW image. The defaults are detectron2's LayoutLMv2 tower, ResNeXt-101
    32x8d."""

    def __init__(self, depths: Sequence[int] = (3, 4, 23, 3),
                 groups: int = 32, width_per_group: int = 8,
                 fpn_channels: int = 256):
        super().__init__()
        self.bottom_up = _BottomUp(depths, groups, width_per_group)
        for i in range(len(depths)):
            setattr(self, f"fpn_lateral{i + 2}",
                    nn.Conv2d(256 * 2 ** i, fpn_channels, 1))
        self.fpn_output2 = nn.Conv2d(fpn_channels, fpn_channels, 3,
                                     padding=1)

    def forward(self, x):
        outs = self.bottom_up(x)
        laterals = [getattr(self, f"fpn_lateral{i + 2}")(o)
                    for i, o in enumerate(outs)]
        top = laterals[-1]
        for lateral in reversed(laterals[:-1]):
            top = lateral + F.interpolate(top, size=lateral.shape[-2:],
                                          mode="nearest-exact")
        return self.fpn_output2(top)


class VisualBackbone(nn.Module):
    """The ``visual`` module of the reference: the tower under
    ``backbone``. The pixel normalisation and the pooling are
    :class:`LayoutLMv2Model`'s (pixel mean and std come from the config)."""

    def __init__(self, depths: Sequence[int]):
        super().__init__()
        self.backbone = ResNeXtFPN(tuple(depths))


def visual_grid_bbox(grid_h: int, grid_w: int) -> np.ndarray:
    """The grid's pseudo-boxes on the [0, 1000] page (HF
    ``_calc_visual_bbox``), int64 (grid_h · grid_w, 4); no cls box."""
    xe = np.arange(0, 1000 * (grid_w + 1), 1000) // grid_w
    ye = np.arange(0, 1000 * (grid_h + 1), 1000) // grid_h
    x0, y0 = np.meshgrid(xe[:-1], ye[:-1], indexing="xy")
    x1, y1 = np.meshgrid(xe[1:], ye[1:], indexing="xy")
    return np.stack([x0, y0, x1, y1], axis=-1).reshape(-1, 4) \
        .astype(np.int64)


# ----------------------------------------------------------------------- text
class LayoutLMv2SharedEmbeddings(nn.Module):
    """Word / position / spatial / token-type tables shared by the text and
    the visual tokens."""

    def __init__(self, cfg: LayoutLMv2Config):
        super().__init__()
        n2d = cfg.max_2d_position_embeddings
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.x_position_embeddings = nn.Embedding(n2d, cfg.coordinate_size)
        self.y_position_embeddings = nn.Embedding(n2d, cfg.coordinate_size)
        self.h_position_embeddings = nn.Embedding(n2d, cfg.shape_size)
        self.w_position_embeddings = nn.Embedding(n2d, cfg.shape_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def spatial(self, bbox):
        """x0, y0, x1, y1 (x / y tables), then h and w, concatenated."""
        x, y = self.x_position_embeddings, self.y_position_embeddings
        return torch.cat([
            x(bbox[:, :, 0]), y(bbox[:, :, 1]), x(bbox[:, :, 2]),
            y(bbox[:, :, 3]),
            self.h_position_embeddings(bbox[:, :, 3] - bbox[:, :, 1]),
            self.w_position_embeddings(bbox[:, :, 2] - bbox[:, :, 0]),
        ], dim=-1)


class LayoutLMv2SelfAttention(RelBiasSelfAttention):
    """``fast_qkv``: one bias-free (H, 3H) projection plus the q and v
    biases of shape (1, 1, H); else ``query/key/value``. The layer around it
    is :class:`~peneo_tpu_torch.models.layoutlmv3.LayoutLMv3Layer` (JAX
    ``Layer``: attention output, MLP, post-LN)."""

    def __init__(self, cfg: LayoutLMv2Config):
        super().__init__(cfg)
        h = cfg.hidden_size
        self.fast_qkv = cfg.fast_qkv
        if cfg.fast_qkv:
            self.qkv_linear = QuantLinear(h, 3 * h, bias=False)
            self.q_bias = nn.Parameter(torch.zeros(1, 1, h))
            self.v_bias = nn.Parameter(torch.zeros(1, 1, h))
        else:
            self.query = QuantLinear(h, h)
            self.key = QuantLinear(h, h)
            self.value = QuantLinear(h, h)

    def project(self, x):
        if not self.fast_qkv:
            return self.query(x), self.key(x), self.value(x)
        q_bias, v_bias = self.q_bias, self.v_bias
        if self.tp.size == 1:
            qkv = self.qkv_linear(x)
        else:  # this rank's heads' rows of each third
            w = copy_to_tp(self.qkv_linear.weight, self.tp)
            H = w.shape[1]
            cols = self.tp.part(H)
            qkv = self.qkv_linear.linear(
                x, w.view(3, H, H)[:, cols].reshape(-1, H))
            q_bias = copy_to_tp(q_bias, self.tp)[..., cols]
            v_bias = copy_to_tp(v_bias, self.tp)[..., cols]
        # k is a strided view of the (B, L, 3H) product: the kernels read it
        q, k, v = qkv.chunk(3, dim=-1)
        return q + q_bias.to(q.dtype), k, v + v_bias.to(v.dtype)


# ---------------------------------------------------------------------- model
class LayoutLMv2Model(RelBiasBackbone):
    """Full LayoutLMv2 / LayoutXLM encoder. ``forward`` returns a dict with
    ``last_hidden_state`` (B, L + 49, H): the text positions, then the 7×7
    visual tokens."""

    def __init__(self, cfg: LayoutLMv2Config):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = LayoutLMv2SharedEmbeddings(cfg)
        self.visual = VisualBackbone(cfg.visual_depths)
        self.visual_proj = nn.Linear(cfg.image_feature_pool_shape[2], h)
        self.visual_LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.encoder = LayoutLMv3Encoder(cfg, LayoutLMv2SelfAttention)
        self.grid = tuple(cfg.image_feature_pool_shape[:2])
        self.n_vis = self.grid[0] * self.grid[1]
        self.bias_div = 1.0  # v2 adds the relative bias unscaled

    def cast(self, dtype: torch.dtype) -> "LayoutLMv2Model":
        """Cast to the compute dtype, keeping in fp32 the embeddings (tables
        and LayerNorm), the visual LayerNorm, the three bucket tables and
        the frozen norms (folded in fp32 on every call)."""
        self.to(dtype)
        self.embeddings.float()
        self.visual_LayerNorm.float()
        self._keep_tables_fp32()
        for m in self.modules():
            if isinstance(m, FrozenBatchNorm):
                m.float()
        return self

    def init_weights(self, generator: torch.Generator, std: float) -> None:
        """Text side as the reference's _init_weights: normal(std) Linears
        and Embeddings, zero biases (``q_bias`` / ``v_bias`` too), unit
        LayerNorms, the word table's padding row zeroed. The tower, which
        the reference takes pretrained: He-normal bias-free convs, identity
        frozen norms except each residual branch's last (gain
        ``RESIDUAL_GAIN``), fan-in normal FPN convs with zero biases."""
        init_module_weights(self, generator, std)
        with torch.no_grad():
            self.embeddings.word_embeddings.weight[
                self.cfg.pad_token_id].zero_()
            for m in self.modules():
                if isinstance(m, LayoutLMv2SelfAttention) and m.fast_qkv:
                    m.q_bias.zero_()
                    m.v_bias.zero_()
                if not isinstance(m, nn.Conv2d):
                    continue
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, ConvFrozenBN) else 1.0
                m.weight.normal_(0.0, (gain / fan_in) ** 0.5,
                                 generator=generator)
                if isinstance(m, ConvFrozenBN):
                    m.norm.weight.fill_(1.0)
                    m.norm.bias.zero_()
                    m.norm.running_mean.zero_()
                    m.norm.running_var.fill_(1.0 - BN_EPS)
                else:
                    m.bias.zero_()
            for m in self.modules():
                if isinstance(m, ResNeXtBlock):
                    m.conv3.norm.weight.fill_(RESIDUAL_GAIN)

    def visual_features(self, image):
        """(B, 3, S, S) BGR 0-255 floats → the pooled p2 features (B, 49,
        C): normalised in fp32 by the config's pixel mean and std, then the
        tower in the compute dtype, then an average pool of window
        ``p2 // 7``."""
        stats = self._static_tensor(
            ("pixel",), lambda: np.array([self.cfg.pixel_mean,
                                          self.cfg.pixel_std], np.float32),
            image.device)[:, :, None, None]
        x = ((image.float() - stats[0]) / stats[1]).to(self.dtype)
        p2 = self.visual.backbone(x)
        window = (p2.shape[2] // self.grid[0], p2.shape[3] // self.grid[1])
        return F.avg_pool2d(p2, window).flatten(2).transpose(1, 2)

    def forward(self, input_ids, bbox,
                attention_mask: Optional[torch.Tensor] = None,
                image: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``image`` (B, 3, S, S) BGR 0-255 floats, or None for the
        text-only mode (the 49 visual tokens then come from zero features).
        ``generator`` (CPU) draws each layer's attention-dropout seed in
        training mode (the default generator when None)."""
        cfg, emb, dtype = self.cfg, self.embeddings, self.dtype
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        input_ids = input_ids.long()
        bbox = bbox.long()
        B, L = input_ids.shape
        dev = input_ids.device
        drop = cfg.hidden_dropout_prob

        text_pos = self._static_tensor(
            ("arange", L), lambda: np.arange(L, dtype=np.int64), dev)
        text = (word_lookup(emb.word_embeddings, input_ids)
                + emb.position_embeddings(text_pos) + emb.spatial(bbox)
                + emb.token_type_embeddings.weight[0])
        text = F.dropout(emb.LayerNorm(text.float()).to(dtype), drop,
                         self.training)

        vis_box = self._static_tensor(
            ("grid_bbox",), lambda: visual_grid_bbox(*self.grid), dev)
        vis_box = vis_box[None].expand(B, -1, -1)
        vis_pos = self._static_tensor(
            ("arange", self.n_vis),
            lambda: np.arange(self.n_vis, dtype=np.int64), dev)
        if image is not None:
            feats = self.visual_features(image)
        else:
            feats = torch.zeros((B, self.n_vis, self.visual_proj.in_features),
                                dtype=dtype, device=dev)
        vis = (self.visual_proj(feats).float() + emb.position_embeddings(
            vis_pos) + emb.spatial(vis_box))
        vis = F.dropout(self.visual_LayerNorm(vis).to(dtype), drop,
                        self.training)

        x = torch.cat([text, vis], dim=1)
        mask = key_mask_bias(torch.cat(
            [attention_mask, attention_mask.new_ones((B, self.n_vis))], dim=1))
        rel_bias = self.rel_bias(torch.cat([bbox, vis_box], dim=1), L,
                                 self.n_vis)
        return {"last_hidden_state": self.run_layers(x, mask, rel_bias,
                                                     generator)}
