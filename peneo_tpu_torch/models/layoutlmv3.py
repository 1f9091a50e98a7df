"""LayoutLMv3 backbone in PyTorch — single-stream transformer over
[text tokens ‖ CLS_img ‖ image patches] with T5-style 1D + 2D relative
attention biases.

Counterpart of ``peneo_tpu/models/layoutlmv3.py``. Module and parameter
names are the reference's torch key names (model/backbone/layoutlmv3/
modeling_layoutlmv3.py), the ones ``peneo_tpu/models/convert_layoutlmv3.py``
reads: ``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``norm`` (the
visual LayerNorm, eps 1e-6), ``LayerNorm`` (after the concat),
``encoder.rel_pos_bias`` / ``rel_pos_x_bias`` / ``rel_pos_y_bias`` as
bias-free Linears of weight (heads, bins), ``encoder.layer.N.…``.

Attention: ``softmax(q·kᵀ/√d + rel_bias + key_mask)·v``. The relative bias
is computed once per forward as one fp32 ``(B, nh, L', L')`` tensor shared by
all layers. In eval mode each layer runs
:func:`peneo_tpu_torch.ops.bias_attention.bias_attention` (kernel #4 on the
card, its plain twin on the CPU); in training mode
:func:`~peneo_tpu_torch.ops.bias_attention.bias_attention_train` (kernels
#5/#6 with one in-kernel dropout mask and ``dbias``), each layer drawing one
seed per step from the ``generator`` its caller passes, outside the
checkpointed region. ``set_attention_impl("plain")`` forces the plain twins
on any device (tests and the on-card parity checks only). The reference's
PB-Relax softmax equals the plain max-subtracted softmax and is not carried.

The relative bias (:class:`RelBias`): the buckets are integer functions of
positions and boxes, read from a small table made on the host
(:func:`bucket_table`) instead of a device ``log``, so they are the JAX
package's buckets bit for bit on every device. The forward gathers
``w1[:, b1] + (wx + wy)[:, bx·bins + by]`` straight into the layout the
kernels read (one gather for both 2D tables): a ``(B, nh, L', L')`` view of
an ``(nh, B, L', L'4)`` buffer, rows of ``L'4`` = L' rounded up to a
multiple of 4 floats (712 for 709: +0.4 %), so that every row starts
16-byte aligned and the kernels fetch it in 16-byte requests; the padding
columns hold the gather of real buckets and no reader looks at them. The
backward sums ``dbias``
per bucket as matrix products with one-hot bucket matrices, per batch row:
deterministic, no atomics (a scatter-add of B·L'²·nh values onto 32 or 64
rows serialises on them); the 1D table's gradient is summed over the batch
first, its buckets being batch-independent.

The embedding sum and its LayerNorm run in fp32 and only the output is cast
to the compute dtype (:meth:`LayoutLMv3Model.cast`).

:class:`RelBiasSelfAttention` (the attention) and :class:`RelBiasBackbone`
(the bias build, the layer loop, the shape-only tensor cache) are shared
with LayoutLMv2 (``models/layoutlmv2.py``), whose bias is not divided by √d.

Under tensor parallelism (``parallel/tensor_parallel.py``) a rank runs
``nh / tp`` heads: the attention and the MLP split as LiLT's do, and the
bias build gathers only this rank's head rows of the (B, nh, L', L') bias
from the replicated bucket tables, which enter through ``copy_to_tp``: each
rank's table gradient covers its heads, and their sum is the gradient.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LayoutLMv3Config
from ..ops.biacm_attention import element_dropout_bits
from ..ops.bias_attention import (bias_attention, bias_attention_reference,
                                  bias_attention_train,
                                  bias_attention_train_reference)
from ..ops.quant import QuantLinear
from ..parallel.tensor_parallel import NO_TP, copy_to_tp
from .dropout_seeds import layer_seed
from .lilt import (ATTENTION_IMPLS, Intermediate, ResidualOutput,
                   init_module_weights, key_mask_bias, make_position_ids,
                   word_lookup)


@functools.lru_cache(maxsize=None)
def bucket_table(num_buckets: int, max_distance: int) -> np.ndarray:
    """Half of the bidirectional T5 log-bucketing
    (modeling_layoutlmv3.py:586-613) as a table: entry ``n`` is the bucket
    of distance ``|rel| = n`` for ``n`` in [0, max_distance], before the
    sign's offset; larger distances share the last entry. The arithmetic is
    the JAX package's ``static_rel_pos_bucket`` (fp32 ``log``, truncation)."""
    half = num_buckets // 2
    max_exact = half // 2
    n = np.arange(max_distance + 1, dtype=np.int64)
    n_safe = np.maximum(n, 1).astype(np.float32)
    large = max_exact + (
        np.log(n_safe / np.float32(max_exact))
        / np.float32(math.log(max_distance / max_exact))
        * (half - max_exact)
    ).astype(np.int32)
    large = np.minimum(large, half - 1)
    table = np.where(n < max_exact, n, large).astype(np.int64)
    table.setflags(write=False)  # shared by every caller of the cache
    return table


def relative_position_bucket(rel_pos, num_buckets: int, max_distance: int,
                             lut: Optional[torch.Tensor] = None):
    """Bucket of each relative position (a numpy array or a tensor of
    integers); int64, same type of container as ``rel_pos``. ``lut``: the
    caller's copy of ``bucket_table`` on the tensor's device, uploaded here
    when None."""
    table = bucket_table(num_buckets, max_distance)
    if isinstance(rel_pos, torch.Tensor):
        if lut is None:
            lut = torch.from_numpy(table.copy()).to(rel_pos.device)
        n = rel_pos.abs().clamp(max=max_distance)
        return (rel_pos > 0).long() * (num_buckets // 2) + lut[n]
    rel_pos = np.asarray(rel_pos)
    n = np.minimum(np.abs(rel_pos), max_distance)
    return (rel_pos > 0).astype(np.int64) * (num_buckets // 2) + table[n]


def static_rel_pos_bucket(seq_len: int, n_vis: int, num_buckets: int,
                          max_distance: int) -> np.ndarray:
    """The 1D bucket matrix (L', L'): the 1D positions are plain ``arange``
    ramps over the text and over the visual tokens
    (modeling_layoutlmv3.py:1101-1107), so it depends on the shapes only."""
    pos = np.arange(seq_len, dtype=np.int64)
    if n_vis:
        pos = np.concatenate([pos, np.arange(n_vis, dtype=np.int64)])
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets,
                                    max_distance)


def visual_bbox(img_grid: int, max_len: int = 1000) -> np.ndarray:
    """Patch-grid pseudo-boxes + the cls box (modeling_layoutlmv3.py:879-901),
    int64 (1 + grid², 4)."""
    edges = np.arange(0, max_len * (img_grid + 1), max_len) // img_grid
    x0, y0 = np.meshgrid(edges[:-1], edges[:-1], indexing="xy")
    x1, y1 = np.meshgrid(edges[1:], edges[1:], indexing="xy")
    grid = np.stack([x0, y0, x1, y1], axis=-1).reshape(-1, 4)
    cls_box = np.array([[1, 1, max_len - 1, max_len - 1]])
    return np.concatenate([cls_box, grid], axis=0).astype(np.int64)


def _bucket_sum(grad: torch.Tensor, bucket: torch.Tensor, bins: int):
    """``out[h, n] = Σ grad[x, h, i, j] · [bucket[x, i, j] == n]`` for
    ``grad`` (X, nh, L, L) and ``bucket`` (X, L, L): per batch row a batched
    product of (nh, L) rows of ``grad`` with the (L, bins) one-hot rows of
    ``bucket``, summed. Deterministic; the one-hot matrix lives for one
    batch row at a time."""
    ids = torch.arange(bins, device=grad.device)
    out = grad.new_zeros((grad.shape[1], bins))
    for g, b in zip(grad, bucket):
        onehot = (b[..., None] == ids).to(grad.dtype)     # (L, L, bins)
        out += torch.bmm(g.transpose(0, 1), onehot).sum(0)
    return out


class RelBias(torch.autograd.Function):
    """``rel_bias[b, h, i, j] = (w1[h, b1[i, j]] + wx[h, bx[b, i, j]] +
    wy[h, by[b, i, j]]) / div`` as fp32 ``(B, nh, L, L)`` with a contiguous
    last dim: a view of an (nh, B, L, L4) buffer, which the attention
    kernels read through its strides. The buckets come with their key axis
    padded to L4 (a multiple of 4): ``w1`` with ``b1`` (L, L4), or ``wx``,
    ``wy`` with ``bx``, ``by`` (B, L, L4), may be None. The gradient may
    come at any strides. See the module docstring for the backward."""

    @staticmethod
    def forward(ctx, w1, wx, wy, b1, bx, by, batch, div):
        nh = (w1 if w1 is not None else wx).shape[0]
        L, L4 = (b1 if b1 is not None else bx).shape[-2:]
        out = None
        if wx is not None:
            bins = wx.shape[1]
            both = (wx.float()[:, :, None] + wy.float()[:, None, :])
            out = torch.index_select(both.reshape(nh, bins * bins), 1,
                                     (bx * bins + by).reshape(-1))
            out = out.view(nh, batch, L * L4)
        if w1 is not None:
            one_d = torch.index_select(w1.float(), 1, b1.reshape(-1))
            out = (out.add_(one_d[:, None]) if out is not None
                   else one_d[:, None].repeat(1, batch, 1))
        out /= div
        ctx.save_for_backward(b1, bx, by)
        ctx.shapes = (None if w1 is None else w1.shape[1],
                      None if wx is None else wx.shape[1], div)
        return out.view(nh, batch, L, L4).permute(1, 0, 2, 3)[..., :L]

    @staticmethod
    def backward(ctx, grad):
        b1, bx, by = ctx.saved_tensors
        bins1, bins2, div = ctx.shapes
        grad = grad.float()
        L = grad.shape[-1]
        g1 = gx = gy = None
        if bins1 is not None:
            g1 = _bucket_sum(grad.sum(0, keepdim=True), b1[None, :, :L],
                             bins1) / div
        if bins2 is not None:
            gx = _bucket_sum(grad, bx[..., :L], bins2) / div
            gy = _bucket_sum(grad, by[..., :L], bins2) / div
        return g1, gx, gy, None, None, None, None, None


class LayoutLMv3Embeddings(nn.Module):
    """Word + token-type + position + spatial (x0, y0, x1, y1, h, w)
    embeddings → LayerNorm → dropout (modeling_layoutlmv3.py:214-305)."""

    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        n2d = cfg.max_2d_position_embeddings
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.x_position_embeddings = nn.Embedding(n2d, cfg.coordinate_size)
        self.y_position_embeddings = nn.Embedding(n2d, cfg.coordinate_size)
        self.h_position_embeddings = nn.Embedding(n2d, cfg.shape_size)
        self.w_position_embeddings = nn.Embedding(n2d, cfg.shape_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout_prob
        self.pad_token_id = cfg.pad_token_id

    def forward(self, input_ids, bbox, dtype):
        x, y = self.x_position_embeddings, self.y_position_embeddings
        spatial = torch.cat([
            x(bbox[:, :, 0]), y(bbox[:, :, 1]), x(bbox[:, :, 2]),
            y(bbox[:, :, 3]),
            self.h_position_embeddings(
                (bbox[:, :, 3] - bbox[:, :, 1]).clamp(0, 1023)),
            self.w_position_embeddings(
                (bbox[:, :, 2] - bbox[:, :, 0]).clamp(0, 1023)),
        ], dim=-1)
        # token_type_ids are always zeros in the PEneo pipeline
        out = (word_lookup(self.word_embeddings, input_ids)
               + self.token_type_embeddings.weight[0]
               + self.position_embeddings(
                   make_position_ids(input_ids, self.pad_token_id))
               + spatial)
        out = self.LayerNorm(out.float()).to(dtype)
        return F.dropout(out, self.dropout, self.training)


class PatchEmbed(nn.Module):
    """Image → patch tokens: a conv of kernel = stride = patch size."""

    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        self.proj = nn.Conv2d(cfg.num_channels, cfg.hidden_size,
                              kernel_size=cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, image):
        return self.proj(image).flatten(2).transpose(1, 2)  # (B, grid², H)


class RelBiasSelfAttention(nn.Module):
    """Self-attention on a precomputed relative bias, shared by the
    LayoutLMv3 and LayoutLMv2 layers: ``softmax(q·kᵀ/√d + rel_bias +
    key_mask)·v`` through the rel-bias kernels. A subclass makes q, k and v
    (:meth:`project`, each (B, L, H), or (B, L, H / tp) of this rank's heads
    under tp)."""

    tp = NO_TP

    def __init__(self, cfg):
        super().__init__()
        self.nh = cfg.num_attention_heads
        self.dh = cfg.hidden_size // self.nh
        self.attention_impl = "kernel"
        self.dropout = cfg.attention_probs_dropout_prob

    def project(self, x):
        raise NotImplementedError

    def forward(self, x, mask, rel_bias, seed: int = 0):
        """``seed`` keys the attention-dropout mask of a training step."""
        B, L, _ = x.shape
        nh = self.nh // self.tp.size
        # (B, L, nh, d) projections viewed as (B, nh, L, d): no copy, the
        # kernels read them through strides
        qkv = [t.view(B, L, nh, self.dh).transpose(1, 2)
               for t in self.project(copy_to_tp(x, self.tp))]
        scale = 1.0 / math.sqrt(self.dh)
        plain = self.attention_impl == "plain"
        if not self.training:
            fn = bias_attention_reference if plain else bias_attention
            ctx = fn(*qkv, rel_bias, mask, scale)
        elif plain:
            bits = (element_dropout_bits(seed, B, nh, L, x.device)
                    if self.dropout > 0 else None)
            ctx = bias_attention_train_reference(*qkv, rel_bias, mask, bits,
                                                 scale, self.dropout)
        else:
            ctx = bias_attention_train(*qkv, rel_bias, mask, seed, scale,
                                       self.dropout)
        return ctx.transpose(1, 2).reshape(B, L, nh * self.dh)


class LayoutLMv3SelfAttention(RelBiasSelfAttention):
    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__(cfg)
        h = cfg.hidden_size
        self.query = QuantLinear(h, h)
        self.key = QuantLinear(h, h)
        self.value = QuantLinear(h, h)

    def project(self, x):
        return self.query(x), self.key(x), self.value(x)


class LayoutLMv3Attention(nn.Module):
    def __init__(self, cfg, self_attention=LayoutLMv3SelfAttention):
        super().__init__()
        self.self = self_attention(cfg)
        self.output = ResidualOutput(cfg.hidden_size, cfg.hidden_size,
                                     cfg.layer_norm_eps,
                                     cfg.hidden_dropout_prob)

    def forward(self, x, mask, rel_bias, seed: int = 0):
        return self.output(self.self(x, mask, rel_bias, seed), x)


class LayoutLMv3Layer(nn.Module):
    """Transformer layer on a precomputed bias (attention + MLP, post-LN)."""

    def __init__(self, cfg, self_attention=LayoutLMv3SelfAttention):
        super().__init__()
        self.attention = LayoutLMv3Attention(cfg, self_attention)
        self.intermediate = Intermediate(cfg.hidden_size,
                                         cfg.intermediate_size, cfg.hidden_act)
        self.output = ResidualOutput(cfg.intermediate_size, cfg.hidden_size,
                                     cfg.layer_norm_eps,
                                     cfg.hidden_dropout_prob)

    def forward(self, x, mask, rel_bias, seed: int = 0):
        x = self.attention(x, mask, rel_bias, seed)
        return self.output(self.intermediate(x), x)


class LayoutLMv3Encoder(nn.Module):
    """The layers and the three bucket tables, bias-free Linears of weight
    (heads, bins) as in the reference (which multiplies one-hot buckets by
    them; :class:`RelBias` gathers instead)."""

    def __init__(self, cfg, self_attention=LayoutLMv3SelfAttention):
        super().__init__()
        self.layer = nn.ModuleList(LayoutLMv3Layer(cfg, self_attention)
                                   for _ in range(cfg.num_hidden_layers))
        nh = cfg.num_attention_heads
        if cfg.has_relative_attention_bias:
            self.rel_pos_bias = nn.Linear(cfg.rel_pos_bins, nh, bias=False)
        if cfg.has_spatial_attention_bias:
            self.rel_pos_x_bias = nn.Linear(cfg.rel_2d_pos_bins, nh,
                                            bias=False)
            self.rel_pos_y_bias = nn.Linear(cfg.rel_2d_pos_bins, nh,
                                            bias=False)


class RelBiasBackbone(nn.Module):
    """What the rel-bias backbones (LayoutLMv3, and LayoutLMv2 in
    ``models/layoutlmv2.py``) share: an ``encoder`` of layers on one
    relative bias per forward with the three bucket tables, the bias build
    (:meth:`rel_bias`, divided by ``bias_div``), the layer loop with the
    per-layer dropout seeds and checkpointing (:meth:`run_layers`), and a
    cache of device tensors that depend on shapes only. Subclasses set
    ``cfg``, ``encoder`` and ``bias_div``."""

    bias_div = 1.0
    tp = NO_TP  # this rank's share of the heads: its rows of the bias

    def __init__(self):
        super().__init__()
        # per-layer recompute in the backward (PEneoConfig's switch)
        self.gradient_checkpointing = False
        # device tensors that depend on shapes only (bucket matrices, box
        # grids, the 2D bucket table), per device
        self._static = {}

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype: that of the encoder weights."""
        return self.encoder.layer[0].output.LayerNorm.weight.dtype

    def set_attention_impl(self, attention_impl: str) -> None:
        """``"kernel"`` (the default) or ``"plain"``: the plain twin on any
        device, for parity checks only."""
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}")
        for layer in self.encoder.layer:
            layer.attention.self.attention_impl = attention_impl

    def _keep_tables_fp32(self) -> None:
        for name in ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias"):
            if hasattr(self.encoder, name):
                getattr(self.encoder, name).float()

    def _static_tensor(self, key, make, device):
        key = key + (str(device),)
        if key not in self._static:
            # a normal tensor even when first asked for under
            # inference_mode: a later training step saves it for backward
            with torch.inference_mode(False):
                self._static[key] = torch.from_numpy(make()).to(device)
        return self._static[key]

    def _table(self, linear: nn.Linear) -> torch.Tensor:
        """A bucket table's (heads, bins) rows of this rank's heads."""
        if self.tp.size == 1:
            return linear.weight
        w = copy_to_tp(linear.weight, self.tp)
        return w[self.tp.part(w.shape[0])]

    def rel_bias(self, bbox, seq_len: int, n_vis: int):
        """The fp32 (B, nh, L', L') relative-position bias of boxes ``bbox``
        (B, L', 4), divided by ``bias_div`` (rows 16-byte aligned, see
        :class:`RelBias`), or zeros where the config has neither table.
        Under tp its nh / tp rows of this rank's heads."""
        cfg, enc = self.cfg, self.encoder
        B, Lp = bbox.shape[:2]
        if not (cfg.has_relative_attention_bias
                or cfg.has_spatial_attention_bias):
            return torch.zeros((1, 1, Lp, Lp), device=bbox.device).expand(
                B, cfg.num_attention_heads // self.tp.size, Lp, Lp)
        pad = -Lp % 4  # keys appended so that a row is a multiple of 4
        w1 = wx = wy = b1 = bx = by = None
        if cfg.has_relative_attention_bias:
            w1 = self._table(enc.rel_pos_bias)
            b1 = self._static_tensor(
                ("bucket", seq_len, n_vis),
                lambda: np.pad(static_rel_pos_bucket(
                    seq_len, n_vis, cfg.rel_pos_bins, cfg.max_rel_pos),
                    ((0, 0), (0, pad))), bbox.device)
        if cfg.has_spatial_attention_bias:
            wx, wy = (self._table(enc.rel_pos_x_bias),
                      self._table(enc.rel_pos_y_bias))
            cx, cy = bbox[:, :, 0], bbox[:, :, 3]
            bins, far = cfg.rel_2d_pos_bins, cfg.max_rel_2d_pos
            lut = self._static_tensor(
                ("lut", bins, far), lambda: bucket_table(bins, far).copy(),
                bbox.device)
            keys_x, keys_y = F.pad(cx, (0, pad)), F.pad(cy, (0, pad))
            bx = relative_position_bucket(
                keys_x[:, None, :] - cx[:, :, None], bins, far, lut)
            by = relative_position_bucket(
                keys_y[:, None, :] - cy[:, :, None], bins, far, lut)
        return RelBias.apply(w1, wx, wy, b1, bx, by, B, self.bias_div)

    def run_layers(self, x, mask, rel_bias,
                   generator: Optional[torch.Generator] = None):
        """The encoder's layers over ``x`` (B, L', H) with the key mask and
        the bias shared by all of them."""
        draw = self.training and self.cfg.attention_probs_dropout_prob > 0
        for i, layer in enumerate(self.encoder.layer):
            # the seed is drawn outside the checkpointed region: the
            # recompute replays the same mask
            seed = layer_seed(generator, i) if draw else 0
            if self.gradient_checkpointing and self.training:
                x = checkpoint(layer, x, mask, rel_bias, seed,
                               use_reentrant=False)
            else:
                x = layer(x, mask, rel_bias, seed)
        return x


class LayoutLMv3Model(RelBiasBackbone):
    """Full LayoutLMv3 encoder. ``forward`` returns a dict with
    ``last_hidden_state`` (B, L', H) over the text positions and, with an
    image, the 1 + (S/16)² visual tokens after them. The bias is divided by
    √d."""

    def __init__(self, cfg: LayoutLMv3Config):
        super().__init__()
        self.cfg = cfg
        self.embeddings = LayoutLMv3Embeddings(cfg)
        if cfg.visual_embed:
            self.grid = cfg.input_size // cfg.patch_size
            n_vis = self.grid * self.grid + 1
            self.patch_embed = PatchEmbed(cfg)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
            self.pos_embed = nn.Parameter(
                torch.zeros(1, n_vis, cfg.hidden_size))
            self.norm = nn.LayerNorm(cfg.hidden_size, eps=1e-6)
            self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                          eps=cfg.layer_norm_eps)
        self.encoder = LayoutLMv3Encoder(cfg)
        self.bias_div = math.sqrt(cfg.hidden_size // cfg.num_attention_heads)

    def cast(self, dtype: torch.dtype) -> "LayoutLMv3Model":
        """Cast to the compute dtype, keeping the embeddings (tables and
        their LayerNorm) and the three bucket tables in fp32: the embedding
        sum and the relative bias are fp32 whatever the compute dtype."""
        self.to(dtype)
        self.embeddings.float()
        self._keep_tables_fp32()
        return self

    def init_weights(self, generator: torch.Generator, std: float) -> None:
        """normal(std) weights (the patch conv too), zero biases, unit
        LayerNorms, zero ``cls_token`` / ``pos_embed``, zeroed padding rows
        (reference _init_weights, model/modeling_peneo.py:25-28)."""
        init_module_weights(self, generator, std)
        pad = self.cfg.pad_token_id
        with torch.no_grad():
            for emb in (self.embeddings.word_embeddings,
                        self.embeddings.position_embeddings):
                emb.weight[pad].zero_()
            if self.cfg.visual_embed:
                self.patch_embed.proj.weight.normal_(0.0, std,
                                                     generator=generator)
                self.patch_embed.proj.bias.zero_()
                self.cls_token.zero_()
                self.pos_embed.zero_()

    def forward(self, input_ids, bbox,
                attention_mask: Optional[torch.Tensor] = None,
                image: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``image`` (B, 3, S, S) normalised floats, or None for the
        text-only path. ``generator`` (CPU) draws each layer's
        attention-dropout seed in training mode (the default generator when
        None)."""
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        input_ids = input_ids.long()
        bbox = bbox.long()
        B, L = input_ids.shape
        x = self.embeddings(input_ids, bbox, self.dtype)
        n_vis = 0
        if image is not None:
            n_vis = self.grid * self.grid + 1
            patches = self.patch_embed(image.to(self.dtype))
            vis = torch.cat([self.cls_token.to(patches.dtype).expand(B, -1, -1),
                             patches], dim=1)
            vis = self.norm(vis + self.pos_embed.to(patches.dtype))
            # extra LN + dropout over the concatenated stream (:1113-1114)
            x = self.LayerNorm(torch.cat([x, vis.to(x.dtype)], dim=1))
            x = F.dropout(x.to(self.dtype), cfg.hidden_dropout_prob,
                          self.training)
            attention_mask = torch.cat(
                [attention_mask,
                 attention_mask.new_ones((B, n_vis))], dim=1)
            vis_box = self._static_tensor(
                ("visual_bbox",), lambda: visual_bbox(self.grid), bbox.device)
            bbox = torch.cat([bbox, vis_box[None].expand(B, -1, -1)], dim=1)
        mask = key_mask_bias(attention_mask)
        x = self.run_layers(x, mask, self.rel_bias(bbox, L, n_vis), generator)
        return {"last_hidden_state": x}
