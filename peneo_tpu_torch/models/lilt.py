"""LiLT backbone in PyTorch — dual-stream (text + layout) transformer.

Counterpart of ``peneo_tpu/models/lilt.py``. Module and parameter names are
the reference's torch key names (model/backbone/lilt/modeling_lilt.py), so a
reference ``pytorch_model.bin`` loads unchanged and
``peneo_tpu/models/convert.py`` reads the port's ``state_dict``.

BiACM: the reference's text and layout streams share ONE coupled score
matrix ``s_t/√d + s_l/√(d/r)`` and one softmax; each stream applies it to its
own values. In eval mode that runs through
:func:`peneo_tpu_torch.ops.biacm_attention.biacm_attention` (kernel #1 on the
card, its plain twin on the CPU); in training mode through
:func:`~peneo_tpu_torch.ops.biacm_attention.biacm_attention_train` (kernels
#2/#3 with attention dropout drawn on the card, two masks, one per
stream), each
layer drawing one seed per step from the ``generator`` its caller passes.
``LiltModel.set_attention_impl("plain")`` forces the plain twins on any
device (tests and the on-card parity checks only). Hidden dropout is
``F.dropout`` on the embeddings and in every ``ResidualOutput``;
``gradient_checkpointing`` recomputes each layer in the backward, with the
attention seed drawn outside the checkpoint so the recompute replays the
same masks (hidden dropout replays through the checkpoint's saved RNG
state).

The text embedding sum and LayerNorm run in fp32 and only the output is cast
to the compute dtype (the embedding tables stay fp32; see
:meth:`LiltModel.cast`).

Under tensor parallelism (``parallel/tensor_parallel.py``) each rank holds
``nh / tp`` heads of both streams: the q/k/v projections and the
intermediate layers are column-parallel, the attention outputs and MLP
outputs row-parallel, the word table vocab-parallel; the kernels run on the
(B, nh/tp, L, d) strided views as they do at nh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LiltConfig
from ..ops.biacm_attention import (attention_dropout_bits, biacm_attention,
                                   biacm_attention_reference,
                                   biacm_attention_train,
                                   biacm_attention_train_reference)
from ..ops.quant import QuantLinear
from ..parallel.tensor_parallel import (COL, NO_TP, copy_to_tp,
                                        vocab_embedding)
from .dropout_seeds import layer_seed

ACT = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}

ATTENTION_IMPLS = ("kernel", "plain")


def make_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa-style pad-aware position ids: cumsum over non-pad tokens,
    offset by the pad id (reference: modeling_lilt.py:1000-1015)."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def key_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} → (B, L) fp32 additive bias, finfo(f32).min/2 on pads
    (finite, so fully padded score tiles never give inf − inf)."""
    neg = torch.finfo(torch.float32).min / 2
    return (1.0 - attention_mask.to(torch.float32)) * neg


class LiltTextEmbeddings(nn.Module):
    def __init__(self, cfg: LiltConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout_prob

    def forward(self, input_ids, position_ids, dtype):
        # token_type_ids are always zeros in the PEneo pipeline
        x = (word_lookup(self.word_embeddings, input_ids)
             + self.token_type_embeddings.weight[0]
             + self.position_embeddings(position_ids))
        x = self.LayerNorm(x.float()).to(dtype)
        return F.dropout(x, self.dropout, self.training)


def word_lookup(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``table(ids)``, or the vocab-parallel lookup of a split table."""
    tp = getattr(table, "tp", NO_TP)
    return table(ids) if tp.size == 1 else vocab_embedding(ids, table, tp)


class LiltLayoutEmbeddings(nn.Module):
    """x/y/h/w bucket embeddings of the [0,1000] bbox, concat → linear → +
    box position embedding → LayerNorm (modeling_lilt.py:133-210)."""

    def __init__(self, cfg: LiltConfig):
        super().__init__()
        sixth = cfg.hidden_size // 6
        lay_h = cfg.hidden_size // cfg.channel_shrink_ratio
        n2d = cfg.max_2d_position_embeddings
        self.x_position_embeddings = nn.Embedding(n2d, sixth)
        self.y_position_embeddings = nn.Embedding(n2d, sixth)
        self.h_position_embeddings = nn.Embedding(n2d, sixth)
        self.w_position_embeddings = nn.Embedding(n2d, sixth)
        self.box_linear_embeddings = nn.Linear(6 * sixth, lay_h)
        self.box_position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, lay_h)
        self.LayerNorm = nn.LayerNorm(lay_h, eps=cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout_prob

    def forward(self, bbox, position_ids):
        x, y = self.x_position_embeddings, self.y_position_embeddings
        spatial = torch.cat([
            x(bbox[:, :, 0]), y(bbox[:, :, 1]), x(bbox[:, :, 2]),
            y(bbox[:, :, 3]),
            self.h_position_embeddings(bbox[:, :, 3] - bbox[:, :, 1]),
            self.w_position_embeddings(bbox[:, :, 2] - bbox[:, :, 0]),
        ], dim=-1)
        out = (self.box_linear_embeddings(spatial)
               + self.box_position_embeddings(position_ids))
        return F.dropout(self.LayerNorm(out), self.dropout, self.training)


class LiltSelfAttention(nn.Module):
    """Dual-stream attention with BiACM score sharing
    (modeling_lilt.py:328-425); under tp on this rank's ``nh / tp`` heads of
    each stream."""

    tp = NO_TP

    def __init__(self, cfg: LiltConfig):
        super().__init__()
        h = cfg.hidden_size
        lay_h = h // cfg.channel_shrink_ratio
        self.nh = cfg.num_attention_heads
        self.dh = h // self.nh
        self.dh_l = self.dh // cfg.channel_shrink_ratio
        self.attention_impl = "kernel"
        self.dropout = cfg.attention_probs_dropout_prob
        self.query = QuantLinear(h, h)
        self.key = QuantLinear(h, h)
        self.value = QuantLinear(h, h)
        self.layout_query = QuantLinear(lay_h, lay_h)
        self.layout_key = QuantLinear(lay_h, lay_h)
        self.layout_value = QuantLinear(lay_h, lay_h)

    def forward(self, text, layout, bias, seed: int = 0):
        """``seed`` keys the attention-dropout masks of a training step."""
        B, L, _ = text.shape
        nh = self.nh // self.tp.size
        text, layout = copy_to_tp(text, self.tp), copy_to_tp(layout, self.tp)

        def heads(lin, x, d):
            # (B, L, nh, d) projection viewed as (B, nh, L, d): no copy, the
            # kernels read it through strides
            return lin(x).view(B, L, nh, d).transpose(1, 2)

        qkv = (heads(self.query, text, self.dh), heads(self.key, text, self.dh),
               heads(self.value, text, self.dh),
               heads(self.layout_query, layout, self.dh_l),
               heads(self.layout_key, layout, self.dh_l),
               heads(self.layout_value, layout, self.dh_l))
        scales = (1.0 / self.dh ** 0.5, 1.0 / self.dh_l ** 0.5)
        plain = self.attention_impl == "plain"
        if not self.training:
            fn = biacm_attention_reference if plain else biacm_attention
            ctx_t, ctx_l = fn(*qkv, bias, *scales)
        elif plain:
            bits = (attention_dropout_bits(seed, B, nh, L, text.device)
                    if self.dropout > 0 else None)
            ctx_t, ctx_l = biacm_attention_train_reference(
                *qkv, bias, bits, *scales, self.dropout)
        else:
            ctx_t, ctx_l = biacm_attention_train(*qkv, bias, seed, *scales,
                                                 self.dropout)
        return (ctx_t.transpose(1, 2).reshape(B, L, nh * self.dh),
                ctx_l.transpose(1, 2).reshape(B, L, nh * self.dh_l))


class ResidualOutput(nn.Module):
    """Dense → dropout → LayerNorm(x + residual) (modeling_lilt.py:432-443)."""

    def __init__(self, d_in: int, d_out: int, eps: float, dropout: float):
        super().__init__()
        self.dense = QuantLinear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)
        self.dropout = dropout

    def forward(self, x, residual):
        x = F.dropout(self.dense(x), self.dropout, self.training)
        return self.LayerNorm(x + residual)


class Intermediate(nn.Module):
    """Dense + activation, the first half of the MLP (modeling_lilt.py:511-520);
    a column-parallel dense takes its input through ``copy_to_tp``."""

    def __init__(self, d_in: int, d_out: int, act: str):
        super().__init__()
        self.dense = QuantLinear(d_in, d_out)
        self.act = ACT[act]

    def forward(self, x):
        if self.dense.split == COL:
            x = copy_to_tp(x, self.dense.tp)
        return self.act(self.dense(x))


class LiltAttention(nn.Module):
    def __init__(self, cfg: LiltConfig):
        super().__init__()
        h = cfg.hidden_size
        lay_h = h // cfg.channel_shrink_ratio
        self.self = LiltSelfAttention(cfg)
        eps, p = cfg.layer_norm_eps, cfg.hidden_dropout_prob
        self.output = ResidualOutput(h, h, eps, p)
        self.layout_output = ResidualOutput(lay_h, lay_h, eps, p)

    def forward(self, text, layout, bias, seed: int = 0):
        ctx_t, ctx_l = self.self(text, layout, bias, seed)
        return self.output(ctx_t, text), self.layout_output(ctx_l, layout)


class LiltLayer(nn.Module):
    def __init__(self, cfg: LiltConfig):
        super().__init__()
        h, r = cfg.hidden_size, cfg.channel_shrink_ratio
        eps, p = cfg.layer_norm_eps, cfg.hidden_dropout_prob
        self.attention = LiltAttention(cfg)
        self.intermediate = Intermediate(h, cfg.intermediate_size,
                                         cfg.hidden_act)
        self.output = ResidualOutput(cfg.intermediate_size, h, eps, p)
        self.layout_intermediate = Intermediate(
            h // r, cfg.intermediate_size // r, cfg.hidden_act)
        self.layout_output = ResidualOutput(cfg.intermediate_size // r,
                                            h // r, eps, p)

    def forward(self, text, layout, bias, seed: int = 0):
        text, layout = self.attention(text, layout, bias, seed)
        text = self.output(self.intermediate(text), text)
        layout = self.layout_output(self.layout_intermediate(layout), layout)
        return text, layout


class LiltEncoder(nn.Module):
    def __init__(self, cfg: LiltConfig):
        super().__init__()
        self.layer = nn.ModuleList(LiltLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class LiltModel(nn.Module):
    """Full LiLT encoder. ``forward`` returns a dict with
    ``last_hidden_state = concat(semantic, layout)`` (B, L, H + H/r) and the
    two streams."""

    def __init__(self, cfg: LiltConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = LiltTextEmbeddings(cfg)
        self.layout_embeddings = LiltLayoutEmbeddings(cfg)
        self.encoder = LiltEncoder(cfg)
        # per-layer recompute in the backward (PEneoConfig's switch)
        self.gradient_checkpointing = False

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype: that of the encoder weights."""
        return self.layout_embeddings.box_linear_embeddings.weight.dtype

    def set_attention_impl(self, attention_impl: str) -> None:
        """``"kernel"`` (the default) or ``"plain"``: the plain twin on any
        device, for parity checks only."""
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}")
        for layer in self.encoder.layer:
            layer.attention.self.attention_impl = attention_impl

    def cast(self, dtype: torch.dtype) -> "LiltModel":
        """Cast to the compute dtype, keeping the text embeddings (tables and
        their LayerNorm) in fp32: the sum and LayerNorm run in fp32."""
        self.to(dtype)
        self.embeddings.float()
        return self

    def init_weights(self, generator: torch.Generator, std: float) -> None:
        """normal(std) weights, zero biases, unit LayerNorms, zeroed padding
        rows (reference _init_weights, model/modeling_peneo.py:25-28)."""
        init_module_weights(self, generator, std)
        pad = self.cfg.pad_token_id
        with torch.no_grad():
            for emb in (self.embeddings.word_embeddings,
                        self.embeddings.position_embeddings,
                        self.layout_embeddings.box_position_embeddings):
                emb.weight[pad].zero_()

    def forward(self, input_ids, bbox, attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``generator`` (CPU) draws each layer's attention-dropout seed in
        training mode (the default generator when None); a
        :class:`~peneo_tpu_torch.models.dropout_seeds.StepSeeds` gives them
        as device tensors instead (a CUDA graph of the step)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        input_ids = input_ids.long()
        bbox = bbox.long()
        position_ids = make_position_ids(input_ids, self.cfg.pad_token_id)
        bias = key_mask_bias(attention_mask)
        text = self.embeddings(input_ids, position_ids, self.dtype)
        layout = self.layout_embeddings(bbox, position_ids)
        draw = self.training and self.cfg.attention_probs_dropout_prob > 0
        for i, layer in enumerate(self.encoder.layer):
            # the seed is drawn outside the checkpointed region: the
            # recompute replays the same masks
            seed = layer_seed(generator, i) if draw else 0
            if self.gradient_checkpointing and self.training:
                text, layout = checkpoint(layer, text, layout, bias, seed,
                                          use_reentrant=False)
            else:
                text, layout = layer(text, layout, bias, seed)
        return {
            "last_hidden_state": torch.cat([text, layout], dim=-1),
            "semantic_output": text,
            "layout_output": layout,
        }


def init_module_weights(module: nn.Module, generator: torch.Generator,
                        std: float) -> None:
    """normal(0, std) for every Linear/Embedding weight (drawn from
    ``generator`` on the weight's device), zero biases, unit LayerNorms."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
