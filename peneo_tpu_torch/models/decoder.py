"""PEneo decoder: shrink MLP, split handshaking combine, block-wise
upper-triangle pair head with five classifiers; on-device top-k spot
compaction and packing (inference) and the losses (training and eval):
class-weighted CE or streaming OHEM, over one process's batch or, under
data parallelism, the global batch's.

Counterpart of ``peneo_tpu/models/decoder.py`` (``:34-364, 426-504``).
Parameter names are the reference's torch keys (model/peneo_decoder.py):
``shrink_projection.{0,3}``, ``handshaking_kernel.combine_fc`` and
``{head}_fc.{0,3}`` (Sequential indices of Linear → SiLU → Dropout →
Linear; dropout at ``hidden_dropout_prob``, active in training mode).

``Linear([h_i; h_j]) = h_i·W_a + h_j·W_b + b``: the combine keeps the
reference's one ``(H, 2H)`` ``combine_fc`` weight and applies its two
column halves separately, so ``A = h·W_aᵀ + b`` and ``Bm = h·W_bᵀ`` are
computed once (O(L·H²)) and each row block's pair features are
``silu(A[:, i_blk, None] + Bm[:, None, j >= i_blk_start])`` — only the upper
triangle's columns, never the (B, L, L, 2H) concat. In training each row
block's pair bank runs under ``torch.utils.checkpoint`` (the JAX package's
``nn.remat(PairBlockBank)``), so the pair features stay O(L·H) in memory.

Labels are per head either compact ``(B, S, 3)`` spot arrays, scattered
into dense matrices on the device, or dense int8 ``(B, Ld, Ld)`` matrices;
the loss covers the upper triangle of the first Ld positions, and
``label_row_mask`` drops rows (eval's edge-padded ragged batch) from it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import PEneoConfig
from ..ops.losses import (ohem_stream_final, ohem_stream_init,
                          ohem_stream_update, weighted_cross_entropy)
from ..ops.quant import QuantLinear, quantize_rows, set_int8
from ..parallel import dist as pdist

HEAD_NAMES = (
    "line_extraction",
    "ent_linking_h2h",
    "ent_linking_t2t",
    "line_grouping_h2h",
    "line_grouping_t2t",
)
HEAD_CLASSES = {
    "line_extraction": 2,
    "ent_linking_h2h": 3,
    "ent_linking_t2t": 3,
    "line_grouping_h2h": 3,
    "line_grouping_t2t": 3,
}


def pair_classifier(hidden: int, num_classes: int, num_layers: int,
                    dropout: float) -> nn.Module:
    """Reference build_classifier (model/peneo_decoder.py:231-271): one
    Linear, or [Linear, SiLU, Dropout] × (n-1) + [Linear]. The hidden H→H
    layers can run int8 (``quantize_pair_head``); the H→C output stays
    float."""
    if num_layers == 1:
        return nn.Linear(hidden, num_classes)
    layers = []
    for _ in range(num_layers - 1):
        layers += [QuantLinear(hidden, hidden), nn.SiLU(), nn.Dropout(dropout)]
    layers.append(nn.Linear(hidden, num_classes))
    return nn.Sequential(*layers)


class HandshakingKernel(nn.Module):
    """Holds the reference's ``combine_fc`` (H, 2H); applies it split."""

    def __init__(self, hidden: int):
        super().__init__()
        self.combine_fc = nn.Linear(2 * hidden, hidden)

    def forward(self, h):
        """(B, L, H) → (A, Bm), both (B, L, H)."""
        w = self.combine_fc.weight
        H = w.shape[0]
        return (F.linear(h, w[:, :H], self.combine_fc.bias),
                F.linear(h, w[:, H:]))


def dense_labels_from_spots(spots: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, S, 3) padded spot array → dense (B, seq_len, seq_len) int64
    labels, scattered on the spots' device. Spots are (i, j, tag); padding
    rows use i = j = seq_len (a border that is sliced off) or tag 0."""
    B, S, _ = spots.shape
    spots = spots.long()
    dense = torch.zeros((B, seq_len + 1, seq_len + 1), dtype=torch.int64,
                        device=spots.device)
    b_idx = torch.arange(B, device=spots.device)[:, None].expand(B, S)
    dense[b_idx, spots[..., 0], spots[..., 1]] = spots[..., 2]
    return dense[:, :seq_len, :seq_len]


def triu_valid_mask(row0: int, bs: int, n_cols: int, valid_len: int,
                    col0: int = 0, device=None) -> torch.Tensor:
    """(bs, n_cols) bool: upper-triangular and within the first valid_len.
    ``col0`` offsets the column coordinates (triu-sliced blocks)."""
    rows = row0 + torch.arange(bs, device=device)[:, None]
    cols = col0 + torch.arange(n_cols, device=device)[None, :]
    return (rows <= cols) & (rows < valid_len) & (cols < valid_len)


class PEneoDecoder(nn.Module):
    """Pair-extraction head stack.

    - ``labels`` None: per head the compact top-k spots
      (``max_spots_per_head > 0``) or the dense ``tags``/``scores``
      (B, Ld, Ld) maps; ``return_logits=True`` adds the dense ``logits``
      (B, Ld, Ld, C) (lower triangle zero) and keeps the dense maps.
    - ``labels`` given: the five head losses and ``total`` (reference
      model/peneo_decoder.py:375-428); with ``also_decode`` the pair
      ``(losses, outputs)`` from one pass over the grid.
    """

    def __init__(self, cfg: PEneoConfig):
        super().__init__()
        self.cfg = cfg
        bc = cfg.backbone_config or {}
        backbone_hidden = bc.get("hidden_size", 768)
        d_in = cfg.downstream_input_size()
        drop = bc.get("hidden_dropout_prob", 0.1)
        if cfg.peneo_decoder_shrink:
            self.shrink_projection = nn.Sequential(
                nn.Linear(d_in, backbone_hidden), nn.SiLU(), nn.Dropout(drop),
                nn.Linear(backbone_hidden, backbone_hidden // 2), nn.SiLU(),
                nn.Dropout(drop))
        else:
            self.shrink_projection = nn.Identity()
        dec_h = cfg.decoder_hidden_size()
        # the CE class weights live on the model's device, built once: a
        # host-to-device copy inside the step could not be captured in a
        # CUDA graph (not persistent: the state-dict keys stay the
        # reference's)
        weights = cfg.peneo_category_weights
        self.register_buffer("category_weights", None if weights is None
                             else torch.tensor(weights, dtype=torch.float32),
                             persistent=False)
        self.handshaking_kernel = HandshakingKernel(dec_h)
        for name in HEAD_NAMES:
            head = pair_classifier(dec_h, HEAD_CLASSES[name],
                                   cfg.peneo_classifier_num_layers, drop)
            setattr(self, f"{name}_fc", head)
            set_int8(head, cfg.quantize_pair_head == "int8")
        # the five heads' first layers read one input: quantize it once
        self.int8_pair_head = (cfg.quantize_pair_head == "int8"
                               and cfg.peneo_classifier_num_layers > 1)
        # the losses are the global batch's across the process group
        self.data_parallel = False

    def pair_block(self, a_blk, b_cols) -> Dict[str, torch.Tensor]:
        """One row block through the five heads: the pair features are
        computed once and shared (with the int8 head, quantized once too);
        one classifier chain per head."""
        pair = F.silu(a_blk[:, :, None, :] + b_cols[:, None, :, :])
        if not (self.int8_pair_head and not self.training):
            return {name: getattr(self, f"{name}_fc")(pair)
                    for name in HEAD_NAMES}
        quantized = quantize_rows(pair)
        out = {}
        for name in HEAD_NAMES:
            first, *rest = getattr(self, f"{name}_fc")
            x = first(pair, quantized)
            for layer in rest:
                x = layer(x)
            out[name] = x
        return out

    def _pair_logits(self, a_blk, b_cols):
        """The five heads' logits of one row block as a tuple, recomputed in
        the backward when gradients are being recorded."""
        def bank(x, y):
            out = self.pair_block(x, y)
            return tuple(out[name] for name in HEAD_NAMES)

        if torch.is_grad_enabled() and (a_blk.requires_grad
                                        or b_cols.requires_grad):
            return checkpoint(bank, a_blk, b_cols, use_reentrant=False)
        return bank(a_blk, b_cols)

    def forward(self, sequence_output, return_logits: bool = False,
                labels: Optional[Dict[str, torch.Tensor]] = None,
                also_decode: bool = False,
                label_row_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, Ld, _ = sequence_output.shape
        dtype = self.handshaking_kernel.combine_fc.weight.dtype
        h = self.shrink_projection(sequence_output.to(dtype))
        a, b = self.handshaking_kernel(h)

        bs = min(cfg.pair_block_size, max(Ld, 8))
        Lp = ((Ld + bs - 1) // bs) * bs
        if Lp != Ld:
            a = F.pad(a, (0, 0, 0, Lp - Ld))
            b = F.pad(b, (0, 0, 0, Lp - Ld))
        if labels is not None:
            return self._losses(a, b, Ld, Lp, bs, labels, also_decode,
                                label_row_mask)

        dev = sequence_output.device
        tags = {n: torch.zeros((B, Lp, Lp), dtype=torch.int32, device=dev)
                for n in HEAD_NAMES}
        scores = {n: torch.zeros((B, Lp, Lp), dtype=torch.float32, device=dev)
                  for n in HEAD_NAMES}
        logits = ({n: torch.zeros((B, Lp, Lp, HEAD_CLASSES[n]),
                                  dtype=torch.float32, device=dev)
                   for n in HEAD_NAMES} if return_logits else None)
        for r0 in range(0, Lp, bs):
            # triu only: row block r0 needs columns >= r0; the skipped lower
            # triangle stays zero (never read: decode keeps i <= j)
            out = self.pair_block(a[:, r0:r0 + bs], b[:, r0:])
            for name in HEAD_NAMES:
                lg = out[name].float()
                p = torch.softmax(lg, dim=-1)
                s_blk, t_blk = torch.max(p, dim=-1)
                tags[name][:, r0:r0 + bs, r0:] = t_blk.to(torch.int32)
                scores[name][:, r0:r0 + bs, r0:] = s_blk
                if return_logits:
                    logits[name][:, r0:r0 + bs, r0:] = lg

        result = self._spot_outputs(tags, scores, Ld, return_logits)
        if return_logits:
            for name in HEAD_NAMES:
                result[name]["logits"] = logits[name][:, :Ld, :Ld]
        return result

    def _spot_outputs(self, tags, scores, Ld, dense: bool = False):
        k = self.cfg.max_spots_per_head
        result = {}
        for name in HEAD_NAMES:
            t = tags[name][:, :Ld, :Ld]
            s = scores[name][:, :Ld, :Ld]
            if k > 0 and not dense:
                result[name] = compact_spots(t, s, k)
            else:
                result[name] = {"tags": t, "scores": s}
        return result

    def _losses(self, a, b, Ld, Lp, bs, labels, also_decode, label_row_mask):
        """The five head losses over the upper triangle, block by block:
        weighted-CE sums, or with OHEM (``peneo_ohem_num_positive/negative``
        not both -1) each block's weighted CE folded into one streaming
        top-k state per head (``peneo_tpu/models/decoder.py:223-295``); with
        ``also_decode`` the argmax tags/scores of the same blocks. Under
        data parallelism (:meth:`PEneoModel.set_data_parallel`) the losses
        are the global batch's (``parallel/dist.py``)."""
        cfg = self.cfg
        dev = a.device
        if self.category_weights is None:
            raise ValueError("the losses need peneo_category_weights")
        weights = self.category_weights.float()
        ohem = (cfg.peneo_ohem_num_positive != -1
                or cfg.peneo_ohem_num_negative != -1)
        if ohem:
            acc = {name: ohem_stream_init(cfg.peneo_ohem_num_positive,
                                          cfg.peneo_ohem_num_negative, dev)
                   for name in HEAD_NAMES}
        lbl = {}
        for name in HEAD_NAMES:
            m = labels[name]
            if m.dim() == 3 and m.shape[-1] == 3 and m.shape[1] != m.shape[2]:
                m = dense_labels_from_spots(m, Lp)   # compact spots
            else:
                m = m.long()                          # dense int8
                if Lp != Ld:
                    m = F.pad(m, (0, Lp - Ld, 0, Lp - Ld))
            lbl[name] = m
        rowm = (None if label_row_mask is None
                else (label_row_mask > 0)[:, None, None])
        nums = {name: 0.0 for name in HEAD_NAMES}
        dens = {name: 0.0 for name in HEAD_NAMES}
        B = a.shape[0]
        if also_decode:
            tags = {n: torch.zeros((B, Lp, Lp), dtype=torch.int32, device=dev)
                    for n in HEAD_NAMES}
            scores = {n: torch.zeros((B, Lp, Lp), dtype=torch.float32,
                                     device=dev) for n in HEAD_NAMES}
        for r0 in range(0, Lp, bs):
            blk = self._pair_logits(a[:, r0:r0 + bs], b[:, r0:])
            mask = triu_valid_mask(r0, bs, Lp - r0, Ld, col0=r0,
                                   device=dev)[None]
            if rowm is not None:
                mask = mask & rowm
            for name, lg in zip(HEAD_NAMES, blk):
                if also_decode:
                    s_blk, t_blk = torch.max(
                        torch.softmax(lg.float(), dim=-1), dim=-1)
                    tags[name][:, r0:r0 + bs, r0:] = t_blk.to(torch.int32)
                    scores[name][:, r0:r0 + bs, r0:] = s_blk
                w = weights[:2] if name == "line_extraction" else weights
                tgt = lbl[name][:, r0:r0 + bs, r0:]
                if ohem:
                    acc[name] = ohem_stream_update(acc[name], lg, tgt, w,
                                                   mask.expand(lg.shape[:3]))
                    continue
                num, den = weighted_cross_entropy(
                    lg, tgt, w, mask.expand(lg.shape[:3]),
                    return_sum_and_weight=True)
                nums[name] = nums[name] + num
                dens[name] = dens[name] + den
        if ohem:
            merge = (pdist.ohem_stream_merge if self.data_parallel
                     else (lambda state: state))
            parts = torch.stack([ohem_stream_final(merge(acc[name]))
                                 for name in HEAD_NAMES])
        else:
            den = torch.stack([torch.as_tensor(dens[n], device=dev)
                               for n in HEAD_NAMES])
            if self.data_parallel:
                den = pdist.all_sum(den)
            parts = torch.stack([torch.as_tensor(nums[n], device=dev)
                                 for n in HEAD_NAMES]) / den.clamp_min(1e-12)
        if self.data_parallel:
            parts = pdist.global_losses(parts)
        losses = dict(zip(HEAD_NAMES, parts.unbind()))
        ratios = cfg.peneo_loss_ratio or [1.0] * 5
        losses["total"] = sum(r * losses[name]
                              for r, name in zip(ratios, HEAD_NAMES))
        if also_decode:
            return losses, self._spot_outputs(tags, scores, Ld)
        return losses


def compact_spots(tags: torch.Tensor, scores: torch.Tensor, k: int):
    """Dense (B, L, L) argmax maps → the top-k nonzero upper-triangle spots
    of each sample (exact ``torch.topk``). Empty slots score -1; the host
    restores row-major spot order by sorting the flat indices
    (pipeline/decode.py); ``spot_count`` flags overflow."""
    B, L, _ = tags.shape
    dev = tags.device
    triu = torch.ones((L, L), dtype=torch.bool, device=dev).triu()
    valid = triu[None] & (tags != 0)
    k = min(k, L * L)
    flat_scores = torch.where(valid, scores,
                              torch.full_like(scores, -1.0)).reshape(B, L * L)
    top_scores, top_idx = torch.topk(flat_scores, k, dim=1)
    top_tags = torch.gather(tags.reshape(B, L * L), 1, top_idx)
    count = valid.reshape(B, L * L).sum(dim=1)
    return {
        "spot_idx": top_idx.to(torch.int32),        # flat i*L + j
        "spot_tag": top_tags.to(torch.int8),
        "spot_score": top_scores,                   # -1 marks empty slots
        "spot_count": count.to(torch.int32),
        "seq_len": torch.full((B,), L, dtype=torch.int32, device=dev),
    }


def pack_spots(out):
    """The five heads' compact-spot dicts → two int32 tensors (two
    device→host copies per batch instead of 25). Scores are bit-cast, so
    ``pipeline/decode.unpack_spots`` restores float32 exactly.

    Returns (big (5, 3, B, k) int32 = [idx, tag, score-bits],
             small (5, 2, B) int32 = [count, seq_len]).
    """
    big = torch.stack([
        torch.stack([
            out[n]["spot_idx"].to(torch.int32),
            out[n]["spot_tag"].to(torch.int32),
            out[n]["spot_score"].to(torch.float32).contiguous().view(torch.int32),
        ]) for n in HEAD_NAMES])
    small = torch.stack([
        torch.stack([out[n]["spot_count"].to(torch.int32),
                     out[n]["seq_len"].to(torch.int32)])
        for n in HEAD_NAMES])
    return big, small
