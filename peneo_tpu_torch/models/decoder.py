"""PEneo decoder, inference path: shrink MLP, split handshaking combine,
block-wise upper-triangle pair head with five classifiers, on-device top-k
spot compaction and packing.

Counterpart of ``peneo_tpu/models/decoder.py`` (``:34-123, 149-216,
320-364, 426-490``). Parameter names are the reference's torch keys
(model/peneo_decoder.py): ``shrink_projection.{0,3}``,
``handshaking_kernel.combine_fc`` and ``{head}_fc.{0,3}`` (Sequential
indices of Linear → SiLU → Dropout → Linear; the dropout slots are identity
at inference).

``Linear([h_i; h_j]) = h_i·W_a + h_j·W_b + b``: the combine keeps the
reference's one ``(H, 2H)`` ``combine_fc`` weight and applies its two
column halves separately, so ``A = h·W_aᵀ + b`` and ``Bm = h·W_bᵀ`` are
computed once (O(L·H²)) and each row block's pair features are
``silu(A[:, i_blk, None] + Bm[:, None, j >= i_blk_start])`` — only the upper
triangle's columns, never the (B, L, L, 2H) concat.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import PEneoConfig

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


def pair_classifier(hidden: int, num_classes: int, num_layers: int) -> nn.Module:
    """Reference build_classifier (model/peneo_decoder.py:231-271): one
    Linear, or [Linear, SiLU, Dropout] × (n-1) + [Linear]."""
    if num_layers == 1:
        return nn.Linear(hidden, num_classes)
    layers = []
    for _ in range(num_layers - 1):
        layers += [nn.Linear(hidden, hidden), nn.SiLU(), nn.Identity()]
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


class PEneoDecoder(nn.Module):
    """Pair-extraction head stack (inference).

    ``forward(sequence_output)`` returns, per head, the compact top-k spots
    (``max_spots_per_head > 0``) or the dense ``tags``/``scores`` (B, Ld, Ld)
    maps; ``return_logits=True`` adds the dense ``logits`` (B, Ld, Ld, C)
    (lower triangle zero) and keeps the dense maps.
    """

    def __init__(self, cfg: PEneoConfig):
        super().__init__()
        self.cfg = cfg
        bc = cfg.backbone_config or {}
        backbone_hidden = bc.get("hidden_size", 768)
        d_in = cfg.downstream_input_size()
        if cfg.peneo_decoder_shrink:
            self.shrink_projection = nn.Sequential(
                nn.Linear(d_in, backbone_hidden), nn.SiLU(), nn.Identity(),
                nn.Linear(backbone_hidden, backbone_hidden // 2), nn.SiLU(),
                nn.Identity())
        else:
            self.shrink_projection = nn.Identity()
        dec_h = cfg.decoder_hidden_size()
        self.handshaking_kernel = HandshakingKernel(dec_h)
        for name in HEAD_NAMES:
            setattr(self, f"{name}_fc", pair_classifier(
                dec_h, HEAD_CLASSES[name], cfg.peneo_classifier_num_layers))

    def pair_block(self, a_blk, b_cols) -> Dict[str, torch.Tensor]:
        """One row block through the five heads: the pair features are
        computed once and shared; one classifier chain per head."""
        pair = F.silu(a_blk[:, :, None, :] + b_cols[:, None, :, :])
        return {name: getattr(self, f"{name}_fc")(pair) for name in HEAD_NAMES}

    def forward(self, sequence_output, return_logits: bool = False):
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

        result = {}
        k = cfg.max_spots_per_head
        for name in HEAD_NAMES:
            t = tags[name][:, :Ld, :Ld]
            s = scores[name][:, :Ld, :Ld]
            if k > 0 and not return_logits:
                result[name] = compact_spots(t, s, k)
            else:
                result[name] = {"tags": t, "scores": s}
            if return_logits:
                result[name]["logits"] = logits[name][:, :Ld, :Ld]
        return result


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
