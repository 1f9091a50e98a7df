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

Under sequence parallelism (:meth:`PEneoDecoder.set_sequence_parallel`) the
same blocks run over this rank's strided rows only, and the spots are merged
over the sp group (``parallel/seq_parallel.py``).

Under tensor parallelism (``parallel/tensor_parallel.py``) the shrink MLP
and the combine stay replicated: each rank computes a row block's pair
features whole, its columns of each head's ``fc_0`` (SiLU and dropout on
them) and its share of ``fc_out``'s product; the five heads' partial logits
are summed over the tp group in one fp32 all-reduce per block and the
biases added after it, so every tp rank holds the same logits. ``A`` and
``B`` enter through ``copy_to_tp``: each rank's gradient of them covers its
``fc_0`` columns only.
"""

from __future__ import annotations

import contextlib
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
from ..parallel import seq_parallel as sq
from ..parallel.tensor_parallel import (COL, NO_TP, compute_dtype,
                                        copy_to_tp, partial_linear,
                                        reduce_from_tp)

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
        self.sp = sq.SpShard()
        self.tp = NO_TP

    def set_sequence_parallel(self, index: int, size: int,
                              group=None) -> None:
        """Run the pair grid over rows ``index, index + size, …`` only and
        merge the spots over ``group`` (the sp group of
        ``parallel/dist.py``); the losses are then reduced over the whole
        process group."""
        if not 0 <= index < size:
            raise ValueError(f"sp index {index} out of [0, {size})")
        self.sp = sq.SpShard(index, size, group)

    def _split_heads(self) -> bool:
        """Whether the classifiers are split over a tp group (fc_0 by
        columns, fc_out by rows)."""
        return getattr(self.line_extraction_fc[0], "split", None) == COL

    def pair_block(self, a_blk, b_cols) -> Dict[str, torch.Tensor]:
        """One row block through the five heads: the pair features are
        computed once and shared (with the int8 head, quantized once too);
        one classifier chain per head, or under tp each head's partial
        logits and one reduce of all five."""
        pair = F.silu(a_blk[:, :, None, :] + b_cols[:, None, :, :])
        quantized = (quantize_rows(pair) if self.int8_pair_head
                     and not self.training else None)
        split = self._split_heads()
        if quantized is None and not split:
            return {name: getattr(self, f"{name}_fc")(pair)
                    for name in HEAD_NAMES}
        out = {}
        for name in HEAD_NAMES:
            first, *body, last = getattr(self, f"{name}_fc")
            x = first(pair, quantized)
            for layer in body:
                x = layer(x)
            out[name] = partial_linear(x, last.weight) if split else last(x)
        if not split:
            return out
        widths = [HEAD_CLASSES[name] for name in HEAD_NAMES]
        dtype = compute_dtype(pair)
        logits = reduce_from_tp(torch.cat([out[n] for n in HEAD_NAMES], -1),
                                self.tp).split(widths, -1)
        return {name: (lg + getattr(self, f"{name}_fc")[-1].bias.float()
                       ).to(dtype)
                for name, lg in zip(HEAD_NAMES, logits)}

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
        if self._split_heads():
            a, b = copy_to_tp(a, self.tp), copy_to_tp(b, self.tp)

        if self.sp.size > 1:
            return self._sp_forward(a, b, Ld, labels, also_decode,
                                    label_row_mask, return_logits)
        if self.training and self.tp.size > 1:
            with self._shard_rng(a.device):
                return self._grid_forward(a, b, Ld, labels, also_decode,
                                          label_row_mask, return_logits)
        return self._grid_forward(a, b, Ld, labels, also_decode,
                                  label_row_mask, return_logits)

    @contextlib.contextmanager
    def _shard_rng(self, dev):
        """The pair head's dropout on a stream of this rank's own per (tp,
        sp) index, as JAX folds it per shard (``seq_parallel.py:331-337``):
        its activations are split (tp) or its rows are (sp). The device's
        generator is left where the other ranks leave theirs, so that their
        next replicated forwards draw alike."""
        seed = int(torch.randint(0, 2 ** 62, ()))
        seed += self.sp.index + self.tp.index * self.sp.size
        with torch.random.fork_rng(
                devices=[dev] if dev.type == "cuda" else []):
            torch.default_generator.manual_seed(seed)
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    torch.cuda.manual_seed(seed)
            yield

    def _grid_forward(self, a, b, Ld, labels, also_decode, label_row_mask,
                      return_logits):
        """The whole pair grid in one process (or one tp cell)."""
        cfg = self.cfg
        B = a.shape[0]
        bs = min(cfg.pair_block_size, max(Ld, 8))
        Lp = ((Ld + bs - 1) // bs) * bs
        if Lp != Ld:
            a = F.pad(a, (0, 0, 0, Lp - Ld))
            b = F.pad(b, (0, 0, 0, Lp - Ld))
        if labels is not None:
            return self._losses(a, b, Ld, Lp, bs, labels, also_decode,
                                label_row_mask)

        dev = a.device
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

    def _loss_state(self, device):
        """The per-head loss accumulators: streaming OHEM states
        (``peneo_ohem_num_positive/negative`` not both -1), else weighted-CE
        (numerator, denominator) sums."""
        cfg = self.cfg
        if self.category_weights is None:
            raise ValueError("the losses need peneo_category_weights")
        if (cfg.peneo_ohem_num_positive != -1
                or cfg.peneo_ohem_num_negative != -1):
            return {name: ohem_stream_init(cfg.peneo_ohem_num_positive,
                                           cfg.peneo_ohem_num_negative,
                                           device)
                    for name in HEAD_NAMES}
        return {name: (0.0, 0.0) for name in HEAD_NAMES}

    def _fold_loss(self, acc, name, logits, targets, mask) -> None:
        """Fold one block's logits of head ``name`` into ``acc``."""
        weights = self.category_weights.float()
        w = weights[:2] if name == "line_extraction" else weights
        mask = mask.expand(logits.shape[:3])
        if isinstance(acc[name], dict):
            acc[name] = ohem_stream_update(acc[name], logits, targets, w,
                                           mask)
            return
        num, den = weighted_cross_entropy(logits, targets, w, mask,
                                          return_sum_and_weight=True)
        acc[name] = (acc[name][0] + num, acc[name][1] + den)

    def _finish_losses(self, acc, device, reduce: bool):
        """Accumulators → the five head losses and ``total``; with
        ``reduce`` over the process group's ranks (each holding a disjoint
        share: its slice of the global batch, its rows of the pair grid)."""
        if isinstance(acc[HEAD_NAMES[0]], dict):
            merge = pdist.ohem_stream_merge if reduce else (lambda st: st)
            parts = torch.stack([ohem_stream_final(merge(acc[name]))
                                 for name in HEAD_NAMES])
        else:
            den = torch.stack([torch.as_tensor(acc[n][1], device=device)
                               for n in HEAD_NAMES])
            if reduce:
                den = pdist.replica_sum(den)
            parts = torch.stack([torch.as_tensor(acc[n][0], device=device)
                                 for n in HEAD_NAMES]) / den.clamp_min(1e-12)
        if reduce:
            parts = pdist.global_losses(parts)
        losses = dict(zip(HEAD_NAMES, parts.unbind()))
        ratios = self.cfg.peneo_loss_ratio or [1.0] * 5
        losses["total"] = sum(r * losses[name]
                              for r, name in zip(ratios, HEAD_NAMES))
        return losses

    def _losses(self, a, b, Ld, Lp, bs, labels, also_decode, label_row_mask):
        """The five head losses over the upper triangle, block by block:
        weighted-CE sums, or with OHEM (``peneo_ohem_num_positive/negative``
        not both -1) each block's weighted CE folded into one streaming
        top-k state per head (``peneo_tpu/models/decoder.py:223-295``); with
        ``also_decode`` the argmax tags/scores of the same blocks. Under
        data parallelism (:meth:`PEneoModel.set_data_parallel`) the losses
        are the global batch's (``parallel/dist.py``)."""
        dev = a.device
        acc = self._loss_state(dev)
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
                self._fold_loss(acc, name, lg, lbl[name][:, r0:r0 + bs, r0:],
                                mask)
        losses = self._finish_losses(acc, dev, self.data_parallel)
        if also_decode:
            return losses, self._spot_outputs(tags, scores, Ld)
        return losses

    # ------------------------------------------------------ sequence parallel
    def sp_partials(self, a, b, Ld: int, index: int, size: int,
                    labels: Optional[Dict[str, torch.Tensor]] = None,
                    decode: bool = True, label_row_mask=None):
        """Shard ``index`` of ``size`` of the pair grid from the combine
        features ``a``, ``b`` (B, ≥Ld, H): the rows ``index, index + size,
        …`` below Ld, block by block (``pair_block_size / size`` local rows,
        which span ``pair_block_size`` rows of the grid as one process's
        blocks do; the columns from ``r0·size``). Returns (its :class:`~peneo_tpu_torch.
        parallel.seq_parallel.SpotCandidates` or None, its loss accumulators
        or None); nothing is reduced across ranks."""
        dev = a.device
        B = a.shape[0]
        if Ld < size:
            raise ValueError(f"sp {size} needs at least {size} rows of the "
                             f"pair grid, not {Ld}")
        rows = sq.local_rows(Ld, size, index, dev)
        a_loc = a.index_select(1, rows)
        spots = (sq.SpotCandidates(B, self.cfg.max_spots_per_head, Ld, dev)
                 if decode else None)
        acc = lbl = rowm = None
        if labels is not None:
            acc = self._loss_state(dev)
            lbl = {name: sq.local_labels(labels[name], Ld, size, index)
                   for name in HEAD_NAMES}
            if label_row_mask is not None:
                rowm = (label_row_mask > 0)[:, None, None]
        block = max(1, self.cfg.pair_block_size // size)
        for r0, n, col0 in sq.row_blocks(rows.numel(), block, size):
            g = rows[r0:r0 + n]
            a_blk, b_cols = a_loc[:, r0:r0 + n], b[:, col0:Ld]
            if labels is None:
                out = self.pair_block(a_blk, b_cols)
                blk = tuple(out[name] for name in HEAD_NAMES)
            else:
                blk = self._pair_logits(a_blk, b_cols)
            ok = g[:, None] <= torch.arange(col0, Ld, device=dev)[None]
            for hi, (name, lg) in enumerate(zip(HEAD_NAMES, blk)):
                if spots is not None:
                    spots.update(hi, lg, ok, g, col0)
                if labels is not None:
                    mask = ok[None] if rowm is None else ok[None] & rowm
                    self._fold_loss(acc, name, lg, lbl[name][:, r0:r0 + n,
                                                             col0:], mask)
        return spots, acc

    def _sp_forward(self, a, b, Ld, labels, also_decode, label_row_mask,
                    return_logits):
        """This rank's shard of the pair grid, its spots merged over the sp
        group and its losses reduced over the process group. The gradient
        of ``a`` and ``b`` is averaged over the sp group
        (:func:`~peneo_tpu_torch.parallel.dist.sp_mean_grad`): the layers
        below run one backward on the whole gradient, as one process does.
        A training forward draws the pair head's dropout from a stream of
        its own per sp rank (as JAX folds it per shard,
        ``seq_parallel.py:331-337``) and leaves the device's generator where
        the other sp ranks leave theirs, so that their next backbone
        forwards draw alike."""
        decode = labels is None or also_decode
        if decode and (self.cfg.max_spots_per_head <= 0 or return_logits):
            raise ValueError("sequence parallelism returns compact spots: "
                             "max_spots_per_head > 0, no dense logits")
        dev = a.device
        if self.sp.group is not None:
            a, b = pdist.sp_mean_grad(a, b)
        if self.training:
            with self._shard_rng(dev):
                spots, acc = self.sp_partials(
                    a, b, Ld, self.sp.index, self.sp.size, labels, decode,
                    label_row_mask)
        else:
            spots, acc = self.sp_partials(a, b, Ld, self.sp.index,
                                          self.sp.size, labels, decode,
                                          label_row_mask)
        out = None
        if spots is not None:
            gathered = (pdist.sp_gather(spots.packed())
                        if self.sp.group is not None else spots.packed()[None])
            out = sq.merge_spots(gathered, a.shape[0],
                                 self.cfg.max_spots_per_head, Ld, HEAD_NAMES)
        if labels is None:
            return out
        losses = self._finish_losses(acc, dev, pdist.world() > 1)
        return (losses, out) if also_decode else losses


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
