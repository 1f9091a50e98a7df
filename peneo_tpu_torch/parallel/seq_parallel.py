"""Sequence parallelism (sp) of the O(L²) pair grid: its rows split over
the ranks of an sp group.

Counterpart of ``peneo_tpu/parallel/seq_parallel.py`` (``sp_pair_spots``,
``sp_pair_losses``, ``sp_pair_eval``), over processes instead of a mesh
axis. Every rank of an sp group holds the whole model and runs the whole
backbone on the same rows of the batch; the decoder
(``models/decoder.py``, :meth:`PEneoDecoder.sp_partials`) then runs the pair
head over this rank's rows only, block by block, with the single-device
path's ``pair_block``:

- **Strided rows**: rank ``s`` of ``sp`` owns the global rows ``s, s+sp,
  s+2·sp, …`` below Ld (``_strided_perm``, ``:49-70``): the upper triangle's
  work is balanced to within one row, where contiguous slabs would give the
  first rank about twice the last one's. No row padding: the last local
  block is ragged.
- **Column skip**: a local block starting at local row ``r0`` covers global
  rows from ``r0·sp + s ≥ r0·sp``, so its columns start at ``r0·sp``
  (exactly; the JAX package skips in steps of 128, ``:124-131``).
- **Spots**: each rank keeps one int64 key per candidate (the score's
  bits, then the flat index descending, then the tag) and takes its top k
  per head once, over all its blocks, as JAX does; a top k over keys is
  the top k in (score descending, flat index ascending) order, JAX's merge
  order (``_finalize_spots``, ``:157-192``).
  The sp group gathers the k keys of every rank (:func:`parallel.dist.
  sp_gather`, a few KB) and takes the top k again; ``spot_count`` is summed
  over the group; ``seq_len`` is the true Ld. Where scores tie at the k-th
  place, the lowest flat indices are kept, on one rank or many.
- **Losses**: each rank's CE sums and OHEM state cover its rows only; they
  are reduced over the whole world (``parallel/dist.py`` ``all_sum``,
  ``ohem_stream_merge``, ``global_losses``), since the shares of the ranks
  of a ``dp × sp`` grid are disjoint.
- **Labels**: a rank scatters only its rows of each head's label grid,
  (B, ⌈(Ld - s)/sp⌉, Ld), never the whole (B, Ld, Ld) one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

N_HEADS = 5
_FLAT_MAX = (1 << 30) - 1   # flat indices i·Ld + j below 2^30: Ld ≤ 32768
_LOW = (1 << 32) - 1
EMPTY = -1                  # the key of an empty slot (below every spot's)


@dataclass(frozen=True)
class SpShard:
    """This rank's place in its sp group: its ``index`` of ``size``, and the
    group (None: no collective, a shard computed in one process)."""

    index: int = 0
    size: int = 1
    group: Optional[object] = None


def local_rows(valid_len: int, sp: int, s: int, device=None) -> torch.Tensor:
    """Rank ``s``'s global rows of the pair grid: ``s, s+sp, …`` below
    ``valid_len``."""
    return torch.arange(s, valid_len, sp, device=device)


def row_blocks(n_local: int, block: int, sp: int):
    """The local row blocks: (first local row r0, rows in the block, first
    column ``r0·sp``)."""
    for r0 in range(0, n_local, block):
        yield r0, min(block, n_local - r0), r0 * sp


def local_labels(m: torch.Tensor, valid_len: int, sp: int,
                 s: int) -> torch.Tensor:
    """One head's labels → rank ``s``'s rows of the dense grid, (B, n_local,
    Ld) int64. ``m`` is a (B, S, 3) spot array (i, j, tag; padding rows at
    the border or with tag 0) or a dense (B, ≥Ld, ≥Ld) grid."""
    n_local = len(range(s, valid_len, sp))
    if m.dim() == 3 and m.shape[-1] == 3 and m.shape[1] != m.shape[2]:
        B, S, _ = m.shape
        m = m.long()
        i, j, tag = m.unbind(-1)
        mine = (i % sp == s) & (i < valid_len) & (j < valid_len)
        rows = torch.where(mine, i // sp, n_local)   # else the border row
        cols = torch.where(mine, j, valid_len)
        dense = torch.zeros((B, n_local + 1, valid_len + 1),
                            dtype=torch.int64, device=m.device)
        b_idx = torch.arange(B, device=m.device)[:, None].expand(B, S)
        dense[b_idx, rows, cols] = tag
        return dense[:, :n_local, :valid_len]
    return m[:, s:valid_len:sp, :valid_len].long()


def spot_keys(scores: torch.Tensor, tags: torch.Tensor, flat: torch.Tensor,
              ok: torch.Tensor) -> torch.Tensor:
    """int64 sort keys of candidate spots: the fp32 score's bits (positive,
    so ordered as the scores), then ``_FLAT_MAX - flat`` (ties go to the
    lower flat index), then the tag in the two lowest bits; ``EMPTY`` where
    ``ok`` is false or the tag is 0."""
    bits = scores.float().contiguous().view(torch.int32).long()
    low = ((_FLAT_MAX - flat) << 2) | tags.long()
    return torch.where(ok & (tags != 0), (bits << 32) | low,
                       torch.full_like(low, EMPTY))


def decode_keys(keys: torch.Tensor):
    """Keys → (flat index int32, tag int8, score fp32); empty slots give
    index 0, tag 0, score -1."""
    full = keys >= 0
    score = (keys >> 32).to(torch.int32).view(torch.float32)
    flat = _FLAT_MAX - ((keys & _LOW) >> 2)
    return (torch.where(full, flat, 0).to(torch.int32),
            torch.where(full, keys & 3, 0).to(torch.int8),
            torch.where(full, score, torch.full_like(score, -1.0)))


class SpotCandidates:
    """One rank's spot candidates of each head, as keys (:func:`spot_keys`)
    block by block, and its count of nonzero-tag positions. :meth:`packed`
    takes each head's top k once, over all blocks: the keys of a rank's
    rows are O(L²/sp) int64 per head, the same order as its share of the
    grid itself."""

    def __init__(self, batch: int, k: int, valid_len: int, device) -> None:
        if valid_len * valid_len > _FLAT_MAX:
            raise ValueError(f"sp spot keys hold flat indices below 2^30; "
                             f"Ld = {valid_len} is too long")
        self.k = min(k, valid_len * valid_len)
        self.valid_len = valid_len
        # an empty block of k: a rank with fewer candidates still has k
        self.keys = [[torch.full((batch, self.k), EMPTY, dtype=torch.int64,
                                 device=device)] for _ in range(N_HEADS)]
        self.count = torch.zeros((N_HEADS, batch), dtype=torch.int64,
                                 device=device)

    def update(self, head: int, logits: torch.Tensor, ok: torch.Tensor,
               rows: torch.Tensor, col0: int) -> None:
        """Add one block's (B, n, ncols, C) logits of global ``rows`` and
        columns from ``col0``: argmax tag and max probability, as the
        single-device ``compact_spots`` reads them."""
        B, n, ncols, _ = logits.shape
        score, tag = torch.max(torch.softmax(logits.float(), dim=-1), dim=-1)
        cols = torch.arange(col0, col0 + ncols, device=rows.device)
        flat = rows[:, None].long() * self.valid_len + cols[None, :]
        keys = spot_keys(score, tag, flat[None], ok[None])
        self.count[head] += ((tag != 0) & ok[None]).sum((1, 2))
        self.keys[head].append(keys.reshape(B, n * ncols))

    def packed(self) -> torch.Tensor:
        """Each head's top-k keys and the counts as one int64 vector (one
        gather)."""
        top = [torch.topk(torch.cat(keys, 1), self.k, dim=1,
                          sorted=False).values for keys in self.keys]
        return torch.cat([torch.stack(top).reshape(-1),
                          self.count.reshape(-1)])


def merge_spots(packed: torch.Tensor, batch: int, k: int,
                valid_len: int, names) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every rank's :meth:`SpotCandidates.packed` (sp, n) → the group's
    compact spots per head, in the single-device layout (``spot_idx``,
    ``spot_tag``, ``spot_score``, ``spot_count``, ``seq_len``): the top k
    of all ranks' keys, counts summed."""
    sp = packed.shape[0]
    k = min(k, valid_len * valid_len)
    n_keys = N_HEADS * batch * k
    keys = packed[:, :n_keys].view(sp, N_HEADS, batch, k)
    count = packed[:, n_keys:].view(sp, N_HEADS, batch).sum(0)
    keys = keys.permute(1, 2, 0, 3).reshape(N_HEADS, batch, sp * k)
    top = torch.topk(keys, k, dim=-1).values
    idx, tag, score = decode_keys(top)
    seq_len = torch.full((batch,), valid_len, dtype=torch.int32,
                         device=packed.device)
    return {name: {"spot_idx": idx[hi], "spot_tag": tag[hi],
                   "spot_score": score[hi],
                   "spot_count": count[hi].to(torch.int32),
                   "seq_len": seq_len}
            for hi, name in enumerate(names)}
