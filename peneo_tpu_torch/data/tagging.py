"""Pair-label ("handshaking") tagging in dense (L, L) matrix form (the
port's copy of ``peneo_tpu/data/tagging.py:25-107``: the label scatter of
the collator, the spot extraction of decode, and the flattened-triu view).

The reference flattens the upper-triangular token-pair grid into a length
L(L+1)/2 "shaking" sequence (reference: model/peneo_decoder.py:12-115, data/
collator.py:156-204). Both packages keep static shapes instead:
labels are dense int32 ``(L, L)`` matrices whose upper triangle (i <= j) carries
the tags; the lower triangle is ignored everywhere (masked in the loss,
excluded at decode). Semantics are identical: spot ``(i, j, tag)`` with
``i <= j`` sets ``M[i, j] = tag``.

Spot extraction order is row-major over the upper triangle, matching the
flattened shaking order the reference iterates in — parity-critical because
downstream parsing keeps first-seen entries on ties (pipeline/decode.py:45-67).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Spot = Tuple[int, int, int]  # (start_idx, end_idx, tag)


def spots_to_matrix(spots: Sequence[Spot], seq_len: int, out: np.ndarray = None) -> np.ndarray:
    """Scatter spot labels into a dense (seq_len, seq_len) int32 matrix
    (reference: model/peneo_decoder.py:34-73, one sample, dense layout)."""
    m = out if out is not None else np.zeros((seq_len, seq_len), dtype=np.int32)
    for i, j, tag in spots:
        m[i, j] = tag
    return m


def batch_spots_to_matrix(batch_spots: Sequence[Sequence[Spot]], seq_len: int) -> np.ndarray:
    """(B, L, L) int32 label tensor from per-sample spot lists."""
    out = np.zeros((len(batch_spots), seq_len, seq_len), dtype=np.int32)
    for b, spots in enumerate(batch_spots):
        spots_to_matrix(spots, seq_len, out=out[b])
    return out


def matrix_to_spots(
    tags: np.ndarray, scores: np.ndarray = None
) -> List[Tuple[int, int, int, float]]:
    """Extract nonzero upper-triangular spots as (i, j, tag, score).

    ``tags``: (L, L) int array (argmax classes or ground-truth tags).
    ``scores``: (L, L) float array of per-position confidence (max softmax
    prob); defaults to 1.0 (ground-truth decode path, reference:
    model/peneo_decoder.py:102-104).

    Row-major order over i <= j, matching the reference's shaking order.
    """
    tags = np.asarray(tags)
    seq_len = tags.shape[0]
    triu = np.triu(np.ones((seq_len, seq_len), dtype=bool))
    ii, jj = np.nonzero((tags != 0) & triu)  # np.nonzero is row-major
    if scores is None:
        sc = np.ones(len(ii), dtype=np.float64)
    else:
        sc = np.asarray(scores)[ii, jj]
    tg = tags[ii, jj]
    return [(int(i), int(j), int(t), float(s)) for i, j, t, s in zip(ii, jj, tg, sc)]


def flatten_triu(matrix: np.ndarray) -> np.ndarray:
    """Dense (L, L[, C]) → flattened (L(L+1)/2[, C]) in shaking order."""
    seq_len = matrix.shape[0]
    ii, jj = np.triu_indices(seq_len)
    return matrix[ii, jj]
