"""Pair-label ("handshaking") tagging in dense (L, L) matrix form (the
port's copy of the prediction-side helper of ``peneo_tpu/data/tagging.py``).

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

from typing import List, Tuple

import numpy as np


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
