"""Plain float32 PEneo decoder (Lin et al., ACM MM 2024, "PEneo: Unifying
Line Extraction, Line Grouping, and Entity Linking for End-to-end Document
Pair Extraction"), inference side, as the benchmark's yardstick.

The backbone's output without its first (CLS) position goes through the
shrink MLP, then the handshaking combine ``silu(W·[h_i; h_j] + b)`` for
every pair i ≤ j of the upper triangle, then five pair classifiers
(Linear → SiLU → Linear): line extraction (2 classes) and entity linking
and line grouping, head-to-head and tail-to-tail (3 classes each). A cell's
tag is the argmax class and its score the largest softmax probability.
Parameter names are the public checkpoints' (``peneo_decoder.*``).

Imports torch only.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

PREFIX = "peneo_decoder."
HEADS = (("line_extraction", 2), ("ent_linking_h2h", 3),
         ("ent_linking_t2t", 3), ("line_grouping_h2h", 3),
         ("line_grouping_t2t", 3))


def widths(cfg: Dict) -> Tuple[int, int]:
    """(shrink hidden width, decoder width)."""
    h = cfg["hidden_size"]
    return h, h // 2


def param_table(cfg: Dict,
                d_in: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of the decoder's parameters for a backbone
    output of width ``d_in`` (two-layer classifiers, shrink on)."""
    mid, dec = widths(cfg)
    out = []

    def linear(name, a, b):
        out.append((f"{PREFIX}{name}.weight", (b, a), "normal"))
        out.append((f"{PREFIX}{name}.bias", (b,), "zeros"))

    linear("shrink_projection.0", d_in, mid)
    linear("shrink_projection.3", mid, dec)
    linear("handshaking_kernel.combine_fc", 2 * dec, dec)
    for name, classes in HEADS:
        linear(f"{name}_fc.0", dec, dec)
        linear(f"{name}_fc.3", dec, classes)
    return out


def _lin(w, name, x):
    return F.linear(x, w[PREFIX + name + ".weight"],
                    w[PREFIX + name + ".bias"])


def pair_features(w: Dict[str, torch.Tensor], hidden: torch.Tensor):
    """(L, d_in) float32 → the (L, dec) halves A (with the bias) and Bm of
    the combine, whose sum over a pair is the combine's pre-activation."""
    h = F.silu(_lin(w, "shrink_projection.0", hidden))
    h = F.silu(_lin(w, "shrink_projection.3", h))
    W = w[PREFIX + "handshaking_kernel.combine_fc.weight"]
    dec = W.shape[0]
    bias = w[PREFIX + "handshaking_kernel.combine_fc.bias"]
    return (F.linear(h, W[:, :dec], bias),
            F.linear(h, W[:, dec:]))


def pair_logits(w: Dict[str, torch.Tensor], hidden: torch.Tensor,
                rows: int = 64) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                                  Dict[str, torch.Tensor]]]:
    """One page's (L, d_in) hidden states → row blocks of the upper
    triangle: (row indices (r,), column indices (c,), {head: (r, c, C)
    logits}) with every returned cell i ≤ j masked in by the caller."""
    A, Bm = pair_features(w, hidden)
    return pair_blocks(w, A, Bm, rows)


def pair_blocks(w: Dict[str, torch.Tensor], A: torch.Tensor,
                Bm: torch.Tensor, rows: int = 64,
                hidden_linear=F.linear) -> Iterator[
                    Tuple[torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]]:
    """The pair head alone, from one page's combine halves ``A`` (with the
    bias) and ``Bm``, (L, dec) each → row blocks as :func:`pair_logits`
    gives them. ``hidden_linear(x, weight, bias)`` computes the classifiers'
    hidden (dec → dec) layers."""
    L = A.shape[0]
    for r0 in range(0, L, rows):
        r = torch.arange(r0, min(r0 + rows, L), device=A.device)
        c = torch.arange(r0, L, device=A.device)
        pair = F.silu(A[r][:, None, :] + Bm[c][None, :, :])
        out = {}
        for name, _ in HEADS:
            p = PREFIX + name + "_fc.0"
            x = F.silu(hidden_linear(pair, w[p + ".weight"], w[p + ".bias"]))
            out[name] = _lin(w, f"{name}_fc.3", x)
        yield r, c, out


def forward_flops(cfg: Dict, d_in: int, m: int) -> int:
    """Multiply-add FLOPs of the products ``m`` real decoder positions need:
    the shrink MLP and the combine's two halves per position, and per pair
    of the upper triangle (m(m+1)/2 pairs) the five classifiers."""
    mid, dec = widths(cfg)
    per_position = d_in * mid + mid * dec + 2 * dec * dec
    per_pair = sum(dec * dec + dec * c for _, c in HEADS)
    return 2 * (m * per_position + m * (m + 1) // 2 * per_pair)
