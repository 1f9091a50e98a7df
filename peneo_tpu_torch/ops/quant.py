"""Int8 serving matmuls: s8×s8→s32 products with per-output-channel weight
scales and per-row activation scales.

Counterpart of ``peneo_tpu/ops/quant.py:22-58`` (``Int8Dense``), with the
same operations in the same order, all in fp32:

    w_scale = amax|W| / 127 over the inputs      (one per output channel)
    wq      = round(W / max(w_scale, 1e-12))     int8
    x_scale = amax|x| / 127 over the inputs      (one per row)
    xq      = round(x / max(x_scale, 1e-12))     int8
    acc     = xq · wqᵀ                           int32
    y       = acc · x_scale · w_scale + bias     cast to the layer's dtype

``torch.round`` rounds half to even, as ``jnp.round`` does. The weights are
quantized from fp32 (the JAX kernel param is fp32 in a bf16 forward), so a
quantized layer keeps fp32 weights when the model is cast
(:func:`keep_int8_weights_fp32`).

- :func:`int8_matmul` is the s32 product. On CUDA tensors it is
  :func:`int8_matmul_cuda`, ``torch._int_mm`` (cuBLASLt's int8 GEMM; the
  JAX package computes this product with XLA's ``dot_general``, not in a
  Pallas kernel), whose ``launches`` counts its calls; on CPU tensors it is
  :func:`int8_matmul_reference`, an fp64 product, exact (every partial sum
  is an integer below 2^53 for inner sizes below 2^39). ``torch._int_mm`` on the card takes
  more than 16 rows and inner and output sizes that are multiples of 8: the
  rows are padded with zeros (exact), and other sizes raise.
- :class:`QuantLinear` is an ``nn.Linear`` (the same ``weight`` / ``bias``
  keys) that runs :func:`int8_linear` on forwards outside training when its
  ``int8`` switch is on (:func:`set_int8`), and the float product otherwise.
  Under tensor parallelism (``parallel/tensor_parallel.py``) it holds a
  column or a row split of the weight. A column split is a slice of the
  outputs: each output channel's scale and each row's are those of one
  process. A row-parallel layer holds a slice of each row's inputs, so its
  per-row and per-channel scales are the global absmax (one all-reduce max
  each over the tp group, what GSPMD computes for JAX's ``Int8Dense``), and
  the s32 products are summed over the group exactly (in fp64) before the
  scaling: the values of one process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import (NO_TP, ROW, TpShard, compute_dtype,
                                       partial_linear, reduce_from_tp)

MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # a device tensor as the divisor: by a Python scalar, CUDA multiplies
    # by its rounded reciprocal, which is not the quotient JAX computes.
    # Filled on the device: a copy from the host cannot be captured in a
    # CUDA graph (pipeline/graphs.py)
    return amax / amax.new_full((), 127.0)


def _global_max(x: torch.Tensor, tp: TpShard) -> torch.Tensor:
    if tp.size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    return x


def quantize_rows(x: torch.Tensor, tp: TpShard = NO_TP
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) → (xq (N, K) int8, x_scale (N, 1) fp32), N the product of
    the leading dims: one symmetric scale per row. ``tp``: the group over
    which the K inputs are split, whose absmax the scale takes."""
    xf = x.float().reshape(-1, x.shape[-1])
    scale = _scale(_global_max(xf.abs().amax(dim=-1, keepdim=True), tp))
    return torch.round(xf / torch.clamp_min(scale, 1e-12)).to(torch.int8), \
        scale


def quantize_weight(weight: torch.Tensor, tp: TpShard = NO_TP
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch's (F, K) weight → (wq (F, K) int8, w_scale (F,) fp32): one
    symmetric scale per output channel, over ``tp``'s split of K."""
    wf = weight.float()
    scale = _scale(_global_max(wf.abs().amax(dim=1), tp))
    return torch.round(wf / torch.clamp_min(scale, 1e-12)[:, None]).to(
        torch.int8), scale


def int8_matmul_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain s32 product ``xq · wqᵀ`` of (N, K) and (F, K) int8: an fp64
    product (every partial sum is an integer below 2^53), on any device."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_matmul_cuda(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq · wqᵀ`` through ``torch._int_mm`` (cuBLASLt, s32 accumulate) on
    CUDA tensors; rows padded with zeros to more than 16."""
    if not (xq.is_cuda and wq.is_cuda):
        raise ValueError("int8_matmul_cuda takes CUDA tensors")
    n, k = xq.shape
    f = wq.shape[0]
    if k % 8 or f % 8:
        raise ValueError(f"the int8 GEMM takes inner and output sizes that "
                         f"are multiples of 8, got K={k}, F={f}")
    if n < MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, MIN_ROWS - n))
    int8_matmul_cuda.launches += 1
    # A row-major, B = wqᵀ column-major: cuBLASLt's int8 "TN" layout
    return torch._int_mm(xq.contiguous(), wq.contiguous().t())[:n]


int8_matmul_cuda.launches = 0


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 · (F, K) int8 ᵀ → (N, F) int32: the library GEMM on a
    CUDA tensor, the plain twin on a CPU one."""
    if xq.is_cuda:
        return int8_matmul_cuda(xq, wq)
    return int8_matmul_reference(xq, wq)


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                quantized: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                row_split: TpShard = NO_TP) -> torch.Tensor:
    """``x · Wᵀ + b`` as JAX's ``Int8Dense``: (..., K) → (..., F).
    ``quantized`` passes ``quantize_rows(x)`` computed once for several
    layers that read the same input (the pair head's five heads).
    ``row_split``: the tp group of a row-parallel layer, whose ``x`` and
    ``weight`` hold this rank's slice of the K inputs (see the module
    docstring)."""
    xq, x_scale = (quantized if quantized is not None
                   else quantize_rows(x, row_split))
    wq, w_scale = quantize_weight(weight, row_split)
    acc = int8_matmul(xq, wq)
    if row_split.size > 1:
        acc = acc.double()  # fp64 sums of s32: exact
        dist.all_reduce(acc, group=row_split.group)
    y = acc.float() * x_scale * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*x.shape[:-1], weight.shape[0]).to(compute_dtype(x))


class QuantLinear(nn.Linear):
    """``nn.Linear`` with an int8 serving path: with ``int8`` set and the
    module not training, :func:`int8_linear` on the fp32 weights. ``split``
    is ``"col"`` or ``"row"`` once ``parallel/tensor_parallel.py`` has cut
    the weight for the tp group ``tp``; a row split sums its partial
    products over the group and adds the bias once."""

    int8 = False
    split: Optional[str] = None
    tp: TpShard = NO_TP

    def forward(self, x, quantized=None):
        row = self.tp if self.split == ROW else NO_TP
        if self.int8 and not self.training:
            return int8_linear(x, self.weight, self.bias, quantized, row)
        if row.size > 1:  # partial products summed in fp32, then the bias
            y = reduce_from_tp(partial_linear(x, self.weight), row)
            if self.bias is not None:
                y = y + self.bias.float()
            return y.to(compute_dtype(x))
        return super().forward(x)

    def linear(self, x, weight, bias=None):
        """This layer's product with a ``weight`` derived from its own (a
        slice of its rows): int8 or float as :meth:`forward` would run."""
        if self.int8 and not self.training:
            return int8_linear(x, weight, bias)
        return F.linear(x, weight, bias)


def set_int8(module: nn.Module, on: bool) -> None:
    """Switch every :class:`QuantLinear` under ``module``."""
    for m in module.modules():
        if isinstance(m, QuantLinear):
            m.int8 = on


def keep_int8_weights_fp32(module: nn.Module) -> None:
    """After a cast: the switched-on layers' weights and biases back to
    fp32, so their scales come from the fp32 weights, as in JAX."""
    for m in module.modules():
        if isinstance(m, QuantLinear) and m.int8:
            m.float()
