"""Tensor parallelism (tp): Megatron-style splits of the backbones and the
pair head over the ranks of a tp group.

Counterpart of the tp half of ``peneo_tpu/parallel/mesh.py`` (its
``_PARAM_RULES``, ``:54-80``, and ``param_shardings(fsdp=False)``,
``:103-142``), over processes instead of a mesh axis (GSPMD inserts the
collectives there; here they are the autograd ops below):

- **Column-parallel** (the output dim split, torch's weight dim 0 and the
  bias): the attention's q/k/v of every family and stream (LiLT's
  ``layout_`` ones too, LayoutLMv2's ``query/key/value`` without
  ``fast_qkv``), the MLP's intermediate layers, and each pair classifier's
  hidden layer ``fc_0``. Its input enters through :func:`copy_to_tp`
  (identity forward, all-reduce of the gradient), so that every replicated
  parameter below it sees the whole gradient.
- **Row-parallel** (the input dim split, torch's weight dim 1): the attention
  output and MLP output of every stream and family, and ``fc_out``. The
  partial products (:func:`partial_linear`, fp32) are summed over the group
  (:func:`reduce_from_tp`) and the bias, which JAX leaves replicated
  (``P("tp", None)`` shards only the kernel), is added once, after the sum.
- **Vocab-parallel**: the word embeddings (the vocabulary dim); a rank looks
  up the ids of its rows and the lookups are summed (:func:`vocab_embedding`).
- **The divisibility fallback** (``mesh.py:120-126``): a tensor whose split
  dim is not divisible by tp stays replicated. The LiLT and LayoutLMv3
  vocabulary of 50265 is replicated at tp 2, XLM's 250002 is split.
- **Replicated by design, where JAX splits**: the pair head's combine
  (``combine_fc``, JAX ``comb_a``/``comb_b``). Each rank computes a row
  block's pair features ``silu(A_i + B_j)`` whole, its ``fc_0`` columns
  and its share of ``fc_out``'s product, and one all-reduce of the logits
  per block and head follows: split features would have to be gathered
  before ``fc_0``, which moves the (bs, L, H) features, not the logits.
- **Replicated as in JAX**: LayoutLMv2's fused ``qkv_linear`` with
  ``q_bias``/``v_bias`` (JAX ``layoutlmv2.py:214``: no rule matches them;
  a rank takes its heads' rows of them), the rel-bias bucket tables (a rank
  gathers its heads' rows), every LayerNorm, the position tables, the
  shrink MLP and LayoutLMv2's visual tower. Where a rank uses only its
  heads' part of a replicated parameter, the parameter enters through
  :func:`copy_to_tp` too, so its gradient is summed over the group.

:func:`set_tensor_parallel` takes a model that holds the full weights and
keeps this rank's shard of each split tensor in place (``model.tp_splits``
maps every split key to its dim, ``model.tp_shard`` is the rank's
:class:`TpShard`; both by name, so that they outlive a parameter that fsdp
replaces).
Files on disk always hold the full tensors: :func:`gather_state_dict` and
:func:`gather_optimizer_state` (collectives) rebuild them, and
:func:`shard_state_dict` / :func:`shard_optimizer_state` cut a full state
for a rank. Gathers run as an all-reduce of a zero buffer in which each
rank fills its own slice (gloo has no gather of CUDA tensors; x + 0 = x is
exact).
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

COL, ROW, VOCAB = "col", "row", "vocab"
_SPLIT_DIM = {COL: 0, ROW: 1, VOCAB: 0}

_LAYER = r"backbone\.encoder\.layer\.\d+\."
# (regex on the port's state-dict key, kind); first match wins, the rest is
# replicated
RULES = (
    (_LAYER + r"attention\.self\.(layout_)?(query|key|value)\.(weight|bias)$",
     COL),
    (_LAYER + r"attention\.(output|layout_output)\.dense\.weight$", ROW),
    (_LAYER + r"(intermediate|layout_intermediate)\.dense\.(weight|bias)$",
     COL),
    (_LAYER + r"(output|layout_output)\.dense\.weight$", ROW),
    (r"peneo_decoder\.\w+_fc\.0\.(weight|bias)$", COL),
    (r"peneo_decoder\.\w+_fc\.3\.weight$", ROW),
    (r"backbone\.embeddings\.word_embeddings\.weight$", VOCAB),
)


@dataclass(frozen=True)
class TpShard:
    """This rank's ``index`` of ``size`` tp ranks and their ``group`` (None
    with size 1: no collective)."""

    index: int = 0
    size: int = 1
    group: Optional[object] = None

    def part(self, n: int) -> slice:
        """This rank's slice of a dim of ``n`` split over the group."""
        step = n // self.size
        return slice(self.index * step, (self.index + 1) * step)


NO_TP = TpShard()


def split_kind(key: str) -> Optional[str]:
    """The rule's kind for a state-dict key (None: replicated)."""
    for pattern, kind in RULES:
        if re.match(pattern, key):
            return kind
    return None


def param_splits(state: Dict[str, torch.Tensor], size: int) -> Dict[str, int]:
    """The split dim of every key of ``state`` (full shapes) that a tp group
    of ``size`` splits: the rules, less the tensors whose split dim is not
    divisible by ``size`` (they stay replicated, as JAX's do)."""
    if size == 1:
        return {}
    return rule_dims({k: t.shape for k, t in state.items()}, size)


def rule_dims(shapes: Dict[str, Sequence[int]], size: int) -> Dict[str, int]:
    """:func:`param_splits` from full shapes, at any ``size``: at tp 1 the
    dims JAX's specs still name ``tp`` (an axis of size 1)."""
    out = {}
    for key, shape in shapes.items():
        kind = split_kind(key)
        if kind is None:
            continue
        dim = _SPLIT_DIM[kind]
        if dim < len(shape) and shape[dim] % size == 0:
            out[key] = dim
    return out


def shard_tensor(t: torch.Tensor, dim: int, index: int,
                 size: int) -> torch.Tensor:
    """Rank ``index``'s contiguous 1/``size`` of ``t`` along ``dim`` (a
    copy)."""
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).clone()


def shard_state_dict(state: Dict[str, torch.Tensor], splits: Dict[str, int],
                     index: int, size: int) -> Dict[str, torch.Tensor]:
    """A full state dict → rank ``index``'s: each key of ``splits`` cut
    along its dim, the rest as it is."""
    out = dict(state)
    for key, dim in splits.items():
        if key in state:
            out[key] = shard_tensor(state[key], dim, index, size)
    return out


def gather_tensor(t: torch.Tensor, dim: int, tp: TpShard) -> torch.Tensor:
    """The full tensor from every tp rank's shard ``t`` (a collective):
    each rank writes its slice of a zero buffer, then one all-reduce."""
    shape = list(t.shape)
    shape[dim] *= tp.size
    full = t.new_zeros(shape)
    full.narrow(dim, tp.index * t.shape[dim], t.shape[dim]).copy_(t)
    dist.all_reduce(full, group=tp.group)
    return full


def gather_state_dict(state: Dict[str, torch.Tensor], splits: Dict[str, int],
                      tp: TpShard) -> Dict[str, torch.Tensor]:
    """This rank's state dict → the full one, on every rank of the group (a
    collective: every rank calls it, with the same keys)."""
    if tp.size == 1:
        return state
    return {k: (gather_tensor(v.detach(), splits[k], tp) if k in splits
                else v) for k, v in state.items()}


def _optimizer_splits(opt_state: Dict, splits: Dict[str, int]):
    """(state index, split dim) of each split parameter of an optimizer
    state dict whose groups name their parameters (``names``, as
    ``pipeline/train.py`` ``make_optimizer`` builds them)."""
    for group in opt_state["param_groups"]:
        for index, name in zip(group["params"], group["names"]):
            if name in splits:
                yield index, splits[name]


def _map_moments(opt_state: Dict, splits: Dict[str, int], fn) -> Dict:
    """``opt_state`` with ``fn(tensor, dim)`` applied to every moment
    (same shape as its parameter) of each split parameter."""
    state = dict(opt_state["state"])
    for index, dim in _optimizer_splits(opt_state, splits):
        if index in state:
            state[index] = {k: (fn(v, dim) if torch.is_tensor(v)
                                and v.dim() > dim else v)
                            for k, v in state[index].items()}
    return {**opt_state, "state": state}


def gather_optimizer_state(opt_state: Dict, splits: Dict[str, int],
                           tp: TpShard) -> Dict:
    """The AdamW state with the moments of the split parameters gathered to
    full tensors (a collective), as orbax writes a sharded state whole."""
    if tp.size == 1:
        return opt_state
    return _map_moments(opt_state, splits,
                        lambda v, dim: gather_tensor(v, dim, tp))


def shard_optimizer_state(opt_state: Dict, splits: Dict[str, int],
                          index: int, size: int) -> Dict:
    """A full AdamW state → rank ``index``'s moments."""
    if size == 1:
        return opt_state
    return _map_moments(opt_state, splits,
                        lambda v, dim: shard_tensor(v, dim, index, size))


# --------------------------------------------------------------- autograd ops
def _fp32_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The fp32 sum of ``x`` over ``group`` (a new tensor)."""
    out = x.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, group=group)
    return out


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _fp32_sum(grad, ctx.group).to(grad.dtype), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _fp32_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: TpShard) -> torch.Tensor:
    """``x`` unchanged; in the backward its gradient is summed over the tp
    group (the entry of a column-parallel region: each rank's gradient of a
    replicated input covers its columns only)."""
    if tp.size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToTp.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TpShard) -> torch.Tensor:
    """The fp32 sum of ``x`` over the tp group (the exit of a row-parallel
    region: partial products); the gradient passes unchanged."""
    if tp.size == 1:
        return x
    return _ReduceFromTp.apply(x, tp.group)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a float Linear returns for ``x`` here: autocast's when it
    is on, else ``x``'s."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


@contextlib.contextmanager
def _tf32_matmul(on: bool):
    """cuBLAS may run fp32 GEMMs on TF32 tensor cores while inside."""
    flags = torch.backends.cuda.matmul
    was = flags.allow_tf32
    flags.allow_tf32 = on or was
    try:
        yield
    finally:
        flags.allow_tf32 = was


def partial_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer's partial product ``x · Wᵀ`` in fp32, from
    ``x`` and ``W`` rounded to the compute dtype as a bf16 GEMM rounds its
    inputs: a product of two bf16 values is exact in fp32, so the sum over
    the tp group rounds once, where one process's GEMM rounds its output
    (rounding each rank's bf16 partial first doubles the roundings, which
    12 layers compound). bf16 and fp16 values are exact in TF32, so on the
    card such a GEMM runs on TF32 tensor cores with fp32 accumulation: the
    same products and one fp32 sum, at tensor-core rate; fp32 operands keep
    the fp32 GEMM."""
    dtype = compute_dtype(x)
    with torch.autocast(x.device.type, enabled=False), \
            _tf32_matmul(dtype in (torch.bfloat16, torch.float16)):
        return F.linear(x.to(dtype).float(), weight.to(dtype).float())


def vocab_embedding(ids: torch.Tensor, table: nn.Embedding,
                    tp: TpShard) -> torch.Tensor:
    """A vocab-parallel lookup: ``table`` holds this rank's contiguous rows;
    ids outside them give zeros, and the lookups are summed over the group
    (each id is found on one rank: exact)."""
    n = table.weight.shape[0]
    lo = tp.index * n
    outside = (ids < lo) | (ids >= lo + n)
    local = torch.where(outside, torch.zeros_like(ids), ids - lo)
    rows = F.embedding(local, table.weight)
    rows = rows.masked_fill(outside[..., None], 0.0)
    return reduce_from_tp(rows, tp).to(table.weight.dtype)


# ------------------------------------------------------------------ the model
def set_tensor_parallel(model: nn.Module, index: int, size: int,
                        group=None) -> Dict[str, int]:
    """Keep rank ``index``'s shard of every split tensor of ``model`` (which
    holds the full weights) and point its modules at the tp group. Raises
    when ``size`` does not divide the attention heads (JAX asserts
    ``nh % tp == 0``, ``peneo_tpu/ops/biacm_attention.py:155``) or the pair
    classifiers are not two layers deep. Returns the splits."""
    if not 0 <= index < size:
        raise ValueError(f"tp index {index} out of [0, {size})")
    if size == 1:
        return {}
    cfg = model.cfg
    nh = (cfg.backbone_config or {}).get("num_attention_heads", 12)
    if nh % size:
        raise ValueError(f"tp {size} does not divide the backbone's {nh} "
                         "attention heads: each rank runs nh / tp of them")
    if cfg.peneo_classifier_num_layers != 2:
        raise ValueError(
            f"tp splits the pair classifiers as fc_0 (columns) and fc_out "
            f"(rows); peneo_classifier_num_layers "
            f"{cfg.peneo_classifier_num_layers} is not 2")
    if group is None:
        raise ValueError(f"tp {size} needs the group of its ranks "
                         "(parallel/dist.py grid)")
    if getattr(model, "tp_splits", None):
        raise ValueError("the model is already split")
    shard = TpShard(index, size, group)
    splits = param_splits(model.state_dict(), size)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, dim in splits.items():
            p = params[key]
            p.data = shard_tensor(p.data, dim, index, size)
    for m in model.modules():
        if hasattr(m, "tp"):
            m.tp = shard
    for key in splits:
        module = model.get_submodule(key.rsplit(".", 1)[0])
        kind = split_kind(key)
        if kind == VOCAB:
            module.tp = shard
        else:
            module.split = kind
            module.tp = shard
    model.tp_splits, model.tp_shard = splits, shard
    return splits
