"""Data parallelism across processes: one process per rank, each on its own
card (NCCL), on a card it shares with other ranks (gloo), or on the CPU
(gloo) when the caller asks for it.

Counterpart of the dp half of ``peneo_tpu/parallel/mesh.py`` (a ``dp`` mesh
axis under GSPMD there), of ``peneo_tpu/pipeline/evaluation.py:83-118``
``multihost_gather`` and of ``peneo_tpu/ops/losses.py:167-182``
``ohem_stream_merge`` (reference: torchrun + DDP + NCCL, SURVEY.md §2.6).

- :func:`init_distributed` takes the JAX trainer's flags
  (``start/run_rfund.py:112-121,356-366``): ``--coordinator_address host:port
  --num_processes N --process_id i`` become ``init_process_group(
  "tcp://host:port", world_size=N, rank=i)``; ``--distributed`` alone reads
  torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and
  ``LOCAL_RANK``. The local rank picks the card, ``cuda:{local_rank %
  device_count}``. The ranks of one host are ``LOCAL_WORLD_SIZE`` (torchrun
  sets it), else all of them: NCCL when each has a card of its own, gloo on
  the CPU or when ranks share a card (NCCL refuses two ranks on one card).
- The losses are the global batch's, as GSPMD computes them in the JAX
  package: the decoder sums each head's numerator and denominator over the
  ranks (:func:`all_sum`), and streaming OHEM merges its top-k states
  (:func:`ohem_stream_merge`). Gathers go through ``all_reduce`` (each rank
  fills its own row of a zero buffer) or ``all_gather_object``: gloo has no
  gather of CUDA tensors.
- :func:`gather_rows` is the eval metric's ``gather_fn``.
- :func:`grid` lays the ranks out as a ``(dp, tp, sp)`` grid, sp varying
  fastest, then tp (``rank = (d·tp + t)·sp + s``: the JAX mesh's
  ``reshape(dp, tp, sp)`` order, ``peneo_tpu/parallel/mesh.py:31-44``). The
  sp ranks of one (dp, tp) cell run the same rows of the batch through the
  same backbone shard and split the pair grid's rows
  (``parallel/seq_parallel.py``); the tp ranks of one (dp, sp) cell hold
  the shards of a Megatron-split model (``parallel/tensor_parallel.py``)
  and compute the same logits. The ranks with one tp index ``t`` hold the
  same shard of every parameter: their **replica group** is the group
  DDP averages over, and the losses are reduced over it (each of its ranks
  holds a disjoint share). :func:`sp_gather` gathers small tensors (the
  top-k spot candidates) over the sp group.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("auto", "nccl", "gloo")


def initialized() -> bool:
    """Whether this process is in a (default) process group."""
    return dist.is_initialized()


def world() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(global_rank: Optional[int] = None) -> int:
    """This process's rank among the ranks of its host: torchrun's
    ``LOCAL_RANK``, else the global rank (one host)."""
    return int(os.environ.get(
        "LOCAL_RANK", rank() if global_rank is None else global_rank))


def rank_device(device=None, local: Optional[int] = None) -> torch.device:
    """This rank's device: ``cpu`` only when asked for; else
    ``cuda:{local_rank % device_count}``, raising without a GPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    local = local_rank() if local is None else local
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, n_local: int,
                   backend: str = "auto") -> str:
    """NCCL when every rank of the host has a card of its own, gloo on the
    CPU or when ranks share a card; a forced NCCL on a shared card or on the
    CPU raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    shared = (device.type == "cuda"
              and n_local > torch.cuda.device_count())
    if backend == "nccl" and (device.type != "cuda" or shared):
        where = ("the CPU" if device.type != "cuda" else
                 f"{torch.cuda.device_count()} card(s) shared by {n_local} "
                 "ranks")
        raise ValueError(f"NCCL needs one card per rank, not {where}: use "
                         "the gloo backend (the default picks it)")
    if backend != "auto":
        return backend
    return "nccl" if device.type == "cuda" and not shared else "gloo"


def init_distributed(device=None, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "auto",
                     timeout_s: float = 600.0) -> torch.device:
    """Join the default process group and return this rank's device.

    ``coordinator_address`` (``host:port`` of rank 0) with
    ``num_processes`` and ``process_id``: a TCP rendezvous; without them,
    torchrun's environment (``env://``). A group that is already up is
    kept."""
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init = f"tcp://{coordinator_address}"
        n, r = int(num_processes), int(process_id)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(
                f"--distributed without --coordinator_address reads "
                f"torchrun's environment; {missing} are not set (launch "
                "with torchrun, or pass --coordinator_address, "
                "--num_processes and --process_id)")
        init, n, r = "env://", None, None
    n_ranks = n if n is not None else int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, local_rank(
        r if r is not None else int(os.environ["RANK"])))
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_ranks))
    chosen = choose_backend(dev, n_local, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kwargs = {} if n is None else {"world_size": n, "rank": r}
        dist.init_process_group(
            chosen, init_method=init,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    if rank() == 0:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        print(f"[peneo] data parallel: {world()} ranks over "
              f"{dist.get_backend()} ({n_local} on this host, device "
              f"{dev.type}, {cards} card(s) visible)", flush=True)
    return dev


@dataclass(frozen=True)
class ProcessGrid:
    """The ranks as a ``(dp, tp, sp)`` grid. ``sp_group``: the ranks of
    this rank's (d, t) cell; ``dp_group``: those of its (t, s) column;
    ``tp_group``: those of its (d, s) cell; ``replica_group``: every rank
    with its t (built at tp > 1 only, None meaning the default group). The
    others are built only when they have more than one rank and differ from
    the world (None otherwise: no collective)."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    sp_group: Optional[object] = None
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None
    replica_group: Optional[object] = None


_grid = ProcessGrid()  # the layout of the default group, set by grid()


def _cell_groups(members, mine: int):
    """``dist.new_group`` of every member list (each rank calls it for every
    group, in one order); the group whose list holds rank ``mine``."""
    picked = None
    for ranks in members:
        group = dist.new_group(list(ranks))
        if mine in ranks:
            picked = group
    return picked


def grid(dp: Optional[int] = None, tp: int = 1,
         sp: int = 1) -> ProcessGrid:
    """Lay the default group's ranks out as ``dp × tp × sp`` (``dp`` None:
    world // (tp·sp)) and build the groups of :class:`ProcessGrid`. A call
    with the current sizes returns the current grid. Without a process
    group only 1 × 1 × 1 exists."""
    global _grid
    n = world()
    if tp < 1 or sp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"--dp {dp} --tp {tp} --sp {sp}: sizes must be "
                         "positive")
    sizes = f"--tp {tp} × --sp {sp}" if dp is None else \
        f"--dp {dp} × --tp {tp} × --sp {sp}"
    dp = n // (tp * sp) if dp is None else dp
    if dp < 1 or dp * tp * sp != n:
        raise ValueError(
            f"{sizes} does not fit the number of processes, {n} (one rank "
            "each); launch dp·tp·sp processes: torchrun --nproc_per_node N "
            "... --distributed, or --coordinator_address host:port "
            "--num_processes N --process_id i")
    if (_grid.dp, _grid.tp, _grid.sp) == (dp, tp, sp):
        return _grid
    me = rank()

    def at(i, j, k):
        return (i * tp + j) * sp + k

    groups = {}
    if sp > 1:
        groups["sp_group"] = _cell_groups(
            [[at(i, j, k) for k in range(sp)]
             for i in range(dp) for j in range(tp)], me)
    if dp > 1 and tp * sp > 1:
        groups["dp_group"] = _cell_groups(
            [[at(i, j, k) for i in range(dp)]
             for j in range(tp) for k in range(sp)], me)
    if tp > 1:  # DDP needs a replica group even of one rank
        groups["tp_group"] = _cell_groups(
            [[at(i, j, k) for j in range(tp)]
             for i in range(dp) for k in range(sp)], me)
        groups["replica_group"] = _cell_groups(
            [[at(i, j, k) for i in range(dp) for k in range(sp)]
             for j in range(tp)], me)
    _grid = ProcessGrid(dp, tp, sp, **groups)
    return _grid


def dp_index() -> int:
    """This rank's d of the grid: its share of every batch."""
    return rank() // (_grid.tp * _grid.sp)


def dp_size() -> int:
    return world() // (_grid.tp * _grid.sp)


def tp_index() -> int:
    """This rank's t of the grid: its shard of the split parameters."""
    return (rank() // _grid.sp) % _grid.tp


def tp_size() -> int:
    return _grid.tp


def tp_group():
    return _grid.tp_group


def sp_index() -> int:
    """This rank's s of the grid: its rows of the pair grid."""
    return rank() % _grid.sp


def sp_size() -> int:
    return _grid.sp


def sp_group():
    return _grid.sp_group


def dp_group():
    return _grid.dp_group


def replica_size() -> int:
    """The ranks holding this rank's shard of every parameter: dp · sp."""
    return world() // _grid.tp


def replica_group():
    """The group of :func:`replica_size` ranks (None: the default group,
    which it is at tp = 1; a single rank has no collective to run)."""
    return _grid.replica_group


def replica_index() -> int:
    """This rank's place in its replica group: d·sp + s."""
    return dp_index() * _grid.sp + sp_index()


def seed_shard() -> int:
    """The (dp, tp) shard whose dropout masks this rank draws, d·tp + t:
    the JAX kernels' seed fold (``peneo_tpu/ops/biacm_attention.py:193-199``).
    The sp ranks of one cell share it."""
    return dp_index() * _grid.tp + tp_index()


def shutdown() -> None:
    """Leave the process group (and forget the grid)."""
    global _grid
    _grid = ProcessGrid()
    if dist.is_initialized():
        dist.destroy_process_group()


def sp_gather(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` of every rank of this rank's sp group, stacked in sp order
    (a new leading axis of size sp). NCCL: ``all_gather_into_tensor``; gloo,
    which has no gather of CUDA tensors: an all-reduce of a zero buffer in
    which each rank fills its own row (exact: x + 0 = x)."""
    n = _grid.sp
    if n == 1:
        return tensor[None]
    group = _grid.sp_group
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * tensor.numel(),), dtype=tensor.dtype,
                          device=tensor.device)
        dist.all_gather_into_tensor(out, tensor.contiguous().reshape(-1),
                                    group=group)
        return out.view(n, *tensor.shape)
    out = torch.zeros((n, *tensor.shape), dtype=tensor.dtype,
                      device=tensor.device)
    out[sp_index()] = tensor
    dist.all_reduce(out, group=group)
    return out


class _SpMeanGrad(torch.autograd.Function):
    """The identity, whose backward replaces each gradient by its mean over
    the sp group (one fp32 ``all_reduce`` of all of them)."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.float().reshape(-1) for g in grads])
        dist.all_reduce(flat, group=_grid.sp_group)
        flat /= _grid.sp
        out, offset = [], 0
        for g in grads:
            out.append(flat[offset:offset + g.numel()].view_as(g).to(g.dtype))
            offset += g.numel()
        return tuple(out)


def sp_mean_grad(*tensors):
    """``tensors`` unchanged; in the backward their gradients are averaged
    over the sp group. The decoder applies it to the combine features that
    every sp rank computes alike (``peneo_tpu/parallel/seq_parallel.py``:
    the transpose of the replicated input is a psum over sp), so the
    backbone's backward runs once, on the summed gradient of all the
    shares, on every rank: the same numbers as one process, where
    separate backward passes per share would round each in bf16. Each rank
    back-propagates ``replica_size ×`` its share (:func:`global_losses`):
    the mean over sp leaves ``dp ×`` its dp index's, and DDP's mean over the
    replica group makes that the global gradient."""
    if _grid.sp == 1 or not torch.is_grad_enabled():
        return tensors
    return _SpMeanGrad.apply(*tensors)


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def all_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``tensor`` (a new tensor, no gradient)."""
    out = tensor.detach().clone()
    if world() > 1:
        dist.all_reduce(out)
    return out


def replica_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over this rank's replica group (a new tensor,
    no gradient): the shares of a loss that the ranks of a ``dp × tp ×
    sp`` grid hold, each tp shard's ranks counting once."""
    out = tensor.detach().clone()
    if replica_size() > 1:
        dist.all_reduce(out, group=_grid.replica_group)
    return out


def replica_mean_grads(params) -> None:
    """Replace the gradients of ``params`` by their mean over the replica
    group, as DDP averages them: one all-reduce of a flat buffer of every
    gradient, each rank's share divided by the group's size first (DDP's
    reducer scales its buckets before the sum). The gradient mean of K > 1
    steps per call (``pipeline/train.py`` ``MultiTrainStep``), on the card
    inside their CUDA graph, where DDP's reducer, which rebuilds its buckets
    after the first step and broadcasts buffers, cannot be captured. At a
    replica group of one rank it returns before any work."""
    n = replica_size()
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads]).div_(n)
    dist.all_reduce(flat, group=_grid.replica_group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def gather_objects(obj) -> List:
    """``obj`` of every rank, in rank order, on every rank
    (``all_gather_object``)."""
    if world() == 1:
        return [obj]
    parts: List = [None] * world()
    dist.all_gather_object(parts, obj)
    return parts


def gather_rows(rows: List) -> List:
    """Every rank's list of rows, concatenated in rank order: the eval
    metric's ``gather_fn``."""
    return [row for part in gather_objects(list(rows)) for row in part]


def _rank_share(best: torch.Tensor, every: torch.Tensor,
                me: int) -> torch.Tensor:
    """``best`` (this rank's k hardest values, sorted) with every element
    outside the global top k of ``every`` (all ranks' ``best``, one row
    each) set to -inf. The k-th value ``t`` is the threshold: a rank keeps
    its values above ``t``, and the slots left for values equal to ``t``
    go to the ranks in order, so the kept values sum to the global top k's
    sum whatever the ties (which tied element takes the gradient may differ
    from one process's)."""
    k = best.numel()
    t = torch.topk(every.reshape(-1), k).values[-1]
    above = (every > t).sum(1)
    ties = (every == t).sum(1)
    slots = k - above.sum()
    earlier = torch.cumsum(ties, 0) - ties
    mine = torch.minimum(torch.clamp_min(slots - earlier[me], 0), ties[me])
    keep = torch.arange(k, device=best.device) < above[me] + mine
    return torch.where(keep & torch.isfinite(best), best, float("-inf"))


def _merged_state(state, counts, every, me):
    """This rank's merged OHEM state from the summed ``counts`` (one per
    group) and ``every`` rank's ``best`` buffers (one row each, per top-k
    group)."""
    merged = {}
    for i, key in enumerate(("pos", "neg")):
        g = state[key]
        count = counts[i]
        if "sum" in g:
            merged[key] = {"sum": g["sum"], "count": count}
        else:
            merged[key] = {"best": _rank_share(g["best"], every[key], me),
                           "count": count}
    return merged


def ohem_merge_states(states, me: int):
    """Rank ``me``'s merged state from every rank's OHEM ``states`` (in
    rank order) held in one process: what :func:`ohem_stream_merge` computes
    after its all-reduce."""
    counts = [sum(st[key]["count"] for st in states) for key in ("pos",
                                                                 "neg")]
    every = {key: torch.stack([st[key]["best"].detach() for st in states])
             for key in ("pos", "neg") if "best" in states[me][key]}
    return _merged_state(states[me], counts, every, me)


def ohem_stream_merge(state):
    """Merge one head's streaming OHEM state (``ops/losses.py``) across the
    ranks, as ``peneo_tpu/ops/losses.py:167-182`` does across a mesh axis:
    the counts are summed; the ``best`` buffers are gathered, and each rank
    keeps the values of its own that made the global top k. A keep-all
    group's sum stays this rank's. ``ohem_stream_final`` of the merged
    state is then this rank's share of the global loss (the shares sum to
    it), and its gradient reaches only this rank's kept elements. One
    ``all_reduce`` (fp64, exact for counts and fp32 values)."""
    n = replica_size()
    if n == 1:
        return state
    me = replica_index()
    keys = ("pos", "neg")
    dev = state["pos"]["count"].device
    rows = []
    for key in keys:
        g = state[key]
        if "best" in g:
            buf = torch.zeros((n, g["best"].numel()), dtype=torch.float64,
                              device=dev)
            buf[me] = g["best"].detach()
            rows.append(buf)
    counts = torch.stack([state[k]["count"] for k in keys]).double()
    packed = torch.cat([counts] + [b.reshape(-1) for b in rows])
    dist.all_reduce(packed, group=_grid.replica_group)
    every, offset = {}, len(keys)
    for key in keys:
        if "best" in state[key]:
            k = state[key]["best"].numel()
            every[key] = packed[offset:offset + n * k].view(n, k).float()
            offset += n * k
    counts = packed[:len(keys)].round().to(torch.int64)
    return _merged_state(state, counts, every, me)


def global_losses(partials: torch.Tensor) -> torch.Tensor:
    """Per-head losses of the global batch from this rank's shares
    (``partials``, (H,): the shares of the ranks of one replica group sum
    to the global loss; the tp ranks of a cell hold the same share). The
    value is the sum over the replica group, the same on every rank; the
    gradient is ``replica_size × share``, so that DDP's mean over the
    replica group is the global loss's gradient."""
    n = replica_size()
    if n == 1:
        return partials
    total = replica_sum(partials)
    scaled = partials * n
    return scaled + (total - scaled).detach()
