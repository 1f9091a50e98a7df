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
"""

from __future__ import annotations

import datetime
import os
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


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def all_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``tensor`` (a new tensor, no gradient)."""
    out = tensor.detach().clone()
    if world() > 1:
        dist.all_reduce(out)
    return out


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


def ohem_stream_merge(state):
    """Merge one head's streaming OHEM state (``ops/losses.py``) across the
    ranks, as ``peneo_tpu/ops/losses.py:167-182`` does across a mesh axis:
    the counts are summed; the ``best`` buffers are gathered, and each rank
    keeps the values of its own that made the global top k. A keep-all
    group's sum stays this rank's. ``ohem_stream_final`` of the merged
    state is then this rank's share of the global loss (the shares sum to
    it), and its gradient reaches only this rank's kept elements. One
    ``all_reduce`` (fp64, exact for counts and fp32 values)."""
    n = world()
    if n == 1:
        return state
    me = rank()
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
    dist.all_reduce(packed)
    merged, offset = {}, len(keys)
    for i, key in enumerate(keys):
        g = state[key]
        count = packed[i].round().to(torch.int64)
        if "sum" in g:
            merged[key] = {"sum": g["sum"], "count": count}
            continue
        k = g["best"].numel()
        every = packed[offset:offset + n * k].view(n, k).float()
        offset += n * k
        merged[key] = {"best": _rank_share(g["best"], every, me),
                       "count": count}
    return merged


def global_losses(partials: torch.Tensor) -> torch.Tensor:
    """Per-head losses of the global batch from this rank's shares
    (``partials``, (H,): the shares of all ranks sum to the global loss).
    The value is the sum over the ranks, the same on every rank; the
    gradient is ``world × share``, so that DDP's mean of the ranks'
    gradients is the global loss's gradient."""
    n = world()
    if n == 1:
        return partials
    total = all_sum(partials)
    scaled = partials * n
    return scaled + (total - scaled).detach()
