"""Training and eval steps + the reference's four-group AdamW.

Counterpart of ``peneo_tpu/pipeline/train.py:35-197`` (reference: the HF
Trainer internals, pipeline/trainer.py:275-354):

- ``torch.optim.AdamW`` in four parameter groups, {decay, no-decay} ×
  {decoder (``peneo_decoder.*``) at lr × ``peneo_downstream_speedup_ratio``,
  backbone}; weight decay is off for biases and LayerNorm weights;
- a linear warmup + linear decay with HF's ceil warmup, computed on the
  parameters' device from a device step counter (:class:`LinearSchedule`,
  as optax computes it from ``state.step``), written into each group's
  tensor ``lr``; on CUDA the AdamW is ``capturable``: nothing of a step
  reads the host;
- global-norm clipping as optax's ``clip_by_global_norm`` (scale by
  ``max_norm / norm`` only when the norm exceeds it); ``grad_norm`` is the
  norm before clipping.

Master parameters and the optimizer state stay fp32; with
``dtype=torch.bfloat16`` the forward runs under autocast, so the matmuls and
the attention kernels run in bf16 (the flax model's ``dtype=bf16``). Autocast
runs without its cast cache: each use of a weight casts it again, so each
use's gradient reaches the fp32 weight on its own, as JAX's per-use casts do,
and a CUDA graph of the step (which cannot hold the cache) computes what an
eager step computes. A visual backbone's ``image`` travels in the batch.

:class:`MultiTrainStep` runs K steps per call over a stacked group of K
batches (``peneo_tpu/pipeline/train.py:313``, a ``lax.scan`` under ``jit``
there): one replay of a CUDA graph of the K steps on the card, the K
eager steps in a loop on the CPU; in a process group too, the graph then
holding the steps' collectives.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.dropout_seeds import StepSeeds
from ..models.peneo import PEneoModel
from ..parallel.tensor_parallel import NO_TP, TpShard, reduce_from_tp
from .loader import tree_leaves, tree_map


def warmup_steps(total_steps: int, warmup_ratio: float) -> int:
    """HF's warmup: ``ceil(total_steps × warmup_ratio)``."""
    return math.ceil(total_steps * warmup_ratio)


def linear_schedule(lr: float, total_steps: int, warmup_ratio: float = 0.1,
                    n_warmup: Optional[int] = None) -> Callable[[int], float]:
    """Learning rate at optimizer step ``s`` (0-based): linear 0 → lr over
    the warmup, then lr → 0 at ``total_steps``."""
    warmup = n_warmup if n_warmup is not None else warmup_steps(
        total_steps, warmup_ratio)

    def at(step: int) -> float:
        if warmup > 0 and step < warmup:
            return lr * step / warmup
        return lr * max(0.0, (total_steps - step)
                        / max(total_steps - warmup, 1))

    return at


def is_no_decay(name: str) -> bool:
    """Biases and LayerNorm weights take no weight decay (reference:
    pipeline/trainer.py:277-282), by the JAX package's rule: a bias is a
    parameter named ``bias`` (LayoutLMv2's ``q_bias`` / ``v_bias`` decay), a
    LayerNorm one whose module's name ends in ``LayerNorm`` (LayoutLMv2's
    ``visual_LayerNorm`` too)."""
    return name.rsplit(".", 1)[-1] == "bias" or "LayerNorm." in name


class LinearSchedule:
    """:func:`linear_schedule` on the device: the optimizer step counter
    ``count`` (int64) and every group's learning rate (a 0-d fp32 view of
    one vector, the tensor the AdamW reads) live on the parameters' device.
    :meth:`apply` writes the rates of the step ``count`` counts; :meth:`step`
    advances it. A CUDA graph of the step reads and advances both on the
    card, where a ``LambdaLR``'s Python floats would be frozen at capture."""

    def __init__(self, optimizer, total_steps: int, warmup_ratio: float,
                 device) -> None:
        self.optimizer = optimizer
        self.total = total_steps
        self.warmup = warmup_steps(total_steps, warmup_ratio)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.base = torch.tensor([g["initial_lr"]
                                  for g in optimizer.param_groups],
                                 dtype=torch.float32, device=device)
        self.lr = torch.zeros_like(self.base)
        self._bind()

    def _bind(self) -> None:
        for i, group in enumerate(self.optimizer.param_groups):
            group["lr"] = self.lr[i]

    def multiplier(self) -> torch.Tensor:
        """The schedule's factor at step ``count`` (fp32, on the device)."""
        s = self.count.float()
        decay = torch.clamp_min((self.total - s)
                                / max(self.total - self.warmup, 1), 0.0)
        if self.warmup <= 0:
            return decay
        return torch.where(s < self.warmup, s / self.warmup, decay)

    def apply(self) -> torch.Tensor:
        """Write every group's rate for step ``count``; returns the vector."""
        torch.mul(self.base, self.multiplier(), out=self.lr)
        return self.lr

    def step(self) -> None:
        self.count += 1

    def state_dict(self) -> Dict[str, int]:
        return {"count": int(self.count)}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        """Restore the counter in place (a captured graph keeps reading
        it) and hand the optimizer this schedule's rate tensors again
        (``optimizer.load_state_dict`` replaces its groups' ``lr``). Also
        reads the ``LambdaLR`` state of older checkpoints, whose
        ``last_epoch`` counts the optimizer steps taken."""
        if "count" in state:
            count = state["count"]
        elif "last_epoch" in state:
            count = state["last_epoch"]
        else:
            raise ValueError("not a learning-rate schedule's state: keys "
                             f"{sorted(state)}")
        self.count.fill_(int(count))
        self._bind()
        self.apply()


def load_optimizer_state(optimizer, state) -> None:
    """``optimizer.load_state_dict(state)``, then ``capturable`` again as the
    parameters' device requires (on CUDA only), with each parameter's step
    count beside it: a checkpoint written on the other kind of device, or
    by a non-capturable AdamW, carries the other setting."""
    optimizer.load_state_dict(state)
    for group in optimizer.param_groups:
        cuda = group["params"][0].device.type == "cuda"
        group["capturable"] = cuda
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if cuda and "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)


def make_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                   warmup_ratio: float = 0.1, weight_decay: float = 0.01,
                   downstream_speedup_ratio: float = 1.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8):
    """AdamW over the four reference groups (``capturable`` on CUDA, each
    group's ``lr`` a device tensor) and its :class:`LinearSchedule`."""
    groups = {}
    device = None
    for name, param in model.named_parameters():
        if not param.requires_grad:
            continue
        device = param.device
        decoder = name.startswith("peneo_decoder.")
        key = (decoder, is_no_decay(name))
        if key not in groups:
            base = lr * (downstream_speedup_ratio if decoder else 1.0)
            groups[key] = {
                "params": [], "names": [], "initial_lr": base,
                "lr": torch.tensor(base, device=device),
                "weight_decay": 0.0 if key[1] else weight_decay}
        groups[key]["params"].append(param)
        groups[key]["names"].append(name)
    optimizer = torch.optim.AdamW(
        [groups[k] for k in sorted(groups)], lr=lr, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay, capturable=device.type == "cuda")
    scheduler = LinearSchedule(optimizer, total_steps, warmup_ratio, device)
    return optimizer, scheduler


def clip_by_global_norm(named, max_norm: Optional[float],
                        splits: Optional[Dict[str, int]] = None,
                        tp: TpShard = NO_TP,
                        shard_group=None) -> torch.Tensor:
    """Global L2 norm of the gradients of ``named`` ((name, parameter)
    pairs), fp32; scales them by ``max_norm / norm`` when it is larger (no
    host sync). The norm is the whole model's, as JAX's
    ``optax.clip_by_global_norm`` computes it over sharded leaves: under
    fsdp (``shard_group``, over which every parameter's disjoint shards are
    spread) the squares of the local shards are summed over that group;
    under tensor parallelism those of the split parameters (``splits``, by
    name) are summed over the tp group, and the replicated ones counted
    once."""
    splits = splits or {}
    with torch.no_grad():  # a sharded gradient's local tensor, in place
        named = [(n, _local(p.grad)) for n, p in named if p.grad is not None]
        grads = [g for _, g in named]
        if tp.size == 1 and shard_group is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm([g.float() for g in grads])))
        else:
            parts = ([g.float() for n, g in named if n in splits],
                     [g.float() for n, g in named if n not in splits])
            squares = torch.stack([
                torch.stack(torch._foreach_norm(part)).square().sum()
                if part else grads[0].new_zeros((), dtype=torch.float32)
                for part in parts])
            if shard_group is not None:
                dist.all_reduce(squares, group=shard_group)
            squares[0] = reduce_from_tp(squares[0], tp)
            norm = squares.sum().sqrt()
        if max_norm is not None and max_norm > 0:
            scale = torch.clamp(max_norm / norm, max=1.0)
            torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


def _local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A sharded (fsdp) tensor's local shard, any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def autocast(device: torch.device, dtype: torch.dtype):
    """bf16 autocast on the model's device without its cast cache, or
    nothing for fp32."""
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16,
                          cache_enabled=False)


def train_step(model: PEneoModel, optimizer, scheduler,
               batch: Dict[str, torch.Tensor], max_grad_norm: float = 1.0,
               generator=None, dtype: torch.dtype = torch.float32,
               grad_sync: Optional[Callable[[], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step. Returns the five head losses, ``total``,
    ``grad_norm`` (before clipping) and ``learning_rate`` (of the backbone
    groups, as used by this step), as device tensors; reads nothing back to
    the host. ``generator`` (a CPU generator, a
    :class:`~peneo_tpu_torch.models.dropout_seeds.HostSeeds` or a
    :class:`~peneo_tpu_torch.models.dropout_seeds.StepSeeds`) gives the
    attention-dropout seeds; ``grad_sync``, when given, averages the
    gradients over the replicas after the backward (a model that DDP or
    FSDP2 wraps averages them itself). ``model`` may be wrapped by DDP: the
    gradient norm reads the unwrapped module's ``tp_splits``, ``tp_shard``
    and ``fsdp_group``."""
    module = getattr(model, "module", model)
    model.train()
    device = batch["input_ids"].device
    lrs = scheduler.apply()  # groups sort backbone first
    optimizer.zero_grad(set_to_none=True)
    with autocast(device, dtype):
        losses = model(batch["input_ids"], batch["bbox"],
                       batch["attention_mask"], labels=batch["labels"],
                       generator=generator, image=batch.get("image"))
    losses["total"].backward()
    if grad_sync is not None:
        grad_sync()
    norm = clip_by_global_norm(
        [(n, p) for g in optimizer.param_groups
         for n, p in zip(g["names"], g["params"])], max_grad_norm,
        getattr(module, "tp_splits", None),
        getattr(module, "tp_shard", NO_TP),
        getattr(module, "fsdp_group", None))
    optimizer.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = norm
    metrics["learning_rate"] = lrs[0].clone()
    scheduler.step()
    return metrics


class MultiTrainStep:
    """K optimizer steps per call over a stacked group of K batches (every
    tensor's leading axis is K, the JAX layout): the counterpart of
    ``peneo_tpu/pipeline/train.py:313`` ``make_multi_train_step``. A call
    returns each metric's mean over the K steps; ``per_step`` holds the (K,)
    values of the last call. On the card the returned and per-step tensors
    are the graph's outputs: read them before the next call.

    On a CUDA model the K steps are one CUDA graph. The first call copies
    its group into static input buffers and runs the K steps eagerly on a
    side stream: that warm-up builds every kernel library, makes every
    ``cudaFuncSetAttribute``, allocates the optimizer's state and fills the
    models' shape caches, and its results are the call's. Then it captures
    the K steps once (a capture that fails raises; nothing falls back to
    the eager loop). Every later call copies its group into the buffers on
    the current stream and replays the graph there. The attention-dropout
    seeds are :class:`~peneo_tpu_torch.models.dropout_seeds.StepSeeds` of
    ``seed``, the schedule's counter and the (dp, tp) ``shard``, so each
    replay draws fresh masks, each shard its own. A kernel wrapper counts a
    launch when it is called, eagerly or under capture; what a replay
    launches shows in a trace of it. Restore a checkpoint before the first
    call: ``optimizer.load_state_dict`` replaces the state tensors that a
    captured graph keeps reading. In a process group the graph holds the
    collectives of every step (NCCL; gloo's run on the host and cannot be
    captured): ``grad_sync``'s gradient mean, or FSDP2's gathers and
    reduce-scatters, the tp and sp collectives and the losses' reductions.

    On the CPU the K steps run eagerly in a loop, with the attention seeds
    from ``generator`` (a CPU generator or a
    :class:`~peneo_tpu_torch.models.dropout_seeds.HostSeeds`). ``model``
    is the module the steps run (in a process group FSDP2's, or the plain
    one with ``grad_sync``); ``scheduler`` is the :class:`LinearSchedule` of
    :func:`make_optimizer`."""

    def __init__(self, model: PEneoModel, optimizer, scheduler,
                 steps_per_call: int, max_grad_norm: float = 1.0,
                 generator=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, shard: int = 0,
                 grad_sync: Optional[Callable[[], None]] = None) -> None:
        if steps_per_call < 1:
            raise ValueError("steps_per_call must be at least 1")
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.k = steps_per_call
        self.max_grad_norm = max_grad_norm
        self.generator = generator
        self.dtype = dtype
        self.grad_sync = grad_sync
        self.seeds = StepSeeds(seed, scheduler.count, shard)
        self.per_step: Dict[str, torch.Tensor] = {}
        self.graph = None
        self._static = None
        self._outputs = None

    def _steps(self, group, seeds):
        rows = [train_step(self.model, self.optimizer, self.scheduler,
                           tree_map(lambda t, k=k: t[k], group),
                           self.max_grad_norm, seeds, self.dtype,
                           self.grad_sync)
                for k in range(self.k)]
        per_step = {name: torch.stack([r[name] for r in rows])
                    for name in rows[0]}
        return {name: v.mean(0) for name, v in per_step.items()}, per_step

    def _check(self, group) -> None:
        shapes = [tuple(t.shape) for t in tree_leaves(group)]
        want = [tuple(t.shape) for t in tree_leaves(self._static)]
        if shapes != want:
            raise ValueError(f"the group's shapes {shapes} differ from the "
                             f"captured graph's {want}")

    def __call__(self, group) -> Dict[str, torch.Tensor]:
        if group["input_ids"].shape[0] != self.k:
            raise ValueError(f"expected a group of {self.k} batches, got "
                             f"{group['input_ids'].shape[0]}")
        device = self.scheduler.count.device
        if device.type != "cuda":
            means, self.per_step = self._steps(
                tree_map(lambda t: t.to(device), group), self.generator)
            return means
        if self.graph is not None:
            self._check(group)
            for dst, src in zip(tree_leaves(self._static),
                                tree_leaves(group)):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            means, self.per_step = self._outputs
            return means
        self._static = tree_map(lambda t: torch.empty_like(
            t, device=device).copy_(t, non_blocking=True), group)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # the warm-up: real steps
            means, self.per_step = self._steps(self._static, self.seeds)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the feed thread keeps pinning host memory meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._outputs = self._steps(self._static, self.seeds)
        return means


@torch.inference_mode()
def eval_step(model: PEneoModel, batch: Dict[str, torch.Tensor],
              with_loss: bool = False, dtype: torch.dtype = torch.float32):
    """Inference outputs of one batch; ``with_loss`` also returns the five
    head losses from the same forward (decoder ``also_decode``), with the
    batch's ``row_mask`` keeping edge-padded rows out of them."""
    model.eval()
    with autocast(batch["input_ids"].device, dtype):
        args = (batch["input_ids"], batch["bbox"], batch["attention_mask"])
        image = batch.get("image")
        if with_loss:
            losses, out = model(*args, labels=batch["labels"],
                                also_decode=True, image=image,
                                label_row_mask=batch.get("row_mask"))
            return out, losses
        return model(*args, image=image)
