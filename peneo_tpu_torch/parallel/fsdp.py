"""Fully sharded data parallelism (fsdp, ZeRO-3 over dp): every parameter
and its AdamW moments live 1/dp on each rank of a dp group; a unit's
parameters are gathered for its forward and backward, and their gradients
reduce-scattered.

Counterpart of the fsdp half of ``peneo_tpu/parallel/mesh.py``
(``param_shardings(fsdp=True)``, ``:103-142``) over processes, through
PyTorch's FSDP2 (``torch.distributed.fsdp.fully_shard``):

- **Placement** (:func:`fsdp_dims`, JAX's rule): a parameter of at least
  :data:`FSDP_MIN_ELEMENTS` elements (its full size, before a tp cut)
  shards its largest tp-free dim that dp divides, the first of equal ones
  in the flax leaf's order of dims (an ``nn.Linear`` weight is the flax
  kernel transposed, a ``Conv2d`` weight (out, in, kh, kw) the flax (kh, kw,
  in, out) kernel), so each rank holds the elements JAX's device holds.
- **The smaller leaves, by design**: FSDP2 shards every parameter of a unit
  and cannot leave one replicated, so a leaf JAX replicates (under 2^15
  elements, or no free dim that dp divides) is sharded on dim 0, unevenly
  where dp does not divide it (FSDP2 pads only dim 0).
- **Units** (:func:`apply_fsdp`): each backbone layer, the backbone's
  embeddings (LiLT's layout embeddings too), the decoder as one unit, and
  the root for the rest (the rel-bias tables, the patch embedding, the
  visual tower). The decoder reads its weights outside its submodules'
  forwards (``combine_fc``, ``partial_linear``, the sp row shards), all
  under its own forward: no unit nests in it. Gathered parameters stay fp32
  (no ``param_dtype``): autocast casts each use, as in one process.
- **Groups**: the dp ranks of this rank's (t, s) column. At sp 1 FSDP
  shards over them; at sp > 1 a (sp, dp) mesh replicates over sp and shards
  over dp (HSDP), so the gradient mean runs over the replica group that DDP
  averages over without fsdp. Under tp each rank shards its tp shard.
- **States**: checkpoints stay full and sharding-agnostic. :func:`full_state`
  and :func:`full_optimizer_state` gather the shards (a collective: every
  rank calls them), :func:`load_full_state` and
  :func:`shard_optimizer_moments` cut a full state for this rank. On a model
  without fsdp they change nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from . import dist as pdist
from . import tensor_parallel as tpar

# leaves smaller than this are replicated under JAX's fsdp
FSDP_MIN_ELEMENTS = 2 ** 15


def flax_dim_order(module: nn.Module, ndim: int) -> Tuple[int, ...]:
    """The torch dims of ``module``'s weight in the order of the flax
    leaf's dims."""
    if isinstance(module, nn.Linear) and ndim == 2:
        return (1, 0)
    if isinstance(module, nn.Conv2d) and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def fsdp_dims(model: nn.Module, dp: int, tp: int = 1,
              min_elements: int = FSDP_MIN_ELEMENTS
              ) -> Dict[str, Optional[int]]:
    """The dim JAX's ``param_shardings(fsdp=True)`` shards over dp, by
    parameter name (None: replicated there). ``model`` holds this rank's
    shards of a tp group of ``tp`` (``model.tp_splits``) or the full
    tensors: sizes, divisibility and the dims the tp rules name (free of dp
    even at tp 1, as in JAX's specs) are the full tensor's."""
    splits = getattr(model, "tp_splits", {})
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    shapes = {}
    for name, p in params.items():
        shapes[name] = list(p.shape)
        if name in splits:
            shapes[name][splits[name]] *= tp
    rules = tpar.rule_dims(shapes, tp)
    out: Dict[str, Optional[int]] = {}
    for name, shape in shapes.items():
        out[name] = None
        if dp == 1 or math.prod(shape) < min_elements:
            continue
        owner = modules[name.rsplit(".", 1)[0]] if "." in name else model
        free = [d for d in flax_dim_order(owner, len(shape))
                if d != rules.get(name) and shape[d] % dp == 0]
        if free:
            out[name] = max(free, key=lambda d: shape[d])
    return out


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules sharded as units of their own, before the root: each
    backbone layer, the embeddings and the decoder."""
    backbone = model.backbone
    units = list(backbone.encoder.layer)
    for name in ("embeddings", "layout_embeddings"):
        if hasattr(backbone, name):
            units.append(getattr(backbone, name))
    units.append(model.peneo_decoder)
    return units


def fsdp_mesh(device_type: str):
    """The mesh of this rank's dp column of the ``dp × tp × sp`` grid
    (``parallel/dist.py`` ``grid``): 1-D over dp at sp 1, else (sp, dp) for
    HSDP. Every rank builds the whole grid's mesh (a collective)."""
    from torch.distributed.device_mesh import DeviceMesh

    dp, tp, sp = pdist.dp_size(), pdist.tp_size(), pdist.sp_size()
    # rank = (d·tp + t)·sp + s; the mesh's dims in the order (tp, sp, dp)
    ranks = torch.arange(pdist.world()).view(dp, tp, sp).permute(1, 2, 0)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=("tp", "sp", "dp"))
    return mesh["sp", "dp"] if sp > 1 else mesh["dp"]


def apply_fsdp(model: nn.Module, device: torch.device) -> None:
    """Shard ``model`` (already cut to this rank's tp shards) over the dp
    ranks of its column, unit by unit (:func:`fsdp_units`, then the root),
    each parameter on its :func:`fsdp_dims` dim (dim 0 where JAX
    replicates). Build the optimizer afterwards: FSDP2 replaces every
    parameter by a sharded one, under the same name. Sets
    ``model.fsdp_group``, the group a parameter's shards are spread over
    (None at dp 1)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    mesh = fsdp_mesh(device.type)
    dims = fsdp_dims(model, pdist.dp_size(), pdist.tp_size())
    by_param = {p: dims[name] for name, p in model.named_parameters()}

    def place(param):
        dim = by_param[param]
        return Shard(0 if dim is None else dim)

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh, shard_placement_fn=place)
    fully_shard(model, mesh=mesh, shard_placement_fn=place)
    model.fsdp_group = (mesh.get_group("dp") if pdist.dp_size() > 1
                        else None)


def _full(t):
    """A sharded tensor's full value (a collective over its mesh), any
    other tensor itself. Each Shard placement's chunks (``torch.chunk``'s,
    padded to the largest) are gathered with ``all_gather_into_tensor``,
    which NCCL and gloo (CPU and CUDA tensors) both run: two gloo ranks
    sharing a card died (SIGSEGV) in a save through ``full_tensor``."""
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    for mesh_dim, placement in enumerate(t.placements):
        if not placement.is_shard():
            continue
        group = t.device_mesh.get_group(mesh_dim)
        n, dim, size = dist.get_world_size(group), placement.dim, \
            t.shape[placement.dim]
        chunk = -(-size // n)
        rows = local.movedim(dim, 0)
        padded = rows.new_zeros((chunk, *rows.shape[1:]))
        padded[:rows.shape[0]] = rows
        out = rows.new_empty((n * chunk, *rows.shape[1:]))
        dist.all_gather_into_tensor(out, padded, group=group)
        local = torch.cat([out[i * chunk:i * chunk + min(chunk, max(
            0, size - i * chunk))] for i in range(n)]).movedim(0, dim)
    return local


def full_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict with every sharded tensor gathered to the full one."""
    return {k: _full(v) for k, v in state.items()}


def full_optimizer_state(opt_state: Dict) -> Dict:
    """An optimizer state dict with its sharded moments gathered."""
    return {**opt_state,
            "state": {i: {k: _full(v) for k, v in s.items()}
                      for i, s in opt_state["state"].items()}}


def shard_like(full: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's shard of ``full``, laid out as ``like``: each Shard
    placement keeps its mesh coordinate's chunk (``torch.chunk``, an empty
    one past the last, as FSDP2 chunks)."""
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    local = full
    for mesh_dim, placement in enumerate(like.placements):
        if placement.is_shard():
            chunks = torch.chunk(local, mesh.size(mesh_dim), placement.dim)
            i = coord[mesh_dim]
            local = (chunks[i] if i < len(chunks)
                     else local.narrow(placement.dim, 0, 0))
    local = local.to(like.device, like.dtype).contiguous().view(
        like.to_local().shape)
    return DTensor.from_local(local.clone(), mesh, like.placements,
                              shape=like.shape, stride=like.stride())


def load_full_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict`` of a full state dict (this rank's tp
    shards), each sharded parameter cut to its shard first."""
    params = dict(model.named_parameters())
    model.load_state_dict({
        k: (shard_like(v, params[k]) if isinstance(params.get(k), DTensor)
            else v) for k, v in state.items()})


def shard_optimizer_moments(optimizer) -> None:
    """After ``optimizer.load_state_dict`` of a full state: cut each moment
    of a sharded parameter (a tensor of the parameter's full shape) to the
    parameter's shard."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not isinstance(p, DTensor):
                continue
            st = optimizer.state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v) and not isinstance(v, DTensor) \
                        and v.shape == p.shape:
                    st[k] = shard_like(v, p)
