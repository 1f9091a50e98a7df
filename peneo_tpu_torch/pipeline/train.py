"""Training and eval steps + the reference's four-group AdamW.

Counterpart of ``peneo_tpu/pipeline/train.py:35-197`` (reference: the HF
Trainer internals, pipeline/trainer.py:275-354):

- ``torch.optim.AdamW`` in four parameter groups, {decay, no-decay} ×
  {decoder (``peneo_decoder.*``) at lr × ``peneo_downstream_speedup_ratio``,
  backbone}; weight decay is off for biases and LayerNorm weights;
- a ``LambdaLR`` linear warmup + linear decay with HF's ceil warmup;
- global-norm clipping as optax's ``clip_by_global_norm`` (scale by
  ``max_norm / norm`` only when the norm exceeds it); ``grad_norm`` is the
  norm before clipping.

Master parameters and the optimizer state stay fp32; with
``dtype=torch.bfloat16`` the forward runs under autocast, so the matmuls and
the attention kernels run in bf16 (the flax model's ``dtype=bf16``). A visual
backbone's ``image`` travels in the batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..models.peneo import PEneoModel


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
    pipeline/trainer.py:277-282)."""
    return name.endswith("bias") or ".LayerNorm." in name


def make_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                   warmup_ratio: float = 0.1, weight_decay: float = 0.01,
                   downstream_speedup_ratio: float = 1.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8):
    """AdamW over the four reference groups and its LambdaLR schedule."""
    groups = {}
    for name, param in model.named_parameters():
        if not param.requires_grad:
            continue
        decoder = name.startswith("peneo_decoder.")
        key = (decoder, is_no_decay(name))
        if key not in groups:
            groups[key] = {
                "params": [], "names": [],
                "lr": lr * (downstream_speedup_ratio if decoder else 1.0),
                "weight_decay": 0.0 if key[1] else weight_decay}
        groups[key]["params"].append(param)
        groups[key]["names"].append(name)
    optimizer = torch.optim.AdamW(
        [groups[k] for k in sorted(groups)], lr=lr, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay)
    multiplier = linear_schedule(1.0, total_steps, warmup_ratio)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, multiplier)
    return optimizer, scheduler


def clip_by_global_norm(params, max_norm: Optional[float]) -> torch.Tensor:
    """Global L2 norm of the gradients (fp32); scales them by
    ``max_norm / norm`` when it is larger (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))
    if max_norm is not None and max_norm > 0:
        scale = torch.clamp(max_norm / norm, max=1.0)
        torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


def autocast(device: torch.device, dtype: torch.dtype):
    """bf16 autocast on the model's device, or nothing for fp32."""
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)


def train_step(model: PEneoModel, optimizer, scheduler,
               batch: Dict[str, torch.Tensor], max_grad_norm: float = 1.0,
               generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """One optimizer step. Returns the five head losses, ``total``,
    ``grad_norm`` (before clipping) and ``learning_rate`` (of the backbone
    groups, as used by this step), as device tensors."""
    model.train()
    device = batch["input_ids"].device
    lr = scheduler.get_last_lr()[0]  # groups sort backbone first
    optimizer.zero_grad(set_to_none=True)
    with autocast(device, dtype):
        losses = model(batch["input_ids"], batch["bbox"],
                       batch["attention_mask"], labels=batch["labels"],
                       generator=generator, image=batch.get("image"))
    losses["total"].backward()
    norm = clip_by_global_norm(
        [p for g in optimizer.param_groups for p in g["params"]],
        max_grad_norm)
    optimizer.step()
    scheduler.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = norm
    metrics["learning_rate"] = torch.tensor(lr)
    return metrics


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
