"""Where each layer's attention-dropout seed comes from in a training step.

An eager step draws one seed per layer on the host from the caller's CPU
``torch.Generator`` (LiLT, LayoutLMv3 and LayoutLMv2 alike), outside any
checkpointed region, so that a recompute replays the same masks. In a CUDA
graph of the step (``pipeline/train.py``, ``MultiTrainStep``) a host draw
would run once, at capture, and every replay would redraw the masks of that
one value. There the seeds come from :class:`StepSeeds` instead: a 0-d int64
tensor per layer, computed on the card from the optimizer's step counter,
which the graph itself advances, so each replay draws fresh masks. The
attention kernels #2 and #5 read such a seed from device memory when they
run (``ops/biacm_attention.py``, ``ops/bias_attention.py``).

A seed is a pure function of the trainer's seed, the step, the layer and
the (dp, tp) shard ``d·tp + t``: ``seed · 2³² + step · 64 + layer + shard ·
1000003``, the Philox key (lo word ``step · 64 + layer + shard · 1000003``,
hi word ``seed``). A resumed run draws the attention masks of an
uninterrupted one. (The hidden dropout draws from the device's default
generator, which a graph advances by its own offsets on every replay.)

Every (dp, tp) shard draws its own attention masks: a dp index for its own
rows of the batch, a tp index for its own heads. The seed of each layer is
offset by ``(d·tp + t) · 1000003``, as the JAX kernels offset it per (dp,
tp) shard (``peneo_tpu/ops/biacm_attention.py:174-199``,
``bias_attention.py:519-543``), for the host-drawn seeds (:class:`HostSeeds`)
and the device-resident ones (:class:`StepSeeds`) alike. The sp ranks of one
shard share it: they run one backbone forward on the same rows, and must
draw the same masks for the sum of their gradients to be the gradient of
that one forward. The hidden dropout acts on activations every tp rank holds
whole, so the trainer seeds the default generator by the dp index alone,
and the tp ranks of a dp index draw the same hidden masks.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

LAYERS_PER_STEP = 64  # room for this many layers in a step's key range
RANK_STRIDE = 1000003  # a (dp, tp) shard's seed offset (the JAX shards')


class StepSeeds:
    """The layer seeds of the step that ``step`` (an int64 device tensor,
    the optimizer's step counter) counts, under the trainer's ``seed``, at
    (dp, tp) shard ``shard`` = d·tp + t."""

    def __init__(self, seed: int, step: torch.Tensor,
                 shard: int = 0) -> None:
        if not 0 <= seed < 2 ** 31:
            raise ValueError(f"seed must lie in [0, 2^31), got {seed}")
        self.base = (seed << 32) + shard * RANK_STRIDE
        self.step = step

    def layer(self, index: int) -> torch.Tensor:
        if not 0 <= index < LAYERS_PER_STEP:
            raise ValueError(f"layer index {index} out of [0, "
                             f"{LAYERS_PER_STEP})")
        return self.step * LAYERS_PER_STEP + (self.base + index)


class HostSeeds:
    """Seeds drawn on the host from the CPU ``generator``, offset for (dp,
    tp) shard ``shard`` = d·tp + t: each rank draws the same numbers and
    adds its shard's offset."""

    def __init__(self, generator: Optional[torch.Generator],
                 shard: int = 0) -> None:
        self.generator = generator
        self.offset = shard * RANK_STRIDE

    def layer(self, index: int) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=self.generator)) + self.offset


def layer_seed(source: Union[StepSeeds, HostSeeds, torch.Generator, None],
               index: int) -> Union[int, torch.Tensor]:
    """Layer ``index``'s attention-dropout seed: from a :class:`StepSeeds`
    a device tensor, from a :class:`HostSeeds` its offset draw, else an int
    drawn from the CPU generator ``source`` (the default generator when
    None)."""
    if isinstance(source, (StepSeeds, HostSeeds)):
        return source.layer(index)
    return HostSeeds(source).layer(index)
