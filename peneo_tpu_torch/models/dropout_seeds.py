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

A seed is a pure function of the trainer's seed, the step and the layer:
``seed · 2³² + step · 64 + layer``, the Philox key (lo word ``step · 64 +
layer``, hi word ``seed``). A resumed run draws the attention masks of an
uninterrupted one. (The hidden dropout draws from the device's default
generator, which a graph advances by its own offsets on every replay.)
"""

from __future__ import annotations

from typing import Union

import torch

LAYERS_PER_STEP = 64  # room for this many layers in a step's key range


class StepSeeds:
    """The layer seeds of the step that ``step`` (an int64 device tensor,
    the optimizer's step counter) counts, under the trainer's ``seed``."""

    def __init__(self, seed: int, step: torch.Tensor) -> None:
        if not 0 <= seed < 2 ** 31:
            raise ValueError(f"seed must lie in [0, 2^31), got {seed}")
        self.base = seed << 32
        self.step = step

    def layer(self, index: int) -> torch.Tensor:
        if not 0 <= index < LAYERS_PER_STEP:
            raise ValueError(f"layer index {index} out of [0, "
                             f"{LAYERS_PER_STEP})")
        return self.step * LAYERS_PER_STEP + (self.base + index)


def layer_seed(source: Union[StepSeeds, torch.Generator, None],
               index: int) -> Union[int, torch.Tensor]:
    """Layer ``index``'s attention-dropout seed: from a :class:`StepSeeds`
    a device tensor, else an int drawn from the CPU generator ``source``
    (the default generator when None)."""
    if isinstance(source, StepSeeds):
        return source.layer(index)
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=source))
