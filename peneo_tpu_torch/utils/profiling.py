"""Profiling utilities.

Counterpart of ``peneo_tpu/utils/profiling.py``:

- :func:`trace` — context manager around ``torch.profiler`` (CPU, and CUDA
  when a card is present) writing a TensorBoard-loadable trace into a
  directory; it yields the profiler, whose ``key_averages()`` give the
  time by kernel.
- :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of each visible
  card; ``{}`` without one.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile the block into ``logdir`` (``*.pt.trace.json``, read by
    TensorBoard's profiler plugin or chrome://tracing); a no-op yielding
    None when not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:i": torch.cuda.memory_stats(i)}`` for each visible card;
    ``{}`` when there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}
