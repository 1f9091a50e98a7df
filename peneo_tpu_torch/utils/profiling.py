"""Profiling and step-timing utilities.

Counterpart of ``peneo_tpu/utils/profiling.py``:

- :func:`trace` — context manager around ``torch.profiler`` (CPU, and CUDA
  when a card is present) writing a TensorBoard-loadable trace into a
  directory; it yields the profiler, whose ``key_averages()`` give the
  time by kernel.
- :class:`StepTimer` — rolling per-step wall-clock stats for a loop.
- :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of each visible
  card; ``{}`` without one.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, Optional

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


class StepTimer:
    """Seconds between successive :meth:`tick` calls over the last
    ``window`` steps."""

    def __init__(self, window: int = 100):
        self._window = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Mark a step's end; returns the seconds since the previous tick
        (None at the first)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._window.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0

    def throughput(self, items_per_step: int) -> float:
        m = self.mean
        return items_per_step / m if m else 0.0


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:i": torch.cuda.memory_stats(i)}`` for each visible card;
    ``{}`` when there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}
