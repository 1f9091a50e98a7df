"""``peneo_tpu_torch/utils/profiling.py`` against
``peneo_tpu/utils/profiling.py``: ``StepTimer`` gives the JAX timer's
ticks, mean and throughput on the same clock; ``trace`` writes a trace
file on the CPU (and nothing when disabled); ``device_memory_stats`` is
``{}`` without a card (one entry per card with one)."""

import json
import os
import time

import torch

from peneo_tpu.utils.profiling import StepTimer as JaxStepTimer
from peneo_tpu_torch.utils.profiling import StepTimer, device_memory_stats, \
    trace

torch.set_num_threads(1)


def test_step_timer_equals_jax_on_the_same_clock(monkeypatch):
    clock = [0.0, 0.5, 1.25, 1.5, 3.0, 3.1]
    runs = []
    for cls in (StepTimer, JaxStepTimer):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = cls(window=3)
        assert timer.mean == 0.0 and timer.throughput(8) == 0.0
        got = [timer.tick() for _ in clock]
        runs.append((got, timer.mean, timer.throughput(8)))
    assert runs[0] == runs[1]
    assert runs[0][0][0] is None and runs[0][0][1] == 0.5


def test_trace_writes_a_trace_file(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in row.key for row in prof.key_averages())
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_device_memory_stats():
    stats = device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
        return
    assert sorted(stats) == [f"cuda:{i}"
                             for i in range(torch.cuda.device_count())]
    assert all("allocated_bytes.all.current" in s for s in stats.values())
