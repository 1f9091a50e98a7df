"""``peneo_tpu_torch/utils/profiling.py``: ``trace`` writes a trace file
on the CPU (and nothing when disabled); ``device_memory_stats`` is ``{}``
without a card (one entry per card with one)."""

import json
import os

import torch

from peneo_tpu_torch.utils.profiling import device_memory_stats, trace

torch.set_num_threads(1)


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
