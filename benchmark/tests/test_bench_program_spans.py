"""The metrics that read the program's own spans and counters
(``benchmark/program_spans.py``): known values from a synthetic trace and
synthetic spans, None without a trace or from a program that keeps no
spans, and every one read from a traced run of the tiny cell on the CPU."""

from __future__ import annotations

import sys
import tempfile
import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELL, tiny_root
from peneo_tpu_torch.utils import tracing

MS = 1_000_000
SERVING, POOL = 1, 2
READERS = ("page_wait_share.serve", "idle_page_wait_share.serve",
           "dispatch_ms_per_batch", "fetch_ms_per_batch",
           "preprocess_wait_ms_per_page", "pair_grid_useful_share.serve")


def span(name, thread, start, end, cpu=None, counts=None):
    return tracing.Span(name, {}, thread=thread, start_ns=start * MS,
                        end_ns=end * MS, cpu_start_ns=0,
                        cpu_end_ns=(end - start if cpu is None else cpu) * MS,
                        counts=counts)


@pytest.fixture
def synthetic():
    """A window of 10 ms from 1 ms: the device busy over 2-4.5 and 7-8 ms
    (idle 6.5 ms), the serving thread waiting for pages over 1-3, 5-6 and
    10.5-11.5 ms (3.5 ms inside the window, 2.5 of them while the device
    idles); a pool thread's waits do not count; spans that start before
    the window do not count in the means."""
    tracing.clear()
    for s in [
        span("serve.run", SERVING, 1, 11),
        span("serve.wait_page", SERVING, 1, 3),
        span("serve.wait_page", SERVING, 5, 6),
        span("serve.wait_page", SERVING, 10.5, 11.5),
        span("serve.wait_page", POOL, 3, 9),
        span("serve.dispatch", SERVING, 0.5, 0.9, counts={
            "serve.pair_cells_real": 100,
            "serve.pair_cells_computed": 100}),
        span("serve.dispatch", SERVING, 3, 3.4, counts={
            "serve.pair_cells_real": 30, "serve.pair_cells_computed": 100}),
        span("serve.dispatch", SERVING, 6, 6.6, counts={
            "serve.pair_cells_real": 10, "serve.pair_cells_computed": 100}),
        span("serve.fetch", SERVING, 4, 5),
        span("serve.fetch", SERVING, 8, 10),
        span("serve.preprocess", POOL, 2, 4, cpu=0.5),
        span("serve.preprocess", POOL, 4, 5, cpu=1),
    ]:
        tracing.RECORDER.add(s)
    ops = [("a", 2 * MS, 2 * MS), ("b", 3.5 * MS, 1 * MS),
           ("c", 7 * MS, 1 * MS)]
    yield harness.Trace(ops, [], 1 * MS, 11 * MS)
    tracing.clear()


def read(name, trace, run=None):
    return harness.metric_reader(name).read(run or {}, trace)


@pytest.mark.parametrize("name,want", [
    ("page_wait_share.serve", 35.0),
    ("idle_page_wait_share.serve", 100 * 2.5 / 6.5),
    ("dispatch_ms_per_batch", 0.5),
    ("fetch_ms_per_batch", 1.5),
    ("preprocess_wait_ms_per_page", 0.75),
    ("pair_grid_useful_share.serve", 20.0),
])
def test_known_values(synthetic, name, want):
    assert read(name, synthetic) == pytest.approx(want, rel=1e-9)


def test_idle_is_the_complement_of_busy(synthetic):
    from benchmark import program_spans

    idle = program_spans.length(program_spans.idle(synthetic))
    assert idle / 1e9 == pytest.approx(synthetic.window_s
                                       - synthetic.busy_s())


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(synthetic, monkeypatch, name):
    assert read(name, None) is None
    # a program that keeps no spans (one older than utils/tracing.py)
    import peneo_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "peneo_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(peneo_tpu_torch.utils, "tracing")
    assert read(name, synthetic) is None
    monkeypatch.undo()
    tracing.clear()
    assert read(name, synthetic) is None


def test_a_traced_run_on_the_cpu_reads_every_metric():
    root = tiny_root(tempfile.mkdtemp())
    resolved = harness.cell_spec(CELL, harness.benchmark_spec(root), root)
    tracing.clear()
    out = harness.entry_module("serve").run({
        "spec": resolved, "seed": 2 ** 31 + 5, "seconds": 0.3,
        "trace": True, "device": "cpu", "t_process": time.time(),
        "precision": None})
    assert all(c["ok"] for c in out["checks"].values()), out["checks"]
    # the CPU trace holds no device operation to be idle between
    got = {name: harness.metric_reader(name, root).read(out["run"],
                                                        out["trace"])
           for name in READERS if name != "idle_page_wait_share.serve"}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["page_wait_share.serve"] < 100
    assert got["pair_grid_useful_share.serve"] < 100
    assert out["last_run"]["serve.token_slots"] > 0
    tracing.clear()
