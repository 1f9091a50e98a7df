"""Spans and counters inside the port's serving path, on the clock of a
``torch.profiler`` trace.

A **span** is a named stretch of one thread's time. It keeps its start and
end on ``time.time_ns()``, the wall clock that the profiler stamps its host
and device events on, so a span lines up with the device's operations of
the same run; the thread's CPU time at both ends (``time.thread_time_ns()``:
wall minus CPU is time the thread waited, for the interpreter lock, I/O or
the device); the enclosing span on the same thread (``parent``); and ids
that chain the spans of one page: ``job`` (:func:`new_job`, one a
``PageServer.run`` call), ``page`` (the page's index in the job) and
``batch`` (the batch's index in the job). A child span inherits its
parent's ids. Spans are kept in memory, in a bounded buffer that drops the
oldest and counts what it drops (:func:`dropped`); read them with
:func:`spans`, or write them out with :func:`write_chrome_trace`.

A **counter** (:func:`count`) adds integers under a lock, so counts from
pool threads stay exact. Counters are always on (an integer add a batch or
a page); a count made inside an open recorded span is also added to that
span's ``counts``, so a window of spans gives the counts of its work.

Spans of ``PageServer.run`` (``pipeline/infer.py``;
``ArtifactInferenceService`` inherits them):

- ``serve.run``: one job, with ``pages``, ``batch_size`` and ``L``;
- ``serve.wait_page``: the serving thread blocked on the next preprocessed
  page (the preprocess pool's results, in order), ``page``;
- ``serve.dispatch``: one batch stacked, copied to the device and its
  forward launched, ``batch``, ``pages``, ``L``;
- ``serve.fetch``: one batch's outputs copied to the host, ``batch``; its
  child ``serve.fetch.own`` waits for that batch's own forward (a CUDA
  event recorded at dispatch), so the rest of ``serve.fetch`` is the copy
  and any wait behind batches dispatched after it;
- ``serve.preprocess``: one page's preprocess on its pool thread, ``page``,
  with the children ``serve.preprocess.read`` (image size, OCR JSON or
  tesseract), ``.image`` (a visual backbone's page image: decode, resize
  and the array; a text-only backbone opens none), ``.order`` (reading
  order), ``.tokenize`` (the line loop) and ``.pack`` (the padded arrays).
  With ``preprocess_procs`` the pages are preprocessed in other processes
  and these six are not recorded; ``serve.wait_page`` still shows the
  wait;
- ``serve.decode``: one page's host decode on the decode pool, ``page``
  and ``batch``.

Counters (each also a key of ``PageServer.last_run``, counted over the
job; ``PERF.md`` names the metric that reads each):

- at dispatch: ``serve.tokens_real`` (the real pages' tokens),
  ``serve.token_slots`` (batch × L, a tail batch's repeated rows
  included), ``serve.pair_cells_real`` (the upper triangle of each real
  page's decoder positions) and ``serve.pair_cells_computed`` (the cells
  ``models/decoder.py`` computes for the whole batch); one a forward of
  ``serve.graph_replays`` (its segments replayed as CUDA graphs),
  ``serve.graph_captures`` (a segment captured: the first batch of its
  shape) or ``serve.eager_forwards`` (it ran eagerly;
  ``pipeline/graphs.py``); for a visual backbone ``serve.visual_tokens``
  (LayoutLMv3's image positions of every row: batch × 197 at 224 px; 0
  for LayoutXLM) and ``serve.image_bytes`` (the page images' bytes
  copied to the device, every row's);
- at preprocess: ``preprocess.pages_cut`` (pages cut at
  ``max_token_len``), and for a visual backbone ``preprocess.images``
  (page images loaded) and ``preprocess.image_bytes`` (their files'
  bytes); none is counted in ``preprocess_procs`` workers;
- at decode: ``decode.spots_found.<head>`` (spots the device found) and
  ``decode.spots_dropped.<head>`` (those past ``max_spots_per_head``).

**When spans are recorded.** :func:`span` records inside a recorded span of
the same thread, or while a :func:`recording` block is open (the
operator's switch: ``serve.py --trace_out``). ``PageServer.run`` decides
once, at its start, on the calling thread (:func:`recorder`): it records
while a :func:`recording` block is open or a torch profiler is active on
that thread, so a profiled run gets the spans without asking. Otherwise a
span costs one call on a shared no-op object, and nothing is kept.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# a 51-s window of serving holds about 5,300 pages of ~10 spans each
CAPACITY = 1 << 17
IDS = ("job", "page", "batch")


class Span:
    """One finished (or open) span; times in ns."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "cpu_start_ns",
                 "cpu_end_ns", "id", "parent", "attrs", "counts")

    def __init__(self, name: str, attrs: Dict, thread: int = 0,
                 start_ns: int = 0, end_ns: int = 0, cpu_start_ns: int = 0,
                 cpu_end_ns: int = 0, parent: Optional[int] = None,
                 counts: Optional[Dict[str, int]] = None) -> None:
        self.name, self.attrs, self.thread = name, attrs, thread
        self.start_ns, self.end_ns = start_ns, end_ns
        self.cpu_start_ns, self.cpu_end_ns = cpu_start_ns, cpu_end_ns
        self.id, self.parent = next(_ids), parent
        self.counts = counts if counts is not None else {}

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def cpu_ns(self) -> int:
        return self.cpu_end_ns - self.cpu_start_ns


class Recorder:
    """The bounded buffer of finished spans and the counters."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        self.lock = threading.Lock()
        self.buffer: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.counters: Dict[str, int] = {}
        self.depth = 0  # open recording() blocks

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.buffer) == self.buffer.maxlen:
                self.dropped += 1
            self.buffer.append(span)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n


RECORDER = Recorder()
_ids = itertools.count(1)
_jobs = itertools.count(1)
_local = threading.local()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """The context of one recorded span."""

    __slots__ = ("span",)

    def __init__(self, name: str, attrs: Dict) -> None:
        self.span = Span(name, attrs)

    def __enter__(self) -> Span:
        s, stack = self.span, _stack()
        if stack:
            parent = stack[-1]
            s.parent = parent.id
            for k in IDS:
                if k in parent.attrs and k not in s.attrs:
                    s.attrs[k] = parent.attrs[k]
        s.thread = threading.get_ident()
        stack.append(s)
        s.cpu_start_ns = time.thread_time_ns()
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        s.end_ns = time.time_ns()
        s.cpu_end_ns = time.thread_time_ns()
        _stack().pop()
        RECORDER.add(s)


_NULL = contextlib.nullcontext()


class _Off:
    """What :func:`recorder` gives when nothing asks for spans."""

    on = False

    def span(self, name: str, **attrs):
        return _NULL


class _On:
    on = True

    def span(self, name: str, **attrs):
        return _Open(name, attrs)


OFF, ON = _Off(), _On()


def active() -> bool:
    """A :func:`recording` block is open, or a torch profiler is active on
    the calling thread."""
    if RECORDER.depth > 0:
        return True
    import torch  # not at import: preprocess workers load no torch

    return torch.autograd._profiler_enabled()


def recorder():
    """:data:`ON` where :func:`active`, else :data:`OFF`: decided once by a
    caller that then opens its spans with ``.span(name, **attrs)``."""
    return ON if active() else OFF


def span(name: str, **attrs):
    """A context manager that records a span named ``name`` inside a
    recorded span of this thread or while :func:`recording` is open; a
    shared no-op otherwise. ``attrs``: the ids (``job``, ``page``,
    ``batch``) and any numbers worth keeping."""
    if RECORDER.depth or getattr(_local, "stack", None):
        return _Open(name, attrs)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record spans while the block is open (in every thread)."""
    with RECORDER.lock:
        RECORDER.depth += 1
    try:
        yield
    finally:
        with RECORDER.lock:
            RECORDER.depth -= 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and to the innermost open recorded
    span of this thread."""
    RECORDER.count(name, n)
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def new_job() -> int:
    """A fresh job id."""
    return next(_jobs)


def spans(start_ns: Optional[int] = None,
          end_ns: Optional[int] = None) -> List[Span]:
    """The kept spans that overlap ``[start_ns, end_ns]``, by start."""
    with RECORDER.lock:
        kept = list(RECORDER.buffer)
    lo = start_ns if start_ns is not None else -1
    hi = end_ns if end_ns is not None else float("inf")
    return sorted((s for s in kept if s.end_ns >= lo and s.start_ns <= hi),
                  key=lambda s: s.start_ns)


def counters() -> Dict[str, int]:
    """Every counter's total since the process started (or :func:`clear`)."""
    with RECORDER.lock:
        return dict(RECORDER.counters)


def dropped() -> int:
    """Spans the full buffer dropped."""
    return RECORDER.dropped


def clear() -> None:
    """Forget every kept span, the drop count and the counters."""
    with RECORDER.lock:
        RECORDER.buffer.clear()
        RECORDER.dropped = 0
        RECORDER.counters.clear()


def write_chrome_trace(path: str, base_ns: int = 0) -> int:
    """Write the kept spans as a chrome trace: one complete event per span
    on its thread, with its ids, attributes, CPU ms and counts under
    ``args``, and a counter event at the end of each span that counted,
    with the running total. Returns the number of spans written.

    Timestamps are µs after ``base_ns`` on ``time.time_ns()``'s clock. A
    ``torch.profiler`` chrome trace (``export_chrome_trace``) stamps its
    events in µs after its ``baseTimeNanoseconds`` on the same clock: pass
    that as ``base_ns`` and append this file's ``traceEvents`` to the
    profiler's, and the spans sit under the process's own threads beside
    the device's streams (chrome://tracing, Perfetto)."""
    pid = os.getpid()
    events, totals, threads = [], {}, {}
    for s in spans():
        threads.setdefault(s.thread, len(threads))
        args = dict(s.attrs, cpu_ms=s.cpu_ns / 1e6, span_id=s.id)
        if s.parent is not None:
            args["parent"] = s.parent
        if s.counts:
            args["counts"] = dict(s.counts)
        events.append({"name": s.name, "ph": "X", "pid": pid,
                       "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": s.wall_ns / 1e3, "args": args})
        for name, n in s.counts.items():
            totals[name] = totals.get(name, 0) + n
            events.append({"name": name, "ph": "C", "pid": pid,
                           "ts": (s.end_ns - base_ns) / 1e3,
                           "args": {name: totals[name]}})
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"peneo spans {i}"}}
               for tid, i in threads.items()]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return sum(e["ph"] == "X" for e in events)
