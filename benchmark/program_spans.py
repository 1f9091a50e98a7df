"""What the per-layer metrics read from the program's own spans share: the
spans that ``peneo_tpu_torch.utils.tracing`` kept over a traced window, the
serving thread's among them, and the device's idle stretches of the window.

The program records its serving spans whenever a torch profiler is active
around ``PageServer.run``, as it is in a ``--trace 1`` run. A program that
keeps no such spans (one older than ``utils/tracing.py``) gives None here,
and its line leaves these metrics out.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def window(trace):
    """The program's spans that overlap the traced window, or None (no
    trace, or a program that keeps no spans)."""
    if trace is None:
        return None
    try:
        from peneo_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans(trace.start_ns, trace.end_ns) or None


def started(spans, name: str, trace) -> list:
    """The spans named ``name`` that start inside the window."""
    return [s for s in spans if s.name == name
            and trace.start_ns <= s.start_ns <= trace.end_ns]


def serving(spans, name: str) -> list:
    """The spans named ``name`` on the serving thread: the thread of the
    ``serve.run`` spans."""
    threads = {s.thread for s in spans if s.name == "serve.run"}
    return [s for s in spans if s.name == name and s.thread in threads]


def intervals(spans, trace) -> List[Tuple[int, int]]:
    """The spans' stretches clipped to the window, overlaps merged, in
    order."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((max(x.start_ns, trace.start_ns),
                        min(x.end_ns, trace.end_ns)) for x in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle(trace) -> List[Tuple[int, int]]:
    """The window's stretches with no device operation: the complement of
    the operations' union, as ``Trace.busy_s`` counts it."""
    out, edge = [], trace.start_ns
    for _, s, d in trace.ops:
        s, e = max(s, edge), min(s + d, trace.end_ns)
        if e > s:
            if s > edge:
                out.append((edge, s))
            edge = e
    if trace.end_ns > edge:
        out.append((edge, trace.end_ns))
    return out


def length(stretches) -> int:
    return sum(e - s for s, e in stretches)


def overlap(a, b) -> int:
    """ns that two ordered lists of disjoint stretches share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def mean_ms(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) / 1e6 if values else None
