"""What every cell shares: reading the benchmark's files by name, the
device's description, the check that the process holds no JAX, the
reduction of a profiler trace, and the result line.

The benchmark is data. ``BENCHMARK.json`` at the checkout's root names the
cells; a cell's name finds ``workloads/<cell>.json`` (its entry, serving or
training parameters and the limits of its output check), whose ``config``
finds ``configs/<config>.json`` through ``BENCHMARK.json`` and whose
``traffic`` finds ``traffic/<traffic>.json``. A per-layer metric is read by
``metrics/<metric>.py`` and a kernel's operations and bytes are counted by
``roofline/<kernel>.py``. An entry is ``entries/<entry>.py``. A new cell,
traffic mix, configuration or metric is a new file: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "peneo_tpu")


def read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> Dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def bench_dir(root: str) -> str:
    """The benchmark's folder of a checkout rooted at ``root``."""
    return os.path.join(root, os.path.basename(HERE))


def cell_spec(name: str, spec: Dict, root: str = ROOT) -> Dict:
    """The cell ``name`` resolved: its ``BENCHMARK.json`` entry
    (``workload``), ``workloads/<name>.json`` (``cell``), its configuration
    file (``config``) and its traffic file (``traffic``)."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = bench_dir(root)
    cell = read_json(os.path.join(here, "workloads", name + ".json"))
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return {"workload": entry, "cell": cell,
            "config": read_json(os.path.join(root, conf["file"])),
            "traffic": read_json(os.path.join(here, "traffic",
                                              entry["traffic"] + ".json")),
            "root": root}


def backbone_config(config: Dict) -> Dict:
    """The published backbone keys of a configuration file (without the
    decoder's group, the served type and the notes)."""
    return {k: v for k, v in config.items()
            if k not in ("peneo", "assumed", "family", "served",
                         "backbone_name")}


def cell_metrics(name: str, spec: Dict, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports: those that list it, or list no cells."""
    return [m for m in spec[kind]
            if "workloads" not in m or name in m["workloads"]]


def load_file_module(path: str, name: str):
    """A module from a file whose name may hold dots
    (``metrics/mfu.serve.py``)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def metric_reader(metric: str, root: str = ROOT):
    return load_file_module(
        os.path.join(bench_dir(root), "metrics", metric + ".py"),
        "benchmark_metric_" + metric.replace(".", "_"))


def roofline(kernel: str, root: str = ROOT):
    return load_file_module(
        os.path.join(bench_dir(root), "roofline", kernel + ".py"),
        "benchmark_roofline_" + kernel)


def entry_module(entry: str):
    return importlib.import_module(f"benchmark.entries.{entry}")


def reference_module(family: str):
    """The plain reference of a model family, ``reference/<family>.py``."""
    return importlib.import_module(f"benchmark.reference.{family}")


def peaks(kind: str, root: str = ROOT) -> Dict:
    """The published peaks of the card named ``kind``."""
    table = read_json(os.path.join(bench_dir(root), "peaks.json"))
    for card in table["cards"]:
        if card["match"] in kind:
            return card
    raise KeyError(f"no published peaks for {kind!r} in peaks.json")


def loaded_forbidden() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``peneo_tpu_torch`` is not ``peneo_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    """Exit with code 3 and no result unless ``n`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"benchmark: this cell needs {n} CUDA card(s), "
                         f"{have} visible; no result\n")
        sys.exit(3)


def process_start_time() -> Optional[float]:
    """The process's start on the ``time.time()`` clock, from
    ``/proc/self/stat`` (None where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, field 22 of stat
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import time

        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return None


# ------------------------------------------------------------------ traces
class Trace:
    """A profiled window reduced to what the metric readers take: the
    device's operations ``(name, start_ns, dur_ns)``, the host's annotated
    spans ``(name, start_ns, end_ns)``, and the window's edges (ns)."""

    def __init__(self, ops, spans, start_ns: int, end_ns: int,
                 launches=(), op_by_launch=None) -> None:
        self.ops, self.spans = ops, spans
        self.start_ns, self.end_ns = start_ns, end_ns
        # (host time, correlation id) of each launch; device ns by id
        self.launches = sorted(launches)
        self.op_by_launch = op_by_launch or {}

    @classmethod
    def from_profiler(cls, prof, start_ns: int, end_ns: int) -> "Trace":
        ops, spans, launches, by_launch = [], [], [], {}
        for e in prof.profiler.kineto_results.events():
            kind = str(getattr(e, "activity_type", lambda: "")()).lower()
            if str(e.device_type()).endswith("CUDA"):
                if e.is_user_annotation() or "annotation" in kind:
                    continue
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
                corr = e.correlation_id()
                by_launch[corr] = by_launch.get(corr, 0) + e.duration_ns()
            elif e.is_user_annotation():
                if e.name().startswith("bench."):
                    spans.append((e.name(), e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
            elif e.name().startswith(("cuda", "cu")) and e.correlation_id():
                launches.append((e.start_ns(), e.correlation_id()))
        ops.sort(key=lambda o: o[1])
        spans.sort(key=lambda s: s[1])
        return cls(ops, spans, start_ns, end_ns, launches, by_launch)

    def span_device_s(self, name: str) -> List[float]:
        """Per host span ``name``: device seconds of the operations that
        were launched inside it (matched by the launch's correlation)."""
        import bisect

        times = [t for t, _ in self.launches]
        out = []
        for span, s, e in self.spans:
            if span != name:
                continue
            lo = bisect.bisect_left(times, s)
            hi = bisect.bisect_right(times, e)
            out.append(sum(self.op_by_launch.get(c, 0)
                           for _, c in self.launches[lo:hi]) / 1e9)
        return out

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (overlaps
        counted once), inside the window."""
        busy, edge = 0, self.start_ns
        for _, s, d in self.ops:
            s, e = max(s, edge), min(s + d, self.end_ns)
            if e > s:
                busy += e - s
                edge = e
        return busy / 1e9

    def op_seconds(self, match: str) -> List[float]:
        """Durations (s) of the device operations whose name holds
        ``match``."""
        return [d / 1e9 for n, _, d in self.ops if match in n]

    def top_ops(self, n: int = 10):
        total: Dict[str, float] = {}
        for name, _, d in self.ops:
            total[name] = total.get(name, 0.0) + d / 1e9
        return sorted(([k[:120], v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest stretches with no device operation, each named by
        the innermost host span that held its start."""
        gaps, edge = [], self.start_ns
        for _, s, d in self.ops + [("", self.end_ns, 0)]:
            if s > edge:
                gaps.append((s - edge, edge))
            edge = max(edge, s + d)
        gaps.sort(reverse=True)
        out = []
        for length, start in gaps[:n]:
            inside = [sp for sp in self.spans if sp[1] <= start < sp[2]]
            label = (min(inside, key=lambda sp: sp[2] - sp[1])[0]
                     if inside else "no host span")
            out.append([label, length / 1e9])
        return out


# ------------------------------------------------------------- result line
def device_block(count: int, memory_peak: int, trace: Optional[Trace]):
    import torch

    block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": count, "memory_peak_bytes": int(memory_peak)}
    if trace is not None:
        block["busy_s"] = trace.busy_s()
        block["window_s"] = trace.window_s
    return block


def emit(correct: bool, attempted: int, failed: int, metrics: Dict,
         device: Dict, checks: Dict, breakdown: Optional[Dict]) -> None:
    """The check's numbers on the last lines of standard error, then the
    result as the last line of standard output (the checks' key last)."""
    for name, c in checks.items():
        sys.stderr.write(f"check {name}: {c['value']!r} limit {c['limit']!r}"
                         f" {'ok' if c['ok'] else 'FAILED'}\n")
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
