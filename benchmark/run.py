"""Run one cell of the benchmark once, on the CUDA card(s) of this machine:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown`` of the traced window, and last the numbers the
output check compared (also the last lines of standard error). Without the
cards the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it exits non-zero and prints no result.

The program under test is ``peneo_tpu_torch``; the benchmark's own files
(this folder) are the yardstick: traffic, weights, plain references, metric
readers and roofline counts.
"""

from __future__ import annotations

import os

# a library the program imports may load JAX by itself unless told not to
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

from . import harness  # noqa: E402


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float = None,
             precision: str = None, root: str = harness.ROOT) -> dict:
    """One run of cell ``name``: the entry's result with the metrics this
    run reports (``metrics``) and the device block (``device``). ``device``
    ``cpu`` is for tests at a tiny configuration only."""
    spec = harness.benchmark_spec(root)
    resolved = harness.cell_spec(name, spec, root)
    entry = harness.entry_module(resolved["cell"]["entry"])
    out = entry.run({"spec": resolved, "seed": seed, "seconds": seconds,
                     "trace": trace, "device": device,
                     "t_process": t_process or time.time(),
                     "precision": precision})
    if trace:
        metrics = {}
        for m in harness.cell_metrics(name, spec, "per_layer"):
            value = harness.metric_reader(m["name"], root).read(
                out["run"], out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in harness.cell_metrics(name, spec, "end_to_end")}
    out["metrics"] = metrics
    return out


def main(argv=None) -> int:
    t_process = harness.process_start_time() or time.time()
    args = build_argparser().parse_args(argv)
    spec = harness.benchmark_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        sys.stderr.write(f"benchmark: no workload {args.workload!r}\n")
        return 2
    harness.require_cards(cell["chips"])
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_process=t_process)
    found = harness.loaded_forbidden()
    if found:
        sys.stderr.write("benchmark: the run loaded JAX or the JAX package: "
                         f"{found}; no result\n")
        return 4
    sys.stderr.write(json.dumps({"jobs": out["jobs"],
                                 "window_s": out["window_s"],
                                 "set_up_and_check_s": out["phases"],
                                 "last_run": out["last_run"]}) + "\n")
    checks = out["checks"]
    correct = all(c["ok"] for c in checks.values())
    trace = out["trace"]
    breakdown = ({"device_ops": trace.top_ops(10),
                  "idle_gaps": trace.idle_gaps(10)}
                 if trace is not None else None)
    harness.emit(correct, out["attempted"], out["failed"], out["metrics"],
                 harness.device_block(cell["chips"], out["memory_peak"],
                                      trace),
                 checks, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
