"""Readings that set the limits of a cell's output check: the check's
numbers of the program as the configuration states it, and of the control,
over many seeds in one process, on the card:

    python -m benchmark.calibrate --workload <cell> --seeds 11 12 13 \\
        [--precision int8|int8_pair_head|fp8] [--seconds 3]

``--precision`` reads a bf16 serving cell in the precision below the one
the configuration states: ``int8`` the program's own int8 pair head and
backbone, ``int8_pair_head`` its int8 pair head alone, ``fp8`` the control,
the reference's pair head in float8 put in the program's place at the pair
stage (``entries/serve.py``). One JSON line per seed: its checks' values and
the cell's throughput. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness
from .run import run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=None,
                   choices=("int8", "int8_pair_head", "fp8"))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    spec = harness.benchmark_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    harness.require_cards(cell["chips"])
    for seed in args.seeds:
        out = run_cell(args.workload, seed, args.seconds, False,
                       precision=args.precision)
        print(json.dumps({
            "seed": seed, "precision": args.precision or "as configured",
            "checks": {k: c["value"] for k, c in out["checks"].items()},
            "metrics": {k: m["value"] for k, m in out["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
