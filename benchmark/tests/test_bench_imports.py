"""The benchmark loads neither JAX nor the JAX package, and reads none of
the files measured before the port.

Names are compared by their top-level part, whole: ``peneo_tpu_torch``
passes, ``peneo_tpu`` fails."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

from benchmark import harness

PROBE = r"""
import json, sys, tempfile
from benchmark import harness
from benchmark.run import run_cell
from benchmark.tests.tiny import CELL, tiny_root
import benchmark.calibrate
spec = harness.benchmark_spec()
for m in spec["per_layer"]:
    harness.metric_reader(m["name"])
root = tiny_root(tempfile.mkdtemp())
run_cell(CELL, 7, 0.3, False, device="cpu", root=root)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "peneo_tpu_torch" in top and "benchmark" in top
    assert not top & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "peneo_tpu_torch_x", sys)
    assert "peneo_tpu_torch_x" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "peneo_tpu.models", sys)
    assert harness.loaded_forbidden() == ["peneo_tpu.models"]


READS = re.compile(r"(import|from)\s+peneo_tpu\b|peneo_tpu/|BENCH_r0|BASELINE"
                   r"|MULTICHIP_r0|profile_chip|probe_")


def test_no_file_reads_the_jax_package_or_the_old_measurements():
    here = harness.bench_dir(harness.ROOT)
    found = []
    for dirpath, _, files in os.walk(here):
        for name in files:
            if name.endswith((".py", ".json")) and name != os.path.basename(
                    __file__):
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    for n, line in enumerate(f, 1):
                        if READS.search(line):
                            found.append(f"{name}:{n}: {line.strip()}")
    assert not found, found
