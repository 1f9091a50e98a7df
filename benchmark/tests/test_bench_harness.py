"""The harness as data: every cell resolves to its files by name, a cell
added as new files runs, the traffic is a function of the seed, the result
line has its keys, and a machine without the card gets no result."""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from benchmark import harness, pages
from benchmark.run import run_cell
from benchmark.tests.tiny import CELL, tiny_root

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    resolved = harness.cell_spec(cell, SPEC)
    assert harness.entry_module(resolved["cell"]["entry"]).run
    config = next(c for c in SPEC["configs"]
                  if c["name"] == resolved["workload"]["config"])
    assert config["file"].startswith(SPEC["paths"][0] + "/")
    reported = [m["name"] for m in harness.cell_metrics(cell, SPEC,
                                                        "end_to_end")]
    assert "setup_s" in reported and len(reported) >= 2
    layers = harness.cell_metrics(cell, SPEC, "per_layer")
    assert layers
    for m in layers:
        assert callable(harness.metric_reader(m["name"]).read)
    for name in os.listdir(os.path.join(harness.bench_dir(harness.ROOT),
                                        "roofline")):
        if name.endswith(".py"):
            assert harness.roofline(name[:-3]).KERNEL


def test_a_cell_added_as_new_files_runs(tmp_path):
    root = tiny_root(str(tmp_path))
    out = run_cell(CELL, 4242, 0.5, False, device="cpu", root=root)
    assert set(out["metrics"]) == {"serve_pages_per_s", "setup_s"}
    assert out["attempted"] >= 8 and out["failed"] == 0
    assert all(c["ok"] for c in out["checks"].values()), out["checks"]
    # nothing of the checkout's benchmark was edited to find it
    for sub in ("entries", "reference", "metrics"):
        a = os.path.join(harness.bench_dir(harness.ROOT), sub)
        b = os.path.join(harness.bench_dir(root), sub)
        for name in os.listdir(a):
            if name.endswith(".py"):
                with open(os.path.join(a, name)) as f, \
                        open(os.path.join(b, name)) as g:
                    assert f.read() == g.read()


def traffic():
    t = harness.cell_spec("lilt.serve.forms", SPEC)["traffic"]
    return dict(t, pages_per_job=16, directories=2)


def test_traffic_is_a_function_of_the_seed(tmp_path):
    def tree(seed, where):
        dirs = pages.make_directories(str(where), traffic(), seed)
        out = {}
        for d in dirs:
            for name in sorted(os.listdir(d["ocr"])):
                with open(os.path.join(d["ocr"], name)) as f:
                    out[d["ocr"][len(str(where)):] + name] = f.read()
        return out, sorted(sum(v) for d in dirs for v in d["lines"].values())

    a, sizes_a = tree(5, tmp_path / "a")
    b, sizes_b = tree(5, tmp_path / "b")
    c, sizes_c = tree(2 ** 31 + 77, tmp_path / "c")
    assert a == b and a != c
    # another seed deals out the same page sizes, within a line's tokens
    want = sorted(pages.token_counts(traffic()))
    for sizes in (sizes_a, sizes_c):
        assert all(w <= s < w + 6 * 3 for w, s in zip(want, sizes))


def test_token_counts_follow_the_traffic():
    t = harness.cell_spec("lilt.serve.forms", SPEC)["traffic"]
    counts = pages.token_counts(t)
    assert len(counts) == t["pages_per_job"] * t["directories"]
    counts.sort()
    assert abs(counts[len(counts) // 2] - t["tokens"]["median"]) <= 2
    over = sum(c > 510 for c in counts) / len(counts)
    assert 0.12 <= over <= 0.18


def test_result_line_keys():
    buf = io.StringIO()
    checks = {"a": {"value": 1.0, "limit": 2.0, "ok": True}}
    with redirect_stdout(buf):
        harness.emit(True, 3, 0, {}, {"platform": "gpu"}, checks, None)
        harness.emit(True, 3, 0, {}, {"platform": "gpu"}, checks,
                     {"device_ops": [], "idle_gaps": []})
    plain, traced = (json.loads(x) for x in buf.getvalue().splitlines())
    base = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(plain) == base + ["checks"]
    assert list(traced) == base + ["breakdown", "checks"]


def run_module(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = run_module(["--workload", "lilt.serve.forms", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], harness.ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(os.path.join(harness.ROOT, p), tmp_path / p)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = run_module(["--workload", "lilt.serve.forms", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], str(tmp_path), env)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_the_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_module(["--workload", "lilt.serve.forms", "--seed", "31",
                    "--seconds", "2", "--trace", "0"], harness.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
