"""A tiny copy of the benchmark's page-image cell for tests on the CPU: the
checkout's benchmark folder copied beside a ``BENCHMARK.json`` that adds the
cell ``tiny.scans.serve`` (a 2-layer, 48-wide LayoutLMv3 reading a 32-px
image in 8-px patches, 17 image positions, served in float32 on the CPU;
8-page directories of inked pages at L = 64), whose files are new files
only."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import harness

CELL = "tiny.scans.serve"
CONFIG = "layoutlmv3-base-chinese"


def tiny_config(std: float = 0.2, dtype: str = "float32"):
    cfg = harness.read_json(os.path.join(
        harness.bench_dir(harness.ROOT), "configs", CONFIG + ".json"))
    cfg.update(hidden_size=48, num_attention_heads=4, intermediate_size=96,
               num_hidden_layers=2, vocab_size=2000, coordinate_size=8,
               shape_size=8, input_size=32, patch_size=8,
               initializer_range=std)
    cfg["served"]["dtype"] = dtype
    cfg["peneo"].update(max_spots_per_head=64, pair_block_size=16)
    return cfg


def tiny_root(tmp: str, std: float = 0.2, spot_error_rms: float = 1e-5,
              pair_head_rel_error: float = 1e-4,
              backbone_rel_error: float = 1e-4) -> str:
    """Write the tiny checkout under ``tmp`` and return its root."""
    shutil.copytree(harness.bench_dir(harness.ROOT),
                    harness.bench_dir(tmp),
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = harness.bench_dir(tmp)
    spec = harness.benchmark_spec()
    traffic = harness.read_json(os.path.join(here, "traffic",
                                             "forms_scanned.json"))
    traffic.update(pages_per_job=8, directories=2,
                   tokens=dict(traffic["tokens"], median=24, min=4, max=90))
    cell = harness.read_json(os.path.join(here, "workloads",
                                          "layoutlmv3.serve.forms.json"))
    cell.update(batch_size=4, max_seq_len=64)
    cell["check"].update(sample_pages=6, longest=2, reference_batch=4,
                         spot_error_rms=spot_error_rms,
                         pair_head_rel_error=pair_head_rel_error,
                         backbone_rel_error=backbone_rel_error)
    for path, data in ((("configs", "tiny_scans.json"), tiny_config(std)),
                       (("traffic", "tiny_scans.json"), traffic),
                       (("workloads", CELL + ".json"), cell)):
        with open(os.path.join(here, *path), "w") as f:
            json.dump(data, f)
    spec["configs"].append({"name": "tiny_scans", "source": "tests",
                            "file": "benchmark/configs/tiny_scans.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny_scans",
                              "traffic": "tiny_scans", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "layoutlmv3.serve.forms" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return tmp
