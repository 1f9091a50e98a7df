"""Smoke-check an exported serving artifact on random inputs: load it, run
it once, print each head's output keys, then ``End``.

Counterpart of ``tools/check_run_artifact.py``. The inputs are made from
seed 0 with numpy at the artifact's (batch, max_seq_len).

    python -m peneo_tpu_torch.check_run_artifact --artifact_dir ART \\
        [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .export_artifact import load_artifact


def main(artifact_dir: str, device=None):
    """Returns the program's outputs on the random inputs."""
    call, meta, cfg = load_artifact(artifact_dir, device)
    dev = torch.device(meta["device"])
    B, L = meta["batch_size"], meta["max_seq_len"]
    rng = np.random.default_rng(0)
    vocab = (cfg.backbone_config or {}).get("vocab_size", 1000)
    ids = rng.integers(3, vocab, (B, L)).astype(np.int32)
    x0 = rng.integers(0, 800, (B, L))
    y0 = rng.integers(0, 800, (B, L))
    bbox = np.stack([x0, y0, x0 + 50, y0 + 20], -1).astype(np.int32)
    attn = np.ones((B, L), np.int32)
    image = None
    if meta["has_image"]:
        size = (cfg.backbone_config or {}).get("input_size", 224)
        image = torch.from_numpy(rng.normal(size=(B, 3, size, size)).astype(
            np.float32)).to(dev)
    with torch.inference_mode():
        out = call(*(torch.from_numpy(x).to(dev) for x in (ids, bbox, attn)),
                   image=image)
    for name, head in out.items():
        print(f"{name}: {sorted(head.keys())}")
    print("End")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact_dir", required=True)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the GPU)")
    a = p.parse_args()
    main(a.artifact_dir, a.device)
