"""Export a serving artifact: a ``torch.export`` program of the inference
forward, with its weights, the config and the tokenizer files.

Counterpart of ``tools/export_artifact.py`` (the JAX package's
``jax.export`` StableHLO artifact). The program is traced at a fixed
(batch, max_seq_len) with int32 ``input_ids``, ``bbox`` (B, L, 4) and
``attention_mask``, as the preprocessor emits them, plus an fp32 ``image``
(B, 3, S, S) for the visual families (S = the backbone's ``input_size``),
and returns the five heads' compact-spot dicts. The attention of each layer
is one node of the graph: ``peneo::biacm_attention`` (kernel #1, LiLT) or
``peneo::bias_attention`` (kernel #4, LayoutLMv3 and LayoutLMv2), custom
operators that launch the CUDA kernels on the card and run their plain
twins on the CPU.

    python -m peneo_tpu_torch.export_artifact --model_name_or_path DIR \\
        --output_dir OUT [--batch_size 1] [--max_seq_len 512] \\
        [--dtype bfloat16] [--device cpu]

It writes ``forward.pt2`` (the program and its weights), ``config.json``,
``artifact_meta.json`` (the JAX artifact's keys plus ``device``, ``torch``,
``kernels``, and the seconds the export and the save took) and the
tokenizer files. Where the JAX artifact keeps its weights in a
``params.msgpack`` beside the program, the ``.pt2`` holds them. The graph
is fixed per device type, as ``jax.export`` lowers per platform: an
artifact exported on the card serves on a card, one exported with
``--device cpu`` on the CPU. Runs on the GPU unless ``--device cpu`` is
given.

Check an artifact with ``python -m peneo_tpu_torch.check_run_artifact``;
serve it with ``python -m peneo_tpu_torch.inference_artifact``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import torch

PROGRAM = "forward.pt2"
META = "artifact_meta.json"


def _example_inputs(cfg, batch_size: int, max_seq_len: int, has_image: bool,
                    device) -> tuple:
    """(args, kwargs) of the shapes and dtypes the program is traced at."""
    B, L = batch_size, max_seq_len
    ids = torch.ones((B, L), dtype=torch.int32, device=device)
    bbox = torch.zeros((B, L, 4), dtype=torch.int32, device=device)
    kwargs = {}
    if has_image:
        size = (cfg.backbone_config or {}).get("input_size", 224)
        kwargs["image"] = torch.zeros((B, 3, size, size), dtype=torch.float32,
                                      device=device)
    return (ids, bbox, ids.clone()), kwargs


def _graph_kernels(program) -> list:
    """The ``peneo::`` custom operators the program's graph holds."""
    return sorted({n.target._schema.name for n in program.graph.nodes
                   if getattr(n.target, "namespace", None) == "peneo"})


def export_artifact(model_name_or_path: str, output_dir: str,
                    batch_size: int = 1, max_seq_len: int = 512,
                    dtype: str = "bfloat16", device=None) -> str:
    """Export the model directory's inference forward to ``output_dir``
    (see the module docstring); returns ``output_dir``. ``device`` None is
    ``cuda`` and raises without a GPU; on the card ``dtype`` must be
    ``bfloat16`` (the attention kernels' type)."""
    from .config import PEneoConfig
    from .models.peneo import PEneoModel
    from .pipeline.infer import (DTYPES, load_family_kernel, load_weights,
                                 resolve_device)
    from .registry import TOKENIZER_FILES, get_backbone_info

    device = resolve_device(device)
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
    if device.type == "cuda" and dtype != "bfloat16":
        raise ValueError("the CUDA attention kernels (BiACM, rel-bias) take "
                         "bfloat16; export with dtype='bfloat16'")
    cfg = PEneoConfig.from_pretrained(model_name_or_path)
    cfg.max_seq_len = max_seq_len
    cfg.inference_mode = True
    info = get_backbone_info(cfg.backbone_name)
    load_family_kernel(device, info.family)
    model = PEneoModel(cfg)
    load_weights(model, model_name_or_path)
    model = model.cast(DTYPES[dtype]).to(device).eval().requires_grad_(False)
    args, kwargs = _example_inputs(cfg, batch_size, max_seq_len,
                                   info.has_visual_embeds, device)
    t0 = time.perf_counter()
    program = torch.export.export(model, args, kwargs, strict=False)
    t1 = time.perf_counter()
    os.makedirs(output_dir, exist_ok=True)
    torch.export.save(program, os.path.join(output_dir, PROGRAM))
    t2 = time.perf_counter()
    cfg.save_pretrained(output_dir)
    meta = {"batch_size": batch_size, "max_seq_len": max_seq_len,
            "dtype": dtype, "has_image": info.has_visual_embeds,
            "backbone_name": cfg.backbone_name, "device": device.type,
            "torch": torch.__version__, "kernels": _graph_kernels(program),
            "export_seconds": t1 - t0, "save_seconds": t2 - t1}
    with open(os.path.join(output_dir, META), "w") as f:
        json.dump(meta, f, indent=2)
    for fname in TOKENIZER_FILES:  # the tokenizer travels with the artifact
        src = os.path.join(model_name_or_path, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, fname))
    print(f"[peneo] exported serving artifact to {output_dir}")
    return output_dir


def load_artifact(artifact_dir: str, device=None):
    """Returns ``(call, meta, cfg)``: ``call(input_ids, bbox,
    attention_mask, image=None)`` runs the loaded program (``image`` only
    for an artifact with ``has_image``). ``device`` None is ``cuda`` and
    raises without a GPU; an artifact exported for another device type
    raises."""
    from .config import PEneoConfig
    from .pipeline.infer import load_family_kernel, resolve_device
    from .registry import get_backbone_info

    device = resolve_device(device)
    with open(os.path.join(artifact_dir, META)) as f:
        meta = json.load(f)
    if meta["device"] != device.type:
        raise ValueError(
            f"{artifact_dir} was exported for {meta['device']}, not "
            f"{device.type}: the graph is fixed per device type; export it "
            f"again with --device {device.type}")
    cfg = PEneoConfig.from_pretrained(artifact_dir)
    load_family_kernel(device, get_backbone_info(cfg.backbone_name).family)
    module = torch.export.load(os.path.join(artifact_dir, PROGRAM)).module()

    def call(input_ids, bbox, attention_mask, image=None):
        if meta["has_image"]:
            return module(input_ids, bbox, attention_mask, image=image)
        return module(input_ids, bbox, attention_mask)

    return call, meta, cfg


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None,
                   help="cpu to export on the CPU (default: the GPU)")
    a = p.parse_args(argv)
    return export_artifact(a.model_name_or_path, a.output_dir, a.batch_size,
                           a.max_seq_len, a.dtype, a.device)


if __name__ == "__main__":
    main()
