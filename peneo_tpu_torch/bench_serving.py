"""End-to-end serving benchmark of the port: OCR JSON → ``InferenceService.run``
→ kv records, on synthetic pages.

Counterpart of ``tools/bench_serving.py``. It measures the deployment path
— preprocess (tokenize, sort, pad, and for the visual families the page
image's decode and resize) on the thread pool or in spawned processes, the
forward on the card (the CUDA attention kernels), the fetch of the packed
spots and the host chain-walk decode — with a full-width model of the
chosen family (the config's base defaults, seeded random weights written
as ``params.msgpack`` by the port's own writer) and the toy tokenizer.

    python -m peneo_tpu_torch.bench_serving [--pages 256] [--batch 32] \\
        [--L 512] [--backbone lilt|layoutlmv3|layoutlmv2] [--workers 4] \\
        [--preprocess_procs N] [--device cpu]

It prints one JSON line: the JAX tool's keys (``metric``, ``value`` =
whole-run pages/s, ``unit``, ``pages``, ``batch``, ``L``, ``workers``,
``buckets``, ``mixed_lines``), plus the warm rate after the first batch's
fetch, the pool's start seconds and the device with its power limit.
``--dp/--tp/--sp`` run under a process group (``--distributed`` under
torchrun, or the coordinator flags), one process per rank; without one
they raise. Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import tempfile
import time

FAMILIES = {"lilt": "lilt-infoxlm-base",
            "layoutlmv3": "layoutlmv3-base-chinese",
            "layoutlmv2": "layoutxlm-base"}


def build_assets(root: str, pages: int, L: int, lines_per_page,
                 backbone: str = "lilt", geometry=None):
    """A model directory (``weights``: config, ``params.msgpack``, the toy
    tokenizer) and ``pages`` synthetic pages (``images``, ``ocr``) under
    ``root``. ``geometry`` overrides fields of the backbone config (the
    base defaults otherwise). Returns (weights dir, image dir, OCR dir,
    tokenizer)."""
    import torch
    from PIL import Image

    from .config import (LayoutLMv2Config, LayoutLMv3Config, LiltConfig,
                         PEneoConfig)
    from .data.synthetic import ToyTokenizer, make_document, render_page
    from .models.convert import state_dict_to_jax_params
    from .models.peneo import PEneoModel
    from .pipeline.weights_io import write_flax_msgpack

    tok = ToyTokenizer()
    wdir = os.path.join(root, "weights")
    os.makedirs(wdir, exist_ok=True)
    cls, pad = {"lilt": (LiltConfig, 0), "layoutlmv3": (LayoutLMv3Config, 1),
                "layoutlmv2": (LayoutLMv2Config, 1)}[backbone]
    bb_cfg = cls(**{"vocab_size": tok.vocab_size,
                    "max_position_embeddings": L + 8, "pad_token_id": pad,
                    **(geometry or {})})
    cfg = PEneoConfig(backbone_name=FAMILIES[backbone],
                      backbone_config=bb_cfg.to_dict(), max_seq_len=L)
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(0))
    write_flax_msgpack(state_dict_to_jax_params(model.state_dict(), cfg),
                       os.path.join(wdir, "params.msgpack"))
    del model

    img_dir = os.path.join(root, "images")
    ocr_dir = os.path.join(root, "ocr")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ocr_dir, exist_ok=True)
    prng = random.Random(7)
    # a handful of distinct pages, the rest aliased (each page is still
    # opened and decoded); ``lines_per_page`` may be a list of densities
    # cycled across pages (a mixed-length corpus for bucketed runs)
    densities = (list(lines_per_page)
                 if isinstance(lines_per_page, (list, tuple))
                 else [lines_per_page])
    base = []
    for i in range(min(pages, max(16, 4 * len(densities)))):
        lines = densities[i % len(densities)]
        doc = make_document(prng, f"b{i}.png", n_pairs=max(1, lines // 2),
                            n_noise=2)
        ocr = [{"text": ln["text"], "bbox": ln["bbox"]}
               for e in doc["entities"] for ln in e["lines"]]
        base.append((Image.fromarray(render_page(doc)), ocr))
    for i in range(pages):
        img, ocr = base[i % len(base)]
        img.save(os.path.join(img_dir, f"p{i:04d}.png"))
        with open(os.path.join(ocr_dir, f"p{i:04d}.json"), "w") as f:
            json.dump(ocr, f)
    return wdir, img_dir, ocr_dir, tok


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return smi[torch.device(device).index or 0]


def build_argparser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pages", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--L", type=int, default=512)
    p.add_argument("--lines_per_page", type=int, default=24)
    p.add_argument("--mixed_lines", type=str, default=None,
                   help="comma-separated line densities cycled across pages "
                        "(e.g. '4,10,24'); overrides --lines_per_page")
    p.add_argument("--bucket_lengths", type=str, default=None,
                   help="comma-separated sequence-length buckets "
                        "(InferenceService bucket_lengths)")
    p.add_argument("--backbone", default="lilt", choices=sorted(FAMILIES))
    p.add_argument("--no_raw_image", action="store_true",
                   help="visual families: host-normalized fp32 pages "
                        "instead of uint8 pages normalized on the card")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--preprocess_procs", type=int, default=0,
                   help="preprocess in N spawned processes instead of "
                        "--workers threads")
    p.add_argument("--int8_pair_head", action="store_true", default=None)
    p.add_argument("--no_int8_pair_head", dest="int8_pair_head",
                   action="store_false")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--distributed", action="store_true",
                   help="one process per rank, torch.distributed from "
                        "torchrun's environment")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--keep_dir", type=str, default=None,
                   help="reuse/keep the assets here instead of a temp dir")
    p.add_argument("--inflight_depth", type=int, default=2)
    p.add_argument("--device", type=str, default=None,
                   help="cpu to run on the CPU (default: the GPU)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from .parallel import dist as pdist

    started = False
    if args.distributed or args.coordinator_address:
        if not pdist.initialized():
            pdist.init_distributed(args.device, args.coordinator_address,
                                   args.num_processes, args.process_id)
            started = True
    elif args.dp * args.tp * args.sp > 1:
        raise ValueError(
            f"--dp {args.dp} --tp {args.tp} --sp {args.sp} needs one process "
            "per rank: torchrun --nproc_per_node N -m "
            "peneo_tpu_torch.bench_serving --distributed --dp ... --tp ... "
            "--sp ..., or one command per rank with --coordinator_address "
            "host:port --num_processes N --process_id i")
    try:
        return _bench(args, pdist)
    finally:
        if started:
            pdist.shutdown()


def _bench(args, pdist):
    from .pipeline.infer import InferenceService, resolve_device

    if not pdist.initialized():
        resolve_device(args.device)  # no GPU and no --device cpu: raise
    root = args.keep_dir or tempfile.mkdtemp(prefix="peneo_serve_bench_")
    lines = ([int(x) for x in args.mixed_lines.split(",")]
             if args.mixed_lines else args.lines_per_page)
    wdir = os.path.join(root, "weights")
    img_dir, ocr_dir = os.path.join(root, "images"), os.path.join(root, "ocr")
    if not os.path.isdir(wdir):
        if pdist.rank() == 0:
            build_assets(root, args.pages, args.L, lines, args.backbone)
        pdist.barrier()

    buckets = ([int(b) for b in args.bucket_lengths.split(",")]
               if args.bucket_lengths else None)
    svc = InferenceService(wdir, batch_size=args.batch, dtype="bfloat16",
                           max_seq_len=args.L, dp=args.dp, tp=args.tp,
                           sp=args.sp, int8_pair_head=args.int8_pair_head,
                           bucket_lengths=buckets, device=args.device)
    if args.no_raw_image and svc.image_loader is not None:
        from .data.image_processing import make_image_loader

        svc.raw_image = False
        svc.image_loader = make_image_loader(svc.cfg, raw=False)
    # warm the kernels, cuBLAS and the allocator outside the timed run:
    # one forward per bucket shape
    warm_img = os.path.join(img_dir, sorted(os.listdir(img_dir))[0])
    warm_ocr = os.path.join(ocr_dir, sorted(os.listdir(ocr_dir))[0])
    if svc.bucket_lengths:
        page = svc.preprocess_page(warm_img, warm_ocr)
        for b in svc.bucket_lengths:
            svc._fetch(svc.dispatch_batch([page], bucket=b))
    else:
        svc.run(warm_img, warm_ocr)

    t0 = time.perf_counter()
    results = svc.run(img_dir, ocr_dir, workers=args.workers,
                      preprocess_procs=args.preprocess_procs,
                      inflight_depth=args.inflight_depth)
    dt = time.perf_counter() - t0
    run = svc.last_run
    n = len(results)
    tag = "" if args.backbone == "lilt" else f"_{args.backbone}"
    line = {
        "metric": f"serving_pages_per_sec_e2e{tag}",
        "value": round(n / dt, 2),
        "unit": "pages/s",
        "pages": n,
        "batch": args.batch,
        "L": args.L,
        "workers": args.workers,
        "preprocess_procs": args.preprocess_procs,
        "buckets": svc.bucket_lengths,
        "mixed_lines": args.mixed_lines,
        "warm_pages_per_s": (run["warm_pages"] / run["warm_seconds"]
                             if run["warm_seconds"] else None),
        "pool_start_seconds": run["pool_start_seconds"],
        "dp": args.dp, "tp": args.tp, "sp": args.sp,
        "device": device_name(svc.device),
    }
    if pdist.rank() == 0:
        print(json.dumps(line), flush=True)
    if args.keep_dir is None:
        pdist.barrier()
        if pdist.rank() == 0:
            shutil.rmtree(root, ignore_errors=True)
    return line


if __name__ == "__main__":
    main()
