"""Serving CLI of the PyTorch port (counterpart of deploy/inference.py).

    python -m peneo_tpu_torch.serve \
        --model_name_or_path /path/to/model --dir_image pages/ \
        --dir_ocr ocr_json/ --dir_save results.json [--batch_size 32] \
        [--dir_visualize viz/] [--preprocess_procs 8] [--int8_pair_head]

The model directory holds ``config.json``, the weights — ``params.msgpack``
(the JAX package's param tree), ``model.safetensors`` or
``pytorch_model.bin`` (reference torch key names), read in that order — and
the tokenizer files. ``--apply_ocr`` reads each page with tesseract instead
of OCR JSON (needs pytesseract and the tesseract binary). Runs on the GPU
unless ``--device cpu`` is given.

Across processes, ``--dp N --tp T --sp M`` (``deploy/inference.py:39-45``):
N × T × M ranks, one process each, laid out as the JAX mesh's ``(dp, tp,
sp)`` (rank = (d·T + t)·M + s); each dp index serves every N-th page, its T
tp ranks hold the shards of the Megatron-split model, its M sp ranks split
each page's pair grid by rows, and rank 0 writes the one JSON:

    torchrun --nproc_per_node 4 -m peneo_tpu_torch.serve --distributed \
        --dp 2 --tp 2 --model_name_or_path M --dir_image I --dir_ocr O

or one command per rank with ``--coordinator_address host:port
--num_processes 4 --process_id i`` in place of ``--distributed``. Each rank
takes its card (NCCL), or ranks share one (gloo). Left out of
``deploy/inference.py``'s flags: the ``--*fused*`` switches (the port's
attention is always its CUDA kernels on the card).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--dir_image", type=str, required=True)
    p.add_argument("--dir_ocr", type=str, default=None,
                   help="line-level OCR JSON dir (paired by basename stem); "
                        "omit with --apply_ocr")
    p.add_argument("--apply_ocr", action="store_true",
                   help="run tesseract OCR instead of reading OCR JSON")
    p.add_argument("--dir_save", type=str, default="inference_results.json")
    p.add_argument("--dir_visualize", type=str, default=None,
                   help="also draw each page's predictions into this dir")
    p.add_argument("--batch_size", type=int, default=1,
                   help="pages per device forward")
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--score_thresh", type=float, default=0.0)
    p.add_argument("--workers", type=int, default=4,
                   help="preprocess threads")
    p.add_argument("--decode_workers", type=int, default=2,
                   help="host-decode threads")
    p.add_argument("--inflight_depth", type=int, default=2,
                   help="batches kept in flight on the device")
    p.add_argument("--preprocess_procs", type=int, default=0,
                   help="preprocess in N spawned worker processes instead "
                        "of threads (escapes the GIL that caps the thread "
                        "pool; costs the workers' start, so it pays on "
                        "large directories of page images)")
    p.add_argument("--int8_pair_head", action="store_true", default=None,
                   help="quantize the pair head's hidden matmuls to int8 "
                        "(s8xs8->s32; default off)")
    p.add_argument("--no_int8_pair_head", dest="int8_pair_head",
                   action="store_false",
                   help="keep the pair head in the serving dtype (the "
                        "default; a config that sets int8 still serves it)")
    p.add_argument("--int8_backbone", action="store_true",
                   help="additionally quantize the backbone's projection/"
                        "MLP matmuls to int8 (all three text encoders; "
                        "the v2 conv tower stays full precision)")
    p.add_argument("--bucket_lengths", type=str, default=None,
                   help="comma-separated sequence-length buckets (e.g. "
                        "'128,256,384'); pages pad only to their bucket; "
                        "max_seq_len is always the overflow bucket")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks (each serves every dp-th "
                        "page); default: the number of processes // "
                        "(--tp × --sp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (each page's pair grid "
                        "split by rows over them)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (the backbone and the pair "
                        "head split Megatron-style over them)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per rank, torch.distributed from "
                        "torchrun's environment")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (for launches without "
                        "torchrun)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default="auto",
                   choices=["auto", "nccl", "gloo"],
                   help="process-group backend: auto = NCCL when every "
                        "rank has a card of its own, else gloo")
    args = p.parse_args(argv)
    if not args.apply_ocr and args.dir_ocr is None:
        p.error("--dir_ocr is required unless --apply_ocr is set")

    from .parallel import dist as pdist

    started = False
    if args.distributed or args.coordinator_address:
        if not pdist.initialized():
            pdist.init_distributed(args.device, args.coordinator_address,
                                   args.num_processes, args.process_id,
                                   backend=args.dist_backend)
            started = True
    elif (args.dp or 1) * args.tp * args.sp > 1:
        raise ValueError(
            f"--dp {args.dp} --tp {args.tp} --sp {args.sp} needs one process "
            "per rank: torchrun --nproc_per_node N -m peneo_tpu_torch.serve "
            "--distributed --dp ... --tp ... --sp ..., or one command per "
            "rank with --coordinator_address host:port --num_processes N "
            "--process_id i")
    try:
        return _serve(args, pdist)
    finally:
        if started:
            pdist.shutdown()


def _serve(args, pdist):
    from .pipeline.infer import InferenceService

    tp, sp = args.tp, args.sp
    dp = args.dp if args.dp is not None else max(pdist.world() // (tp * sp),
                                                 1)
    service = InferenceService(
        args.model_name_or_path,
        max_seq_len=args.max_seq_len,
        batch_size=args.batch_size,
        dtype=args.dtype,
        score_thresh=args.score_thresh,
        int8_pair_head=args.int8_pair_head,
        int8_backbone=args.int8_backbone,
        bucket_lengths=[int(b) for b in args.bucket_lengths.split(",")]
        if args.bucket_lengths else None,
        device=args.device,
        dp=dp,
        tp=tp,
        sp=sp,
    )
    results = service.run(args.dir_image,
                          None if args.apply_ocr else args.dir_ocr,
                          visualize_dir=args.dir_visualize,
                          workers=args.workers,
                          decode_workers=args.decode_workers,
                          preprocess_procs=args.preprocess_procs,
                          inflight_depth=args.inflight_depth)
    run = service.last_run
    if pdist.rank() == 0:
        with open(args.dir_save, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=1)
        print(f"[peneo] {len(results)} pages in {run['seconds']:.3f}s "
              f"(batch_size={args.batch_size}, dp={dp}, tp={tp}, sp={sp}); "
              f"wrote "
              f"{args.dir_save}")
    return results


if __name__ == "__main__":
    main()
