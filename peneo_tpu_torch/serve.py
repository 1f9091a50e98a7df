"""Serving CLI of the PyTorch port (counterpart of deploy/inference.py).

    python -m peneo_tpu_torch.serve \
        --model_name_or_path /path/to/model --dir_image pages/ \
        --dir_ocr ocr_json/ --dir_save results.json [--batch_size 32]

The model directory holds ``config.json``, ``pytorch_model.bin`` (reference
torch key names) and the tokenizer files. Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--dir_image", type=str, required=True)
    p.add_argument("--dir_ocr", type=str, required=True,
                   help="line-level OCR JSON dir (paired by basename stem)")
    p.add_argument("--dir_save", type=str, default="inference_results.json")
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
    p.add_argument("--bucket_lengths", type=str, default=None,
                   help="comma-separated sequence-length buckets (e.g. "
                        "'128,256,384'); pages pad only to their bucket; "
                        "max_seq_len is always the overflow bucket")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    args = p.parse_args(argv)

    from .pipeline.infer import InferenceService

    service = InferenceService(
        args.model_name_or_path,
        max_seq_len=args.max_seq_len,
        batch_size=args.batch_size,
        dtype=args.dtype,
        score_thresh=args.score_thresh,
        bucket_lengths=[int(b) for b in args.bucket_lengths.split(",")]
        if args.bucket_lengths else None,
        device=args.device,
    )
    results = service.run(args.dir_image, args.dir_ocr, workers=args.workers,
                          decode_workers=args.decode_workers,
                          inflight_depth=args.inflight_depth)
    with open(args.dir_save, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=1)
    run = service.last_run
    print(f"[peneo] {run['pages']} pages in {run['seconds']:.3f}s "
          f"(batch_size={args.batch_size}); wrote {args.dir_save}")
    return results


if __name__ == "__main__":
    main()
