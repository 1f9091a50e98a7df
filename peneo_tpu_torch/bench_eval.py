"""A/B of the port's pipelined eval loop against the strictly sequential one.

Counterpart of ``tools/bench_eval.py``. ``PEneoTrainer.evaluate`` keeps one
batch in flight on the card while the previous one is fetched and decoded
on a host pool; ``PENEO_EVAL_SEQUENTIAL=1`` restores the fetch → decode →
dispatch loop. The variable is read at each ``evaluate()`` call, so one
process times both modes in turns on the same model and asserts that their
metrics are identical.

The eval shape is the reference recipe's (``per_device_eval_batch_size``
16, L = 512) on a synthetic RFUND corpus, LiLT at ``--hidden``/``--layers``
with seeded random weights: random logits mark many spots, a heavy host
decode. ``--sparse`` pushes the pair heads' positive classes down, so that
almost no spot is marked (a trained model's regime, device-bound).

    python -m peneo_tpu_torch.bench_eval [--pages 192] [--B 16] [--iters 3] \\
        [--sparse] [--out FILE] [--device cpu]

It prints one JSON line (the JAX tool's keys, plus the device with its
power limit). Runs on the GPU, in bf16, unless ``--device cpu`` is given
(then fp32).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pages", type=int, default=192)
    p.add_argument("--B", type=int, default=16,
                   help="per-device eval batch (reference recipe: 16)")
    p.add_argument("--L", type=int, default=512)
    p.add_argument("--iters", type=int, default=3,
                   help="timed evaluate() calls per mode (in turns)")
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--out", default=None, help="append the JSON line here")
    p.add_argument("--sparse", action="store_true",
                   help="shift the pair heads' output biases so that "
                        "(almost) no position is tagged")
    p.add_argument("--device", type=str, default=None,
                   help="cpu to run on the CPU (default: the GPU)")
    args = p.parse_args(argv)

    import torch

    from .bench_serving import device_name
    from .config import LiltConfig, PEneoConfig
    from .data.collator import PEneoCollator
    from .data.datasets import RFUNDDataset
    from .data.fetchers import fetch_xlm
    from .data.synthetic import ToyTokenizer, write_rfund_dataset
    from .models.peneo import PEneoModel
    from .pipeline.infer import resolve_device
    from .pipeline.trainer import PEneoTrainer, TrainingArguments

    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="bench_eval_")
    root = write_rfund_dataset(os.path.join(tmp, "data"), n_train=4,
                               n_val=args.pages)
    tok = ToyTokenizer()
    ds_kwargs = dict(tokenizer=tok, tokenizer_fetcher=fetch_xlm,
                     max_token_len=args.L - 1, add_cls_token=True)
    eval_ds = RFUNDDataset(root, "dev", "en", **ds_kwargs)
    coll = PEneoCollator(max_seq_len=args.L, pad_token_id=0,
                         add_cls_token=True)
    bb = LiltConfig(vocab_size=tok.vocab_size, hidden_size=args.hidden,
                    num_hidden_layers=args.layers,
                    max_position_embeddings=args.L + 2).to_dict()
    cfg = PEneoConfig(backbone_name="lilt-infoxlm-base", backbone_config=bb,
                      max_seq_len=args.L, max_spots_per_head=256,
                      dtype="bfloat16" if device.type == "cuda"
                      else "float32")
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(0))
    if args.sparse:
        # each pair classifier ends in a Linear to the classes: its
        # positive classes' biases pushed down → argmax 0 everywhere
        with torch.no_grad():
            for name, param in model.peneo_decoder.named_parameters():
                if name.endswith("_fc.3.bias"):
                    param[1:] -= 50.0
    targs = TrainingArguments(
        output_dir=os.path.join(tmp, "run"), max_steps=1,
        per_device_eval_batch_size=args.B, seed=0, device=str(device))
    trainer = PEneoTrainer(cfg, model, targs, eval_dataset=eval_ds,
                           collator=coll, tokenizer=tok)

    print(f"device={device_name(device)} pages={args.pages} B={args.B} "
          f"L={args.L}", flush=True)
    t0 = time.perf_counter()
    warm = trainer.evaluate()
    print(f"warmup {time.perf_counter() - t0:.1f}s f1={warm.get('f1')}",
          flush=True)

    results = {"pipelined": [], "sequential": []}
    metrics = {}
    try:
        for it in range(args.iters):
            for mode in ("pipelined", "sequential"):
                os.environ["PENEO_EVAL_SEQUENTIAL"] = \
                    "1" if mode == "sequential" else "0"
                t0 = time.perf_counter()
                m = trainer.evaluate()
                dt = time.perf_counter() - t0
                results[mode].append(dt)
                metrics.setdefault(mode, m)
                print(f"  iter {it} {mode}: {dt:.2f}s "
                      f"({args.pages / dt:.2f} samples/s)", flush=True)
    finally:
        os.environ.pop("PENEO_EVAL_SEQUENTIAL", None)

    # the decode futures drain in dispatch order: identical metrics
    for k, v in metrics["pipelined"].items():
        if k != "eval_samples_per_second" and v != metrics["sequential"][k]:
            raise AssertionError(f"{k}: pipelined {v} != sequential "
                                 f"{metrics['sequential'][k]}")

    med = {m: sorted(v)[len(v) // 2] for m, v in results.items()}
    line = {
        "metric": "eval_samples_per_second",
        "B": args.B, "L": args.L, "pages": args.pages,
        "pipelined_s": med["pipelined"],
        "sequential_s": med["sequential"],
        "pipelined_samples_per_s": args.pages / med["pipelined"],
        "sequential_samples_per_s": args.pages / med["sequential"],
        "speedup": med["sequential"] / med["pipelined"],
        "sparse": args.sparse, "f1": metrics["pipelined"].get("f1"),
        "device": device_name(device),
    }
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return line, metrics


if __name__ == "__main__":
    main()
