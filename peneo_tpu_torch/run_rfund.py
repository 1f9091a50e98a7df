"""Fine-tune / evaluate PEneo (LiLT, LayoutLMv3 or LayoutLMv2/LayoutXLM) on
RFUND with the port.

The single-device flag surface of ``start/run_rfund.py`` (reference:
start/run_rfund.py:23-81), plus ``--device``:

    python -m peneo_tpu_torch.run_rfund \\
        --model_name_or_path /path/to/peneo-weights \\
        --data_dir /path/to/rfund --language en \\
        --output_dir out --do_train --do_eval \\
        --max_steps 25000 --learning_rate 5e-5 --warmup_ratio 0.1 \\
        --per_device_train_batch_size 4 --per_device_eval_batch_size 16

``--synthetic_data`` writes a synthetic RFUND corpus (64 train, 16 dev
pages, rendered to PNGs for a visual backbone) and uses the toy tokenizer
with a seeded random model of the ``--synthetic_model`` geometry (LayoutLMv3
presets take a 64 px image; LayoutLMv2 presets a 56 px one and a ResNeXt
tower of one block per stage, ``base`` the full ResNeXt-101 at 224 px), or
with ``--model_name_or_path`` the saved model's own config: no downloads.
``--backbone_name layoutlmv3-base[-chinese]`` selects the LayoutLMv3 family,
``layoutxlm-base`` / ``layoutlmv2-base-uncased`` the LayoutLMv2 one. Runs
on ``cuda`` (the CUDA attention kernels, bf16) unless ``--device cpu`` is
given; without a GPU and without ``--device`` it raises.
``--steps_per_call K`` runs K optimizer steps per call over a group of K
batches: on the card one replay of a CUDA graph of the K steps (a capture
that fails raises), on the CPU the K steps in a loop; ``max_steps`` rounds
up to a multiple of K. ``--logging_dir D`` also writes the logged scalars
as TensorBoard events into D. ``--quantize_pair_head int8`` runs the eval
forwards' pair head as s8×s8→s32 products (training stays full precision).

``--model_name_or_path`` reads, as the JAX trainer does, ``params.msgpack``,
``backbone_params.msgpack`` (``python -m
peneo_tpu_torch.generate_peneo_weights``: a pretrained backbone, the
decoder keeps its seeded init), ``model.safetensors`` or
``pytorch_model.bin``, the first present.

Data-parallel fine-tuning, one process per rank (``parallel/dist.py``):

    torchrun --nproc_per_node N -m peneo_tpu_torch.run_rfund --distributed ...

or the JAX trainer's launch, one command per process: ``--coordinator_address
host:port --num_processes N --process_id i``. Each rank takes its card
(``cuda:{local_rank}``; NCCL), or shares one with other ranks (gloo), or runs
on the CPU with ``--device cpu`` (gloo); ``--dist_backend`` forces one.
Batch sizes are per rank; the losses are the global batch's. ``--tp``,
``--sp`` and ``--fsdp`` are accepted and refused unless 1 / off
(``ROADMAP.md`` §1), as is ``--steps_per_call`` > 1 in a process group.
Left out (one attention path, one backend): ``--platform`` and the
``--fused_*`` flags.
"""

from __future__ import annotations

import argparse
import json
import os

SYNTHETIC_MODEL_PRESETS = {
    "tiny": dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=96),
    "small": dict(hidden_size=240, num_hidden_layers=4, num_attention_heads=4,
                  intermediate_size=480),
    # full lilt-infoxlm-base geometry (sans the 250k real vocab unless
    # --synthetic_vocab 250002)
    "base": dict(hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072),
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # model args (reference ModelArguments)
    p.add_argument("--model_name_or_path", type=str, default=None)
    p.add_argument("--backbone_name", type=str, default="lilt-infoxlm-base")
    # data args (reference DataArguments)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--language", type=str, default="en")
    p.add_argument("--apply_box_aug", action="store_true")
    p.add_argument("--box_aug_quirk", action="store_true",
                   help="with --apply_box_aug: the reference's always-down "
                        "vertical jitter (data_utils.py:155-160)")
    p.add_argument("--detail_eval", action="store_true")
    p.add_argument("--save_eval_detail", action="store_true")
    p.add_argument("--start_eval_epoch", type=int, default=0)
    # training args (HF TrainingArguments subset)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--max_steps", type=int, default=25000)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--per_device_eval_batch_size", type=int, default=16)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--logging_dir", type=str, default=None,
                   help="also write the logged scalars as TensorBoard "
                        "events here")
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--save_total_limit", type=int, default=1)
    p.add_argument("--metric_for_best_model", type=str, default="f1")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="K optimizer steps per call (one CUDA graph replay "
                        "of the K steps on the card); max_steps rounds up "
                        "to a multiple of K")
    # parallelism (the JAX trainer's mesh and multi-process flags)
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks; default (and the only value "
                        "taken): the number of processes")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: not ported (1 only)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel chips: not ported (1 only)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params + optimizer state over dp: not "
                        "ported")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run: torch.distributed from "
                        "torchrun's environment (RANK, WORLD_SIZE, "
                        "MASTER_ADDR, MASTER_PORT, LOCAL_RANK); one process "
                        "per rank, shared output_dir; rank 0 writes "
                        "logs/artifacts")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (implies --distributed; "
                        "for launches without torchrun)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default="auto",
                   choices=["auto", "nccl", "gloo"],
                   help="process-group backend: auto = NCCL when every "
                        "rank has a card of its own, else gloo")
    # port extensions
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda (raises without a GPU)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--dense_labels", action="store_true",
                   help="ship dense int8 label matrices instead of spots")
    p.add_argument("--synthetic_data", action="store_true",
                   help="generate a synthetic corpus + toy tokenizer")
    p.add_argument("--synthetic_model", type=str, default="small",
                   choices=sorted(SYNTHETIC_MODEL_PRESETS),
                   help="backbone size for --synthetic_data runs")
    p.add_argument("--quantize_pair_head", type=str, default=None,
                   choices=["int8"],
                   help="quantize the pair head's matmuls on eval forwards "
                        "(s8xs8->s32, ops/quant.py); training stays full "
                        "precision")
    p.add_argument("--synthetic_vocab", type=int, default=None,
                   help="backbone vocab_size for --synthetic_data runs "
                        "(e.g. 250002, the real XLM vocab; the toy "
                        "tokenizer's ids stay valid)")
    return p


def setup(args, dataset_cls_name: str = "rfund"):
    """Shared run_rfund/run_sibr setup. Returns (cfg, model, train_ds,
    eval_ds, collator, tokenizer)."""
    import torch

    from .config import (LayoutLMv2Config, LayoutLMv3Config, LiltConfig,
                         PEneoConfig)
    from .data.collator import PEneoCollator
    from .data.datasets import RFUNDDataset, SIBRDataset
    from .models.peneo import PEneoModel
    from .parallel import dist as pdist
    from .pipeline.infer import load_weights
    from .registry import get_backbone_info, load_tokenizer

    data_dir = args.data_dir or os.path.join(args.output_dir, "synthetic_data")
    if args.synthetic_data:
        info = get_backbone_info(
            PEneoConfig.from_pretrained(args.model_name_or_path).backbone_name
            if args.model_name_or_path else args.backbone_name)
        from .data.fetchers import fetch_xlm
        from .data.synthetic import ToyTokenizer, write_rfund_dataset, \
            write_sibr_dataset

        if pdist.rank() == 0:  # the other ranks wait for its corpus
            if dataset_cls_name == "rfund":
                if not os.path.exists(os.path.join(
                        data_dir, f"{args.language}.train.json")):
                    write_rfund_dataset(data_dir, args.language, n_train=64,
                                        n_val=16,
                                        with_images=info.has_visual_embeds)
            elif not os.path.exists(os.path.join(data_dir, "train.txt")):
                write_sibr_dataset(data_dir, n_train=64, n_test=16)
        pdist.barrier()
        tokenizer = ToyTokenizer()
        fetcher = fetch_xlm
        if args.model_name_or_path:
            cfg = PEneoConfig.from_pretrained(args.model_name_or_path)
        else:
            preset = SYNTHETIC_MODEL_PRESETS[args.synthetic_model]
            vocab = args.synthetic_vocab or tokenizer.vocab_size
            if info.family == "layoutlmv3":
                # the 4 coordinate + 2 shape embeddings concat to hidden_size
                coord = preset["hidden_size"] // 6
                backbone_config = LayoutLMv3Config(
                    vocab_size=vocab, pad_token_id=0, coordinate_size=coord,
                    shape_size=(preset["hidden_size"] - 4 * coord) // 2,
                    input_size=64, **preset).to_dict()
            elif info.family == "layoutlmv2":
                h = preset["hidden_size"]
                coord = h // 6
                full = args.synthetic_model == "base"
                backbone_config = LayoutLMv2Config(
                    vocab_size=vocab, pad_token_id=0, coordinate_size=coord,
                    shape_size=(h - 4 * coord) // 2,
                    visual_depths=[3, 4, 23, 3] if full else [1, 1, 1, 1],
                    # the stride-4 p2 map must tile the 7x7 pool: 56 -> 14
                    input_size=224 if full else 56, **preset).to_dict()
            else:
                backbone_config = LiltConfig(vocab_size=vocab, pad_token_id=0,
                                             **preset).to_dict()
            cfg = PEneoConfig(
                backbone_name=args.backbone_name,
                backbone_config=backbone_config,
                peneo_category_weights=[1.0, 10.0, 10.0],
                peneo_downstream_speedup_ratio=30.0)
    else:
        if not args.model_name_or_path:
            raise ValueError("--model_name_or_path is required without "
                             "--synthetic_data")
        cfg = PEneoConfig.from_pretrained(args.model_name_or_path)
        tokenizer = None
        fetcher = None
    cfg.max_seq_len = args.max_seq_len
    cfg.dtype = args.dtype
    if args.quantize_pair_head:
        # forwards outside training only: the decoder keeps training float
        cfg.quantize_pair_head = args.quantize_pair_head
    info = get_backbone_info(cfg.backbone_name or args.backbone_name)
    if tokenizer is None:
        tokenizer = load_tokenizer(info, args.model_name_or_path)
        fetcher = info.tokenizer_fetcher

    # the seeded init, then the directory's weights over it: a partial tree
    # (a backbone from generate_peneo_weights) leaves the rest at its init
    model = PEneoModel(cfg).init_weights(
        torch.Generator().manual_seed(args.seed))
    if args.model_name_or_path:
        kept = load_weights(model, args.model_name_or_path, train_init=True)
        if kept:
            print(f"[peneo] {kept} of the model's tensors keep their seeded "
                  "init (absent from the checkpoint)")

    budget = args.max_seq_len - int(info.add_cls_token) \
        - int(info.add_sep_token)
    ds_kwargs = dict(tokenizer=tokenizer, tokenizer_fetcher=fetcher,
                     max_token_len=min(info.max_token_len, budget + 1),
                     add_cls_token=info.add_cls_token,
                     add_sep_token=info.add_sep_token)
    aug = dict(apply_box_aug=args.apply_box_aug,
               box_aug_quirk=args.box_aug_quirk)
    if dataset_cls_name == "rfund":
        train_ds = RFUNDDataset(data_dir, "train", args.language, **aug,
                                **ds_kwargs)
        eval_ds = RFUNDDataset(data_dir, "dev", args.language, **ds_kwargs)
    else:
        train_ds = SIBRDataset(data_dir, "train", **aug, **ds_kwargs)
        eval_ds = SIBRDataset(data_dir, "test", **ds_kwargs)
    image_loader = None
    if info.has_visual_embeds:
        from .data.image_processing import make_image_loader

        image_loader = make_image_loader(cfg)
    collator = PEneoCollator(
        max_seq_len=args.max_seq_len,
        pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0,
        add_cls_token=info.add_cls_token,
        labels_as_spots=not args.dense_labels, image_loader=image_loader)
    return cfg, model, train_ds, eval_ds, collator, tokenizer


def training_arguments(args):
    """The trainer's arguments from the parsed flags."""
    from .pipeline.trainer import TrainingArguments

    return TrainingArguments(
        output_dir=args.output_dir, learning_rate=args.learning_rate,
        warmup_ratio=args.warmup_ratio, max_steps=args.max_steps,
        per_device_train_batch_size=args.per_device_train_batch_size,
        per_device_eval_batch_size=args.per_device_eval_batch_size,
        weight_decay=args.weight_decay, logging_steps=args.logging_steps,
        logging_dir=args.logging_dir,
        eval_steps=args.eval_steps, save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        metric_for_best_model=args.metric_for_best_model, seed=args.seed,
        detail_eval=args.detail_eval, save_eval_detail=args.save_eval_detail,
        start_eval_epoch=args.start_eval_epoch, resume=not args.no_resume,
        device=args.device, steps_per_call=args.steps_per_call)


def check_parallel_flags(args) -> None:
    """Refuse the mesh flags that are not ported, before anything starts."""
    for flag, value, off in (("--tp", args.tp, 1), ("--sp", args.sp, 1),
                             ("--fsdp", args.fsdp, False)):
        if value != off:
            raise NotImplementedError(
                f"{flag} {value}: tensor, sequence and fully sharded "
                "parallelism are not ported yet (PR 10, ROADMAP.md §1); "
                "data parallelism is --distributed / --dp")


def init_parallel(args) -> bool:
    """Join the process group the flags describe (if any) and check
    ``--dp`` against it; True when this call started the group."""
    from .parallel import dist as pdist

    started = False
    if (args.distributed or args.coordinator_address) \
            and not pdist.initialized():
        pdist.init_distributed(args.device, args.coordinator_address,
                               args.num_processes, args.process_id,
                               backend=args.dist_backend)
        started = True
    if args.dp is not None and args.dp != pdist.world():
        raise ValueError(f"--dp {args.dp} must equal the number of "
                         f"processes, {pdist.world()} (one rank each)")
    return started


def main(argv=None, dataset_cls_name: str = "rfund"):
    args = build_argparser().parse_args(argv)
    check_parallel_flags(args)
    started = init_parallel(args)
    try:
        return run(args, dataset_cls_name)[0]
    finally:
        if started:
            from .parallel import dist as pdist

            pdist.dist.destroy_process_group()


def run(args, dataset_cls_name: str = "rfund"):
    """Train and/or evaluate as the flags say, in the process group (if
    any) already joined; returns (the final eval metrics or None, the
    trainer)."""
    from .parallel import dist as pdist

    os.makedirs(args.output_dir, exist_ok=True)
    if pdist.rank() == 0:
        with open(os.path.join(args.output_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)

    from .pipeline.trainer import PEneoTrainer

    cfg, model, train_ds, eval_ds, collator, tokenizer = setup(
        args, dataset_cls_name)
    targs = training_arguments(args)
    trainer = PEneoTrainer(cfg, model, targs, train_ds, eval_ds, collator,
                           tokenizer=tokenizer,
                           source_dir=args.model_name_or_path)
    if args.do_train:
        trainer.train()
        trainer.save_model()
    if args.do_eval:
        metrics = trainer.evaluate()
        trainer.log({"event": "final_eval", **metrics})
        if pdist.rank() == 0:
            with open(os.path.join(args.output_dir, "eval_results.json"),
                      "w") as f:
                json.dump(metrics, f, indent=2)
        return metrics, trainer
    return None, trainer


if __name__ == "__main__":
    main()
