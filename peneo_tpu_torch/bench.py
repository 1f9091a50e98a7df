"""Batched forward throughput of the port (pages/s on one card).

Counterpart of ``bench.py``: a full-width model of one backbone family
(base geometry, vocab 250002, seeded random weights of std 0.02, bf16) and
the PEneo decoder, at L tokens and batch B, run as the serving forward runs
it — backbone, pair head, the on-device top-k spot compaction and packing of
the five heads — with every batch's packed spots pulled to the host. The
visual families get a random page image (fp32, pre-normalized, as an
exported artifact takes pages).

    python -m peneo_tpu_torch.bench [--backbone lilt|layoutlmv3|layoutlmv2] \\
        [--L 512] [--B 32] [--iters 16] [--no_fused_biacm] \\
        [--no_fused_bias_attention] [--int8_pair_head] [--int8_backbone] \\
        [--spot_streaming] [--no_image] [--device cpu]

Two warm calls, then ``iters`` forwards with one batch in flight: batch n+1
is enqueued before the host waits for batch n's spots, which were copied
into pinned buffers behind an event recorded before n+1 was enqueued (a
plain ``.cpu()`` of batch n after n+1's launch would wait for n+1 too).

The last line is the JAX tool's: ``{"metric", "value", "unit",
"vs_baseline"}`` with its metric names. Earlier lines give the device with
its power limit, the baseline's source, the forward's wall ms, the attention
kernels' launches per forward and the host syncs of one forward (on the
card, under ``torch.cuda.set_sync_debug_mode``). ``vs_baseline`` divides by
the original PyTorch PEneo's pages/s on a CPU, read from
``BASELINE_measured.json`` beside the package (``--baseline_cache``), else
1.0. Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, N_ITERS = 32, 512, 16
CACHE = os.path.join(REPO, "BASELINE_measured.json")
FALLBACK_REF_PAGES_PER_SEC = 1.0
FAMILIES = {"lilt": "lilt-infoxlm-base",
            "layoutlmv3": "layoutlmv3-base-chinese",
            "layoutlmv2": "layoutxlm-base"}
WEIGHT_STD = 0.02


def make_inputs(rng, batch, seq_len, vocab):
    """``bench.py``'s ``_inputs``: random ids in [3, vocab), no padding,
    boxes of 60×24 at random corners."""
    input_ids = rng.integers(3, vocab, (batch, seq_len)).astype(np.int64)
    attn = np.ones((batch, seq_len), np.int64)
    x0 = rng.integers(0, 800, (batch, seq_len))
    y0 = rng.integers(0, 800, (batch, seq_len))
    bbox = np.stack([x0, y0, x0 + 60, y0 + 24], -1).astype(np.int64)
    return input_ids, bbox, attn


def reference_pages_per_sec(cache=CACHE):
    """(pages/s of the original PyTorch PEneo on a CPU, where it came
    from): the cache file, else the fallback."""
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)["reference_cpu_pages_per_sec"], "cache"
    return FALLBACK_REF_PAGES_PER_SEC, "fallback"


def build_config(args, geometry=None):
    """``bench.py``'s config: the family's base geometry at vocab 250002,
    ``max_position_embeddings`` L + 8, no dropout; ``geometry`` overrides
    backbone fields (tests)."""
    from .config import (LayoutLMv2Config, LayoutLMv3Config, LiltConfig,
                         PEneoConfig)

    cls = {"lilt": LiltConfig, "layoutlmv3": LayoutLMv3Config,
           "layoutlmv2": LayoutLMv2Config}[args.backbone]
    bb = cls(**{"vocab_size": 250002, "max_position_embeddings": args.L + 8,
                "pad_token_id": 1, "hidden_dropout_prob": 0.0,
                "attention_probs_dropout_prob": 0.0, **(geometry or {})})
    return PEneoConfig(
        backbone_name=FAMILIES[args.backbone], backbone_config=bb.to_dict(),
        max_seq_len=args.L, use_fused_biacm=args.fused_biacm,
        use_fused_bias_attention=args.fused_bias_attention,
        quantize_pair_head="int8" if args.int8_pair_head else None,
        quantize_backbone="int8" if args.int8_backbone else None,
        spot_streaming=args.spot_streaming)


def random_model(cfg, device, seed=0):
    """The port's model with every parameter drawn from normal(0, 0.02) by
    a seeded generator on ``device`` (``bench.py``'s ``_random_params``),
    cast to bf16, in eval mode."""
    import torch

    from .models.peneo import PEneoModel

    model = PEneoModel(cfg).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, WEIGHT_STD, generator=gen)
    return model.cast(torch.bfloat16).eval()


def kernel_launches():
    """The serving attention kernels' launch counters (#1, #4)."""
    from .ops import biacm_attention as ba
    from .ops import bias_attention as rb

    return {"biacm_attention": ba.biacm_attention_cuda,
            "bias_attention": rb.bias_attention_cuda}


class PinnedFetch:
    """Two sets of pinned host buffers for a forward's packed spots: a
    batch's spots are copied in behind an event, and the host waits on that
    event only, never on work enqueued after it."""

    def __init__(self, outs):
        import torch

        self.slots = [[torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                       for o in outs] for _ in range(2)]
        self.turn = 0

    def start(self, outs):
        import torch

        host = self.slots[self.turn]
        self.turn ^= 1
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def wait(pending):
        host, done = pending
        done.synchronize()
        return [h.numpy() for h in host]


def build_argparser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--L", type=int, default=L)
    p.add_argument("--B", type=int, default=B)
    p.add_argument("--iters", type=int, default=N_ITERS)
    p.add_argument("--backbone", default="lilt", choices=sorted(FAMILIES))
    p.add_argument("--fused_biacm", action="store_true", default=True,
                   help="LiLT attention through kernel #1 (the default)")
    p.add_argument("--no_fused_biacm", dest="fused_biacm",
                   action="store_false",
                   help="LiLT attention through the plain twin")
    p.add_argument("--fused_bias_attention", action="store_true",
                   default=True,
                   help="LayoutLMv3/v2 attention through kernel #4 (the "
                        "default)")
    p.add_argument("--no_fused_bias_attention", dest="fused_bias_attention",
                   action="store_false",
                   help="LayoutLMv3/v2 attention through the plain twin")
    p.add_argument("--int8_pair_head", action="store_true",
                   help="the pair head's hidden layers in int8 (default "
                        "off, as the port's serving)")
    p.add_argument("--no_int8_pair_head", dest="int8_pair_head",
                   action="store_false")
    p.add_argument("--int8_backbone", action="store_true",
                   help="the backbone's projections and MLPs in int8 too")
    p.add_argument("--spot_streaming", action="store_true", default=False,
                   help="kept in the config (the port's spot path is one)")
    p.add_argument("--no_spot_streaming", dest="spot_streaming",
                   action="store_false")
    p.add_argument("--no_image", action="store_true",
                   help="layoutlmv3/v2: no page image (text only)")
    p.add_argument("--baseline_cache", default=CACHE,
                   help="the reference's cached CPU pages/s")
    p.add_argument("--device", type=str, default=None,
                   help="cpu to run on the CPU (default: the GPU)")
    return p


def main(argv=None, geometry=None):
    """Run the bench; returns the last line's dict. ``geometry`` overrides
    fields of the backbone config (tests)."""
    return run(argv, geometry)[1]


def run(argv=None, geometry=None):
    """Run the bench and print its lines; returns (the run's line, the
    last line)."""
    import torch

    from .bench_serving import device_name
    from .models.decoder import pack_spots
    from .pipeline.infer import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)  # no GPU, no --device cpu: raise
    on_card = device.type == "cuda"
    ref_pps, ref_source = reference_pages_per_sec(args.baseline_cache)
    emit({"device": device_name(device), "torch": torch.__version__,
          "baseline": {"source": ref_source, "pages_per_s": ref_pps}})

    cfg = build_config(args, geometry)
    bb = cfg.backbone()
    t0 = time.perf_counter()
    model = random_model(cfg, device)
    fused = (args.fused_biacm if args.backbone == "lilt"
             else args.fused_bias_attention)
    model.set_attention_impl("kernel" if fused else "plain")
    if on_card:
        from .pipeline.infer import load_family_kernel

        load_family_kernel(device, cfg.backbone_family())
    rng = np.random.default_rng(0)
    ids, bbox, attn = (torch.from_numpy(x).to(device) for x in
                       make_inputs(rng, args.B, args.L, bb.vocab_size))
    image = None
    if args.backbone != "lilt" and not args.no_image:
        s = bb.input_size
        image = torch.from_numpy(rng.standard_normal(
            (args.B, 3, s, s)).astype(np.float32)).to(device)
    setup_s = time.perf_counter() - t0

    forwards = 0  # every forward of the run, warm and timed

    def run_once():
        nonlocal forwards
        forwards += 1
        with torch.inference_mode():
            return pack_spots(model(ids, bbox, attn, image=image))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    first = [o.cpu() for o in run_once()]  # first call: kernels load, warm
    first_s = time.perf_counter() - t0
    [o.cpu() for o in run_once()]  # warm

    wall = []  # one forward, dispatch to fetched spots
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        [o.cpu() for o in run_once()]
        wall.append((time.perf_counter() - t0) * 1e3)

    syncs = sync_sites = None
    if on_card:  # the forward alone: any host sync inside it shows here
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                outs = run_once()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the warning of each synchronizing operation (not the mode's own
        # note that it is a prototype)
        sync_sites = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                      for w in caught if "called a synchronizing"
                      in str(w.message)]
        syncs = len(sync_sites)
        fetch = PinnedFetch(outs)
    counters = kernel_launches()
    before = {k: c.launches for k, c in counters.items()}

    sync()
    t0 = time.perf_counter()
    if on_card:
        pending = fetch.start(run_once())
        for _ in range(args.iters - 1):
            nxt = fetch.start(run_once())
            last = fetch.wait(pending)
            pending = nxt
        last = fetch.wait(pending)
    else:
        for _ in range(args.iters):
            last = [o.numpy() for o in run_once()]
    dt = time.perf_counter() - t0
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    if any(not np.array_equal(a, b.numpy()) for a, b in zip(last, first)):
        raise RuntimeError("the timed forwards' spots differ from the first "
                           "call's")
    pages_per_sec = args.B * args.iters / dt
    record = {
        "backbone": args.backbone, "B": args.B, "L": args.L,
        "iters": args.iters, "image": image is not None,
        "attention": "kernel" if fused else "plain",
        "int8_pair_head": args.int8_pair_head,
        "int8_backbone": args.int8_backbone,
        "setup_seconds": setup_s, "first_call_seconds": first_s,
        "forward_wall_ms": statistics.median(wall),
        "forward_wall_ms_runs": wall,
        "ms_per_batch_in_flight": dt / args.iters * 1e3,
        "forwards": forwards,
        "pages_per_s": pages_per_sec, "launches": launches,
        "launches_per_forward": {k: v / args.iters
                                 for k, v in launches.items()},
        "host_syncs_per_forward": syncs, "host_sync_sites": sync_sites,
        "device": device_name(device)}
    emit(record)

    suffix = f"_L{args.L}"
    if args.backbone != "lilt":
        img_tag = "" if image is not None else "_textonly"
        suffix = f"_{args.backbone}{img_tag}{suffix}"
    line = {"metric": f"pages_per_sec_per_chip{suffix}_bf16_batch_inference",
            "value": round(pages_per_sec, 2), "unit": "pages/s",
            "vs_baseline": round(pages_per_sec / ref_pps, 2)}
    emit(line)
    return record, line


def emit(obj):
    print(json.dumps(obj), flush=True)


if __name__ == "__main__":
    main()
