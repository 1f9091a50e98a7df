"""Timing of the sp pair path on one card: bf16 against int8 pair heads.

Counterpart of ``tools/bench_sp_pair.py``. An sp rank runs the decoder's
``sp_partials`` over its rows of the pair grid (every row block through the
five heads, the spot keys, its top k) and ``parallel/seq_parallel.py``
``merge_spots`` over the group's candidates (``models/decoder.py``
``_sp_forward``). At ``size 1`` that is exactly one rank's work on a grid
of its own, so this tool times it alone: from random combine features a, b
(B, L, hidden/2) in bf16, on a decoder of ``max_spots_per_head = k`` with
seeded random weights, first with the bf16 pair head, then with its hidden
layers in int8 (scales from the same fp32 weights). Every iteration fetches
the merged spots to the host.

    python -m peneo_tpu_torch.bench_sp_pair [--L 2048] [--B 1] [--iters 16] \\
        [--hidden 768] [--k 256] [--device cpu]

It prints the device with its power limit, then the JAX tool's lines: per
mode ``{"mode", "L", "B", "ms_per_batch", "pages_per_s"}``, then ``{"L",
"B", "int8_speedup"}``. Runs on the GPU unless ``--device cpu`` is given.
The JAX tool times the stacked, column-padded weights of its sp path; the
port's sp path runs the decoder's own layers, so there is no stacked layout
to time.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np

MODES = ("bf16", "int8")


def build_argparser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--L", type=int, default=2048)
    p.add_argument("--B", type=int, default=1)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--hidden", type=int, default=768,
                   help="backbone hidden (pair features are hidden // 2)")
    p.add_argument("--k", type=int, default=256)
    p.add_argument("--device", type=str, default=None,
                   help="cpu to run on the CPU (default: the GPU)")
    return p


def decoders(hidden, k, device, seed=0):
    """The bf16 decoder and its int8 twin (same fp32 weights; the int8
    layers keep them in fp32 for their scales), in eval mode."""
    import torch

    from .config import LiltConfig, PEneoConfig
    from .models.decoder import PEneoDecoder
    from .models.lilt import init_module_weights
    from .ops.quant import keep_int8_weights_fp32

    out = {}
    state = None
    for mode in MODES:
        cfg = PEneoConfig(
            backbone_name="lilt-infoxlm-base",
            backbone_config=LiltConfig(hidden_size=hidden).to_dict(),
            max_spots_per_head=k,
            quantize_pair_head="int8" if mode == "int8" else None)
        dec = PEneoDecoder(cfg)
        if state is None:
            init_module_weights(dec, torch.Generator().manual_seed(seed),
                                cfg.initializer_range)
            state = copy.deepcopy(dec.state_dict())
        else:
            dec.load_state_dict(state)
        dec = dec.to(device=device, dtype=torch.bfloat16)
        keep_int8_weights_fp32(dec)
        out[mode] = dec.eval()
    return out


def sp_spots(dec, a, b):
    """One sp rank's work at size 1: ``sp_partials`` over every row, then
    ``merge_spots``; the packed spots (``pack_spots``)."""
    from .models.decoder import HEAD_NAMES, pack_spots
    from .parallel.seq_parallel import merge_spots

    spots, _ = dec.sp_partials(a, b, a.shape[1], 0, 1)
    return pack_spots(merge_spots(spots.packed()[None], a.shape[0],
                                  dec.cfg.max_spots_per_head, a.shape[1],
                                  HEAD_NAMES))


def one_process_spots(dec, a, b):
    """The same decoder's single-process path over the whole grid (dense
    tag and score maps, then ``compact_spots``), packed."""
    from .models.decoder import pack_spots

    return pack_spots(dec._grid_forward(a, b, a.shape[1], None, False, None,
                                        False))


def main(argv=None, reference=False):
    """Time both modes and print the lines. Returns {mode: (line, the last
    iteration's packed spots as host arrays)}, the speed-up line under
    ``"speedup"`` and, with ``reference``, the bf16 decoder's one-process
    spots under ``"one_process"``."""
    import torch

    from .bench_serving import device_name
    from .pipeline.infer import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)  # no GPU, no --device cpu: raise
    print(json.dumps({"device": device_name(device),
                      "torch": torch.__version__}), flush=True)
    decs = decoders(args.hidden, args.k, device)
    H = args.hidden // 2
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((args.B, args.L, H))
                             .astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for _ in range(2))

    def fetch(outs):
        return [o.cpu().numpy() for o in outs]

    result, times = {}, {}
    with torch.inference_mode():
        for mode in MODES:
            fetch(sp_spots(decs[mode], a, b))  # warm
            t0 = time.perf_counter()
            for _ in range(args.iters):
                spots = fetch(sp_spots(decs[mode], a, b))
            dt = (time.perf_counter() - t0) / args.iters
            times[mode] = dt
            line = {"mode": mode, "L": args.L, "B": args.B,
                    "ms_per_batch": round(dt * 1e3, 3),
                    "pages_per_s": round(args.B / dt, 3)}
            print(json.dumps(line), flush=True)
            result[mode] = (line, spots)
        result["speedup"] = {"L": args.L, "B": args.B,
                             "int8_speedup": round(times["bf16"]
                                                   / times["int8"], 4)}
        print(json.dumps(result["speedup"]), flush=True)
        if reference:
            result["one_process"] = fetch(one_process_spots(decs["bf16"], a,
                                                            b))
    return result


if __name__ == "__main__":
    main()
