"""Time the attention CUDA kernels of one checkout at the main path's shapes,
on one GPU: BiACM #1 (serving forward), #2 (training forward), #3 (training
backward) and rel-bias #4 (serving forward), #5 (training forward), #6
(training backward):

    python peneo_tpu_torch/ops/biacm_timing.py [--tree DIR] [--library]

``--tree`` names the root of the checkout whose ``peneo_tpu_torch`` is timed
(default: the one this file lies in), so that two commits can be compared
within one process group on one card: unpack the other commit with ``git
archive`` and run the script once per tree, in turns. It prints one JSON
line: per kernel the median milliseconds of 20 calls between CUDA events
(which includes the time the card waits for the host between launches) and
the device milliseconds per call by kernel name from torch.profiler. With
``--library``, also ``F.scaled_dot_product_attention``: on the head-dim-80
concatenation at dropout rates 0 and 0.1 (BiACM), and with ``attn_mask =
bias + mask`` in bf16 at its natural and at a padded row stride (rel-bias),
forward and backward: a yardstick only, the port never calls it.

Shapes: kernels #1/#4 at B=32, the training kernels at B=8; nh=12; BiACM at
L=512, d = 64 + 16; rel-bias at L'=709 (512 text + 197 visual positions),
d = 64, an fp32 (B, nh, L', L') bias laid out as the model's ``RelBias``
lays it out (a view of an (nh, B, L', 712) buffer; the ``*_natural`` rows
take the same values contiguous, row stride 709); bf16 inputs, the last 100
(text) keys of every other batch row masked; training kernels at rates 0.1
and 0 with the on-card bits of seed 0.
"""

import argparse
import json
import os
import statistics
import sys


def time_ms(fn, n=20, warmup=3):
    """Median milliseconds of ``n`` calls, each between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20):
    """Device milliseconds per call by kernel name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / n / 1e3, 4)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def inputs(batch, length, gen):
    """q/k/v as (B, nh, L, d) views of (B, L, nh, d) bf16 buffers (the LiLT
    layer's layout), the (B, L) fp32 key mask and two output gradients."""
    import torch

    def heads(d):
        x = torch.randn((batch, length, 12, d), generator=gen, device="cuda")
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads(64) for _ in range(3)] + [heads(16) for _ in range(3)]
    bias = torch.zeros((batch, length), device="cuda")
    bias[::2, length - 100:] = torch.finfo(torch.float32).min / 2
    return qkv, bias, (heads(64), heads(16))


def bias_inputs(batch, length, gen):
    """Rel-bias inputs: q/k/v and an output gradient as (B, nh, L', 64)
    views of (B, L', nh, 64) bf16 buffers; the fp32 bias as a (B, nh, L',
    L') view of an (nh, B, L', L'p) buffer, L'p = L' rounded up to a
    multiple of 4 (the model's layout), and the same values contiguous; the
    key mask."""
    import torch

    def heads():
        x = torch.randn((batch, length, 12, 64), generator=gen, device="cuda")
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads() for _ in range(3)]
    buf = torch.randn((12, batch, length, -(-length // 4) * 4),
                      generator=gen, device="cuda")
    bias = buf.permute(1, 0, 2, 3)[..., :length]
    mask = torch.zeros((batch, length), device="cuda")
    mask[::2, 512 - 100:512] = torch.finfo(torch.float32).min / 2
    return qkv, bias, bias.contiguous(), mask, heads()


def library_masks(natural, mask):
    """SDPA's additive bf16 mask (bias + key mask) at its natural row stride
    and at one padded to a multiple of 8 elements (16-byte rows)."""
    import torch

    full = (natural + mask[:, None, None, :]).to(torch.bfloat16)
    n = full.shape[-1]
    padded = torch.zeros(full.shape[:-1] + (-(-n // 8) * 8,),
                         dtype=full.dtype, device=full.device)[..., :n]
    padded.copy_(full)
    return (("", full), ("_padded", padded))


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                   help="root of the checkout to time")
    p.add_argument("--library", action="store_true",
                   help="also time the library call (SDPA)")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    import torch.nn.functional as F

    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb

    if not torch.cuda.is_available():
        print("biacm_timing: no CUDA device", file=sys.stderr)
        return 1
    st, sl = 0.125, 0.25
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": args.tree, "device": torch.cuda.get_device_name(0)}

    def both(name, fn):
        out[name + "_ms"] = time_ms(fn)
        out[name + "_device_ms"] = device_ms(fn)

    qkv, bias, _ = inputs(32, 512, gen)
    both("k1", lambda: ba.biacm_attention_cuda(*qkv, bias, st, sl))
    qkv, bias, dctx = inputs(8, 512, gen)
    for rate, tag in ((0.1, ""), (0.0, "_rate0")):
        res = ba.biacm_attention_train_fwd_cuda(*qkv, bias, 0, st, sl, rate)
        # a tree from before the masks were carried bit-packed returns
        # three values, and its backward takes the seed in the masks' place
        keep = res[3] if len(res) == 4 else 0
        both("k2" + tag, lambda: ba.biacm_attention_train_fwd_cuda(
            *qkv, bias, 0, st, sl, rate))
        both("k3" + tag, lambda: ba.biacm_attention_train_bwd_cuda(
            *qkv, bias, keep, res[2], *dctx, st, sl, rate))
    if args.library:
        q80 = torch.cat([qkv[0] * st, qkv[3] * sl], -1).detach() \
            .requires_grad_()
        k80 = torch.cat([qkv[1], qkv[4]], -1).detach().requires_grad_()
        v80 = torch.cat([qkv[2], qkv[5]], -1).detach().requires_grad_()
        mask = bias[:, None, None, :].to(torch.bfloat16)
        d80 = torch.cat(dctx, -1)
        for rate in (0.0, 0.1):
            def sdpa():
                return F.scaled_dot_product_attention(
                    q80, k80, v80, attn_mask=mask, dropout_p=rate, scale=1.0)

            with torch.no_grad():
                both(f"sdpa_fwd_rate{rate}", sdpa)
            o80 = sdpa()
            both(f"sdpa_bwd_rate{rate}", lambda: torch.autograd.grad(
                o80, (q80, k80, v80), d80, retain_graph=True))
        del q80, k80, v80, o80
    del qkv, bias, dctx

    # rel-bias: #4 at B=32, #5/#6 at B=8, L' = 709
    qkv, bias, natural, mask, dctx = bias_inputs(32, 709, gen)
    both("k4", lambda: rb.bias_attention_cuda(*qkv, bias, mask, 0.125))
    out["k4_natural_device_ms"] = device_ms(
        lambda: rb.bias_attention_cuda(*qkv, natural, mask, 0.125))
    if args.library:
        for tag, m in library_masks(natural, mask):
            with torch.no_grad():
                both("sdpa_bias_fwd" + tag,
                     lambda: F.scaled_dot_product_attention(*qkv,
                                                            attn_mask=m))
        del m
    del qkv, bias, natural, mask, dctx
    qkv, bias, natural, mask, dctx = bias_inputs(8, 709, gen)
    for rate, tag in ((0.1, ""), (0.0, "_rate0")):
        res = rb.bias_attention_train_fwd_cuda(*qkv, bias, mask, 0, 0.125,
                                               rate)
        # a tree from before the mask was carried bit-packed returns two
        # values, and its backward takes the seed in the flags' place
        keep = res[2] if len(res) == 3 else 0
        both("k5" + tag, lambda: rb.bias_attention_train_fwd_cuda(
            *qkv, bias, mask, 0, 0.125, rate))
        both("k6" + tag, lambda: rb.bias_attention_train_bwd_cuda(
            *qkv, bias, mask, keep, res[1], dctx, 0.125, rate))
        if not tag:
            out["k5_natural_device_ms"] = device_ms(
                lambda: rb.bias_attention_train_fwd_cuda(
                    *qkv, natural, mask, 0, 0.125, rate))
            out["k6_natural_device_ms"] = device_ms(
                lambda: rb.bias_attention_train_bwd_cuda(
                    *qkv, natural, mask, keep, res[1], dctx, 0.125, rate))
    if args.library:
        ql, kl, vl = (x.detach().requires_grad_() for x in qkv)
        for tag, m in library_masks(natural, mask):
            m = m.detach().requires_grad_()
            with torch.no_grad():
                both("sdpa_bias_train_fwd" + tag,
                     lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                            attn_mask=m))
            o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m)
            both("sdpa_bias_bwd" + tag, lambda: torch.autograd.grad(
                o, (ql, kl, vl, m), dctx, retain_graph=True))
            del o
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
