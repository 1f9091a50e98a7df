#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (peneo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises; exit code != 0):

1. device  — requires CUDA; prints ``nvidia-smi`` name and power limit.
2. build   — builds the four CUDA libraries from ``peneo_tpu_torch/csrc``
   (one nvcc each, started together) and prints their ptxas reports and,
   for every kernel of both families, its registers, shared memory, stack
   frame and spills (any spill fails) and the resident CTAs per SM the
   runtime grants it.
3. kernel  — kernel #1 against its plain PyTorch twin (fp32 on the same
   bf16 inputs) at B=32, nh=12, d 64/16 and L = 512 (serving shape, last
   100 keys of half the rows masked), 128 and a ragged 200 (one row's first
   80 keys masked); max abs error ≤ 2e-2. Median of 20 launches (CUDA
   events) of the kernel, the twin and ``F.scaled_dot_product_attention``
   on the head_dim-80 concatenation (same function; a yardstick only).
4. kernel_train — kernels #2 (training forward, attention dropout) and #3
   (backward) against the fp32 twin and its autograd gradients on the same
   bf16 inputs and output gradients, at B=8, nh=12 and L = 512 (the
   training shape, last 100 keys of half the rows masked), 128, a ragged
   200, and 512 with nearly collinear rows (as in LiLT-base's last layers),
   rates 0 and 0.1, with explicit bits and with the in-kernel
   generator (the twin then takes ``attention_dropout_bits`` of the seed):
   forward max abs err ≤ 2e-2, each gradient's max abs err ≤ 2e-2 of its
   own max |reference|; kernel #2's bit-packed keep flags equal to
   ``pack_keep_mask(attention_dropout_bits(...) < threshold)`` word for
   word, and kernel #3 fed either, bit for bit; the kept share of each
   stream and the share where the two differ; timings at the training
   shape, beside ``F.scaled_dot_product_attention`` at rate 0 and 0.1,
   between CUDA events and as device time (torch.profiler), since these
   calls are shorter than the host time of a wrapper call.
5. serve   — LiLT-base (768 hidden, 12 layers, vocab 250002) + PEneo decoder
   with seeded random weights, saved as config.json / pytorch_model.bin /
   toy_tokenizer.json; 96 synthetic pages (3 batches of 32, L=512, bf16)
   through ``InferenceService.run``. Every page must return a record and
   kernel #1 must launch exactly 12 times per forward. The warm rate
   (pages after the first batch's fetch over the time to the last decoded
   page) is the median of SERVE_REPEATS runs.
6. parity  — one batch through the model with the kernel and with
   ``set_attention_impl("plain")``: relative error of last_hidden_state and of
   the line-extraction logits ≤ 2e-2.
7. decode  — a random model finds no key/value pair, so the decode half of
   the path is held to a known answer: one batch's ground-truth spots (from
   the synthetic documents' relations) go through the service's on-card
   ``compact_spots`` / ``pack_spots``, the fetch and the host chain walk;
   the records must be exactly the documents' key/value pairs and lines.
8. breakdown — one batch's host preprocess and forward times and its
   device time by kernel (torch.profiler); ``--profile DIR`` also writes the
   kernel table and a chrome trace there.
9. train   — ``python -m peneo_tpu_torch.run_rfund`` in process: a synthetic
   RFUND corpus (64 train, 16 dev pages), LiLT-base at vocab 250002 with
   seeded random init, B=8, L=512, bf16 autocast, dropout 0.1, decoder lr
   ×30, TRAIN_STEPS steps logged every LOG_EVERY, eval and save at the
   end. Every step's loss must be finite (the trainer counts non-finite
   ones on the card), kernels #2 and #3 must launch 12 times per step,
   kernel #1 12 times per eval forward, the metrics must cover all 16 dev
   pages, and the saved directory must serve one page through
   ``InferenceService``. ms/step is the mean over the steps between the
   first and the last log.
10. train_parity — one batch, one training step's loss and gradients from
   the same weights and seeds with the kernels, with the plain twins, and
   with kernel #2's forward and the twin's backward: the loss within 1e-3
   and each attention projection's weight gradient (layers 0 and 11) and
   combine_fc's within 1e-2, relative (layer 11's query and key, whose
   keys are nearly collinear, within 3e-2 of the twins' path; kernel #3
   alone within 1e-2 of the twin's backward everywhere).
11. train_breakdown — one training step's device time by kernel.

The LayoutLMv3 family (rel-bias attention, kernels #4-#6) at full width and
depth: ``layoutlmv3-base-chinese`` geometry (768 hidden, 12 layers, 12 heads
of 64, vocab 250002, 224 px image → 197 visual tokens, so L' = 709 at 512
text positions), seeded random weights:

12. kernel_bias — kernel #4 against its fp32 twin at B=32, nh=12, d=64 and
   L' = 709 (last 100 text keys of half the rows masked), 128, a ragged
   200 and LayoutXLM's 561 (512 text + 49 visual tokens: the last key
   tile holds 49), with a random fp32 (B, nh, L', L') bias at its natural
   row stride (rows of L' floats, fetched in 4-byte requests) and at the
   model's padded one (``RelBias``: L' rounded up to a multiple of 4, 16-byte
   requests); max abs error ≤ 2e-2. Times of the kernel (padded stride, the
   main path's; events and device), the twin and
   ``F.scaled_dot_product_attention(q, k, v, attn_mask=bias + mask)`` at
   both strides (events and device; and each backend that accepts the
   mask); at 561 the device times and the bound.
13. kernel_bias_train — kernels #5 and #6 against the fp32 twin and its
   autograd gradients (dq, dk, dv and dbias) at B=8 and the same lengths
   plus 709 with nearly collinear rows, rates 0 and 0.1, explicit bits and
   the in-kernel generator (bit-identical results; the twin takes
   ``element_dropout_bits``), both bias strides: forward ≤ 2e-2, each
   gradient ≤ 2e-2 of its own max |reference|; kernel #5's packed keep
   flags equal to ``pack_keep_mask(element_dropout_bits(...) < threshold)``
   word for word, and kernel #6 fed either, bit for bit; the kept share;
   timings (events and device) beside SDPA's at both strides, and at 561
   the device times.
14. serve_v3 — the model saved as config.json / pytorch_model.bin /
   toy_tokenizer.json, the 96 pages through ``InferenceService.run`` (B=32,
   L=512, bf16, raw uint8 page images normalized on the card): a record per
   page, kernel #4 exactly 12 times per forward, kernel #1 never; warm
   pages/s, peak memory.
15. parity_v3 / breakdown_v3 — as 6 and 8, with the image; the breakdown
   also times the relative-bias build on its own.
16. train_v3 — ``run_rfund`` in process with ``--synthetic_data
   --model_name_or_path <that directory>`` (rendered pages, the 224 px
   geometry), B=8, L=512, TRAIN_STEPS steps, eval and save: finite losses,
   kernels #5 and #6 12 times per step, #4 12 times per eval forward, all
   16 dev pages, the saved directory serves a page.
17. train_parity_v3 — as 10, over layers 0 and 11's query/key/value weight
   gradients, combine_fc's and the three bucket tables', each ≤ 1e-2
   relative on its own (layer 11's query and key within 3e-2 of the twins'
   path, as in 10 and for the same measured reason; kernel #6 alone within
   1e-2 of the twin's backward everywhere).
18. train_breakdown_v3 — as 11, with the bias build and the table gradients
   timed on their own.

The LayoutXLM family (LayoutLMv2: kernels #4-#6 again, on an unscaled bias,
and a ResNeXt-101 32x8d + FPN tower) at full width and depth:
``layoutxlm-base`` geometry (768 hidden, 12 layers, 12 heads of 64, vocab
250002, fast_qkv, 224 px BGR image → p2 56x56 → 7x7 = 49 visual tokens, so
L' = 561), seeded random weights (the tower's residual branches at a small
gain, so that p2 stays of order 1):

19. serve_v2 — as 14: a record per page, kernel #4 exactly 12 times per
   forward, kernel #1 never; warm pages/s, peak memory, and the p2 map's
   max |x| over one batch (finite).
20. parity_v2 — as 15's parity.
21. breakdown_v2 — as 15's breakdown, plus the device time of the tower
   with its pooling (NCHW and channels_last), of the bias build and of the
   decoder with its pair head alone.
22. train_v2 — as 16.
23. train_parity_v2 — as 17, over layers 0 and 11's q, k and v row blocks
   of ``qkv_linear``'s weight gradient, combine_fc's and the three tables'
   (layer 11's q and k within 3e-2 of the twins' path); the stem conv's
   gradient error is reported.
24. train_breakdown_v2 — as 18, plus the tower's forward and forward +
   backward device time.
``steps_per_call``: K = 4 fine-tuning steps as one CUDA graph replay, for
the three families at full width (the counts reset in each phase):

25. kernel_seed — kernels #2 (L = 512) and #5 (L' = 709 and 561) at B=8,
   rate 0.1 with the seed in device memory: the packed keep flags equal
   those of the same seed by value, bit for bit; in a CUDA graph that
   advances the seed before the launch, two replays give different flags,
   each equal to the by-value flags of the seed it read. And
   ``torch.utils.checkpoint`` in a graph: a checkpointed dropout's
   recompute sees the forward's mask (its gradient is mask·2·wᵀ), on two
   replays with different masks.
26. train_graph_parity — per family, dropout 0, the same state and 4
   batches: 4 of the trainer's K = 1 steps, then one replay: losses within
   1e-4 relative, learning rates equal, every fp32 master parameter within
   1e-5 (bit-identical expected).
27-29. train_graph, train_graph_v3, train_graph_v2 — ``run_rfund`` with
   ``--steps_per_call 4`` on the K = 1 phase's arguments, 64 steps logged
   every 16, dropout 0.1, eval and save at the end: the logged steps,
   finite losses, no non-finite step, the wrappers of #2/#3 (or #5/#6)
   called 12 times per step of the first call (its eager warm-up and its
   capture), #1 (or #4) 12 times per eval forward, the saved directory
   serves a page; ms/step over steps 33-64 beside the K = 1 phase's, peak
   memory, and one profiled replay of the saved model's graph: its trace
   holds 12 launches per step of each of the family's mask, forward, dq
   and dk/dv kernels and none of the others; device busy ms per step and
   the idle share; the feed thread's host ms per step (collate with the
   page images' decode, stack, pin).
Checkpoints, int8 and the single-device serving surface of
deploy/inference.py (each phase resets every kernel count just before it
and prints what they read just after; the first three run after phase 8,
the last two after phase 18):

- checkpoints — the LiLT-base serving model written as
   ``params.msgpack`` (``write_flax_msgpack`` of the JAX param tree) and
   ``model.safetensors`` beside its ``pytorch_model.bin``: each loads the
   same weights bit for bit and serves the 96 pages to the same records
   (kernel #1 12 times a forward); ``generate_peneo_weights`` on an
   HF-style copy of its backbone, then 4 ``run_rfund`` steps from the
   output: the backbone before step 1 is the model's bit for bit, the
   decoder keeps its seeded init, finite losses, #2/#3 12 times a step.
- serve_int8 — ``torch._int_mm`` against its integer twin, bit for bit,
   at the pair head's first row block and an intermediate layer's shape,
   timed beside a bf16 product and its bound (int8 tensor-core peak); the
   96 pages through bf16, ``int8_pair_head`` and ``int8_pair_head +
   int8_backbone`` services: pages/s, one batch's forward wall time, peak
   memory, a profiled forward's device busy ms, the int8 launches the
   module structure gives, and one batch's logits against bf16's over the
   upper triangle of the real tokens (err/span < 0.05 and argmax agreement
   > 0.98; with the backbone 0.15 and 0.95).
- serve_api — ``run_page`` on 8 pages equals ``run`` over those pages
   at batch 1, ``run_batch`` on one batch equals the batch-32 run,
   ``run(visualize_dir=...)`` writes one image per page.
- serve_v3_procs — LayoutLMv3-base over 384 pages (the 96 under 4
   names): 4 threads, then min(8, cpu_count) spawned preprocessing
   processes; whole-run pages/s, the pool's start time, the same records.
- serve_int8_v3 — one LayoutLMv3-base forward with both int8 switches:
   kernel #4 12 times behind the int8 projections, the int8 launches, the
   logits against bf16's within the backbone gate.

OHEM and data parallelism (after phase 11; each resets every kernel
count just before it and reads them just after):

- train_ohem — ``run_rfund`` on phase 9's arguments and weights with the
   config's ``peneo_ohem_num_positive/negative`` = 128/512 (the JAX
   L = 512 OHEM test's): finite losses, #2/#3 12 times a step, #1 12 times
   an eval forward, all 16 dev pages; ms/step over steps 11-30 beside phase
   9's plain-CE figure, peak memory; then one batch at dropout 0: the
   streaming OHEM total of the CUDA path equals ``ohem_cross_entropy`` over
   the same block logits concatenated (relative 1e-5) and the plain twins'
   path within 1e-3.
- train_dp — 2 ranks of ``run_rfund --distributed`` spawned by this script
   (``--dp-worker``: torchrun's environment on a free local port, each its
   own CUDA context; gloo when they share the card, NCCL when each has its
   own), global B = 8 (4 a rank), L = 512, bf16, dropout 0: 4 steps of
   plain CE, then 4 of OHEM 128/512, each with an eval over the 16 dev pages
   listed twice and a save; the same global batches in this process. Gates:
   every step's loss within 1e-3 of the one process's and the same on both
   ranks; step 1's all-reduced gradient (layers 0 and 11's attention
   projections, combine_fc, the classifiers) within 1e-2 of each tensor's
   max |g|; both ranks' eval metrics alike, over 16 pages, equal to the one
   process's; kernel #2's flags at rate 0.1 differ between the ranks and
   equal the plain bits of each rank's offset seed; rank 0's saved weights
   are the ones it ended with, bit for bit, and serve the 96 pages to the
   same records; one rank over NCCL (world 1): the one process's losses
   within 1e-6. Any rank that fails or outlives its timeout fails the
   script (all ranks are killed). ms/step for both backends and one
   process: between the logged steps, and steady (5 more steps on one
   batch after each CE run, past DDP's bucket rebuild at its second step).

30. the ``kernels`` line (all six; ``launches`` sums every path's serving
   and training runs: the wrappers' counts, and for the graph runs also
   the profiled replay's launches read from its trace; the phase lines
   give each path's), then the final ``{"ok": true, ...}``.

Every phase also prints its seconds.
"""

import gc
import json
import math
import os
import random
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
KERNEL_TOL = 2e-2
PARITY_TOL = 2e-2
B, NH, L = 32, 12, 512
N_PAGES = 96
SERVE_REPEATS = 3  # runs of the 96 pages; the first one is checked
TRAIN_B, TRAIN_STEPS, DROP = 8, 30, 0.1
# the train phase logs (and so fetches losses to the host) every LOG_EVERY
# steps; ms/step is taken over the steps after the first log
LOG_EVERY = 10
# training kernels vs the fp32 twin: forward max abs err as kernel #1; each
# gradient's max abs err over its own max |reference|: the kernels round
# p/(1-r) (for dv) and the gradients to bf16 (2^-8 relative each; dS goes
# into dq and dk as two bf16 parts) and sum in another order
TRAIN_KERNEL_TOL = 2e-2
GRAD_NAMES = ("dq_t", "dk_t", "dv_t", "dq_l", "dk_l", "dv_l")
KEEP_TOL = 2e-3  # kept share of each stream vs 1 - rate
# one training step, kernels vs plain twins (both bf16 autocast, identical
# dropout): relative error of the total loss, and of each attention
# projection's weight gradient in the first and last layers (and of the
# decoder's combine_fc) on its own; the twins round p and dS to bf16 at
# other points than the kernels, and 12 layers compound it
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 1e-2
# except the last layer's query and key weight gradients of the kernels vs
# the plain twins: that layer's keys are nearly collinear (the phase prints
# their spread), so dq and dk are small differences of large terms, and the
# bf16-level differences between the two paths' forwards (the kernels round
# the un-normalised p, the twins the normalised one) show there amplified.
# Kernel #3 alone is held to TRAIN_GRAD_TOL there too: against the twin's
# backward on kernel #2's forward. The same holds for LayoutLMv3's last
# layer and kernels #5/#6 (keys' spread 0.22 against 1.18 in layer 0; the
# path differs by 1.1 %, kernel #6 alone by 0.6 %).
PATH_QK_TOL = 3e-2
# LayoutLMv3: 224 px image in 16 px patches + the visual cls token
N_VIS = 197
LV = L + N_VIS  # 709
# LayoutLMv2 / LayoutXLM: the 7x7 grid pooled from the ResNeXt-FPN's p2
N_VIS_V2 = 49
LV2 = L + N_VIS_V2  # 561 = 8 key tiles of 64 + a ragged one of 49
BIAS_GRAD_NAMES = ("dq", "dk", "dv", "dbias")
# dense bf16 tensor-core peak (FLOP/s) and memory rate (B/s) of the two
# H100 parts, by the names the driver reports (NVIDIA data sheets, dense
# rates, full power limit)
PEAKS = (("H100 PCIe", ("H100 PCIe",), 756e12, 2.0e12),
         ("H100 SXM", ("H100 SXM", "H100 80GB HBM3"), 989e12, 3.35e12))


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name):
    for part, keys, flops, bw in PEAKS:
        if any(k in name for k in keys):
            return part, flops, bw
    raise RuntimeError(f"no peak table entry for {name!r}")


def time_ms(fn, n=20, warmup=3):
    """Median milliseconds of ``n`` launches, each between CUDA events."""
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
    """Device milliseconds of one call of ``fn``: the summed durations of
    every kernel and memset it launches (torch.profiler's device-side
    rows), over ``n`` calls. Unlike :func:`time_ms` it leaves out the time
    the card waits for the host between launches, which exceeds a kernel of
    under ~0.2 ms (a wrapper's checks, allocations and ctypes call take
    ~0.1 ms of host time)."""
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
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total / n / 1e3


def bound_of(n_bytes, flops, peaks):
    """The least time of a call: its bytes at the memory rate or its bf16
    tensor-core FLOPs at the peak rate, whichever is larger."""
    _, peak_flops, peak_bw = peaks
    t_bytes, t_flops = n_bytes / peak_bw * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": n_bytes, "flops": flops}


def kernel_resources(log, occupancy):
    """Per kernel of ``occupancy`` (name → CTAs per SM, dynamic shared
    memory): its registers, static shared memory, stack frame and spill
    bytes from the ptxas report ``log`` (``-Xptxas=-v``: an "entry
    function" line with the mangled name, then "bytes stack frame, … spill
    stores, … spill loads", then "Used N registers, … bytes smem")."""
    found = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = found.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack_frame=int(m.group(1)),
                         spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            entry.update(registers=int(m.group(1)),
                         static_smem=int(smem.group(1)) if smem else 0)
    out = {}
    for name, occ in occupancy.items():
        # "biacm_train_fwd_kernel<true>" is mangled with ILb1E, <false> ILb0E
        stem, _, arg = name.partition("<")
        tag = {"true>": "ILb1E", "false>": "ILb0E", "": ""}[arg]
        hits = [v for k, v in found.items() if stem in k and tag in k]
        if len(hits) != 1 or "registers" not in hits[0] \
                or "spill_stores" not in hits[0]:
            raise RuntimeError(f"no single ptxas entry for {name}: "
                               f"{sorted(found)}")
        out[name] = {**hits[0], **occ}
    return out


def attention_inputs(batch, length, masked, gen):
    """q/k/v as (B, nh, L, d) views of (B, L, nh, d) bf16 buffers (the LiLT
    layer's layout) and the (B, L) fp32 key mask with ``masked`` keys of
    each listed row set to finfo(f32).min/2."""
    import torch

    def heads(d):
        x = torch.randn((batch, length, NH, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
        return x.transpose(1, 2)

    qkv = [heads(64) for _ in range(3)] + [heads(16) for _ in range(3)]
    bias = torch.zeros((batch, length), device="cuda")
    for row, keys in masked:
        bias[row, keys] = torch.finfo(torch.float32).min / 2
    return qkv, bias


def phase_kernel(ba, peaks):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    st, sl = 1.0 / 8.0, 1.0 / 4.0
    cases = {
        512: [(r, slice(L - 100, L)) for r in range(0, B, 2)],
        128: [(r, slice(128 - 17, 128)) for r in range(1, B, 2)],
        200: [(0, slice(0, 80))] + [(r, slice(200 - 37, 200))
                                     for r in range(1, B, 2)],
    }
    errs, timing = {}, {}
    for length, masked in cases.items():
        (qt, kt, vt, ql, kl, vl), bias = attention_inputs(B, length, masked, gen)
        args = (qt, kt, vt, ql, kl, vl, bias, st, sl)
        ct, cl = ba.biacm_attention_cuda(*args)
        rt, rl = ba.biacm_attention_reference(
            *(x.float() for x in args[:6]), bias, st, sl)
        torch.cuda.synchronize()
        for x in (ct, cl):
            if not torch.isfinite(x).all():
                raise RuntimeError(f"non-finite kernel output at L={length}")
        err = max((ct.float() - rt).abs().max().item(),
                  (cl.float() - rl).abs().max().item())
        errs[length] = err
        if err > KERNEL_TOL:
            raise RuntimeError(f"kernel vs plain twin at L={length}: max abs "
                               f"err {err:.3e} > {KERNEL_TOL}")
        if length != L:
            continue
        q80 = torch.cat([qt * st, ql * sl], -1)
        k80 = torch.cat([kt, kl], -1)
        v80 = torch.cat([vt, vl], -1)
        mask = bias[:, None, None, :].to(torch.bfloat16)
        sdpa = F.scaled_dot_product_attention(q80, k80, v80, attn_mask=mask,
                                              scale=1.0)
        sdpa_err = (sdpa.float() - torch.cat([rt, rl], -1)).abs().max().item()
        def library():
            return F.scaled_dot_product_attention(q80, k80, v80,
                                                  attn_mask=mask, scale=1.0)

        timing = {
            "ms": time_ms(lambda: ba.biacm_attention_cuda(*args)),
            "plain_ms": time_ms(lambda: ba.biacm_attention_reference(*args)),
            "library_ms": time_ms(library),
            "device_ms": device_ms(lambda: ba.biacm_attention_cuda(*args)),
            "library_device_ms": device_ms(library),
            "sdpa_max_abs_err": sdpa_err,
        }
    # least time for one serving-shape call: each input read once, each
    # output written once, vs the bf16 tensor-core FLOPs of the 4 products
    bound = bound_of(B * NH * L * (3 * 64 + 3 * 16) * 2 + B * L * 4
                     + B * NH * L * (64 + 16) * 2,
                     4 * B * NH * L * L * (64 + 16), peaks)
    emit({"phase": "kernel", "max_abs_err": errs, "tol": KERNEL_TOL,
          "shape": [B, NH, L, 64, 16], **timing, **bound})
    return max(errs.values()), timing, bound


def write_model(wdir):
    """LiLT-base + PEneo decoder with seeded random weights → wdir."""
    import torch

    from peneo_tpu_torch.config import LiltConfig, PEneoConfig
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.models.peneo import PEneoModel

    tok = ToyTokenizer(vocab_size=250002)
    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=250002, max_position_embeddings=L + 8,
            pad_token_id=tok.pad_token_id, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        max_seq_len=L)
    model = PEneoModel(cfg).init_weights(torch.Generator().manual_seed(SEED))
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    torch.save(model.state_dict(), os.path.join(wdir, "pytorch_model.bin"))
    return sum(p.numel() for p in model.parameters())


def write_pages(img_dir, ocr_dir, n_pages=N_PAGES):
    """``n_pages`` synthetic form pages (24 key/value pairs each) as PNG +
    OCR JSON, paired by stem. Returns the documents; an OCR line's index in
    its JSON is its line id."""
    from PIL import Image

    from peneo_tpu_torch.data.synthetic import make_document, render_page

    os.makedirs(img_dir)
    os.makedirs(ocr_dir)
    rng = random.Random(SEED)
    docs = []
    for i in range(n_pages):
        doc = make_document(rng, f"page_{i:03d}.png", n_pairs=24, n_noise=8,
                            image_size=(1000, 1600))
        Image.fromarray(render_page(doc)).save(
            os.path.join(img_dir, f"page_{i:03d}.png"))
        ocr = [{"text": ln["text"], "bbox": ln["bbox"]}
               for e in doc["entities"] for ln in e["lines"]]
        with open(os.path.join(ocr_dir, f"page_{i:03d}.json"), "w") as f:
            json.dump(ocr, f)
        docs.append(doc)
    return docs


def phase_serve(ba, tmp):
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    wdir = os.path.join(tmp, "model")
    img_dir, ocr_dir = os.path.join(tmp, "images"), os.path.join(tmp, "ocr")
    t0 = time.perf_counter()
    n_params = write_model(wdir)
    docs = write_pages(img_dir, ocr_dir)
    svc = InferenceService(wdir, batch_size=B, dtype="bfloat16")
    setup_s = time.perf_counter() - t0

    ba.biacm_attention_cuda.launches = 0
    results = svc.run(img_dir, ocr_dir)
    torch.cuda.synchronize()
    launches = ba.biacm_attention_cuda.launches

    n_forwards = math.ceil(N_PAGES / B)
    layers = svc.cfg.backbone().num_hidden_layers
    if launches != layers * n_forwards:
        raise RuntimeError(f"kernel launched {launches} times over "
                           f"{n_forwards} forwards, expected "
                           f"{layers * n_forwards}")
    expected = {f"page_{i:03d}.png" for i in range(N_PAGES)}
    if set(results) != expected:
        raise RuntimeError(f"{len(expected - set(results))} pages returned "
                           "no record")
    for name, rec in results.items():
        if not (isinstance(rec.get("kv_pairs"), list)
                and isinstance(rec.get("lines"), list)):
            raise RuntimeError(f"malformed record for {name}")
    run = svc.last_run
    warm = [run["warm_pages"] / run["warm_seconds"]]
    for _ in range(SERVE_REPEATS - 1):  # spread of the warm rate
        svc.run(img_dir, ocr_dir)
        warm.append(svc.last_run["warm_pages"] / svc.last_run["warm_seconds"])
    tokens = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))[3]
              for i in range(B)]
    emit({"phase": "serve", "params": n_params, "pages": run["pages"],
          "batch_size": B, "L": L, "dtype": "bfloat16",
          "setup_seconds": setup_s, "seconds": run["seconds"],
          "pages_per_s": run["pages"] / run["seconds"],
          "warm_pages_per_s": statistics.median(warm),
          "warm_pages_per_s_runs": warm,
          "kernel_launches": launches, "forwards": n_forwards,
          "launches_per_forward": launches / n_forwards,
          "mean_tokens_per_page": sum(tokens) / len(tokens),
          "kv_pairs": sum(len(r["kv_pairs"]) for r in results.values()),
          "lines": sum(len(r["lines"]) for r in results.values())})
    return svc, img_dir, ocr_dir, docs, launches


def page_paths(img_dir, ocr_dir, i):
    return (os.path.join(img_dir, f"page_{i:03d}.png"),
            os.path.join(ocr_dir, f"page_{i:03d}.json"))


def truth(svc, ocr_path, doc):
    """One page's ground truth at the decoder's token positions (CLS
    stripped), packed as the preprocessor packs the OCR lines: the five
    heads' spots ``(row, col, tag)`` (tag 2 marks a link stored flipped into
    the upper triangle) and the expected records' kv pairs and lines."""
    from peneo_tpu_torch.data.box_utils import sort_boxes
    from peneo_tpu_torch.models.decoder import HEAD_NAMES
    from peneo_tpu_torch.pipeline.preprocess import deploy_text_cleanup, \
        read_ocr_json

    texts, boxes = read_ocr_json(ocr_path)
    texts = [deploy_text_cleanup(t) for t in texts]
    span, cursor = {}, 0
    for idx in sort_boxes(boxes):
        n = len(svc.tokenizer.tokenize(texts[idx]))
        if n:
            span[idx] = (cursor, cursor + n - 1)
            cursor += n
    if cursor > svc.max_token_len:
        raise RuntimeError(f"{ocr_path}: {cursor} tokens do not fit")

    spots = {name: [] for name in HEAD_NAMES}

    def link(name, a, b):
        spots[name].append((a, b, 1) if a <= b else (b, a, 2))

    for head, tail in span.values():
        link("line_extraction", head, tail)
    for rel in doc["relations"]["line_grouping"]:
        a, b = span[rel["from_id"]], span[rel["to_id"]]
        link("line_grouping_h2h", a[0], b[0])
        link("line_grouping_t2t", a[1], b[1])

    def box(ids):
        return [float(min(boxes[i][0] for i in ids)),
                float(min(boxes[i][1] for i in ids)),
                float(max(boxes[i][2] for i in ids)),
                float(max(boxes[i][3] for i in ids))]

    ents = {e["id"]: [ln["id"] for ln in e["lines"]] for e in doc["entities"]}
    kv = []
    for rel in doc["relations"]["kv_entity"]:
        key, val = ents[rel["from_id"]], ents[rel["to_id"]]
        link("ent_linking_h2h", span[key[0]][0], span[val[0]][0])
        link("ent_linking_t2t", span[key[-1]][1], span[val[-1]][1])
        kv.append(("".join(texts[i] for i in key).strip(),
                   "".join(texts[i] for i in val).strip(), box(key), box(val)))
    lines = [(texts[i], box([i])) for i in span]
    return spots, sorted(kv), sorted(lines)


def phase_decode(svc, img_dir, ocr_dir, docs):
    """One batch's ground-truth spots through the on-card compaction and
    packing, the fetch and the host chain walk: the records must be exactly
    the documents' kv pairs and lines."""
    import torch

    from peneo_tpu_torch.models.decoder import HEAD_NAMES, compact_spots, \
        pack_spots
    from peneo_tpu_torch.pipeline import decode as dec

    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    truths = [truth(svc, page_paths(img_dir, ocr_dir, i)[1], docs[i])
              for i in range(B)]
    ld = svc.cfg.max_seq_len - 1  # decoder positions: CLS stripped
    out = {}
    for name in HEAD_NAMES:
        idx = torch.tensor([(b, r, c, tag) for b, (spots, _, _) in
                            enumerate(truths) for r, c, tag in spots[name]],
                           dtype=torch.int64, device=svc.device).T
        tags = torch.zeros((B, ld, ld), dtype=torch.int32, device=svc.device)
        tags[idx[0], idx[1], idx[2]] = idx[3].to(torch.int32)
        out[name] = compact_spots(tags, (tags != 0).float(),
                                  svc.cfg.max_spots_per_head)
    fetched = svc._fetch(pack_spots(out))
    t0 = time.perf_counter()
    records = [dec.decode_page_record(texts, fetched, i, seq_len, 0.0,
                                      score_thresh=svc.score_thresh,
                                      bbox=orig_bbox)
               for i, (_, texts, orig_bbox, seq_len) in enumerate(pages)]
    decode_ms = (time.perf_counter() - t0) / B * 1e3
    for i, (rec, (_, kv, lines)) in enumerate(zip(records, truths)):
        got_kv = sorted((p["key"], p["value"], p["key_box"], p["value_box"])
                        for p in rec["kv_pairs"])
        got_lines = sorted((ln["text"], ln["box"]) for ln in rec["lines"])
        if not kv or got_kv != kv or got_lines != lines:
            raise RuntimeError(
                f"page {i}: decoded {len(got_kv)} kv pairs and "
                f"{len(got_lines)} lines from its ground-truth spots, "
                f"expected {len(kv)} and {len(lines)} (or contents differ)")
    emit({"phase": "decode", "pages": B,
          "kv_pairs": sum(len(r["kv_pairs"]) for r in records),
          "lines": sum(len(r["lines"]) for r in records),
          "spots": {name: sum(len(t[0][name]) for t in truths)
                    for name in HEAD_NAMES},
          "decode_ms_per_page": decode_ms})


def device_rows(prof, wall_ms, profile_dir, stem):
    """The profiler's device-side rows (kernels, copies) as ``(name, ms,
    count)``, largest first, and their total ms; raises if the total
    exceeds the profiled wall time. The aten ops that launch kernels carry
    the same device time again, and user annotations (e.g. the optimizer
    step's) span kernels counted already, so both are left out. With a
    ``profile_dir``, also writes the kernel table and a chrome trace there
    as ``<stem>_kernels.txt`` and ``<stem>_trace.json``."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms > wall_ms:
        raise RuntimeError(f"device time {device_ms:.3f} ms exceeds the "
                           f"profiled wall time {wall_ms:.3f} ms: the "
                           "profiler rows are counted more than once")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, f"{stem}_kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              f"{stem}_trace.json"))
    return rows, device_ms


def phase_breakdown(svc, img_dir, ocr_dir, profile_dir, tag=""):
    """Where one batch's time goes: host preprocess per page, the forward's
    enqueue and wall time (host clock to the fetched outputs), and the
    device time by kernel from torch.profiler. ``tag`` "v3" / "v2": the
    LayoutLMv3 / LayoutXLM service (kernel #4; also times the
    relative-bias build on its own, and for LayoutXLM the visual tower, in
    NCHW and in channels_last, and the decoder (pair head) alone)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    prep_ms = (time.perf_counter() - t0) / B * 1e3
    svc._fetch(svc.dispatch_batch(pages))  # warm
    enqueue, wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_dev = svc.dispatch_batch(pages)
        t1 = time.perf_counter()
        svc._fetch(out_dev)
        wall.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc._fetch(svc.dispatch_batch(pages))
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    stem = f"serve_{tag}_forward" if tag else "serve_forward"
    rows, device_ms_total = device_rows(prof, prof_wall_ms, profile_dir, stem)
    attn_ms = sum(r[1] for r in rows
                  if ("bias_fwd_kernel" if tag else "biacm") in r[0])
    extra = {}
    if tag:
        backbone = svc.model.backbone
        bbox = torch.from_numpy(np.stack([p[0]["bbox"] for p in pages])).cuda()
        n_vis = N_VIS_V2 if tag == "v2" else N_VIS
        boxes = rel_boxes(backbone, bbox)
        with torch.inference_mode():
            extra["rel_bias_build_ms"] = time_ms(
                lambda: backbone.rel_bias(boxes, L, n_vis))
            extra["rel_bias_build_device_ms"] = device_ms(
                lambda: backbone.rel_bias(boxes, L, n_vis))
        if tag == "v2":
            extra.update(v2_breakdown(svc, pages))
    emit({"phase": f"breakdown_{tag}" if tag else "breakdown",
          "batch_size": B, "L": L, **extra,
          "preprocess_ms_per_page": prep_ms,
          "forward_enqueue_ms": statistics.median(enqueue),
          "forward_wall_ms": statistics.median(wall),
          "profiled_forward_wall_ms": prof_wall_ms,
          "device_busy_ms": device_ms_total,
          "bias_attention_ms" if tag else "biacm_attention_ms": attn_ms,
          "device_idle_share": 1 - device_ms_total / prof_wall_ms,
          "top_kernels": [[k[:90], round(ms, 3), n] for k, ms, n in rows[:12]]})


def v2_breakdown(svc, pages):
    """LayoutXLM's serving forward in parts, device time each: the visual
    tower with its pooling (NCHW, the model's layout, and the same weights
    and image in channels_last) and the decoder (shrink MLP, combine and
    pair head) on the backbone's text rows."""
    import numpy as np
    import torch

    backbone = svc.model.backbone
    image = batch_images(svc, pages)
    ids, bbox, attn = (torch.from_numpy(np.stack([p[0][k] for p in pages]))
                       .cuda() for k in ("input_ids", "bbox",
                                         "attention_mask"))
    out = {}
    with torch.inference_mode():
        out["tower_device_ms"] = device_ms(
            lambda: backbone.visual_features(image), n=5)
        hidden = backbone(ids, bbox, attn, image=image)[
            "last_hidden_state"][:, 1:L]
        out["pair_head_device_ms"] = device_ms(
            lambda: svc.model.peneo_decoder(hidden), n=5)
        tower = backbone.visual.backbone
        tower.to(memory_format=torch.channels_last)
        try:
            nhwc = image.contiguous(memory_format=torch.channels_last)
            out["tower_channels_last_device_ms"] = device_ms(
                lambda: backbone.visual_features(nhwc), n=5)
            same = (backbone.visual_features(nhwc).float()
                    - backbone.visual_features(image).float()).abs().max()
            out["tower_channels_last_max_abs_diff"] = same.item()
        finally:
            tower.to(memory_format=torch.contiguous_format)
    return out


def rel_boxes(backbone, bbox):
    """Text boxes (B, L, 4) followed by the visual tokens' boxes, as the
    LayoutLMv3 / LayoutLMv2 forward concatenates them."""
    import torch

    from peneo_tpu_torch.models.layoutlmv2 import LayoutLMv2Model, \
        visual_grid_bbox
    from peneo_tpu_torch.models.layoutlmv3 import visual_bbox

    vis = (visual_grid_bbox(*backbone.grid)
           if isinstance(backbone, LayoutLMv2Model)
           else visual_bbox(backbone.grid))
    vis = torch.from_numpy(vis).to(bbox.device)
    return torch.cat([bbox.long(),
                      vis[None].expand(bbox.shape[0], -1, -1)], dim=1)


def phase_parity(svc, img_dir, ocr_dir, tag=""):
    import numpy as np
    import torch

    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    ids, bbox, attn = (torch.from_numpy(np.stack([p[0][k] for p in pages]))
                       .cuda() for k in ("input_ids", "bbox", "attention_mask"))
    kw = {}
    if tag:  # the raw uint8 pages, normalized on the card as the service does
        kw["image"] = batch_images(svc, pages)
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            svc.model.set_attention_impl(impl)
            hidden = svc.model.backbone(ids, bbox, attn,
                                        **kw)["last_hidden_state"]
            logits = svc.model(ids, bbox, attn, return_logits=True, **kw)[
                "line_extraction"]["logits"]
            out[impl] = (hidden.float(), logits.float())
        svc.model.set_attention_impl("kernel")
    rel = {}
    for i, name in enumerate(("last_hidden_state", "line_extraction_logits")):
        a, b = out["kernel"][i], out["plain"][i]
        if not torch.isfinite(a).all():
            raise RuntimeError(f"non-finite {name} on the kernel path")
        rel[name] = ((a - b).norm() / b.norm()).item()
        if rel[name] > PARITY_TOL:
            raise RuntimeError(f"path parity {name}: rel err {rel[name]:.3e} "
                               f"> {PARITY_TOL}")
    emit({"phase": f"parity_{tag}" if tag else "parity", "rel_err": rel,
          "tol": PARITY_TOL, "shape": list(ids.shape),
          "hidden_shape": list(out["kernel"][0].shape)})


def phase_kernel_train(ba, peaks):
    """Kernels #2 and #3 against the fp32 twin on the same bf16 inputs and
    output gradients; the dropout masks; timings at the training shape."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    st, sl, bt = 1.0 / 8.0, 1.0 / 4.0, TRAIN_B
    cases = {
        512: [(r, slice(L - 100, L)) for r in range(0, bt, 2)],
        128: [(r, slice(128 - 17, 128)) for r in range(1, bt, 2)],
        200: [(0, slice(0, 80))] + [(r, slice(200 - 37, 200))
                                     for r in range(1, bt, 2)],
    }

    def collinear(x):
        """Rows of each (b, h) close to one shared row (spread 0.1), as
        the keys of LiLT-base's last layers are: dq and dk are then small
        differences of large terms. Halved, so that values stay O(1), as
        the absolute forward gate assumes."""
        y = (0.5 * (x[:, :, :1].float() + 0.1 * x.float())).to(torch.bfloat16)
        return y.transpose(1, 2).contiguous().transpose(1, 2)

    def out_grads(length):
        return tuple(torch.randn((bt, length, NH, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     .transpose(1, 2) for d in (64, 16))

    fwd_err, grad_abs, grad_rel, packed_checked = {}, {}, {}, []
    for length, masked, name in [(n, m, f"L{n}") for n, m in cases.items()] \
            + [(L, cases[L], f"L{L}_collinear")]:
        qkv, bias = attention_inputs(bt, length, masked, gen)
        if name.endswith("collinear"):
            qkv = [collinear(x) for x in qkv]
        dctx = out_grads(length)
        for rate in (0.0, DROP):
            seed = SEED + length
            bits = ba.attention_dropout_bits(seed, bt, NH, length, "cuda")
            leaves = [x.float().requires_grad_() for x in qkv]
            want = ba.biacm_attention_train_reference(*leaves, bias, bits, st,
                                                      sl, rate)
            want_g = torch.autograd.grad(want, leaves, dctx)
            got_all = {}
            for mode, rng in (("philox", seed), ("bits", bits)):
                ins = [x.detach().requires_grad_() for x in qkv]
                got = ba.biacm_attention_train(*ins, bias, rng, st, sl, rate)
                got_g = torch.autograd.grad(got, ins, dctx)
                torch.cuda.synchronize()
                key = f"{name}_rate{rate}_{mode}"
                for x in got + got_g:
                    if not torch.isfinite(x).all():
                        raise RuntimeError(f"non-finite kernel output, {key}")
                fwd_err[key] = max((g.float() - w).abs().max().item()
                                   for g, w in zip(got, want))
                errs = [(g.float() - w).abs().max().item()
                        for g, w in zip(got_g, want_g)]
                scales = [w.abs().max().item() for w in want_g]
                if min(scales) == 0.0:
                    raise RuntimeError(f"{key}: a reference gradient is all "
                                       "zero; its relative error is undefined")
                grad_abs[key] = max(errs)
                grad_rel[key] = {n: e / m for n, e, m in
                                 zip(GRAD_NAMES, errs, scales)}
                if fwd_err[key] > TRAIN_KERNEL_TOL \
                        or max(grad_rel[key].values()) > TRAIN_KERNEL_TOL:
                    raise RuntimeError(
                        f"training kernels vs plain twin, {key}: forward "
                        f"max abs err {fwd_err[key]:.3e}, gradients' max abs "
                        f"err over their max |reference| {grad_rel[key]} > "
                        f"{TRAIN_KERNEL_TOL}")
                got_all[mode] = got + got_g
            if not all(torch.equal(a, b) for a, b in
                       zip(got_all["philox"], got_all["bits"])):
                raise RuntimeError(
                    f"{name}, rate {rate}: the in-kernel generator's "
                    "results differ from those of attention_dropout_bits")
            if rate > 0.0:
                # kernel #2's packed keep flags against the plain packing
                # of the same bits; kernel #3 fed either
                plain_keep = ba.pack_keep_mask(
                    torch.stack(bits) < ba.keep_threshold(rate))
                for mode, rng in (("philox", seed), ("bits", bits)):
                    *_, stats, keep = ba.biacm_attention_train_fwd_cuda(
                        *qkv, bias, rng, st, sl, rate)
                    if not torch.equal(keep, plain_keep):
                        raise RuntimeError(
                            f"{name}, {mode}: kernel #2's packed keep flags "
                            f"differ from pack_keep_mask in "
                            f"{(keep != plain_keep).sum().item()} words")
                bwd = [ba.biacm_attention_train_bwd_cuda(
                    *qkv, bias, k, stats, *dctx, st, sl, rate)
                    for k in (keep, plain_keep)]
                if not all(torch.equal(a, b) for a, b in zip(*bwd)):
                    raise RuntimeError(
                        f"{name}: kernel #3 fed the forward's keep flags "
                        "and fed pack_keep_mask's differ")
                packed_checked.append(name)
                del plain_keep, keep, stats, bwd
            del bits, leaves, want, want_g, got_all

    # the masks at the training shape
    b1, b2 = ba.attention_dropout_bits(SEED, bt, NH, L, "cuda")
    thr = ba.keep_threshold(DROP)
    k1, k2 = b1 < thr, b2 < thr
    kept = [k1.float().mean().item(), k2.float().mean().item()]
    differ = (k1 != k2).float().mean().item()
    del b1, b2, k1, k2
    if any(abs(k - (1.0 - DROP)) > KEEP_TOL for k in kept):
        raise RuntimeError(f"kept shares {kept} are not within {KEEP_TOL} "
                           f"of {1.0 - DROP}")

    # timings at the training shape, with the main path's in-kernel bits
    qkv, bias = attention_inputs(bt, L, cases[L], gen)
    dctx = out_grads(L)
    args = (*qkv, bias, SEED, st, sl, DROP)
    stats, keep = ba.biacm_attention_train_fwd_cuda(*args)[2:]
    timing = {
        "fwd_ms": time_ms(lambda: ba.biacm_attention_train_fwd_cuda(*args)),
        "bwd_ms": time_ms(lambda: ba.biacm_attention_train_bwd_cuda(
            *qkv, bias, keep, stats, *dctx, st, sl, DROP)),
        "fwd_rate0_ms": time_ms(lambda: ba.biacm_attention_train_fwd_cuda(
            *qkv, bias, SEED, st, sl, 0.0)),
        "bwd_rate0_ms": time_ms(lambda: ba.biacm_attention_train_bwd_cuda(
            *qkv, bias, None, stats, *dctx, st, sl, 0.0)),
        "fwd_device_ms": device_ms(
            lambda: ba.biacm_attention_train_fwd_cuda(*args)),
        "bwd_device_ms": device_ms(
            lambda: ba.biacm_attention_train_bwd_cuda(
                *qkv, bias, keep, stats, *dctx, st, sl, DROP)),
        "fwd_rate0_device_ms": device_ms(
            lambda: ba.biacm_attention_train_fwd_cuda(
                *qkv, bias, SEED, st, sl, 0.0)),
        "bwd_rate0_device_ms": device_ms(
            lambda: ba.biacm_attention_train_bwd_cuda(
                *qkv, bias, None, stats, *dctx, st, sl, 0.0)),
    }
    bits = ba.attention_dropout_bits(SEED, bt, NH, L, "cuda")
    timing["plain_fwd_ms"] = time_ms(
        lambda: ba.biacm_attention_train_reference(*qkv, bias, bits, st, sl,
                                                   DROP))
    leaves = [x.detach().requires_grad_() for x in qkv]
    out = ba.biacm_attention_train_reference(*leaves, bias, bits, st, sl,
                                             DROP)
    timing["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        out, leaves, dctx, retain_graph=True))
    timing["plain_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        ba.biacm_attention_train_reference(*leaves, bias, bits, st, sl, DROP),
        leaves, dctx))
    del out, leaves, bits
    q80 = torch.cat([qkv[0] * st, qkv[3] * sl], -1).detach().requires_grad_()
    k80 = torch.cat([qkv[1], qkv[4]], -1).detach().requires_grad_()
    v80 = torch.cat([qkv[2], qkv[5]], -1).detach().requires_grad_()
    mask = bias[:, None, None, :].to(torch.bfloat16)
    d80 = torch.cat(dctx, -1)

    def sdpa(rate=0.0):
        return F.scaled_dot_product_attention(q80, k80, v80, attn_mask=mask,
                                              dropout_p=rate, scale=1.0)

    # the library call at rate 0 and at the kernels' rate (one mask over
    # head dim 80, its own generator: a yardstick only)
    for rate, tag in ((0.0, ""), (DROP, "_dropout")):
        with torch.no_grad():
            timing[f"library_fwd{tag}_ms"] = time_ms(lambda: sdpa(rate))
            timing[f"library_fwd{tag}_device_ms"] = device_ms(
                lambda: sdpa(rate))
        o80 = sdpa(rate)

        def library_bwd():
            return torch.autograd.grad(o80, (q80, k80, v80), d80,
                                       retain_graph=True)

        timing[f"library_bwd{tag}_ms"] = time_ms(library_bwd)
        timing[f"library_bwd{tag}_device_ms"] = device_ms(library_bwd)
        del o80
    timing["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa(), (q80, k80, v80), d80))

    io = bt * NH * L * (3 * 64 + 3 * 16) * 2     # q/k/v of both streams
    ctx_bytes = bt * NH * L * (64 + 16) * 2
    stats_bytes = bt * NH * L * 2 * 4
    keep_bytes = keep.numel() * 4                # both streams, bit-packed
    bounds = {
        # reads q/k/v, bias; writes ctx, the statistics, the keep flags
        "fwd": bound_of(io + bt * L * 4 + ctx_bytes + stats_bytes
                        + keep_bytes, 4 * bt * NH * L * L * 80, peaks),
        # reads q/k/v, bias, dctx, stats, the keep flags; writes the six
        # gradients
        "bwd": bound_of(io + bt * L * 4 + ctx_bytes + stats_bytes
                        + keep_bytes + io,
                        5 * 2 * bt * NH * L * L * 80, peaks),
    }
    emit({"phase": "kernel_train", "fwd_max_abs_err": fwd_err,
          "grad_max_abs_err": grad_abs, "grad_rel_err": grad_rel,
          "tol": TRAIN_KERNEL_TOL, "kept_share": kept,
          "streams_differ_share": differ, "rate": DROP,
          "packed_keep_flags_equal": packed_checked,
          "keep_flags_bytes": keep_bytes,
          "shape": [bt, NH, L, 64, 16], **timing, "bounds": bounds})
    errors = {"fwd_max_abs_err": max(fwd_err.values()),
              "grad_max_abs_err": max(grad_abs.values()),
              "grad_max_rel_err": max(max(r.values())
                                      for r in grad_rel.values())}
    return errors, timing, bounds


def phase_train(ba, tmp):
    """LiLT-base fine-tuning through the port's CLI, in process."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.infer import InferenceService

    out = os.path.join(tmp, "train")
    argv = ["--synthetic_data", "--synthetic_model", "base",
            "--synthetic_vocab", "250002", "--output_dir", out, "--do_train",
            "--max_steps", str(TRAIN_STEPS), "--max_seq_len", str(L),
            "--per_device_train_batch_size", str(TRAIN_B),
            "--per_device_eval_batch_size", str(TRAIN_B),
            "--logging_steps", str(LOG_EVERY),
            "--eval_steps", str(TRAIN_STEPS),
            "--save_steps", str(TRAIN_STEPS), "--seed", str(SEED)]
    torch.cuda.reset_peak_memory_stats()
    ba.biacm_attention_cuda.launches = 0
    ba.biacm_attention_train_fwd_cuda.launches = 0
    ba.biacm_attention_train_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    run_rfund.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"biacm_attention": ba.biacm_attention_cuda.launches,
                "fwd": ba.biacm_attention_train_fwd_cuda.launches,
                "bwd": ba.biacm_attention_train_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss/total" in r]
    evals = [r for r in records if "eval/f1" in r]
    losses = [r["loss/total"] for r in steps]
    logged = list(range(LOG_EVERY, TRAIN_STEPS + 1, LOG_EVERY))
    # the trainer counts non-finite losses of every step on the card
    if [r["step"] for r in steps] != logged \
            or not all(map(math.isfinite, losses)) \
            or steps[-1]["nonfinite_loss_steps"] != 0:
        raise RuntimeError(f"logged steps {[r['step'] for r in steps]} (want "
                           f"{logged}), losses {losses}, non-finite steps "
                           f"{[r['nonfinite_loss_steps'] for r in steps]}")
    layers = 12
    if launches["fwd"] != layers * TRAIN_STEPS \
            or launches["bwd"] != layers * TRAIN_STEPS:
        raise RuntimeError(f"training kernels launched {launches} over "
                           f"{TRAIN_STEPS} steps, expected "
                           f"{layers} forward and {layers} backward per step")
    n_dev = 16
    eval_forwards = math.ceil(n_dev / TRAIN_B)
    if launches["biacm_attention"] != layers * eval_forwards:
        raise RuntimeError(f"kernel #1 launched {launches['biacm_attention']}"
                           f" times over {eval_forwards} eval forwards")
    if len(evals) != 1 or evals[0]["eval/num_sample_processed"] != n_dev:
        raise RuntimeError(f"eval records {evals}: expected one over "
                           f"{n_dev} dev pages")
    # steps LOG_EVERY+1 .. TRAIN_STEPS, between the first and the last log
    # (each log fetches the losses, so both ends follow a sync)
    ms_step = ((steps[-1]["time"] - steps[0]["time"])
               / (TRAIN_STEPS - LOG_EVERY) * 1e3)
    intervals = [(b["time"] - a["time"]) / LOG_EVERY * 1e3
                 for a, b in zip(steps, steps[1:])]

    # the saved directory serves a page through kernel #1
    img_dir, ocr_dir = os.path.join(tmp, "one_img"), os.path.join(tmp, "one_ocr")
    write_pages(img_dir, ocr_dir, n_pages=1)
    svc = InferenceService(out, batch_size=1, dtype="bfloat16")
    ba.biacm_attention_cuda.launches = 0
    served = svc.run(img_dir, ocr_dir)
    torch.cuda.synchronize()
    if ba.biacm_attention_cuda.launches != layers or len(served) != 1:
        raise RuntimeError(f"the trained model served {len(served)} pages "
                           f"with {ba.biacm_attention_cuda.launches} "
                           "launches of kernel #1")
    record = {"phase": "train", "steps": TRAIN_STEPS, "batch_size": TRAIN_B,
          "L": L, "dropout": DROP, "launches": launches,
          "ms_per_step": ms_step, "samples_per_s": TRAIN_B / (ms_step / 1e3),
          "ms_per_step_window": [LOG_EVERY + 1, TRAIN_STEPS],
          "ms_per_step_intervals": intervals,
          "max_memory_allocated": peak, "logged_steps": logged,
          "first_logged_loss": losses[0], "last_loss": losses[-1],
          "losses": losses,
          "nonfinite_loss_steps": steps[-1]["nonfinite_loss_steps"],
          "grad_norms": [r["loss/grad_norm"] for r in steps],
          "eval": {k[len("eval/"):]: v for k, v in evals[0].items()
                   if k.startswith("eval/")},
          "wall_seconds": wall, "served_pages": len(served), "argv": argv}
    emit(record)
    return launches, out, record


def train_batch(out):
    """The saved model of the train phase and one collated training batch
    on the card."""
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.loader import batch_to_device

    args = run_rfund.build_argparser().parse_args(
        ["--synthetic_data", "--model_name_or_path", out, "--output_dir", out,
         "--max_seq_len", str(L)])
    _, model, train_ds, _, collator, _ = run_rfund.setup(args)
    batch = collator([train_ds[i] for i in range(TRAIN_B)])
    return model.cuda(), batch_to_device(batch, "cuda")


def twin_backward(ba):
    """A stand-in for kernel #3's launcher: the plain twin's autograd
    gradients at the same inputs and the forward's keep flags, so that a
    run keeps kernel #2's forward and takes the twin's backward."""
    import torch

    def bwd(q_t, k_t, v_t, q_l, k_l, v_l, bias, keep, stats, dct, dcl,
            scale_t, scale_l, rate=0.0):
        bits = None
        if rate > 0.0:  # kernel #2's packed keep flags, as the twin's bits
            bits = ba.keep_mask_bits(keep, q_t.shape[2])
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_()
                      for x in (q_t, k_t, v_t, q_l, k_l, v_l)]
            out = ba.biacm_attention_train_reference(
                *leaves, bias, bits, scale_t, scale_l, rate)
            return torch.autograd.grad(out, leaves, (dct, dcl))
    return bwd


def key_spread(keys, attention_mask):
    """Median over (b, h) of the rms distance of a head's keys from their
    mean over the valid tokens, relative to that mean's norm: small when a
    layer's keys are nearly collinear, where dq and dk are small
    differences of large terms."""
    import torch

    B, length, _ = keys.shape
    k = keys.float().view(B, length, NH, -1)
    m = attention_mask.float()
    if m.shape[1] < length:  # the visual tokens after the text are all valid
        m = torch.cat([m, m.new_ones((B, length - m.shape[1]))], dim=1)
    m = m[:, :, None, None]
    mean = (k * m).sum(1, keepdim=True) / m.sum(1, keepdim=True)
    rms = (((k - mean) ** 2).sum(-1, keepdim=True) * m).sum(1) \
        / m.sum(1)
    return torch.median(rms.sqrt().squeeze(-1)
                        / mean.norm(dim=-1).squeeze(1)).item()


def bias_twin_backward(rb):
    """The same stand-in for kernel #6's launcher (dq, dk, dv, dbias), from
    kernel #5's packed keep flags."""
    import torch

    def bwd(q, k, v, bias, mask, keep, stats, dctx, scale, rate=0.0):
        bits = None
        if rate > 0.0:
            bits = rb.keep_flag_bits(keep, q.shape[2])
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
            out = rb.bias_attention_train_reference(*leaves, mask, bits,
                                                    scale, rate)
            return torch.autograd.grad(out, leaves, dctx)
    return bwd


TABLES = ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias")


def phase_train_parity(ops, model, batch, tag=""):
    """One training step's loss and gradients from the same weights and
    seeds: through the kernels, through the plain twins, and through the
    forward kernel with the twin's backward. The last pair differs only in
    the backward kernel's arithmetic; the first also in the forwards'
    rounding. ``ops`` is the family's kernel module: BiACM (kernels #2/#3),
    or with ``tag`` "v3" / "v2" rel-bias (kernels #5/#6), where the three
    bucket tables' gradients are compared too. LayoutXLM's q, k and v are
    the row blocks of one ``qkv_linear`` weight, each compared on its own;
    its stem conv's gradient error is reported (the whole tower lies
    between it and the loss)."""
    import torch

    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    last = model.cfg.backbone().num_hidden_layers - 1
    hidden = model.cfg.backbone().hidden_size
    prefix = "backbone.encoder.layer.{}.attention.self."
    # name → (parameter, rows of its gradient)
    weights = {}
    for i in (0, last):
        if tag == "v2":
            for j, n in enumerate(("query", "key", "value")):
                weights[f"layer{i}.{n}"] = (
                    prefix.format(i) + "qkv_linear.weight",
                    slice(j * hidden, (j + 1) * hidden))
            continue
        for n in ("query", "key", "value") + (
                () if tag else ("layout_query", "layout_key",
                                "layout_value")):
            weights[f"layer{i}.{n}"] = (prefix.format(i) + n + ".weight",
                                        slice(None))
    weights["combine_fc"] = (
        "peneo_decoder.handshaking_kernel.combine_fc.weight", slice(None))
    if tag:
        weights.update({n: (f"backbone.encoder.{n}.weight", slice(None))
                        for n in TABLES})
    reported = {}
    if tag == "v2":
        reported["stem_conv"] = (
            "backbone.visual.backbone.bottom_up.stem.conv1.weight",
            slice(None))
    bwd_name = ("bias_attention_train_bwd_cuda" if tag
                else "biacm_attention_train_bwd_cuda")
    layers = model.backbone.encoder.layer
    keys = {}

    def keep_keys(i):
        if tag == "v2":  # the key block of the fused projection
            return layers[i].attention.self.qkv_linear.register_forward_hook(
                lambda mod, inp, out: keys.__setitem__(
                    i, out[..., hidden:2 * hidden].detach()))
        return layers[i].attention.self.key.register_forward_hook(
            lambda mod, inp, out: keys.__setitem__(i, out.detach()))

    hooks = [keep_keys(i) for i in (0, last)]
    kernel_bwd = getattr(ops, bwd_name)
    res = {}
    try:
        for run in ("kernel", "plain", "twin_backward"):
            model.load_state_dict(state0)
            model.set_attention_impl("plain" if run == "plain" else "kernel")
            if run == "twin_backward":
                setattr(ops, bwd_name, bias_twin_backward(ops) if tag
                        else twin_backward(ops))
            model.train()
            model.zero_grad(set_to_none=True)
            torch.manual_seed(SEED)
            gen = torch.Generator().manual_seed(SEED)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                losses = model(batch["input_ids"], batch["bbox"],
                               batch["attention_mask"],
                               labels=batch["labels"], generator=gen,
                               image=batch.get("image"))
            losses["total"].backward()
            params = dict(model.named_parameters())
            res[run] = (losses["total"].item(),
                        {k: params[n].grad[rows].clone()
                         for k, (n, rows) in {**weights,
                                              **reported}.items()})
            if run == "kernel":
                spread = {f"layer{i}": key_spread(k, batch["attention_mask"])
                          for i, k in keys.items()}
    finally:
        setattr(ops, bwd_name, kernel_bwd)
        for hook in hooks:
            hook.remove()
        model.set_attention_impl("kernel")
        model.load_state_dict(state0)

    def rel_errs(other, names):
        (la, ga), (lb, gb) = res["kernel"], res[other]
        rel = {"loss_total": abs(la - lb) / abs(lb)}
        for k in names:
            rel[k] = ((ga[k] - gb[k]).norm() / gb[k].norm()).item()
        return rel

    path, backward = rel_errs("plain", weights), rel_errs("twin_backward",
                                                          weights)
    tol = {k: TRAIN_GRAD_TOL for k in weights}
    tol.update({f"layer{last}.{n}": PATH_QK_TOL for n in ("query", "key")})
    extra = {}
    if reported:
        extra["reported_rel_err"] = {
            "path": rel_errs("plain", reported),
            "backward_only": rel_errs("twin_backward", reported)}
    emit({"phase": f"train_parity_{tag}" if tag else "train_parity",
          "loss": {run: res[run][0] for run in res},
          "rel_err": path, "rel_err_backward_only": backward, **extra,
          "key_spread": spread,
          "tol": {"loss": TRAIN_LOSS_TOL, "backward_only": TRAIN_GRAD_TOL,
                  "path": tol}})
    if not math.isfinite(res["kernel"][0]) \
            or path["loss_total"] > TRAIN_LOSS_TOL \
            or any(backward[k] > TRAIN_GRAD_TOL for k in weights) \
            or any(path[k] > tol[k] for k in weights):
        raise RuntimeError(f"training parity: kernels vs plain {path}, "
                           f"the backward kernel vs the twin's backward "
                           f"{backward}")


def phase_train_breakdown(model, batch, profile_dir, tag=""):
    """Where one training step's device time goes (torch.profiler,
    device-side events only). ``tag`` "v3" / "v2": the rel-bias families
    (kernels #5/#6); also times the relative-bias build and the bucket
    tables' gradient (the backward of ``RelBias``) on their own, and for
    LayoutXLM the visual tower's forward and backward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peneo_tpu_torch.pipeline import train as T

    optimizer, scheduler = T.make_optimizer(model, 5e-5, 1000,
                                            downstream_speedup_ratio=30.0)
    gen = torch.Generator().manual_seed(SEED)

    def step():
        return T.train_step(model, optimizer, scheduler, batch, 1.0, gen,
                            torch.bfloat16)

    for _ in range(2):  # warm: the optimizer state, allocator, autotune
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, device_ms_total = device_rows(
        prof, wall_ms, profile_dir, f"train_{tag}_step" if tag
        else "train_step")
    stem = "bias_train_" if tag else "biacm_train_"
    mask_stem = "bias_keep_mask" if tag else "biacm_keep_mask"
    fwd_ms = sum(r[1] for r in rows if stem + "fwd" in r[0]
                 or mask_stem in r[0])
    bwd_ms = sum(r[1] for r in rows if stem + "dkdv" in r[0]
                 or stem + "dq" in r[0])
    extra = {}
    if tag:
        bb = model.backbone
        n_vis = N_VIS_V2 if tag == "v2" else N_VIS
        bbox = rel_boxes(bb, batch["bbox"])
        tables = [getattr(bb.encoder, n).weight for n in TABLES]
        rel = bb.rel_bias(bbox, L, n_vis)
        upstream = torch.randn(rel.shape, device="cuda")
        extra = {
            "rel_bias_build_ms": time_ms(
                lambda: bb.rel_bias(bbox, L, n_vis)),
            "table_grad_ms": time_ms(lambda: torch.autograd.grad(
                rel, tables, upstream, retain_graph=True))}
        del rel, upstream
    if tag == "v2":
        # the tower's forward and backward under the step's autocast, the
        # pooled features' gradient a random one
        image = batch["image"]
        tower = [p for p in bb.visual.parameters() if p.requires_grad]

        def tower_fwd():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return bb.visual_features(image)

        upstream = torch.randn_like(tower_fwd())

        def tower_step():
            return torch.autograd.grad(tower_fwd(), tower, upstream)

        with torch.no_grad():
            extra["tower_fwd_device_ms"] = device_ms(tower_fwd, n=5)
        extra["tower_fwd_bwd_device_ms"] = device_ms(tower_step, n=5)
        del upstream
    emit({"phase": f"train_breakdown_{tag}" if tag else "train_breakdown",
          "batch_size": TRAIN_B, "L": L, **extra,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": device_ms_total,
          "train_fwd_kernel_ms": fwd_ms, "train_bwd_kernels_ms": bwd_ms,
          "train_kernels_share": (fwd_ms + bwd_ms) / device_ms_total,
          "device_idle_share": 1 - device_ms_total / wall_ms,
          "top_kernels": [[k[:90], round(ms, 3), n] for k, ms, n in rows[:15]]})


# ------------------------------------------------------------------------
# LayoutLMv3: rel-bias attention (kernels #4-#6)
# ------------------------------------------------------------------------

def bias_inputs(batch, length, masked, gen, collinear=False):
    """q/k/v as (B, nh, L, 64) views of (B, L, nh, 64) bf16 buffers (the
    LayoutLMv3 layer's layout), a random fp32 (B, nh, L, L) bias (contiguous,
    rows of L floats) and the (B, L) fp32 key mask with ``masked`` keys of
    each listed row set to finfo(f32).min/2. ``collinear``: every row close
    to the first token's (spread 0.1, halved to keep values O(1)), where dq
    and dk are small differences of large terms."""
    import torch

    def heads():
        x = torch.randn((batch, length, NH, 64), generator=gen, device="cuda")
        if collinear:
            x = 0.5 * (x[:, :1] + 0.1 * x)
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads() for _ in range(3)]
    bias = torch.randn((batch, NH, length, length), generator=gen,
                       device="cuda")
    mask = torch.zeros((batch, length), device="cuda")
    for row, keys in masked:
        mask[row, keys] = torch.finfo(torch.float32).min / 2
    return qkv, bias, mask


def relbias_layout(bias):
    """The same values as the model's ``RelBias`` lays them out: a (B, nh,
    L, L) view of an (nh, B, L, L4) buffer, L4 = L rounded up to a multiple
    of 4 (16-byte rows); the padding columns hold NaN, which no kernel may
    read into a result."""
    import torch

    B, nh, n, _ = bias.shape
    buf = torch.full((nh, B, n, -(-n // 4) * 4), float("nan"),
                     device=bias.device)
    out = buf.permute(1, 0, 2, 3)[..., :n]
    out.copy_(bias)
    return out


# the bias row strides the rel-bias kernels are held at: rows of L floats
# (4-byte requests at L = 709) and the model's padded rows (16-byte)
BIAS_STRIDES = (("natural", lambda x: x), ("padded", relbias_layout))


def bias_cases(batch):
    """L' = 709 (LayoutLMv3) with the last 100 text keys of half the rows
    masked (the visual keys after them stay live), 128, a ragged 200, and
    561 (LayoutLMv2) with the first 80 keys of row 0 and the last 100 text
    keys of the odd rows masked."""
    return {
        LV: [(r, slice(L - 100, L)) for r in range(0, batch, 2)],
        128: [(r, slice(128 - 17, 128)) for r in range(1, batch, 2)],
        200: [(0, slice(0, 80))] + [(r, slice(200 - 37, 200))
                                     for r in range(1, batch, 2)],
        LV2: [(0, slice(0, 80))] + [(r, slice(L - 100, L))
                                     for r in range(1, batch, 2)],
    }


def sdpa_backends(fn):
    """Milliseconds of ``fn`` (an SDPA call) under each backend alone, or
    None where that backend refuses the call."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend):
                fn()
                torch.cuda.synchronize()
                out[name] = time_ms(fn, n=5, warmup=1)
        except RuntimeError as err:
            if "No available kernel" not in str(err):
                raise
            out[name] = None  # the backend refused the call
    return out


def padded_rows(x):
    """A copy of ``x`` whose rows start 16 bytes apart at a multiple: the
    last dim allocated up to a multiple of 8 elements, then cut back."""
    import torch

    n = x.shape[-1]
    buf = torch.zeros((*x.shape[:-1], -(-n // 8) * 8), dtype=x.dtype,
                      device=x.device)
    buf[..., :n] = x
    return buf[..., :n]


def bias_bound(batch, length, peaks):
    """Least time for one kernel #4 call: q/k/v, the bias and the mask read
    once, the output written once, vs the FLOPs of the 2 products."""
    return bound_of(4 * batch * NH * length * 64 * 2
                    + batch * NH * length * length * 4 + batch * length * 4,
                    4 * batch * NH * length * length * 64, peaks)


def phase_kernel_bias(rb, peaks):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    scale = 1.0 / 8.0
    errs, timing, timing_v2 = {}, {}, {}
    for length, masked in bias_cases(B).items():
        (q, k, v), natural, mask = bias_inputs(B, length, masked, gen)
        want = rb.bias_attention_reference(q.float(), k.float(), v.float(),
                                           natural, mask, scale)
        for label, layout in BIAS_STRIDES:
            bias = layout(natural)
            got = rb.bias_attention_cuda(q, k, v, bias, mask, scale)
            torch.cuda.synchronize()
            key = f"L{length}_{label}"
            if not torch.isfinite(got).all():
                raise RuntimeError(f"non-finite kernel #4 output, {key}")
            errs[key] = (got.float() - want).abs().max().item()
            if errs[key] > KERNEL_TOL:
                raise RuntimeError(f"kernel #4 vs plain twin, {key}: max abs "
                                   f"err {errs[key]:.3e} > {KERNEL_TOL}")
        if length not in (LV, LV2):
            continue
        # the kernel at the main path's (padded) stride and at the natural
        # one; the library call: one additive bf16 mask, at its natural row
        # stride (not 16-byte aligned at 709 or 561) and at a padded one
        full = (natural + mask[:, None, None, :]).to(torch.bfloat16)
        padded = padded_rows(full)

        def kernel(b=bias):
            return rb.bias_attention_cuda(q, k, v, b, mask, scale)

        def sdpa(m):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m)

        t = {"device_ms": device_ms(kernel),
             "natural_stride_device_ms": device_ms(lambda: kernel(natural)),
             "library_device_ms": device_ms(lambda: sdpa(full)),
             "library_padded_stride_device_ms": device_ms(
                 lambda: sdpa(padded))}
        if length == LV2:  # LayoutLMv2's shape: device times and the bound
            timing_v2 = {**t, **bias_bound(B, LV2, peaks)}
        else:
            timing = {
                **t, "ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: rb.bias_attention_reference(
                    q, k, v, natural, mask, scale)),
                "library_ms": time_ms(lambda: sdpa(full)),
                "library_padded_stride_ms": time_ms(lambda: sdpa(padded)),
                "library_backends": {
                    "natural_stride": sdpa_backends(lambda: sdpa(full)),
                    "padded_stride": sdpa_backends(lambda: sdpa(padded))},
                "sdpa_max_abs_err": (sdpa(full).float() - want).abs().max()
                .item()}
        del full, padded, bias
    bound = bias_bound(B, LV, peaks)
    emit({"phase": "kernel_bias", "max_abs_err": errs, "tol": KERNEL_TOL,
          "shape": [B, NH, LV, 64], **timing, **bound,
          f"L{LV2}": {"shape": [B, NH, LV2, 64], **timing_v2}})
    return max(errs.values()), timing, bound, timing_v2


def phase_kernel_bias_train(rb, ba, peaks):
    """Kernels #5 and #6 against the fp32 twin on the same bf16 inputs and
    output gradient, at both bias strides; the dropout mask and its packed
    keep flags; timings at the training shape."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    scale, bt = 1.0 / 8.0, TRAIN_B
    cases = bias_cases(bt)

    def out_grad(length):
        return torch.randn((bt, length, NH, 64), generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    def rel_errs(got_g, want_g, key):
        errs = [(g.float() - w).abs().max().item()
                for g, w in zip(got_g, want_g)]
        scales = [w.abs().max().item() for w in want_g]
        if min(scales) == 0.0:
            raise RuntimeError(f"{key}: a reference gradient is all zero; "
                               "its relative error is undefined")
        return max(errs), {n: e / m for n, e, m in
                           zip(BIAS_GRAD_NAMES, errs, scales)}

    fwd_err, grad_abs, grad_rel, packed_checked = {}, {}, {}, []
    for length, masked, name in [(n, m, f"L{n}") for n, m in cases.items()] \
            + [(LV, cases[LV], f"L{LV}_collinear")]:
        qkv, natural, mask = bias_inputs(bt, length, masked, gen,
                                         collinear=name.endswith("collinear"))
        dctx = out_grad(length)
        for rate in (0.0, DROP):
            seed = SEED + length
            bits = ba.element_dropout_bits(seed, bt, NH, length, "cuda")
            leaves = [x.float().requires_grad_() for x in qkv] \
                + [natural.clone().requires_grad_()]
            want = rb.bias_attention_train_reference(*leaves, mask, bits,
                                                     scale, rate)
            want_g = torch.autograd.grad(want, leaves, dctx.float())
            for label, layout in BIAS_STRIDES:
                got_all = {}
                for mode, rng in (("philox", seed), ("bits", bits)):
                    ins = [x.detach().requires_grad_() for x in qkv] \
                        + [layout(natural).requires_grad_()]
                    got = rb.bias_attention_train(*ins, mask, rng, scale,
                                                  rate)
                    got_g = torch.autograd.grad(got, ins, dctx)
                    torch.cuda.synchronize()
                    key = f"{name}_rate{rate}_{mode}_{label}"
                    for x in (got, *got_g):
                        if not torch.isfinite(x).all():
                            raise RuntimeError(
                                f"non-finite kernel output, {key}")
                    fwd_err[key] = (got.float() - want).abs().max().item()
                    grad_abs[key], grad_rel[key] = rel_errs(got_g, want_g,
                                                            key)
                    if fwd_err[key] > TRAIN_KERNEL_TOL \
                            or max(grad_rel[key].values()) > TRAIN_KERNEL_TOL:
                        raise RuntimeError(
                            f"rel-bias training kernels vs plain twin, {key}: "
                            f"forward max abs err {fwd_err[key]:.3e}, "
                            f"gradients' max abs err over their max "
                            f"|reference| {grad_rel[key]} > "
                            f"{TRAIN_KERNEL_TOL}")
                    got_all[mode] = (got, *got_g)
                if not all(torch.equal(a, b) for a, b in
                           zip(got_all["philox"], got_all["bits"])):
                    raise RuntimeError(
                        f"{name}, rate {rate}, {label}: the in-kernel "
                        "generator's results differ from those of "
                        "element_dropout_bits")
                del got_all
            if rate > 0.0:
                # kernel #5's packed keep flags against the plain packing of
                # the same bits; kernel #6 fed either
                bias = relbias_layout(natural)
                plain_keep = ba.pack_keep_mask(bits < ba.keep_threshold(rate))
                for mode, rng in (("philox", seed), ("bits", bits)):
                    _, stats, keep = rb.bias_attention_train_fwd_cuda(
                        *qkv, bias, mask, rng, scale, rate)
                    if not torch.equal(keep, plain_keep):
                        raise RuntimeError(
                            f"{name}, {mode}: kernel #5's packed keep flags "
                            f"differ from pack_keep_mask in "
                            f"{(keep != plain_keep).sum().item()} words")
                bwd = [rb.bias_attention_train_bwd_cuda(
                    *qkv, bias, mask, k, stats, dctx, scale, rate)
                    for k in (keep, plain_keep)]
                if not all(torch.equal(a, b) for a, b in zip(*bwd)):
                    raise RuntimeError(
                        f"{name}: kernel #6 fed the forward's keep flags "
                        "and fed pack_keep_mask's differ")
                packed_checked.append(name)
                del plain_keep, keep, stats, bwd, bias
            del bits, leaves, want, want_g

    # the mask at the training shape
    keep = ba.element_dropout_bits(SEED, bt, NH, LV, "cuda") \
        < ba.keep_threshold(DROP)
    kept = keep.float().mean().item()
    del keep
    if abs(kept - (1.0 - DROP)) > KEEP_TOL:
        raise RuntimeError(f"kept share {kept} is not within {KEEP_TOL} of "
                           f"{1.0 - DROP}")

    timing, bounds = bias_train_timing(rb, ba, gen, LV, cases[LV], peaks,
                                       full=True)
    timing_v2, bounds_v2 = bias_train_timing(rb, ba, gen, LV2, cases[LV2],
                                             peaks, full=False)
    emit({"phase": "kernel_bias_train", "fwd_max_abs_err": fwd_err,
          "grad_max_abs_err": grad_abs, "grad_rel_err": grad_rel,
          "tol": TRAIN_KERNEL_TOL, "kept_share": kept, "rate": DROP,
          "packed_keep_flags_equal": packed_checked,
          "shape": [bt, NH, LV, 64], **timing, "bounds": bounds,
          f"L{LV2}": {"shape": [bt, NH, LV2, 64], **timing_v2,
                      "bounds": bounds_v2}})
    errors = {"fwd_max_abs_err": max(fwd_err.values()),
              "grad_max_abs_err": max(grad_abs.values()),
              "grad_max_rel_err": max(max(r.values())
                                      for r in grad_rel.values())}
    return errors, timing, bounds, (timing_v2, bounds_v2)


def bias_train_timing(rb, ba, gen, length, masked, peaks, full):
    """Kernels #5 and #6 at the training shape (B=8, L' = ``length``), with
    the main path's in-kernel bits and bias layout: device times (and at
    the natural stride), the library call's (no dropout, its mask trained
    as the bias is) at both strides, and the bounds. ``full`` adds the
    event times, the plain twin's and each SDPA backend's."""
    import torch
    import torch.nn.functional as F

    scale, bt = 1.0 / 8.0, TRAIN_B
    (q, k, v), natural, mask = bias_inputs(bt, length, masked, gen)
    bias = relbias_layout(natural)
    dctx = torch.randn((bt, length, NH, 64), generator=gen, device="cuda") \
        .to(torch.bfloat16).transpose(1, 2)
    _, stats, keep = rb.bias_attention_train_fwd_cuda(q, k, v, bias, mask,
                                                      SEED, scale, DROP)

    def fwd(rate=DROP, b=bias):
        return rb.bias_attention_train_fwd_cuda(q, k, v, b, mask, SEED,
                                                scale, rate)

    def bwd(rate=DROP, b=bias):
        return rb.bias_attention_train_bwd_cuda(
            q, k, v, b, mask, keep if rate > 0.0 else None, stats, dctx,
            scale, rate)

    timing = {
        "fwd_device_ms": device_ms(fwd), "bwd_device_ms": device_ms(bwd),
        "fwd_rate0_device_ms": device_ms(lambda: fwd(0.0)),
        "bwd_rate0_device_ms": device_ms(lambda: bwd(0.0)),
        "fwd_natural_stride_device_ms": device_ms(lambda: fwd(b=natural)),
        "bwd_natural_stride_device_ms": device_ms(lambda: bwd(b=natural)),
    }
    if full:
        timing.update(fwd_ms=time_ms(fwd), bwd_ms=time_ms(bwd),
                      fwd_rate0_ms=time_ms(lambda: fwd(0.0)))
        bits = ba.element_dropout_bits(SEED, bt, NH, length, "cuda")
        timing["plain_fwd_ms"] = time_ms(
            lambda: rb.bias_attention_train_reference(q, k, v, natural, mask,
                                                      bits, scale, DROP))
        leaves = [x.detach().requires_grad_() for x in (q, k, v, natural)]
        out = rb.bias_attention_train_reference(*leaves, mask, bits, scale,
                                                DROP)
        timing["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            out, leaves, dctx, retain_graph=True))
        del out, leaves, bits
    # the library call (no dropout), its mask trained as the bias is
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    full_mask = (natural + mask[:, None, None, :]).to(torch.bfloat16)
    backends = {}
    for label, m in (("natural_stride", full_mask),
                     ("padded_stride", padded_rows(full_mask))):
        m = m.detach().requires_grad_()

        def sdpa(m=m):
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m)

        def fwd_bwd(m=m):
            return torch.autograd.grad(sdpa(), (ql, kl, vl, m), dctx)

        tag = "" if label == "natural_stride" else "_padded_stride"
        with torch.no_grad():
            if full:
                timing[f"library{tag}_fwd_ms"] = time_ms(sdpa)
            timing[f"library{tag}_fwd_device_ms"] = device_ms(sdpa)
        o = sdpa()

        def library_bwd(o=o, m=m):
            return torch.autograd.grad(o, (ql, kl, vl, m), dctx,
                                       retain_graph=True)

        if full:
            timing[f"library{tag}_bwd_ms"] = time_ms(library_bwd)
            backends[label] = sdpa_backends(fwd_bwd)
        timing[f"library{tag}_bwd_device_ms"] = device_ms(library_bwd)
        del o
    if full:
        timing["library_backends_fwd_bwd"] = backends
    del full_mask

    qkv_bytes = bt * NH * length * 64 * 2        # one of q, k, v, ctx, dctx…
    bias_bytes = bt * NH * length * length * 4
    small = bt * length * 4 + bt * NH * length * 2 * 4  # mask, statistics
    keep_bytes = keep.numel() * 4                # the packed keep flags
    timing["keep_flags_bytes"] = keep_bytes
    bounds = {
        # reads q/k/v, bias, mask; writes ctx, the statistics, the flags
        "fwd": bound_of(4 * qkv_bytes + bias_bytes + small + keep_bytes,
                        4 * bt * NH * length * length * 64, peaks),
        # reads q/k/v, dctx, bias, mask, statistics, the flags; writes
        # dq/dk/dv, dbias
        "bwd": bound_of(7 * qkv_bytes + 2 * bias_bytes + small + keep_bytes,
                        5 * 2 * bt * NH * length * length * 64, peaks),
    }
    return timing, bounds


def write_model_rel(wdir, v2=False):
    """A rel-bias model + PEneo decoder with seeded random weights → wdir:
    the ``layoutlmv3-base-chinese`` geometry (LayoutLMv3Config defaults),
    or with ``v2`` the ``layoutxlm-base`` one (LayoutLMv2Config defaults:
    fast_qkv, ResNeXt-101 32x8d at 224 px), at vocab 250002 and
    pad_token_id 1; dropout 0.1 and the decoder's ×30 learning rate for the
    train phase (serving runs in eval mode)."""
    import torch

    from peneo_tpu_torch.config import (LayoutLMv2Config, LayoutLMv3Config,
                                        PEneoConfig)
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.models.peneo import PEneoModel

    tok = ToyTokenizer(vocab_size=250002)
    name, config = (("layoutxlm-base", LayoutLMv2Config) if v2
                    else ("layoutlmv3-base-chinese", LayoutLMv3Config))
    cfg = PEneoConfig(
        backbone_name=name,
        backbone_config=config(
            vocab_size=250002, max_position_embeddings=L + 8,
            pad_token_id=1, hidden_dropout_prob=DROP,
            attention_probs_dropout_prob=DROP).to_dict(),
        max_seq_len=L, peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0)
    model = PEneoModel(cfg).init_weights(
        torch.Generator().manual_seed(SEED + (4 if v2 else 1)))
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    torch.save(model.state_dict(), os.path.join(wdir, "pytorch_model.bin"))
    return sum(p.numel() for p in model.parameters())


def batch_images(svc, pages):
    """The pages' raw uint8 images on the card, normalized as the service
    normalizes them."""
    import numpy as np
    import torch

    from peneo_tpu_torch.data.image_processing import device_image_normalize

    return device_image_normalize(torch.from_numpy(
        np.stack([p[0]["image"] for p in pages])).cuda(), svc.info.family)


def phase_serve_rel(rb, ba, tmp, img_dir, ocr_dir, v2=False):
    """The 96 pages of the serve phase through the LayoutLMv3 service, or
    with ``v2`` the LayoutXLM one."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    wdir = os.path.join(tmp, "model_v2" if v2 else "model_v3")
    t0 = time.perf_counter()
    n_params = write_model_rel(wdir, v2)
    svc = InferenceService(wdir, batch_size=B, dtype="bfloat16")
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    rb.bias_attention_cuda.launches = 0
    ba.biacm_attention_cuda.launches = 0
    results = svc.run(img_dir, ocr_dir)
    torch.cuda.synchronize()
    launches = rb.bias_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    n_forwards = math.ceil(N_PAGES / B)
    layers = svc.cfg.backbone().num_hidden_layers
    if launches != layers * n_forwards or ba.biacm_attention_cuda.launches:
        raise RuntimeError(
            f"kernel #4 launched {launches} times over {n_forwards} "
            f"forwards (expected {layers * n_forwards}), kernel #1 "
            f"{ba.biacm_attention_cuda.launches} times (expected 0)")
    expected = {f"page_{i:03d}.png" for i in range(N_PAGES)}
    if set(results) != expected:
        raise RuntimeError(f"{len(expected - set(results))} pages returned "
                           "no record")
    for name, rec in results.items():
        if not (isinstance(rec.get("kv_pairs"), list)
                and isinstance(rec.get("lines"), list)):
            raise RuntimeError(f"malformed record for {name}")
    run = svc.last_run
    warm = [run["warm_pages"] / run["warm_seconds"]]
    for _ in range(SERVE_REPEATS - 1):  # spread of the warm rate
        svc.run(img_dir, ocr_dir)
        warm.append(svc.last_run["warm_pages"] / svc.last_run["warm_seconds"])
    t0 = time.perf_counter()
    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    prep_ms = (time.perf_counter() - t0) / B * 1e3
    image = pages[0][0]["image"]
    extra = {}
    if v2:  # the random tower's p2 map over one batch: finite, of order 1
        backbone = svc.model.backbone
        with torch.inference_mode():
            x = batch_images(svc, pages)
            stats = torch.tensor([svc.cfg.backbone().pixel_mean,
                                  svc.cfg.backbone().pixel_std],
                                 device="cuda")[:, :, None, None]
            p2 = backbone.visual.backbone(
                ((x - stats[0]) / stats[1]).to(backbone.dtype)).float()
        extra = {"p2_shape": list(p2.shape),
                 "p2_max_abs": p2.abs().max().item(),
                 "p2_rms": p2.pow(2).mean().sqrt().item()}
        if not torch.isfinite(p2).all():
            raise RuntimeError("non-finite p2 map in the visual tower")
        del p2, x
    emit({"phase": "serve_v2" if v2 else "serve_v3", "params": n_params,
          "pages": run["pages"], "batch_size": B, "L": L,
          "attention_length": LV2 if v2 else LV,
          "dtype": "bfloat16", "setup_seconds": setup_s,
          "seconds": run["seconds"],
          "pages_per_s": run["pages"] / run["seconds"],
          "warm_pages_per_s": statistics.median(warm),
          "warm_pages_per_s_runs": warm,
          "preprocess_ms_per_page": prep_ms,
          "image": [str(image.dtype), *image.shape],
          "max_memory_allocated": peak, **extra,
          "kernel_launches": launches, "forwards": n_forwards,
          "launches_per_forward": launches / n_forwards,
          "mean_tokens_per_page": sum(p[3] for p in pages) / len(pages),
          "kv_pairs": sum(len(r["kv_pairs"]) for r in results.values()),
          "lines": sum(len(r["lines"]) for r in results.values())})
    return svc, wdir, launches


def phase_train_rel(rb, ba, tmp, wdir, v2=False):
    """LayoutLMv3 (or with ``v2`` LayoutXLM) fine-tuning through the port's
    CLI, in process, from the saved full-width model on the synthetic corpus
    with rendered pages."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.infer import InferenceService

    tag = "v2" if v2 else "v3"
    out = os.path.join(tmp, f"train_{tag}")
    argv = ["--synthetic_data", "--model_name_or_path", wdir,
            "--output_dir", out, "--do_train",
            "--max_steps", str(TRAIN_STEPS), "--max_seq_len", str(L),
            "--per_device_train_batch_size", str(TRAIN_B),
            "--per_device_eval_batch_size", str(TRAIN_B),
            "--logging_steps", str(LOG_EVERY),
            "--eval_steps", str(TRAIN_STEPS),
            "--save_steps", str(TRAIN_STEPS), "--seed", str(SEED)]
    counters = {"bias_attention": rb.bias_attention_cuda,
                "fwd": rb.bias_attention_train_fwd_cuda,
                "bwd": rb.bias_attention_train_bwd_cuda,
                "biacm_attention": ba.biacm_attention_cuda,
                "biacm_fwd": ba.biacm_attention_train_fwd_cuda}
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run_rfund.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss/total" in r]
    evals = [r for r in records if "eval/f1" in r]
    losses = [r["loss/total"] for r in steps]
    logged = list(range(LOG_EVERY, TRAIN_STEPS + 1, LOG_EVERY))
    if [r["step"] for r in steps] != logged \
            or not all(map(math.isfinite, losses)) \
            or steps[-1]["nonfinite_loss_steps"] != 0:
        raise RuntimeError(f"logged steps {[r['step'] for r in steps]} (want "
                           f"{logged}), losses {losses}, non-finite steps "
                           f"{[r['nonfinite_loss_steps'] for r in steps]}")
    layers, n_dev = 12, 16
    eval_forwards = math.ceil(n_dev / TRAIN_B)
    want = {"fwd": layers * TRAIN_STEPS, "bwd": layers * TRAIN_STEPS,
            "bias_attention": layers * eval_forwards, "biacm_attention": 0,
            "biacm_fwd": 0}
    if launches != want:
        raise RuntimeError(f"kernels launched {launches} over {TRAIN_STEPS} "
                           f"steps and {eval_forwards} eval forwards, "
                           f"expected {want}")
    if len(evals) != 1 or evals[0]["eval/num_sample_processed"] != n_dev:
        raise RuntimeError(f"eval records {evals}: expected one over "
                           f"{n_dev} dev pages")
    ms_step = ((steps[-1]["time"] - steps[0]["time"])
               / (TRAIN_STEPS - LOG_EVERY) * 1e3)
    intervals = [(b["time"] - a["time"]) / LOG_EVERY * 1e3
                 for a, b in zip(steps, steps[1:])]

    # the saved directory serves a page through kernel #4
    img_dir = os.path.join(tmp, f"one_img_{tag}")
    ocr_dir = os.path.join(tmp, f"one_ocr_{tag}")
    write_pages(img_dir, ocr_dir, n_pages=1)
    svc = InferenceService(out, batch_size=1, dtype="bfloat16")
    rb.bias_attention_cuda.launches = 0
    served = svc.run(img_dir, ocr_dir)
    torch.cuda.synchronize()
    if rb.bias_attention_cuda.launches != layers or len(served) != 1:
        raise RuntimeError(f"the trained model served {len(served)} pages "
                           f"with {rb.bias_attention_cuda.launches} "
                           "launches of kernel #4")
    record = {"phase": f"train_{tag}", "steps": TRAIN_STEPS,
          "batch_size": TRAIN_B, "L": L,
          "attention_length": LV2 if v2 else LV, "dropout": DROP,
          "launches": launches, "ms_per_step": ms_step,
          "samples_per_s": TRAIN_B / (ms_step / 1e3),
          "ms_per_step_window": [LOG_EVERY + 1, TRAIN_STEPS],
          "ms_per_step_intervals": intervals,
          "max_memory_allocated": peak, "logged_steps": logged,
          "first_logged_loss": losses[0], "last_loss": losses[-1],
          "losses": losses,
          "nonfinite_loss_steps": steps[-1]["nonfinite_loss_steps"],
          "grad_norms": [r["loss/grad_norm"] for r in steps],
          "eval": {k[len("eval/"):]: v for k, v in evals[0].items()
                   if k.startswith("eval/")},
          "wall_seconds": wall, "served_pages": len(served), "argv": argv}
    emit(record)
    return launches, out, record


def run_rel_path(rb, ba, tmp, img_dir, ocr_dir, profile_dir, tag):
    """A rel-bias family's main path at full width and depth (``tag`` "v3":
    LayoutLMv3, "v2": LayoutXLM): serve, parity, breakdown, then train,
    train_parity and train_breakdown. Returns its launch counts, the train
    phase's line and its output directory."""
    import torch

    v2 = tag == "v2"
    svc, wdir, serve_launches = timed(
        f"serve_{tag}", phase_serve_rel, rb, ba, tmp, img_dir, ocr_dir, v2)
    timed(f"parity_{tag}", phase_parity, svc, img_dir, ocr_dir, tag)
    timed(f"breakdown_{tag}", phase_breakdown, svc, img_dir, ocr_dir,
          profile_dir, tag)
    del svc
    torch.cuda.empty_cache()
    train_launches, train_out, train_record = timed(
        f"train_{tag}", phase_train_rel, rb, ba, tmp, wdir, v2)
    model, batch = train_batch(train_out)
    timed(f"train_parity_{tag}", phase_train_parity, rb, model, batch, tag)
    timed(f"train_breakdown_{tag}", phase_train_breakdown, model, batch,
          profile_dir, tag)
    del model, batch
    torch.cuda.empty_cache()
    return {"serve": serve_launches, "train": train_launches,
            "train_record": train_record, "train_out": train_out,
            "wdir": wdir}


# ------------------------------------------------------------------------
# checkpoints, int8 and the single-device serving surface of
# deploy/inference.py; every phase resets all kernel counts just before it
# and returns what they read just after
# ------------------------------------------------------------------------
# int8 logits against the bf16 service's on one batch (the gates of
# tests/test_int8_pair_head.py:63-66 and :173-175): max error over the
# largest |bf16 logit|, and the argmax agreement, over the upper triangle of
# the pages' real tokens
INT8_PAIR_GATE = (0.05, 0.98)
INT8_BACKBONE_GATE = (0.15, 0.95)
# dense int8 tensor-core rate (ops/s) of the two parts (NVIDIA data sheets)
INT8_PEAKS = {"H100 PCIe": 1513e12, "H100 SXM": 1979e12}
API_PAGES = 8  # run_page's pages
LONG_REPEATS = 4  # serve_v3_procs: the 96 pages under this many names


def kernel_counters(ba, rb):
    from peneo_tpu_torch.ops import quant

    return {"biacm_attention": ba.biacm_attention_cuda,
            "fwd": ba.biacm_attention_train_fwd_cuda,
            "bwd": ba.biacm_attention_train_bwd_cuda,
            "bias_attention": rb.bias_attention_cuda,
            "bias_fwd": rb.bias_attention_train_fwd_cuda,
            "bias_bwd": rb.bias_attention_train_bwd_cuda,
            "int8": quant.int8_matmul_cuda}


def reset_counts(ba, rb):
    for fn in kernel_counters(ba, rb).values():
        fn.launches = 0


def read_counts(ba, rb):
    import torch

    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in kernel_counters(ba, rb).items()}


def expect_counts(counts, want, what):
    """Raise unless ``counts`` is ``want`` (absent keys: 0)."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise RuntimeError(f"{what}: launches {counts}, expected {full}")


def records_of(results):
    return {k: (v["kv_pairs"], v["lines"]) for k, v in results.items()}


def as_record(kv_pairs, lines):
    """``run_page`` / ``run_batch``'s (kv_pairs, lines) as ``run``'s record
    lists."""
    return ([{"key": k, "value": v, "key_box": [float(x) for x in kb],
              "value_box": [float(x) for x in vb]}
             for k, v, kb, vb in kv_pairs],
            [{"text": t, "box": [float(x) for x in b]} for t, b in lines])


def write_safetensors(tensors, path):
    """fp32 tensors as a ``.safetensors`` file: the 8-byte little-endian
    length of a JSON header (dtype, shape, data offsets per tensor), the
    header, then the data."""
    import numpy as np
    import torch

    header, arrays, offset = {}, [], 0
    for name, t in tensors.items():
        a = t.detach().to("cpu", torch.float32).contiguous().numpy()
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for a in arrays:
            f.write(a.reshape(-1).view(np.uint8).data)


def phase_checkpoints(ba, rb, tmp, img_dir, ocr_dir):
    """The LiLT-base serving model written three ways without JAX —
    ``params.msgpack`` (``write_flax_msgpack`` of the JAX param tree),
    ``model.safetensors`` and the serve phase's ``pytorch_model.bin`` —
    each loads the same weights bit for bit and serves the 96 pages to the
    same records. Then ``generate_peneo_weights`` on an HF-style backbone
    directory of the same model and 4 ``run_rfund`` steps from its output:
    the backbone before step 1 is the model's bit for bit, the losses are
    finite, kernels #2/#3 run 12 times a step."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.config import PEneoConfig
    from peneo_tpu_torch.generate_peneo_weights import main as generate
    from peneo_tpu_torch.models.convert import state_dict_to_jax_params
    from peneo_tpu_torch.models.peneo import PEneoModel
    from peneo_tpu_torch.pipeline.infer import InferenceService, load_weights
    from peneo_tpu_torch.pipeline.weights_io import write_flax_msgpack

    src = os.path.join(tmp, "model")
    cfg = PEneoConfig.from_pretrained(src)
    sd = torch.load(os.path.join(src, "pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    dirs, seconds = {"pytorch_model.bin": src}, {}
    for name, write in (
            ("params.msgpack", lambda p: write_flax_msgpack(
                state_dict_to_jax_params(sd, cfg), p)),
            ("model.safetensors", lambda p: write_safetensors(sd, p))):
        d = os.path.join(tmp, "ckpt_" + name.split(".")[1])
        os.makedirs(d)
        for f in ("config.json", "toy_tokenizer.json"):
            shutil.copy(os.path.join(src, f), d)
        t0 = time.perf_counter()
        write(os.path.join(d, name))
        seconds[f"write {name}"] = time.perf_counter() - t0
        dirs[name] = d
    sizes = {n: os.path.getsize(os.path.join(d, n)) for n, d in dirs.items()}
    for name, d in dirs.items():
        model = PEneoModel(cfg)
        t0 = time.perf_counter()
        load_weights(model, d)
        seconds[f"load {name}"] = time.perf_counter() - t0
        got = model.state_dict()
        bad = [k for k in sd if not torch.equal(got[k], sd[k])]
        if bad:
            raise RuntimeError(f"{name}: {len(bad)} tensors differ from the "
                               f"model's, e.g. {bad[:3]}")
        del model, got

    records = {}
    reset_counts(ba, rb)
    for name, d in dirs.items():
        svc = InferenceService(d, batch_size=B, dtype="bfloat16")
        records[name] = records_of(svc.run(img_dir, ocr_dir))
        del svc
    counts = read_counts(ba, rb)
    n_forwards = math.ceil(N_PAGES / B)
    expect_counts(counts, {"biacm_attention": 12 * n_forwards * len(dirs)},
                  "serving the three files")
    ref = records["pytorch_model.bin"]
    if len(ref) != N_PAGES or any(r != ref for r in records.values()):
        raise RuntimeError("the three checkpoint files served different "
                           "records: " + str({n: sum(
                               a != ref.get(k) for k, a in r.items())
                               for n, r in records.items()}))

    # the weight generator on an HF-style backbone directory of the model
    hf = os.path.join(tmp, "hf", "lilt-infoxlm-base")
    os.makedirs(hf)
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump(cfg.backbone_config, f)
    shutil.copy(os.path.join(src, "toy_tokenizer.json"), hf)
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    write_safetensors({"lilt." + k: v for k, v in backbone.items()},
                      os.path.join(hf, "model.safetensors"))
    gen = os.path.join(tmp, "generated")
    t0 = time.perf_counter()
    generate(["--backbone_name_or_path", hf, "--output_dir", gen])
    seconds["generate_peneo_weights"] = time.perf_counter() - t0

    out = os.path.join(tmp, "train_generated")
    steps = 4
    argv = ["--synthetic_data", "--model_name_or_path", gen,
            "--output_dir", out, "--max_steps", str(steps),
            "--max_seq_len", str(L),
            "--per_device_train_batch_size", str(TRAIN_B),
            "--logging_steps", "1", "--eval_steps", "1000",
            "--save_steps", "1000", "--seed", str(SEED)]
    model = run_rfund.setup(run_rfund.build_argparser().parse_args(argv))[1]
    got = model.state_dict()
    bad = [k for k, v in backbone.items()
           if not torch.equal(got["backbone." + k], v)]
    kept = [k for k in got if not k.startswith("backbone.")]
    if bad or not kept:
        raise RuntimeError(f"fine-tuning's start: {len(bad)} backbone "
                           f"tensors differ from the model's, e.g. {bad[:3]}")
    del model, got
    reset_counts(ba, rb)
    run_rfund.main(argv + ["--do_train"])
    train_counts = read_counts(ba, rb)
    expect_counts(train_counts, {"fwd": 12 * steps, "bwd": 12 * steps},
                  f"{steps} steps from the generated directory")
    with open(os.path.join(out, "log.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["loss/total"] for r in logged if "loss/total" in r]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"losses {losses} over {steps} steps")
    emit({"phase": "checkpoints", "files": list(dirs), "bytes": sizes,
          "seconds": seconds,
          "read_gb_per_s": {n: sizes[n] / seconds[f"load {n}"] / 1e9
                            for n in dirs},
          "pages": N_PAGES, "records_equal": True,
          "backbone_tensors": len(backbone),
          "decoder_tensors_at_init": len(kept), "losses": losses,
          "launches": {"serve": counts, "train": train_counts}})
    return {k: counts[k] + train_counts[k] for k in counts}


def triu_valid(attn):
    """(B, Ld, Ld) bool: the decoder positions' upper triangle over the
    pages' real tokens (CLS stripped)."""
    import torch

    valid = attn[:, 1:].bool()
    ld = valid.shape[1]
    triu = torch.ones((ld, ld), dtype=torch.bool, device=attn.device).triu()
    return triu[None] & valid[:, :, None] & valid[:, None, :]


def int8_logit_gate(ref, got, mask, gate, what):
    """Per head: max |int8 − bf16| over max |bf16| and the argmax agreement
    on ``mask``; raise outside ``gate``."""
    from peneo_tpu_torch.models.decoder import HEAD_NAMES

    out = {}
    for name in HEAD_NAMES:
        a = ref[name]["logits"][mask].float()
        b = got[name]["logits"][mask].float()
        err = ((a - b).abs().max() / a.abs().max()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        out[name] = {"err_over_span": err, "argmax_agreement": agree}
        if not (err < gate[0] and agree > gate[1]):
            raise RuntimeError(f"{what} {name}: err/span {err:.4f} (< "
                               f"{gate[0]}), argmax agreement {agree:.4f} "
                               f"(> {gate[1]})")
    return out


def batch_tensors(svc, pages):
    import numpy as np
    import torch

    ids, bbox, attn = (torch.from_numpy(np.stack([p[0][k] for p in pages]))
                       .cuda() for k in ("input_ids", "bbox",
                                         "attention_mask"))
    kw = {"image": batch_images(svc, pages)} if "image" in pages[0][0] \
        else {}
    return ids, bbox, attn, kw


def phase_serve_int8(ba, rb, tmp, img_dir, ocr_dir, peaks, profile_dir):
    """int8 on the LiLT-base serving path. The library GEMM
    (``torch._int_mm``) against its integer twin, bit for bit, at the pair
    head's first row block (B·128·512 rows, 384→384) and LiLT's
    intermediate layer (B·L rows, 768→3072), with its time beside a bf16
    product of the same shapes; then the 96 pages through three services —
    bf16, ``int8_pair_head``, ``int8_pair_head + int8_backbone`` — each
    with its warm and whole-run pages/s, peak memory, one profiled
    forward's device busy ms, the int8 launches of a run against the number
    the module structure gives, and one batch's logits against the bf16
    service's within the int8 gates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peneo_tpu_torch.ops import quant
    from peneo_tpu_torch.pipeline.infer import InferenceService

    int8_peak = INT8_PEAKS[peaks[0]]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gemm = {}
    for what, (n, k, f) in (("pair_head", (B * 128 * L, 384, 384)),
                            ("intermediate", (B * L, 768, 3072))):
        xq = torch.randint(-127, 128, (n, k), device="cuda",
                           dtype=torch.int8, generator=gen)
        wq = torch.randint(-127, 128, (f, k), device="cuda",
                           dtype=torch.int8, generator=gen)
        if not torch.equal(quant.int8_matmul_cuda(xq, wq),
                           quant.int8_matmul_reference(xq, wq)):
            raise RuntimeError(f"int8 GEMM at {what} ({n}x{k}x{f}) differs "
                               "from its integer twin")
        xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
        t_bytes = (n * k + f * k + 4 * n * f) / peaks[2] * 1e3
        t_ops = 2 * n * k * f / int8_peak * 1e3
        gemm[what] = {
            "shape": [n, k, f], "equal_to_twin": True,
            "ms": time_ms(lambda: quant.int8_matmul_cuda(xq, wq), n=10),
            "plain_ms": time_ms(lambda: quant.int8_matmul_reference(xq, wq),
                                n=3, warmup=1),
            "bf16_ms": time_ms(lambda: xb @ wb.t(), n=10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del xq, wq, xb, wb
    torch.cuda.empty_cache()

    wdir = os.path.join(tmp, "model")
    modes = (("bf16", {}), ("int8_pair_head", {"int8_pair_head": True}),
             ("int8_pair_head+backbone", {"int8_pair_head": True,
                                          "int8_backbone": True}))
    n_forwards = math.ceil(N_PAGES / B)
    rows = {}
    total = {}
    ref = mask = None
    for mode, kw in modes:
        svc = InferenceService(wdir, batch_size=B, dtype="bfloat16", **kw)
        pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                 for i in range(B)]
        ids, bbox, attn, _ = batch_tensors(svc, pages)
        reset_counts(ba, rb)
        svc.run(img_dir, ocr_dir)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        svc.run(img_dir, ocr_dir)
        torch.cuda.synchronize()
        run = dict(svc.last_run)
        peak = torch.cuda.max_memory_allocated()
        svc.run(img_dir, ocr_dir)
        warm = [run["warm_pages"] / run["warm_seconds"],
                svc.last_run["warm_pages"] / svc.last_run["warm_seconds"]]
        blocks = math.ceil((L - 1) / svc.cfg.pair_block_size)
        per_forward = (5 * blocks if "int8_pair_head" in kw else 0) + (
            12 * 12 if kw.get("int8_backbone") else 0)
        expect_counts(read_counts(ba, rb),
                      {"biacm_attention": 12 * 3 * n_forwards,
                       "int8": per_forward * 3 * n_forwards},
                      f"serve_int8 {mode}, three runs")
        # one batch's forward and fetch on the host clock, then profiled
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc._fetch(svc.dispatch_batch(pages))
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc._fetch(svc.dispatch_batch(pages))
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels, busy = device_rows(prof, wall_ms, profile_dir,
                                    "serve_int8_" + mode.replace("+", "_"))
        with torch.inference_mode():
            out = svc.model(ids, bbox, attn, return_logits=True)
        for k, v in read_counts(ba, rb).items():
            total[k] = total.get(k, 0) + v
        if ref is None:
            ref, mask = out, triu_valid(attn)
            gates = None
        else:
            gate = INT8_BACKBONE_GATE if kw.get("int8_backbone") \
                else INT8_PAIR_GATE
            gates = int8_logit_gate(ref, out, mask, gate, mode)
        rows[mode] = {
            "pages_per_s": run["pages"] / run["seconds"],
            "warm_pages_per_s": statistics.median(warm),
            "warm_pages_per_s_runs": warm,
            "max_memory_allocated": peak,
            "forward_wall_ms": statistics.median(walls),
            "forward_wall_ms_runs": walls,
            "batch_pages_per_s": B / (statistics.median(walls) / 1e3),
            "profiled_forward_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "int8_launches_per_forward": per_forward,
            "logits_vs_bf16": gates,
            "top_kernels": [[k[:90], round(ms, 3), c]
                            for k, ms, c in kernels[:8]]}
        del svc, out
        torch.cuda.empty_cache()
    emit({"phase": "serve_int8", "batch_size": B, "L": L, "pages": N_PAGES,
          "gemm": gemm, "modes": rows, "gates": {
              "pair_head": INT8_PAIR_GATE, "backbone": INT8_BACKBONE_GATE},
          "launches": total})
    return total


def phase_serve_int8_v3(ba, rb, tmp, img_dir, ocr_dir):
    """One LayoutLMv3-base forward (B=32, the 224 px image) with
    ``int8_pair_head + int8_backbone``: kernel #4 12 times behind the int8
    projections, the int8 launches the module structure gives, the logits
    against the bf16 service's within the backbone gate."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    wdir = os.path.join(tmp, "model_v3")
    outs = {}
    reset_counts(ba, rb)
    for mode, kw in (("bf16", {}), ("int8", {"int8_pair_head": True,
                                             "int8_backbone": True})):
        svc = InferenceService(wdir, batch_size=B, dtype="bfloat16", **kw)
        pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                 for i in range(B)]
        ids, bbox, attn, image = batch_tensors(svc, pages)
        before = read_counts(ba, rb)
        with torch.inference_mode():
            outs[mode] = svc.model(ids, bbox, attn, return_logits=True,
                                   **image)
        after = read_counts(ba, rb)
        blocks = math.ceil((L - 1) / svc.cfg.pair_block_size)
        expect_counts({k: after[k] - before[k] for k in after},
                      {"bias_attention": 12,
                       "int8": (5 * blocks + 12 * 6) if kw else 0},
                      f"one v3 {mode} forward")
        del svc
    gates = int8_logit_gate(outs["bf16"], outs["int8"], triu_valid(attn),
                            INT8_BACKBONE_GATE, "v3 int8")
    counts = read_counts(ba, rb)
    del outs
    torch.cuda.empty_cache()
    emit({"phase": "serve_int8_v3", "batch_size": B, "L": L,
          "attention_length": LV, "logits_vs_bf16": gates,
          "gate": INT8_BACKBONE_GATE, "launches": counts})
    return counts


def link_pages(src_img, src_ocr, dst_img, dst_ocr, indices, repeats=1):
    """Symlinks to the serve phase's pages: each page under ``repeats``
    names."""
    os.makedirs(dst_img)
    os.makedirs(dst_ocr)
    for r in range(repeats):
        for i in indices:
            img, ocr = page_paths(src_img, src_ocr, i)
            os.symlink(img, os.path.join(dst_img, f"page_{i:03d}_{r}.png"))
            os.symlink(ocr, os.path.join(dst_ocr, f"page_{i:03d}_{r}.json"))


def phase_serve_api(ba, rb, svc, tmp, img_dir, ocr_dir):
    """The single-page API on LiLT-base: ``run_page`` on 8 pages gives the
    records of ``run`` over a directory of those pages at batch 1 (the same
    forward shape), ``run_batch`` on one batch those of the batch-32 run;
    ``run(visualize_dir=…)`` writes one image per page."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    sub_img, sub_ocr = (os.path.join(tmp, "api_images"),
                        os.path.join(tmp, "api_ocr"))
    link_pages(img_dir, ocr_dir, sub_img, sub_ocr, range(API_PAGES))
    reset_counts(ba, rb)
    one = InferenceService(os.path.join(tmp, "model"), batch_size=1,
                           dtype="bfloat16")
    by_run = records_of(one.run(sub_img, sub_ocr))
    t0 = time.perf_counter()
    by_page = {name: as_record(*one.run_page(
        os.path.join(sub_img, name),
        os.path.join(sub_ocr, name[:-4] + ".json"))) for name in sorted(by_run)}
    torch.cuda.synchronize()
    page_ms = (time.perf_counter() - t0) / API_PAGES * 1e3
    del one
    if by_page != by_run:
        raise RuntimeError("run_page differs from run at batch 1 on "
                           f"{sum(by_page[k] != by_run[k] for k in by_run)} "
                           f"of {API_PAGES} pages")
    viz = os.path.join(tmp, "visualize")
    full = svc.run(img_dir, ocr_dir, visualize_dir=viz)
    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    t0 = time.perf_counter()
    batch = svc.run_batch(pages)
    batch_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(ba, rb)
    n_forwards = 2 * API_PAGES + math.ceil(N_PAGES / B) + 1
    expect_counts(counts, {"biacm_attention": 12 * n_forwards},
                  "serve_api")
    want = records_of(full)
    for i, res in enumerate(batch):
        if as_record(*res) != want[f"page_{i:03d}.png"]:
            raise RuntimeError(f"run_batch differs from run on page {i}")
    written = sorted(os.listdir(viz))
    if written != sorted(full):
        raise RuntimeError(f"visualize_dir holds {len(written)} images for "
                           f"{len(full)} pages")
    same_as_b32 = sum(by_page[f"page_{i:03d}_0.png"] == want[
        f"page_{i:03d}.png"] for i in range(API_PAGES))
    emit({"phase": "serve_api", "run_page_pages": API_PAGES,
          "run_page_ms_per_page": page_ms, "run_batch_ms": batch_ms,
          "run_page_equal_to_batch1_run": True,
          "run_page_equal_to_batch32_run": same_as_b32,
          "run_batch_equal_to_run": True, "visualized": len(written),
          "launches": counts})
    return counts


def phase_serve_v3_procs(ba, rb, tmp, img_dir, ocr_dir):
    """LayoutLMv3-base serving over 384 pages (the 96 under 4 names each),
    first on 4 preprocessing threads, then in min(8, cpu_count) spawned
    worker processes: whole-run pages/s of each (the host image path
    bounds v3 on a long directory), the same records."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    long_img, long_ocr = (os.path.join(tmp, "long_images"),
                          os.path.join(tmp, "long_ocr"))
    link_pages(img_dir, ocr_dir, long_img, long_ocr, range(N_PAGES),
               LONG_REPEATS)
    n = N_PAGES * LONG_REPEATS
    svc = InferenceService(os.path.join(tmp, "model_v3"), batch_size=B,
                           dtype="bfloat16")
    svc.run_batch([svc.preprocess_page(*page_paths(img_dir, ocr_dir, 0))])
    procs = min(8, os.cpu_count() or 1)
    reset_counts(ba, rb)
    runs = {}
    for what, kw in (("threads_4", {"workers": 4}),
                     (f"procs_{procs}", {"preprocess_procs": procs})):
        res = svc.run(long_img, long_ocr, **kw)
        torch.cuda.synchronize()
        run = dict(svc.last_run)
        runs[what] = {"records": records_of(res), "seconds": run["seconds"],
                      "pages_per_s": run["pages"] / run["seconds"],
                      "pool_start_seconds": run["pool_start_seconds"],
                      "pages_per_s_after_pool_start": run["pages"] / (
                          run["seconds"] - run["pool_start_seconds"]),
                      "warm_pages_per_s": run["warm_pages"]
                      / run["warm_seconds"]}
    counts = read_counts(ba, rb)
    expect_counts(counts, {"bias_attention": 12 * 2 * math.ceil(n / B)},
                  "serve_v3_procs")
    a, b = (r.pop("records") for r in runs.values())
    if len(a) != n or a != b:
        raise RuntimeError("preprocess_procs served other records than the "
                           "threads")
    del svc
    torch.cuda.empty_cache()
    emit({"phase": "serve_v3_procs", "pages": n, "batch_size": B,
          "cpu_count": os.cpu_count(), "runs": runs, "records_equal": True,
          "launches": counts})
    return counts


# ------------------------------------------------------------------------
# steps_per_call: K fine-tuning steps as one CUDA graph replay
# ------------------------------------------------------------------------

GRAPH_K = 4
# the graph phases: four logs (every 16 steps), eval and save at 64 (96
# until PR 8); ms/step over steps 33-64: the feed thread holds at most three
# groups (12 steps) ready, so by step 32 a feed slower than the replays has
# spent them
GRAPH_STEPS, GRAPH_LOG, GRAPH_FROM = 64, 16, 32
# the trainer's K = 1 steps against one replay of the K-step graph from the
# same state and batches, dropout 0: the same kernels in the same order, so
# the expectation is bit-identical; the gates leave room for a library
# choosing another algorithm under capture
GRAPH_LOSS_RTOL = 1e-4
GRAPH_PARAM_ATOL = 1e-5


def phase_kernel_seed(ba, rb):
    """Kernels #2 and #5 with the seed in device memory (a 0-d int64 CUDA
    tensor), at the main path's shapes and rate 0.1: the packed keep flags
    equal those of the same seed by value, bit for bit; in a CUDA graph that
    advances the seed before the launch, two replays give different flags,
    each equal to the host seed's for the value it read. Also the CUDA
    graph with ``torch.utils.checkpoint``: a checkpointed dropout captured
    in a graph, whose recompute in the backward must see the forward's
    mask, on two replays."""
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {}
    for name, length in (("biacm_attention_train_fwd", L),
                         ("bias_attention_train_fwd", LV),
                         ("bias_attention_train_fwd", LV2)):
        if name.startswith("biacm"):
            qkv, bias = attention_inputs(TRAIN_B, length, [], gen)

            def keep(rng, qkv=qkv, bias=bias):
                return ba.biacm_attention_train_fwd_cuda(
                    *qkv, bias, rng, 0.125, 0.25, DROP)[3]
        else:
            qkv, bias, mask = bias_inputs(TRAIN_B, length, [], gen)
            bias = relbias_layout(bias)

            def keep(rng, qkv=qkv, bias=bias, mask=mask):
                return rb.bias_attention_train_fwd_cuda(
                    *qkv, bias, mask, rng, 0.125, DROP)[2]
        seed = 1_000_003 * length + (1 << 40)
        by_value = keep(seed)
        on_card = torch.tensor(seed, dtype=torch.int64, device="cuda")
        equal = torch.equal(by_value, keep(on_card))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            on_card.add_(1)
            flags = keep(on_card)
        replays = []
        for _ in range(2):
            graph.replay()
            replays.append(flags.clone())
        torch.cuda.synchronize()
        per_replay = [torch.equal(r, keep(seed + i + 1))
                      for i, r in enumerate(replays)]
        fresh = not torch.equal(replays[0], replays[1])
        cases[f"{name}@{length}"] = {
            "device_seed_equal": equal, "replays_equal_host": per_replay,
            "replays_differ": fresh,
            "kept_share": unpack_share(ba, replays[0], length)}
        if not (equal and all(per_replay) and fresh):
            raise RuntimeError(f"{name} at L = {length}: device seed "
                               f"{cases[f'{name}@{length}']}")
        del graph, flags, replays

    # checkpoint's saved RNG state under capture: the recompute's dropout
    # mask must be the forward's (the gradient is mask / (1 - p) · wᵀ)
    x = torch.randn((64, 256), device="cuda", generator=gen,
                    requires_grad=True)
    w = torch.randn((256, 256), device="cuda", generator=gen) / 16

    def drop(a):
        return F.dropout(a @ w, 0.5, True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        checkpoint(drop, x, use_reentrant=False).sum().backward()
    torch.cuda.current_stream().wait_stream(side)
    x.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = checkpoint(drop, x, use_reentrant=False)
        y.sum().backward()
    ckpt = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        want = ((y != 0).float() * 2.0) @ w.t()
        ckpt.append({"grad_max_abs_err": (x.grad - want).abs().max().item(),
                     "mask": (y != 0).clone()})
    ckpt_fresh = not torch.equal(ckpt[0]["mask"], ckpt[1]["mask"])
    errs = [c["grad_max_abs_err"] for c in ckpt]
    emit({"phase": "kernel_seed", "rate": DROP, "batch_size": TRAIN_B,
          "cases": cases, "checkpoint_in_graph": {
              "grad_max_abs_err": errs, "masks_differ": ckpt_fresh}})
    if max(errs) > 1e-4 or not ckpt_fresh:
        raise RuntimeError("a checkpointed dropout in a CUDA graph: the "
                           f"recompute's mask differs (errors {errs}) or "
                           f"replays repeat it ({not ckpt_fresh})")


def unpack_share(ba, flags, length):
    """The kept share of packed keep flags."""
    return ba.unpack_keep_mask(flags, length).float().mean().item()


def graph_model_dir(model_dir, dst, dropout, **cfg_keys):
    """``model_dir``'s weights and tokenizer under a config whose hidden and
    attention dropout is ``dropout`` and whose other ``cfg_keys`` are set
    (files linked, config rewritten)."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(model_dir):
        src = os.path.join(model_dir, name)
        if name != "config.json" and os.path.isfile(src):
            os.symlink(src, os.path.join(dst, name))
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["backbone_config"]["hidden_dropout_prob"] = dropout
    cfg["backbone_config"]["attention_probs_dropout_prob"] = dropout
    cfg.update(cfg_keys)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


def graph_setup(data_dir, model_dir):
    """The model of ``model_dir`` on the card, its optimizer, a group of
    GRAPH_K training batches (leading axis K) from the synthetic corpus
    under ``data_dir`` on the card, and the host milliseconds per step of
    the trainer's feed thread for that group once its items are parsed (the
    feed caches them): collate (page images decoded and resized there),
    stack, copy to pinned memory."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import stack_batches, \
        to_host_tensors, tree_map

    args = run_rfund.build_argparser().parse_args(
        ["--synthetic_data", "--model_name_or_path", model_dir,
         "--output_dir", data_dir, "--max_seq_len", str(L)])
    _, model, train_ds, _, collator, _ = run_rfund.setup(args)
    model.cuda()
    items = [[train_ds[j * TRAIN_B + i] for i in range(TRAIN_B)]
             for j in range(GRAPH_K)]
    t0 = time.perf_counter()
    host = to_host_tensors(stack_batches([collator(x) for x in items]),
                           pin=True)
    feed_ms = (time.perf_counter() - t0) / GRAPH_K * 1e3
    group = tree_map(lambda t: t.cuda(), host)
    # 8 steps with 2 of warmup: the first four rates are 0, 2.5e-5, 5e-5
    # and 4.2e-5, so that every step moves the parameters
    optimizer, scheduler = T.make_optimizer(
        model, 5e-5, 8, warmup_ratio=0.25, downstream_speedup_ratio=30.0)
    return model, group, optimizer, scheduler, feed_ms


def phase_train_graph_parity(families, tmp):
    """For each family (LiLT, LayoutLMv3, LayoutXLM at full width, B=8,
    every dropout 0): from one state and the same GRAPH_K batches, GRAPH_K
    of the trainer's K = 1 steps (``train_step``), then one replay of the
    K-step graph from that state again: the per-step losses within
    GRAPH_LOSS_RTOL, the learning rates equal, every fp32 master parameter
    within GRAPH_PARAM_ATOL."""
    import torch

    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import tree_map

    names3 = ("total", "learning_rate", "grad_norm")
    out = {}
    for tag, (data_dir, model_dir) in families.items():
        free = graph_model_dir(model_dir, os.path.join(tmp, f"free_{tag}"),
                               0.0)
        model, group, optimizer, scheduler, _ = graph_setup(data_dir, free)
        names, params = zip(*[(n, p) for n, p in model.named_parameters()
                              if p.requires_grad])
        start = [p.detach().clone() for p in params]
        gen = torch.Generator().manual_seed(SEED)

        def reset():  # in place: the graph keeps these tensors
            with torch.no_grad():
                for p, s in zip(params, start):
                    p.copy_(s)
            for state in optimizer.state.values():
                for v in state.values():
                    v.zero_()
            scheduler.count.zero_()

        def eager():
            reset()
            rows = [T.train_step(model, optimizer, scheduler,
                                 tree_map(lambda t, k=k: t[k], group),
                                 1.0, gen, torch.bfloat16)
                    for k in range(GRAPH_K)]
            return ({k: [float(m[k]) for m in rows] for k in names3},
                    [p.detach().clone() for p in params])

        def compare(a, b, pa, pb):
            diffs = sorted(((x - y).abs().max().item(), n)
                           for n, x, y in zip(names, pa, pb))
            return {"loss_max_rel_diff": max(
                        abs(x - y) / abs(y)
                        for x, y in zip(a["total"], b["total"])),
                    "learning_rates_equal":
                        a["learning_rate"] == b["learning_rate"],
                    "param_max_abs_diff": diffs[-1][0],
                    "bit_identical": diffs[-1][0] == 0.0 and a == b,
                    "differing_params": [[n, d] for d, n in diffs[-5:]
                                         if d > 0]}

        steps, reference = eager()
        step_fn = T.MultiTrainStep(model, optimizer, scheduler, GRAPH_K, 1.0,
                                   gen, torch.bfloat16, SEED)
        reset()
        step_fn(group)  # the warm-up's eager steps, then the capture
        reset()
        t0 = time.perf_counter()
        step_fn(group)  # one replay
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        graph = {k: step_fn.per_step[k].tolist() for k in names3}
        graph_params = [p.detach().clone() for p in params]
        gate = compare(graph, steps, graph_params, reference)
        out[tag] = {"eager": steps, "graph": graph, **gate,
                    "replay_seconds": replay_s}
        if gate["loss_max_rel_diff"] > GRAPH_LOSS_RTOL \
                or not gate["learning_rates_equal"] \
                or gate["param_max_abs_diff"] > GRAPH_PARAM_ATOL:
            raise RuntimeError(f"{tag}: the K-step graph differs from K "
                               f"eager steps: {out[tag]}")
        del model, group, optimizer, scheduler, step_fn, start, reference, \
            graph_params
        torch.cuda.empty_cache()
    emit({"phase": "train_graph_parity", "steps_per_call": GRAPH_K,
          "batch_size": TRAIN_B, "dropout": 0.0, "families": out})


# the kernels of each family's training step (``<<<...>>>`` in
# csrc/*_train.cu: the mask kernel and the forward per call of the forward
# wrapper, dq and dk/dv per call of the backward wrapper), and the serving
# forwards' kernels, as a trace names them
STEP_KERNELS = {
    "": ("biacm_keep_mask_kernel", "biacm_train_fwd_kernel",
         "biacm_train_dq_kernel", "biacm_train_dkdv_kernel"),
    "rel": ("bias_keep_mask_kernel", "bias_train_fwd_kernel",
            "bias_train_dq_kernel", "bias_train_dkdv_kernel")}
EVAL_KERNELS = ("biacm_fwd_kernel", "bias_fwd_kernel")


def trace_launches(rows):
    """Launches of each of the port's kernels in a trace's device rows."""
    names = [*STEP_KERNELS[""], *STEP_KERNELS["rel"], *EVAL_KERNELS]
    return {name: sum(n for key, _, n in rows
                      if re.search(rf"\b{name}\b", key))
            for name in names}


def phase_train_graph(rb, ba, tmp, argv, eager, tag, profile_dir):
    """``run_rfund.main`` with ``--steps_per_call GRAPH_K``: the arguments
    ``argv`` of the family's K = 1 train phase (``eager``: its line) with
    GRAPH_STEPS steps, logged every GRAPH_LOG, eval and save at the end.
    Gates: the logged steps, finite losses, no non-finite step, the
    training wrappers #2/#3 (LiLT) or #5/#6 called 12 times per step of the
    first call (its K eager warm-up steps, then the K steps it captures)
    and no other training wrapper, #1 / #4 12 times per eval forward, and
    the saved directory serves one page. Then one replay of the K-step
    graph of the saved model, profiled: its trace must hold 12 launches per
    step of each of the family's four kernels (mask, forward, dq, dk/dv)
    and none of the other family's or of the serving forwards; device busy
    ms per step and the idle share; and the feed thread's host ms per step
    (for the visual families it decodes the page images: a floor under
    ms/step that no graph removes). Returns the launches for the
    ``kernels`` line: the wrappers' counts of the run, plus the profiled
    replay's from its trace (the run's other replays are not traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.infer import InferenceService

    name = f"train_graph_{tag}" if tag else "train_graph"
    out = os.path.join(tmp, name)
    argv = list(argv) + ["--output_dir", out, "--max_steps", str(GRAPH_STEPS),
                         "--logging_steps", str(GRAPH_LOG),
                         "--eval_steps", str(GRAPH_STEPS),
                         # the model is saved; no checkpoint (3.3 GB with
                         # the optimizer's state, read by no gate)
                         "--save_steps", "0",
                         "--steps_per_call", str(GRAPH_K)]
    wrappers = {"fwd": ba.biacm_attention_train_fwd_cuda,
                "bwd": ba.biacm_attention_train_bwd_cuda,
                "eval": ba.biacm_attention_cuda,
                "rel_fwd": rb.bias_attention_train_fwd_cuda,
                "rel_bwd": rb.bias_attention_train_bwd_cuda,
                "rel_eval": rb.bias_attention_cuda}
    own = ("rel_fwd", "rel_bwd", "rel_eval") if tag else ("fwd", "bwd",
                                                         "eval")
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run_rfund.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    launches = dict(zip(("fwd", "bwd", "eval"), (counts[k] for k in own)))
    others = sum(counts.values()) - sum(launches.values())
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()

    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss/total" in r]
    evals = [r for r in records if "eval/f1" in r]
    losses = [r["loss/total"] for r in steps]
    logged = list(range(GRAPH_LOG, GRAPH_STEPS + 1, GRAPH_LOG))
    if [r["step"] for r in steps] != logged \
            or not all(map(math.isfinite, losses)) \
            or steps[-1]["nonfinite_loss_steps"] != 0:
        raise RuntimeError(f"logged steps {[r['step'] for r in steps]} (want "
                           f"{logged}), losses {losses}, non-finite steps "
                           f"{[r['nonfinite_loss_steps'] for r in steps]}")
    layers, n_dev = 12, 16
    eval_forwards = math.ceil(n_dev / TRAIN_B)
    # the first call's K warm-up steps and the K steps it captures
    want = {"fwd": layers * 2 * GRAPH_K, "bwd": layers * 2 * GRAPH_K,
            "eval": layers * eval_forwards}
    if launches != want or others:
        raise RuntimeError(f"wrappers called {launches} (+{others} of other "
                           f"wrappers) over the first call's warm-up and "
                           f"capture and {eval_forwards} eval forwards, "
                           f"expected {want}")
    if len(evals) != 1 or evals[0]["eval/num_sample_processed"] != n_dev:
        raise RuntimeError(f"eval records {evals}: expected one over "
                           f"{n_dev} dev pages")
    times = {r["step"]: r["time"] for r in steps}
    ms_step = ((times[GRAPH_STEPS] - times[GRAPH_FROM])
               / (GRAPH_STEPS - GRAPH_FROM) * 1e3)
    intervals = [(b["time"] - a["time"]) / GRAPH_LOG * 1e3
                 for a, b in zip(steps, steps[1:])]

    img_dir = os.path.join(tmp, f"one_img_{name}")
    ocr_dir = os.path.join(tmp, f"one_ocr_{name}")
    write_pages(img_dir, ocr_dir, n_pages=1)
    svc = InferenceService(out, batch_size=1, dtype="bfloat16")
    serve_fn = wrappers[own[2]]
    serve_fn.launches = 0
    served = svc.run(img_dir, ocr_dir)
    torch.cuda.synchronize()
    if serve_fn.launches != layers or len(served) != 1:
        raise RuntimeError(f"the trained model served {len(served)} pages "
                           f"with {serve_fn.launches} launches")
    del svc

    # one replay of the saved model's K-step graph, profiled (the same
    # dropout as the run): what the card launched, read from the trace
    model, group, optimizer, scheduler, feed_ms = graph_setup(out, out)
    step_fn = T.MultiTrainStep(model, optimizer, scheduler, GRAPH_K, 1.0,
                               None, torch.bfloat16, SEED)
    step_fn(group)  # warm-up and capture
    step_fn(group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(group)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3
    rows, busy_ms = device_rows(prof, replay_ms, profile_dir, name)
    traced = trace_launches(rows)
    family = STEP_KERNELS["rel" if tag else ""]
    want_traced = {k: (layers * GRAPH_K if k in family else 0)
                   for k in traced}
    if traced != want_traced:
        raise RuntimeError(f"the profiled replay launched {traced}, "
                           f"expected {want_traced}")
    del model, group, optimizer, scheduler, step_fn
    torch.cuda.empty_cache()
    emit({"phase": name, "steps": GRAPH_STEPS, "steps_per_call": GRAPH_K,
          "batch_size": TRAIN_B, "L": L, "dropout": DROP,
          "wrapper_calls": launches, "replay_trace_launches": traced,
          "ms_per_step": ms_step,
          "samples_per_s": TRAIN_B / (ms_step / 1e3),
          "ms_per_step_window": [GRAPH_FROM + 1, GRAPH_STEPS],
          "ms_per_step_intervals": intervals,
          "eager_ms_per_step": eager["ms_per_step"],
          "eager_ms_per_step_intervals": eager["ms_per_step_intervals"],
          "profiled_replay_ms_per_step": replay_ms / GRAPH_K,
          "device_busy_ms_per_step": busy_ms / GRAPH_K,
          "device_idle_share": 1 - busy_ms / replay_ms,
          "feed_thread_ms_per_step": feed_ms,
          "max_memory_allocated": peak,
          "max_memory_reserved": peak_reserved,
          "eager_max_memory_allocated": eager["max_memory_allocated"],
          "logged_steps": logged, "losses": losses,
          "nonfinite_loss_steps": steps[-1]["nonfinite_loss_steps"],
          "learning_rates": [r["loss/learning_rate"] for r in steps],
          "eval": {k[len("eval/"):]: v for k, v in evals[0].items()
                   if k.startswith("eval/")},
          "wall_seconds": wall, "served_pages": len(served),
          "top_kernels": [[k[:90], round(ms, 3), n] for k, ms, n in rows[:8]]})
    return {"fwd": launches["fwd"] + traced[family[1]],
            "bwd": launches["bwd"] + traced[family[2]],
            "eval": launches["eval"], "ms_per_step": ms_step}


# OHEM and data parallelism --------------------------------------------------
OHEM_K = (128, 512)  # the JAX L = 512 OHEM test's (tests/test_losses.py)
OHEM_STREAM_RTOL = 1e-5
DP_STEPS = 4
DP_WORLD = 2
DP_LOSS_RTOL = 1e-3
DP_GRAD_TOL = 1e-2  # of each tensor's max |g|, as train_parity's
NCCL_LOSS_RTOL = 1e-6
DP_TIMEOUT = 420  # seconds for all ranks of one launch


def ohem_keys():
    return {"peneo_ohem_num_positive": OHEM_K[0],
            "peneo_ohem_num_negative": OHEM_K[1]}


def log_records(path):
    """A trainer log's step records (with losses) and eval records."""
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return ([r for r in records if "loss/total" in r],
            [r for r in records if "eval/f1" in r])


def phase_train_ohem(ba, rb, tmp, train_out, train_record):
    """LiLT-base fine-tuning with OHEM 128/512 through ``run_rfund`` (the
    train phase's arguments on its weights and corpus, the config's OHEM
    keys set), then the OHEM loss of one batch at dropout 0 three ways."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.models.decoder import (HEAD_NAMES,
                                                dense_labels_from_spots,
                                                triu_valid_mask)
    from peneo_tpu_torch.ops.losses import ohem_cross_entropy

    model_dir = graph_model_dir(train_out, os.path.join(tmp, "ohem_model"),
                                DROP, **ohem_keys())
    out = os.path.join(tmp, "train_ohem")
    argv = list(train_record["argv"])
    argv[argv.index("--output_dir") + 1] = out
    argv[argv.index("--save_steps") + 1] = "0"  # the model, no checkpoint
    argv += ["--model_name_or_path", model_dir, "--data_dir",
             os.path.join(train_out, "synthetic_data")]
    reset_counts(ba, rb)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_rfund.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts(ba, rb)
    peak = torch.cuda.max_memory_allocated()
    steps, evals = log_records(os.path.join(out, "log.jsonl"))
    losses = [r["loss/total"] for r in steps]
    logged = list(range(LOG_EVERY, TRAIN_STEPS + 1, LOG_EVERY))
    if [r["step"] for r in steps] != logged \
            or not all(map(math.isfinite, losses)) \
            or steps[-1]["nonfinite_loss_steps"] != 0:
        raise RuntimeError(f"OHEM run: logged steps "
                           f"{[r['step'] for r in steps]}, losses {losses}")
    layers, n_dev = 12, 16
    expect_counts(counts, {"fwd": layers * TRAIN_STEPS,
                           "bwd": layers * TRAIN_STEPS,
                           "biacm_attention": layers * math.ceil(
                               n_dev / TRAIN_B)}, "train_ohem")
    if len(evals) != 1 or evals[0]["eval/num_sample_processed"] != n_dev:
        raise RuntimeError(f"OHEM eval records {evals}")
    ms_step = ((steps[-1]["time"] - steps[0]["time"])
               / (TRAIN_STEPS - LOG_EVERY) * 1e3)

    # one batch at dropout 0: the streaming OHEM total of the CUDA path,
    # dense OHEM over the same block logits concatenated, the plain twins
    pdir = graph_model_dir(train_out, os.path.join(tmp, "ohem_parity"),
                           0.0, **ohem_keys())
    model, batch = train_batch(pdir)
    dec = model.peneo_decoder
    blocks = []
    pair_logits = dec._pair_logits

    def keep_blocks(a_blk, b_cols):
        logits = pair_logits(a_blk, b_cols)
        blocks.append([x.detach() for x in logits])
        return logits

    def total(impl, record=False):
        model.set_attention_impl(impl)
        if record:
            dec._pair_logits = keep_blocks
        try:
            model.train()
            with torch.no_grad(), torch.autocast("cuda",
                                                 dtype=torch.bfloat16):
                out = model(batch["input_ids"], batch["bbox"],
                            batch["attention_mask"], labels=batch["labels"],
                            generator=torch.Generator().manual_seed(SEED))
            return {k: v.item() for k, v in out.items()}
        finally:
            model.set_attention_impl("kernel")
            dec.__dict__.pop("_pair_logits", None)

    stream = total("kernel", record=True)
    plain = total("plain")
    cfg = model.cfg
    Ld = L - 1
    bs = min(cfg.pair_block_size, max(Ld, 8))
    Lp = -(-Ld // bs) * bs
    weights = dec.category_weights.float()
    dense = {}
    for i, name in enumerate(HEAD_NAMES):
        labels = dense_labels_from_spots(batch["labels"][name], Lp)
        logit, tgt, mask = [], [], []
        for j, r0 in enumerate(range(0, Lp, bs)):
            lg = blocks[j][i]
            t = labels[:, r0:r0 + bs, r0:]
            logit.append(lg.reshape(-1, lg.shape[-1]))
            tgt.append(t.reshape(-1))
            mask.append(triu_valid_mask(r0, bs, Lp - r0, Ld, col0=r0,
                                        device="cuda")[None].expand(
                                            t.shape).reshape(-1))
        w = weights[:2] if name == "line_extraction" else weights
        dense[name] = ohem_cross_entropy(
            torch.cat(logit), torch.cat(tgt), w, torch.cat(mask),
            *OHEM_K).item()
    ratios = cfg.peneo_loss_ratio or [1.0] * 5
    dense["total"] = sum(r * dense[n] for r, n in zip(ratios, HEAD_NAMES))
    rel_dense = abs(stream["total"] - dense["total"]) / abs(dense["total"])
    rel_plain = abs(stream["total"] - plain["total"]) / abs(plain["total"])
    del model, batch, blocks
    torch.cuda.empty_cache()
    emit({"phase": "train_ohem", "steps": TRAIN_STEPS, "batch_size": TRAIN_B,
          "L": L, "dropout": DROP, "ohem": list(OHEM_K),
          "launches": counts, "ms_per_step": ms_step,
          "ms_per_step_window": [LOG_EVERY + 1, TRAIN_STEPS],
          "plain_ce_ms_per_step": train_record["ms_per_step"],
          "max_memory_allocated": peak,
          "plain_ce_max_memory_allocated":
              train_record["max_memory_allocated"],
          "losses": losses, "eval": {k[len("eval/"):]: v
                                     for k, v in evals[0].items()
                                     if k.startswith("eval/")},
          "wall_seconds": wall,
          "one_batch": {"stream": stream, "dense": dense, "plain": plain,
                        "rel_err_dense": rel_dense,
                        "rel_err_plain": rel_plain,
                        "tol": {"dense": OHEM_STREAM_RTOL,
                                "plain": TRAIN_LOSS_TOL}}})
    if rel_dense > OHEM_STREAM_RTOL or rel_plain > TRAIN_LOSS_TOL \
            or not math.isfinite(stream["total"]):
        raise RuntimeError(f"OHEM one batch: streaming {stream['total']}, "
                           f"dense {dense['total']}, plain {plain['total']}")
    return counts


def dp_data_dir(src, dst):
    """The corpus of ``src`` with every dev page listed twice (the same
    file names: the metric's dedup must count each once)."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name != "en.val.json":
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "en.val.json")) as f:
        dev = json.load(f)
    dev["documents"] = dev["documents"] * 2
    with open(os.path.join(dst, "en.val.json"), "w") as f:
        json.dump(dev, f)
    return dst


def probe_names(model):
    """The parameters whose step-1 gradients are compared: layers 0 and
    11's attention projections of both streams, combine_fc and every
    classifier layer."""
    names = [n for n, _ in model.named_parameters()]
    keep = []
    for n in names:
        if re.fullmatch(r"backbone\.encoder\.layer\.(0|11)\.attention\.self"
                        r"\.(layout_)?(query|key|value)\.weight", n) \
                or n == "peneo_decoder.handshaking_kernel.combine_fc.weight" \
                or re.fullmatch(r"peneo_decoder\.\w+_fc\.\d+\.weight", n):
            keep.append(n)
    return keep


def first_step_grads(argv):
    """One trainer step (``train_step``, under DDP in a process group) on
    the first global batch of ``run_rfund``'s arguments: the loss and the
    (all-reduced) gradients of :func:`probe_names`, on the CPU."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import DataFeed, batch_to_device
    from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

    args = run_rfund.build_argparser().parse_args(argv)
    cfg, model, train_ds, _, collator, _ = run_rfund.setup(args)
    trainer = PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                           train_ds, None, collator)
    feed = DataFeed(train_ds, collator, args.per_device_train_batch_size,
                    shuffle=True, seed=args.seed, rank=trainer.rank,
                    world=trainer.world)
    batch = batch_to_device(next(iter(feed)), trainer.device)
    metrics = T.train_step(trainer.step_model, trainer.optimizer,
                           trainer.scheduler, batch,
                           trainer.args.max_grad_norm, trainer.seeds,
                           trainer.dtype)
    params = dict(model.named_parameters())
    grads = {n: params[n].grad.detach().float().cpu()
             for n in probe_names(model)}
    loss = metrics["total"].item()
    del trainer, model, params, batch
    torch.cuda.empty_cache()
    return loss, grads


def rank_keep_flags(ba, rank):
    """Kernel #2's packed keep flags at rate DROP on fixed inputs with data
    parallel rank ``rank``'s first layer seed (``HostSeeds`` of SEED)."""
    import torch

    from peneo_tpu_torch.models.dropout_seeds import HostSeeds

    qkv, bias = attention_inputs(TRAIN_B // DP_WORLD, L, [(0, slice(400,
                                                                    None))],
                                 torch.Generator(device="cuda").manual_seed(
                                     SEED))
    seed = HostSeeds(torch.Generator().manual_seed(SEED), rank).layer(0)
    keep = ba.biacm_attention_train_fwd_cuda(*qkv, bias, seed, 0.125, 0.25,
                                             DROP)[3]
    return seed, keep.cpu()


STEADY_STEPS = 6  # train_dp: steps timed after a run, the first not counted


def steady_ms(trainer):
    """ms per step of STEADY_STEPS - 1 more of ``trainer``'s steps on the
    first batch of its feed, after one more (DDP has rebuilt its buckets
    by then, every library is warm), between syncs; under DDP every rank
    calls it."""
    import torch

    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import DataFeed, batch_to_device

    args = trainer.args
    feed = DataFeed(trainer.train_dataset, trainer.collator,
                    args.per_device_train_batch_size, shuffle=True,
                    seed=args.seed, rank=trainer.rank, world=trainer.world)
    batch = batch_to_device(next(iter(feed)), trainer.device)
    for i in range(STEADY_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        T.train_step(trainer.step_model, trainer.optimizer, trainer.scheduler,
                     batch, args.max_grad_norm, trainer.seeds, trainer.dtype)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (STEADY_STEPS - 1) * 1e3


def tensor_digests(state):
    """sha256 of each tensor's fp32 bytes, by name."""
    import hashlib

    return {k: hashlib.sha256(v.detach().float().cpu().numpy().tobytes())
            .hexdigest() for k, v in state.items()}


def served_as_ended(trainer, pages):
    """The weights a run ended with (digests), and the records a service of
    its saved directory gives with those weights put in from memory."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    state = trainer.model.state_dict()
    svc = InferenceService(trainer.args.output_dir, batch_size=32,
                           dtype="bfloat16", device=trainer.device)
    svc.model.load_state_dict(state)
    svc.model.cast(torch.bfloat16)
    records = records_of(svc.run(*pages))
    return {"final_weights": tensor_digests(state),
            "final_records": json.loads(json.dumps(records))}


def dp_worker(spec):
    """One rank of a ``train_dp`` launch (``chip_smoke.py --dp-worker``):
    joins the process group as ``run_rfund --distributed`` does (torchrun's
    environment, set by the parent), optionally takes the step-1 gradient
    and the dropout-flag probes, then runs ``run_rfund`` for each loss of
    ``spec`` with the launch counts reset just before and read just after;
    writes its results to ``spec["result"]``."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.parallel import dist as pdist

    parse = run_rfund.build_argparser().parse_args
    argvs = {k: v + ["--distributed"] for k, v in spec["argv"].items()}
    first = parse(argvs[spec["losses"][0]])
    run_rfund.check_parallel_flags(first)
    run_rfund.init_parallel(first)
    me = pdist.rank()
    result = {"rank": me, "world": pdist.world(),
              "backend": pdist.dist.get_backend(),
              "device": str(pdist.rank_device())}
    try:
        if spec.get("probe"):
            loss, grads = first_step_grads(spec["probe"] + ["--distributed"])
            result["step1_loss"] = loss
            if me == 0:
                torch.save(grads, spec["grads"])
            seed, keep = rank_keep_flags(ba, me)
            result["keep_seed"] = seed
            torch.save(keep, spec["keep"].format(rank=me))
        for name in spec["losses"]:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ba, rb)
            _, trainer = run_rfund.run(parse(argvs[name]))
            result[name] = {"launches": read_counts(ba, rb),
                            "max_memory_allocated":
                                torch.cuda.max_memory_allocated()}
            if me == 0 and spec.get("pages") and name == "ce":
                result.update(served_as_ended(trainer, spec["pages"]))
            if name == "ce":
                result[name]["steady_ms"] = steady_ms(trainer)
            del trainer
        pdist.barrier()
    finally:
        pdist.dist.destroy_process_group()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(spec, world, tmp, tag):
    """``world`` rank processes of :func:`dp_worker`, each with torchrun's
    environment on a free local port and its own CUDA context; their
    results in rank order. A rank that fails, or a launch that outlives
    DP_TIMEOUT, kills every rank and raises with their output's tail."""
    port = free_port()
    procs, logs, results = [], [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        rspec = dict(spec, result=os.path.join(tmp, f"{tag}.rank{r}.json"))
        logs.append(os.path.join(tmp, f"{tag}.rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker",
                 json.dumps(rspec)], env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
        results.append(rspec["result"])
    deadline = time.time() + DP_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    except subprocess.TimeoutExpired:
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    if failed:
        tails = []
        for r in failed:
            with open(logs[r]) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError(f"{tag}: rank(s) {failed} failed or timed out "
                           f"after {DP_TIMEOUT} s\n" + "\n".join(tails))
    out = []
    for path in results:
        with open(path) as f:
            out.append(json.load(f))
    return out


def step_ms(steps):
    """ms per step between the first and the last logged step."""
    return ((steps[-1]["time"] - steps[0]["time"])
            / (steps[-1]["step"] - steps[0]["step"]) * 1e3)


def rel_close(a, b, rtol):
    return all(abs(x - y) <= rtol * abs(y) for x, y in zip(a, b)) \
        and len(a) == len(b)


def phase_train_dp(ba, rb, tmp, train_out, img_dir, ocr_dir, smi):
    """Data-parallel fine-tuning of LiLT-base through ``run_rfund
    --distributed``: DP_WORLD ranks spawned with torchrun's environment
    (each its own CUDA context; over gloo when they share the card, NCCL
    when each has its own), global B = TRAIN_B, L = 512, bf16, dropout 0,
    DP_STEPS steps of plain CE, then of OHEM 128/512, each with an eval over
    the 16 dev pages listed twice and a save; the same global batches in
    one process (here); one NCCL rank (world 1) of the CE run."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.infer import InferenceService

    data = dp_data_dir(os.path.join(train_out, "synthetic_data"),
                       os.path.join(tmp, "dp_data"))
    models = {"ce": graph_model_dir(train_out, os.path.join(tmp, "dp_ce"),
                                    0.0),
              "ohem": graph_model_dir(train_out,
                                      os.path.join(tmp, "dp_ohem"), 0.0,
                                      **ohem_keys())}

    def argv(loss, out, per_rank):
        # the model is saved; no checkpoint (3.3 GB with the optimizer's
        # state: the machine's disk writes are bounded; the CPU tests check
        # rank 0's checkpoints)
        return ["--synthetic_data", "--model_name_or_path", models[loss],
                "--data_dir", data, "--output_dir", out, "--do_train",
                "--max_steps", str(DP_STEPS), "--max_seq_len", str(L),
                "--per_device_train_batch_size", str(per_rank),
                "--per_device_eval_batch_size", str(per_rank),
                "--logging_steps", "1", "--eval_steps", str(DP_STEPS),
                "--save_steps", "0", "--seed", str(SEED), "--no_resume"]

    per_rank = TRAIN_B // DP_WORLD
    outs = {(run, loss): os.path.join(tmp, f"dp_{run}_{loss}")
            for run in ("solo", "ranks", "nccl") for loss in ("ce", "ohem")}
    # the same global batches in this process
    parse = run_rfund.build_argparser().parse_args
    reset_counts(ba, rb)
    solo_ms = {}
    for loss in ("ce", "ohem"):
        _, trainer = run_rfund.run(parse(argv(loss, outs["solo", loss],
                                              TRAIN_B)))
        if loss == "ce":
            solo_counts = read_counts(ba, rb)
            solo_ms = steady_ms(trainer)
            reset_counts(ba, rb)
        del trainer
    for k, v in read_counts(ba, rb).items():
        solo_counts[k] += v
    solo_loss, solo_grads = first_step_grads(
        argv("ce", os.path.join(tmp, "dp_probe_solo"), TRAIN_B))
    gc.collect()
    torch.cuda.empty_cache()

    spec = {"argv": {loss: argv(loss, outs["ranks", loss], per_rank)
                     for loss in ("ce", "ohem")},
            "losses": ["ce", "ohem"],
            "probe": argv("ce", os.path.join(tmp, "dp_probe_ranks"),
                          per_rank),
            "grads": os.path.join(tmp, "dp_grads.pt"),
            "keep": os.path.join(tmp, "dp_keep.rank{rank}.pt"),
            "pages": [img_dir, ocr_dir]}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, DP_WORLD, tmp, "train_dp")
    ranks_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = launch_ranks({"argv": {"ce": argv("ce", outs["nccl", "ce"],
                                              TRAIN_B)},
                         "losses": ["ce"]}, 1, tmp, "train_dp_nccl")[0]
    nccl_wall = time.perf_counter() - t0
    backend = ranks[0]["backend"]
    if nccl["backend"] != "nccl" or any(r["backend"] != backend
                                        for r in ranks):
        raise RuntimeError(f"backends: ranks {[r['backend'] for r in ranks]}"
                           f", world 1 {nccl['backend']}")

    # losses and eval: both ranks alike, equal to the one process
    report, errors = {"backend": backend, "world": DP_WORLD,
                      "nvidia_smi": smi, "devices":
                          [r["device"] for r in ranks]}, []
    layers, n_dev = 12, 16
    per_run = {"fwd": layers * DP_STEPS, "bwd": layers * DP_STEPS,
               "biacm_attention": layers * 2 * n_dev // TRAIN_B}
    for loss in ("ce", "ohem"):
        solo_steps, solo_evals = log_records(
            os.path.join(outs["solo", loss], "log.jsonl"))
        logs = [log_records(os.path.join(
            outs["ranks", loss], "log.jsonl" if r == 0
            else f"log.rank{r}.jsonl")) for r in range(DP_WORLD)]
        want = [r["loss/total"] for r in solo_steps]
        got = [[r["loss/total"] for r in steps] for steps, _ in logs]
        evals = [{k: v for k, v in e[0].items()
                  if k.startswith("eval/") and "per_second" not in k}
                 for _, e in logs]
        solo_eval = {k: v for k, v in solo_evals[0].items()
                     if k.startswith("eval/") and "per_second" not in k}
        report[loss] = {
            "losses_one_process": want, "losses_rank0": got[0],
            "max_rel_err": max(abs(a - b) / abs(b)
                               for a, b in zip(got[0], want)),
            "ms_per_step_logged_ranks": step_ms(logs[0][0]),
            "ms_per_step_logged_one_process": step_ms(solo_steps),
            "eval_rank0": evals[0], "eval_one_process": solo_eval,
            "launches_ranks": [r[loss]["launches"] for r in ranks],
            "max_memory_allocated_ranks":
                [r[loss]["max_memory_allocated"] for r in ranks]}
        if len(want) != DP_STEPS or not all(map(math.isfinite, want)):
            errors.append(f"{loss}: one-process losses {want}")
        if any(g != got[0] for g in got) \
                or not rel_close(got[0], want, DP_LOSS_RTOL):
            errors.append(f"{loss}: rank losses {got} vs one process {want}")
        if any(e != evals[0] for e in evals) \
                or evals[0]["eval/num_sample_processed"] != n_dev \
                or any(evals[0][k] != solo_eval[k] for k in
                       ("eval/precision", "eval/recall", "eval/f1",
                        "eval/num_sample_processed")) \
                or not rel_close([v for k, v in sorted(evals[0].items())
                                  if "loss" in k],
                                 [v for k, v in sorted(solo_eval.items())
                                  if "loss" in k], DP_LOSS_RTOL):
            errors.append(f"{loss}: eval {evals} vs one process {solo_eval}")
        for r in ranks:
            expect_counts(r[loss]["launches"], per_run,
                          f"train_dp rank {r['rank']} {loss}")

    # step 1's all-reduced gradient against one process's
    grads = torch.load(spec["grads"], weights_only=True)
    grad_err = {n: ((grads[n] - g).abs().max() / g.abs().max()).item()
                for n, g in solo_grads.items()}
    report["step1_grad_err_over_max"] = grad_err
    report["step1_loss"] = {"ranks": [r["step1_loss"] for r in ranks],
                            "one_process": solo_loss}
    if set(grads) != set(solo_grads) or len(grads) < 20 \
            or any(v > DP_GRAD_TOL for v in grad_err.values()):
        errors.append(f"step-1 gradients: {grad_err}")

    # each rank's dropout flags: its own, those of its offset seed
    flags, same = [], []
    for r in ranks:
        keep = torch.load(spec["keep"].format(rank=r["rank"]),
                          weights_only=True)
        bits = ba.attention_dropout_bits(
            r["keep_seed"], TRAIN_B // DP_WORLD, NH, L, device="cuda")
        want = ba.pack_keep_mask(torch.stack(bits)
                                 < ba.keep_threshold(DROP)).cpu()
        same.append(torch.equal(keep, want))
        flags.append(keep)
    report["dropout_flags"] = {
        "seeds": [r["keep_seed"] for r in ranks],
        "equal_to_offset_seed_bits": same,
        "differing_words": int((flags[0] != flags[1]).sum())}
    if not all(same) or torch.equal(flags[0], flags[1]):
        errors.append(f"dropout flags {report['dropout_flags']}")

    # world 1 over NCCL: the one-process losses bit for bit
    nccl_steps, _ = log_records(os.path.join(outs["nccl", "ce"],
                                             "log.jsonl"))
    nccl_losses = [r["loss/total"] for r in nccl_steps]
    report["nccl_world1"] = {
        "losses": nccl_losses,
        "ms_per_step_logged": step_ms(nccl_steps),
        "launches": nccl["ce"]["launches"],
        "max_memory_allocated": nccl["ce"]["max_memory_allocated"]}
    report["ms_per_step_steady"] = {
        "one_process": solo_ms,
        f"{backend}_{DP_WORLD}_ranks": ranks[0]["ce"]["steady_ms"],
        "nccl_world1": nccl["ce"]["steady_ms"], "steps": STEADY_STEPS - 1}
    if not rel_close(nccl_losses, report["ce"]["losses_one_process"],
                     NCCL_LOSS_RTOL):
        errors.append(f"NCCL world 1 losses {nccl_losses}")
    expect_counts(nccl["ce"]["launches"], per_run, "train_dp nccl")

    # rank 0's save served by one process: the records of the model the
    # run ended with (rank 0 served them from its weights in memory), and
    # those weights bit for bit
    saved = outs["ranks", "ce"]
    on_disk = torch.load(os.path.join(saved, "pytorch_model.bin"),
                         weights_only=True)
    identical = ranks[0]["final_weights"] == tensor_digests(on_disk)
    svc = InferenceService(saved, batch_size=32, dtype="bfloat16")
    served = json.loads(json.dumps(records_of(svc.run(img_dir, ocr_dir))))
    del svc
    report["save"] = {"weights_bit_identical": identical,
                      "pages_served": len(served),
                      "records_equal": served == ranks[0]["final_records"]}
    if not identical or len(served) != N_PAGES \
            or served != ranks[0]["final_records"]:
        errors.append(f"save: {report['save']}")

    report.update({"phase": "train_dp", "steps": DP_STEPS,
                   "global_batch": TRAIN_B, "per_rank_batch": per_rank,
                   "L": L, "dropout": 0.0, "ohem_k": list(OHEM_K),
                   "ranks_wall_seconds": ranks_wall,
                   "nccl_wall_seconds": nccl_wall,
                   "tol": {"loss": DP_LOSS_RTOL, "grad": DP_GRAD_TOL,
                           "nccl_loss": NCCL_LOSS_RTOL}})
    emit(report)
    if errors:
        raise RuntimeError("train_dp: " + "; ".join(errors))
    # the main path's launches: this process's runs and every rank's
    total = dict(solo_counts)
    for r in ranks + [nccl]:
        for loss in ("ce", "ohem"):
            for k, v in r.get(loss, {}).get("launches", {}).items():
                total[k] += v
    return total


def timed(name, fn, *a, **kw):
    """Run one phase and print its seconds."""
    import torch

    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
    return out


def main(argv=None):
    import argparse

    # the run uses one card: the device count printed last is the cards
    # it used (unless the caller chose the visible cards)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="also write the profiled forward's kernel table and "
                        "chrome trace into DIR")
    p.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dp_worker:  # one rank of train_dp, started by this script
        return dp_worker(json.loads(args.dp_worker))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # the port must sit beside this script: fail before printing anything
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.ops.cuda_build import BUILD_DIR, build_libraries, \
        build_log

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": {"table": peaks[0], "bf16_flops": peaks[1],
                    "bytes_per_s": peaks[2]}})

    t0 = time.perf_counter()
    sources = (ba.SOURCE, ba.TRAIN_SOURCE, rb.SOURCE, rb.TRAIN_SOURCE)
    build_libraries(sources)  # one nvcc each, all started together
    ba.load_kernel()
    ba.load_train_kernel()
    rb.load_kernel()
    rb.load_train_kernel()
    ptxas = {src: [ln.strip() for ln in build_log(src).splitlines()
                   if "registers" in ln or "spill" in ln
                   or "entry function" in ln]
             for src in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})
    # each kernel's registers, shared memory and spills from the ptxas
    # report, and the resident CTAs per SM the runtime grants it
    resources = kernel_resources(
        "\n".join(build_log(src) for src in sources),
        {**ba.kernel_occupancy(), **rb.kernel_occupancy()})
    emit({"phase": "kernel_resources", "threads_per_cta": 128,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "kernels": resources})
    spilled = {k: v for k, v in resources.items()
               if v["spill_stores"] or v["spill_loads"] or v["stack_frame"]}
    if spilled:
        raise RuntimeError(f"register spills or a stack frame: {spilled}")

    max_err, timing, bound = timed("kernel", phase_kernel, ba, peaks)
    train_err, train_timing, train_bounds = timed(
        "kernel_train", phase_kernel_train, ba, peaks)
    bias_err, bias_timing, bias_bound, _ = timed(
        "kernel_bias", phase_kernel_bias, rb, peaks)
    bias_train_err, bias_train_timing, bias_train_bounds, _ = timed(
        "kernel_bias_train", phase_kernel_bias_train, rb, ba, peaks)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-", dir=BUILD_DIR) as tmp:
        svc, img_dir, ocr_dir, docs, launches = timed(
            "serve", phase_serve, ba, tmp)
        timed("parity", phase_parity, svc, img_dir, ocr_dir)
        timed("decode", phase_decode, svc, img_dir, ocr_dir, docs)
        timed("breakdown", phase_breakdown, svc, img_dir, ocr_dir,
              args.profile)
        # checkpoints, int8 and the serving surface: each phase's launches
        surface = [
            timed("checkpoints", phase_checkpoints, ba, rb, tmp, img_dir,
                  ocr_dir),
            timed("serve_int8", phase_serve_int8, ba, rb, tmp, img_dir,
                  ocr_dir, peaks, args.profile),
            timed("serve_api", phase_serve_api, ba, rb, svc, tmp, img_dir,
                  ocr_dir)]
        del svc
        train_launches, train_out, train_record = timed(
            "train", phase_train, ba, tmp)
        model, batch = train_batch(train_out)
        timed("train_parity", phase_train_parity, ba, model, batch)
        timed("train_breakdown", phase_train_breakdown, model, batch,
              args.profile)
        del model, batch
        torch.cuda.empty_cache()
        # OHEM and data parallelism: each phase's launches
        surface.append(timed("train_ohem", phase_train_ohem, ba, rb, tmp,
                             train_out, train_record))
        surface.append(timed("train_dp", phase_train_dp, ba, rb, tmp,
                             train_out, img_dir, ocr_dir, smi))

        launches_v3 = run_rel_path(rb, ba, tmp, img_dir, ocr_dir,
                                   args.profile, "v3")
        surface.append(timed("serve_v3_procs", phase_serve_v3_procs, ba, rb,
                             tmp, img_dir, ocr_dir))
        surface.append(timed("serve_int8_v3", phase_serve_int8_v3, ba, rb,
                             tmp, img_dir, ocr_dir))
        launches_v2 = run_rel_path(rb, ba, tmp, img_dir, ocr_dir,
                                   args.profile, "v2")

        # steps_per_call: K fine-tuning steps as one CUDA graph replay
        timed("kernel_seed", phase_kernel_seed, ba, rb)
        timed("train_graph_parity", phase_train_graph_parity,
              {"lilt": (train_out, train_out),
               "v3": (launches_v3["train_out"],) * 2,
               "v2": (launches_v2["train_out"],) * 2}, tmp)
        graph = {"": timed("train_graph", phase_train_graph, rb, ba, tmp,
                           train_record["argv"], train_record, "",
                           args.profile)}
        for tag, path in (("v3", launches_v3), ("v2", launches_v2)):
            graph[tag] = timed(
                f"train_graph_{tag}", phase_train_graph, rb, ba, tmp,
                path["train_record"]["argv"], path["train_record"], tag,
                args.profile)
    # launches on every path: serving, and the training runs (with their
    # eval forwards); for the K-step graph runs, the wrappers' calls (the
    # warm-up and the capture) and one profiled replay's from its trace
    launches += train_launches["biacm_attention"] + graph[""]["eval"]
    for k in ("fwd", "bwd"):
        train_launches[k] += graph[""][k]
    bias_launches = sum(p["serve"] + p["train"]["bias_attention"]
                        for p in (launches_v3, launches_v2)) \
        + graph["v3"]["eval"] + graph["v2"]["eval"]
    bias_train_launches = {k: sum(p["train"][k] for p in (launches_v3,
                                                          launches_v2))
                           + graph["v3"][k] + graph["v2"][k]
                           for k in ("fwd", "bwd")}
    # and the checkpoint, int8 and serving-surface phases'
    for counts in surface:
        launches += counts["biacm_attention"]
        bias_launches += counts["bias_attention"]
        for k in ("fwd", "bwd"):
            train_launches[k] += counts[k]
            bias_train_launches[k] += counts["bias_" + k]

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bnd,
              library_ms, device, max_rel_err=None):
        """One kernel of the ``kernels`` line; every entry has these keys
        (``max_rel_err`` is null for the forward kernels). ``ms``,
        ``plain_ms`` and ``library_ms`` are medians between CUDA events
        around the call (host time between launches included);
        ``device_ms`` and ``library_device_ms`` are the profiler's device
        time of the same calls (the events hold the host's time between
        launches once a call is under ~0.2 ms)."""
        return {"name": name, "route": "cuda",
                "source": "peneo_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "max_rel_err": max_rel_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
                "bound_by": bnd["bound_by"], "library_ms": library_ms,
                "device_ms": device[0], "library_device_ms": device[1]}

    jb = "peneo_tpu/ops/biacm_attention.py:"
    jr = "peneo_tpu/ops/bias_attention.py:"
    # the backward kernels' max_abs_err is over their gradients; the gate is
    # each one's error over its own max |reference| (max_rel_err)
    emit({"kernels": [
        entry("biacm_attention", "biacm_attention.cu", jb + "49", launches,
              max_err, timing["ms"], timing["plain_ms"], bound,
              timing["library_ms"],
              device=(timing["device_ms"], timing["library_device_ms"])),
        entry("biacm_attention_train_fwd", "biacm_attention_train.cu",
              jb + "295", train_launches["fwd"], train_err["fwd_max_abs_err"],
              train_timing["fwd_ms"], train_timing["plain_fwd_ms"],
              train_bounds["fwd"], train_timing["library_fwd_ms"],
              device=(train_timing["fwd_device_ms"],
                      train_timing["library_fwd_dropout_device_ms"])),
        entry("biacm_attention_train_bwd", "biacm_attention_train.cu",
              jb + "327", train_launches["bwd"],
              train_err["grad_max_abs_err"], train_timing["bwd_ms"],
              train_timing["plain_bwd_ms"], train_bounds["bwd"],
              train_timing["library_bwd_ms"],
              max_rel_err=train_err["grad_max_rel_err"],
              device=(train_timing["bwd_device_ms"],
                      train_timing["library_bwd_dropout_device_ms"])),
        entry("bias_attention", "bias_attention.cu", jr + "59", bias_launches,
              bias_err, bias_timing["ms"], bias_timing["plain_ms"],
              bias_bound, bias_timing["library_ms"],
              device=(bias_timing["device_ms"],
                      bias_timing["library_device_ms"])),
        entry("bias_attention_train_fwd", "bias_attention_train.cu",
              jr + "280", bias_train_launches["fwd"],
              bias_train_err["fwd_max_abs_err"], bias_train_timing["fwd_ms"],
              bias_train_timing["plain_fwd_ms"], bias_train_bounds["fwd"],
              bias_train_timing["library_fwd_ms"],
              device=(bias_train_timing["fwd_device_ms"],
                      bias_train_timing["library_fwd_device_ms"])),
        entry("bias_attention_train_bwd", "bias_attention_train.cu",
              jr + "304", bias_train_launches["bwd"],
              bias_train_err["grad_max_abs_err"],
              bias_train_timing["bwd_ms"], bias_train_timing["plain_bwd_ms"],
              bias_train_bounds["bwd"], bias_train_timing["library_bwd_ms"],
              max_rel_err=bias_train_err["grad_max_rel_err"],
              device=(bias_train_timing["bwd_device_ms"],
                      bias_train_timing["library_bwd_device_ms"]))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
