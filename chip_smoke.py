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
   L' = 709 (last 100 text keys of half the rows masked), 128 and a ragged
   200, with a random fp32 (B, nh, L', L') bias at its natural row stride
   (rows of L' floats, fetched in 4-byte requests) and at the model's
   padded one (``RelBias``: L' rounded up to a multiple of 4, 16-byte
   requests); max abs error ≤ 2e-2. Times of the kernel (padded stride, the
   main path's; events and device), the twin and
   ``F.scaled_dot_product_attention(q, k, v, attn_mask=bias + mask)`` at
   both strides (events and device; and each backend that accepts the
   mask).
13. kernel_bias_train — kernels #5 and #6 against the fp32 twin and its
   autograd gradients (dq, dk, dv and dbias) at B=8 and the same lengths
   plus 709 with nearly collinear rows, rates 0 and 0.1, explicit bits and
   the in-kernel generator (bit-identical results; the twin takes
   ``element_dropout_bits``), both bias strides: forward ≤ 2e-2, each
   gradient ≤ 2e-2 of its own max |reference|; kernel #5's packed keep
   flags equal to ``pack_keep_mask(element_dropout_bits(...) < threshold)``
   word for word, and kernel #6 fed either, bit for bit; the kept share;
   timings (events and device) beside SDPA's at both strides.
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
19. the ``kernels`` line (all six), then the final ``{"ok": true, ...}``.

Every phase also prints its seconds.
"""

import json
import math
import os
import random
import statistics
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
    import re

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
                                      svc.score_thresh, orig_bbox)
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


def phase_breakdown(svc, img_dir, ocr_dir, profile_dir, v3=False):
    """Where one batch's time goes: host preprocess per page, the forward's
    enqueue and wall time (host clock to the fetched outputs), and the
    device time by kernel from torch.profiler. ``v3``: the LayoutLMv3
    service (kernel #4; also times the relative-bias build on its own)."""
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
    rows, device_ms = device_rows(prof, prof_wall_ms, profile_dir,
                                  "serve_v3_forward" if v3 else "serve_forward")
    attn_ms = sum(r[1] for r in rows
                  if ("bias_fwd_kernel" if v3 else "biacm") in r[0])
    extra = {}
    if v3:
        bbox = v3_boxes(svc.model.backbone, torch.from_numpy(
            np.stack([p[0]["bbox"] for p in pages])).cuda())
        with torch.inference_mode():
            extra["rel_bias_build_ms"] = time_ms(
                lambda: svc.model.backbone.rel_bias(bbox, L, N_VIS))
    emit({"phase": "breakdown_v3" if v3 else "breakdown", "batch_size": B,
          "L": L, **extra, "preprocess_ms_per_page": prep_ms,
          "forward_enqueue_ms": statistics.median(enqueue),
          "forward_wall_ms": statistics.median(wall),
          "profiled_forward_wall_ms": prof_wall_ms,
          "device_busy_ms": device_ms,
          "bias_attention_ms" if v3 else "biacm_attention_ms": attn_ms,
          "device_idle_share": 1 - device_ms / prof_wall_ms,
          "top_kernels": [[k[:90], round(ms, 3), n] for k, ms, n in rows[:12]]})


def v3_boxes(backbone, bbox):
    """Text boxes (B, L, 4) followed by the visual tokens' boxes, as
    ``LayoutLMv3Model.forward`` concatenates them."""
    import torch

    from peneo_tpu_torch.models.layoutlmv3 import visual_bbox

    vis = torch.from_numpy(visual_bbox(backbone.grid)).to(bbox.device)
    return torch.cat([bbox.long(),
                      vis[None].expand(bbox.shape[0], -1, -1)], dim=1)


def phase_parity(svc, img_dir, ocr_dir, v3=False):
    import numpy as np
    import torch

    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    ids, bbox, attn = (torch.from_numpy(np.stack([p[0][k] for p in pages]))
                       .cuda() for k in ("input_ids", "bbox", "attention_mask"))
    kw = {}
    if v3:  # the raw uint8 pages, normalized on the card as the service does
        from peneo_tpu_torch.data.image_processing import \
            device_image_normalize

        kw["image"] = device_image_normalize(torch.from_numpy(
            np.stack([p[0]["image"] for p in pages])).cuda(), svc.info.family)
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
    emit({"phase": "parity_v3" if v3 else "parity", "rel_err": rel,
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
    emit({"phase": "train", "steps": TRAIN_STEPS, "batch_size": TRAIN_B,
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
          "wall_seconds": wall, "served_pages": len(served)})
    return launches, out


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


def phase_train_parity(ops, model, batch, v3=False):
    """One training step's loss and gradients from the same weights and
    seeds: through the kernels, through the plain twins, and through the
    forward kernel with the twin's backward. The last pair differs only in
    the backward kernel's arithmetic; the first also in the forwards'
    rounding. ``ops`` is the family's kernel module: BiACM (kernels #2/#3),
    or with ``v3`` rel-bias (kernels #5/#6), where the three bucket tables'
    gradients are compared too."""
    import torch

    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    proj = ("query", "key", "value") if v3 else (
        "query", "key", "value", "layout_query", "layout_key", "layout_value")
    last = model.cfg.backbone().num_hidden_layers - 1
    weights = {f"layer{i}.{n}":
               f"backbone.encoder.layer.{i}.attention.self.{n}.weight"
               for i in (0, last) for n in proj}
    weights["combine_fc"] = \
        "peneo_decoder.handshaking_kernel.combine_fc.weight"
    if v3:
        weights.update({n: f"backbone.encoder.{n}.weight" for n in
                        ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias")})
    bwd_name = ("bias_attention_train_bwd_cuda" if v3
                else "biacm_attention_train_bwd_cuda")
    layers = model.backbone.encoder.layer
    keys = {}
    hooks = [layers[i].attention.self.key.register_forward_hook(
        lambda mod, inp, out, i=i: keys.__setitem__(i, out.detach()))
        for i in (0, last)]
    kernel_bwd = getattr(ops, bwd_name)
    res = {}
    try:
        for run in ("kernel", "plain", "twin_backward"):
            model.load_state_dict(state0)
            model.set_attention_impl("plain" if run == "plain" else "kernel")
            if run == "twin_backward":
                setattr(ops, bwd_name, bias_twin_backward(ops) if v3
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
                        {k: params[n].grad.clone()
                         for k, n in weights.items()})
            if run == "kernel":
                spread = {f"layer{i}": key_spread(k, batch["attention_mask"])
                          for i, k in keys.items()}
    finally:
        setattr(ops, bwd_name, kernel_bwd)
        for hook in hooks:
            hook.remove()
        model.set_attention_impl("kernel")
        model.load_state_dict(state0)

    def rel_errs(other):
        (la, ga), (lb, gb) = res["kernel"], res[other]
        rel = {"loss_total": abs(la - lb) / abs(lb)}
        for k in weights:
            rel[k] = ((ga[k] - gb[k]).norm() / gb[k].norm()).item()
        return rel

    path, backward = rel_errs("plain"), rel_errs("twin_backward")
    tol = {k: TRAIN_GRAD_TOL for k in weights}
    tol.update({f"layer{last}.{n}": PATH_QK_TOL for n in ("query", "key")})
    emit({"phase": "train_parity_v3" if v3 else "train_parity",
          "loss": {run: res[run][0] for run in res},
          "rel_err": path, "rel_err_backward_only": backward,
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


def phase_train_breakdown(model, batch, profile_dir, v3=False):
    """Where one training step's device time goes (torch.profiler,
    device-side events only). ``v3``: LayoutLMv3 (kernels #5/#6); also
    times the relative-bias build and the bucket tables' gradient (the
    backward of ``RelBias``) on their own."""
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
    rows, device_ms = device_rows(prof, wall_ms, profile_dir,
                                  "train_v3_step" if v3 else "train_step")
    stem = "bias_train_" if v3 else "biacm_train_"
    mask_stem = "bias_keep_mask" if v3 else "biacm_keep_mask"
    fwd_ms = sum(r[1] for r in rows if stem + "fwd" in r[0]
                 or mask_stem in r[0])
    bwd_ms = sum(r[1] for r in rows if stem + "dkdv" in r[0]
                 or stem + "dq" in r[0])
    extra = {}
    if v3:
        bb = model.backbone
        bbox = v3_boxes(bb, batch["bbox"])
        tables = [bb.encoder.rel_pos_bias.weight,
                  bb.encoder.rel_pos_x_bias.weight,
                  bb.encoder.rel_pos_y_bias.weight]
        rel = bb.rel_bias(bbox, L, N_VIS)
        upstream = torch.randn(rel.shape, device="cuda")
        extra = {
            "rel_bias_build_ms": time_ms(
                lambda: bb.rel_bias(bbox, L, N_VIS)),
            "table_grad_ms": time_ms(lambda: torch.autograd.grad(
                rel, tables, upstream, retain_graph=True))}
        del rel, upstream
    emit({"phase": "train_breakdown_v3" if v3 else "train_breakdown",
          "batch_size": TRAIN_B, "L": L, **extra,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": device_ms,
          "train_fwd_kernel_ms": fwd_ms, "train_bwd_kernels_ms": bwd_ms,
          "train_kernels_share": (fwd_ms + bwd_ms) / device_ms,
          "device_idle_share": 1 - device_ms / wall_ms,
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
    """L' = 709 with the last 100 text keys of half the rows masked (the
    visual keys after them stay live), 128, and a ragged 200."""
    return {
        LV: [(r, slice(L - 100, L)) for r in range(0, batch, 2)],
        128: [(r, slice(128 - 17, 128)) for r in range(1, batch, 2)],
        200: [(0, slice(0, 80))] + [(r, slice(200 - 37, 200))
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


def phase_kernel_bias(rb, peaks):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    scale = 1.0 / 8.0
    errs, timing = {}, {}
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
        if length != LV:
            continue
        # the kernel at the main path's (padded) stride and at the natural
        # one; the library call: one additive bf16 mask, at its natural row
        # stride (709 · 2 bytes, not 16-byte aligned) and at a padded one
        full = (natural + mask[:, None, None, :]).to(torch.bfloat16)
        padded = padded_rows(full)

        def kernel(b=bias):
            return rb.bias_attention_cuda(q, k, v, b, mask, scale)

        def sdpa(m):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m)

        sdpa_err = (sdpa(full).float() - want).abs().max().item()
        timing = {
            "ms": time_ms(kernel),
            "device_ms": device_ms(kernel),
            "natural_stride_device_ms": device_ms(lambda: kernel(natural)),
            "plain_ms": time_ms(lambda: rb.bias_attention_reference(
                q, k, v, natural, mask, scale)),
            "library_ms": time_ms(lambda: sdpa(full)),
            "library_device_ms": device_ms(lambda: sdpa(full)),
            "library_padded_stride_ms": time_ms(lambda: sdpa(padded)),
            "library_padded_stride_device_ms": device_ms(
                lambda: sdpa(padded)),
            "library_backends": {
                "natural_stride": sdpa_backends(lambda: sdpa(full)),
                "padded_stride": sdpa_backends(lambda: sdpa(padded))},
            "sdpa_max_abs_err": sdpa_err,
        }
        del full, padded, bias
    # least time for one serving-shape call: q/k/v, the bias and the mask
    # read once, the output written once, vs the FLOPs of the 2 products
    bound = bound_of(4 * B * NH * LV * 64 * 2 + B * NH * LV * LV * 4
                     + B * LV * 4, 4 * B * NH * LV * LV * 64, peaks)
    emit({"phase": "kernel_bias", "max_abs_err": errs, "tol": KERNEL_TOL,
          "shape": [B, NH, LV, 64], **timing, **bound})
    return max(errs.values()), timing, bound


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

    # timings at the training shape, with the main path's in-kernel bits and
    # bias layout (and device times at the natural stride)
    (q, k, v), natural, mask = bias_inputs(bt, LV, cases[LV], gen)
    bias = relbias_layout(natural)
    dctx = out_grad(LV)
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
        "fwd_ms": time_ms(fwd), "fwd_device_ms": device_ms(fwd),
        "bwd_ms": time_ms(bwd), "bwd_device_ms": device_ms(bwd),
        "fwd_rate0_ms": time_ms(lambda: fwd(0.0)),
        "fwd_rate0_device_ms": device_ms(lambda: fwd(0.0)),
        "bwd_rate0_device_ms": device_ms(lambda: bwd(0.0)),
        "fwd_natural_stride_device_ms": device_ms(lambda: fwd(b=natural)),
        "bwd_natural_stride_device_ms": device_ms(lambda: bwd(b=natural)),
    }
    bits = ba.element_dropout_bits(SEED, bt, NH, LV, "cuda")
    timing["plain_fwd_ms"] = time_ms(
        lambda: rb.bias_attention_train_reference(q, k, v, natural, mask,
                                                  bits, scale, DROP))
    leaves = [x.detach().requires_grad_() for x in (q, k, v, natural)]
    out = rb.bias_attention_train_reference(*leaves, mask, bits, scale, DROP)
    timing["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        out, leaves, dctx, retain_graph=True))
    del out, leaves, bits
    # the library call (no dropout), its mask trained as the bias is
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    full = (natural + mask[:, None, None, :]).to(torch.bfloat16)
    backends = {}
    for label, m in (("natural_stride", full),
                     ("padded_stride", padded_rows(full))):
        m = m.detach().requires_grad_()

        def sdpa(m=m):
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m)

        def fwd_bwd(m=m):
            return torch.autograd.grad(sdpa(), (ql, kl, vl, m), dctx)

        tag = "" if label == "natural_stride" else "_padded_stride"
        with torch.no_grad():
            timing[f"library{tag}_fwd_ms"] = time_ms(sdpa)
            timing[f"library{tag}_fwd_device_ms"] = device_ms(sdpa)
        o = sdpa()

        def library_bwd(o=o, m=m):
            return torch.autograd.grad(o, (ql, kl, vl, m), dctx,
                                       retain_graph=True)

        timing[f"library{tag}_bwd_ms"] = time_ms(library_bwd)
        timing[f"library{tag}_bwd_device_ms"] = device_ms(library_bwd)
        del o
        backends[label] = sdpa_backends(fwd_bwd)
    timing["library_backends_fwd_bwd"] = backends
    del full

    qkv_bytes = bt * NH * LV * 64 * 2            # one of q, k, v, ctx, dctx…
    bias_bytes = bt * NH * LV * LV * 4
    small = bt * LV * 4 + bt * NH * LV * 2 * 4   # mask, statistics
    keep_bytes = keep.numel() * 4                # the packed keep flags
    bounds = {
        # reads q/k/v, bias, mask; writes ctx, the statistics, the flags
        "fwd": bound_of(4 * qkv_bytes + bias_bytes + small + keep_bytes,
                        4 * bt * NH * LV * LV * 64, peaks),
        # reads q/k/v, dctx, bias, mask, statistics, the flags; writes
        # dq/dk/dv, dbias
        "bwd": bound_of(7 * qkv_bytes + 2 * bias_bytes + small + keep_bytes,
                        5 * 2 * bt * NH * LV * LV * 64, peaks),
    }
    emit({"phase": "kernel_bias_train", "fwd_max_abs_err": fwd_err,
          "grad_max_abs_err": grad_abs, "grad_rel_err": grad_rel,
          "tol": TRAIN_KERNEL_TOL, "kept_share": kept, "rate": DROP,
          "packed_keep_flags_equal": packed_checked,
          "keep_flags_bytes": keep_bytes,
          "shape": [bt, NH, LV, 64], **timing, "bounds": bounds})
    errors = {"fwd_max_abs_err": max(fwd_err.values()),
              "grad_max_abs_err": max(grad_abs.values()),
              "grad_max_rel_err": max(max(r.values())
                                      for r in grad_rel.values())}
    return errors, timing, bounds


def write_model_v3(wdir):
    """layoutlmv3-base-chinese geometry (LayoutLMv3Config defaults at vocab
    250002, pad_token_id 1) + PEneo decoder with seeded random weights →
    wdir; dropout 0.1 and the decoder's ×30 learning rate for the train
    phase (serving runs in eval mode)."""
    import torch

    from peneo_tpu_torch.config import LayoutLMv3Config, PEneoConfig
    from peneo_tpu_torch.data.synthetic import ToyTokenizer
    from peneo_tpu_torch.models.peneo import PEneoModel

    tok = ToyTokenizer(vocab_size=250002)
    cfg = PEneoConfig(
        backbone_name="layoutlmv3-base-chinese",
        backbone_config=LayoutLMv3Config(
            vocab_size=250002, max_position_embeddings=L + 8,
            pad_token_id=1, hidden_dropout_prob=DROP,
            attention_probs_dropout_prob=DROP).to_dict(),
        max_seq_len=L, peneo_category_weights=[1.0, 10.0, 10.0],
        peneo_downstream_speedup_ratio=30.0)
    model = PEneoModel(cfg).init_weights(
        torch.Generator().manual_seed(SEED + 1))
    cfg.save_pretrained(wdir)
    tok.save_pretrained(wdir)
    torch.save(model.state_dict(), os.path.join(wdir, "pytorch_model.bin"))
    return sum(p.numel() for p in model.parameters())


def phase_serve_v3(rb, ba, tmp, img_dir, ocr_dir):
    """The 96 pages of the serve phase through the LayoutLMv3 service."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    wdir = os.path.join(tmp, "model_v3")
    t0 = time.perf_counter()
    n_params = write_model_v3(wdir)
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
    emit({"phase": "serve_v3", "params": n_params, "pages": run["pages"],
          "batch_size": B, "L": L, "attention_length": LV,
          "dtype": "bfloat16", "setup_seconds": setup_s,
          "seconds": run["seconds"],
          "pages_per_s": run["pages"] / run["seconds"],
          "warm_pages_per_s": statistics.median(warm),
          "warm_pages_per_s_runs": warm,
          "preprocess_ms_per_page": prep_ms,
          "image": [str(image.dtype), *image.shape],
          "max_memory_allocated": peak,
          "kernel_launches": launches, "forwards": n_forwards,
          "launches_per_forward": launches / n_forwards,
          "mean_tokens_per_page": sum(p[3] for p in pages) / len(pages),
          "kv_pairs": sum(len(r["kv_pairs"]) for r in results.values()),
          "lines": sum(len(r["lines"]) for r in results.values())})
    return svc, wdir, launches


def phase_train_v3(rb, ba, tmp, wdir):
    """LayoutLMv3 fine-tuning through the port's CLI, in process, from the
    saved full-width model on the synthetic corpus with rendered pages."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.infer import InferenceService

    out = os.path.join(tmp, "train_v3")
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
    img_dir = os.path.join(tmp, "one_img_v3")
    ocr_dir = os.path.join(tmp, "one_ocr_v3")
    write_pages(img_dir, ocr_dir, n_pages=1)
    svc = InferenceService(out, batch_size=1, dtype="bfloat16")
    rb.bias_attention_cuda.launches = 0
    served = svc.run(img_dir, ocr_dir)
    torch.cuda.synchronize()
    if rb.bias_attention_cuda.launches != layers or len(served) != 1:
        raise RuntimeError(f"the trained model served {len(served)} pages "
                           f"with {rb.bias_attention_cuda.launches} "
                           "launches of kernel #4")
    emit({"phase": "train_v3", "steps": TRAIN_STEPS, "batch_size": TRAIN_B,
          "L": L, "attention_length": LV, "dropout": DROP,
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
          "wall_seconds": wall, "served_pages": len(served)})
    return launches, out


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
    args = p.parse_args(argv)

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

    def timed(name, fn, *a, **kw):
        """Run one phase and print its seconds."""
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
        return out

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
    bias_err, bias_timing, bias_bound = timed(
        "kernel_bias", phase_kernel_bias, rb, peaks)
    bias_train_err, bias_train_timing, bias_train_bounds = timed(
        "kernel_bias_train", phase_kernel_bias_train, rb, ba, peaks)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-", dir=BUILD_DIR) as tmp:
        svc, img_dir, ocr_dir, docs, launches = timed(
            "serve", phase_serve, ba, tmp)
        timed("parity", phase_parity, svc, img_dir, ocr_dir)
        timed("decode", phase_decode, svc, img_dir, ocr_dir, docs)
        timed("breakdown", phase_breakdown, svc, img_dir, ocr_dir,
              args.profile)
        del svc
        train_launches, train_out = timed("train", phase_train, ba, tmp)
        model, batch = train_batch(train_out)
        timed("train_parity", phase_train_parity, ba, model, batch)
        timed("train_breakdown", phase_train_breakdown, model, batch,
              args.profile)
        del model, batch
        torch.cuda.empty_cache()

        svc, wdir_v3, bias_launches = timed(
            "serve_v3", phase_serve_v3, rb, ba, tmp, img_dir, ocr_dir)
        timed("parity_v3", phase_parity, svc, img_dir, ocr_dir, v3=True)
        timed("breakdown_v3", phase_breakdown, svc, img_dir, ocr_dir,
              args.profile, v3=True)
        del svc
        torch.cuda.empty_cache()
        bias_train_launches, train_out = timed(
            "train_v3", phase_train_v3, rb, ba, tmp, wdir_v3)
        model, batch = train_batch(train_out)
        timed("train_parity_v3", phase_train_parity, rb, model, batch,
              v3=True)
        timed("train_breakdown_v3", phase_train_breakdown, model, batch,
              args.profile, v3=True)
        del model, batch

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
