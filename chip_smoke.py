#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (peneo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises; exit code != 0):

1. device  — requires CUDA; prints ``nvidia-smi`` name and power limit.
2. build   — builds both CUDA libraries from ``peneo_tpu_torch/csrc`` (one
   nvcc each, started together) and prints their ptxas reports.
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
   own max |reference|; the kept share of each stream and the share where
   the two differ; timings at the training shape.
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
12. the ``kernels`` line, then the final ``{"ok": true, ...}`` line.
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
# backward on kernel #2's forward.
PATH_QK_TOL = 3e-2
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


def bound_of(n_bytes, flops, peaks):
    """The least time of a call: its bytes at the memory rate or its bf16
    tensor-core FLOPs at the peak rate, whichever is larger."""
    _, peak_flops, peak_bw = peaks
    t_bytes, t_flops = n_bytes / peak_bw * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": n_bytes, "flops": flops}


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
        timing = {
            "ms": time_ms(lambda: ba.biacm_attention_cuda(*args)),
            "plain_ms": time_ms(lambda: ba.biacm_attention_reference(*args)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q80, k80, v80, attn_mask=mask, scale=1.0)),
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


def phase_breakdown(svc, img_dir, ocr_dir, profile_dir):
    """Where one batch's time goes: host preprocess per page, the forward's
    enqueue and wall time (host clock to the fetched outputs), and the
    device time by kernel from torch.profiler."""
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
                                  "serve_forward")
    attn_ms = sum(r[1] for r in rows if "biacm" in r[0])
    emit({"phase": "breakdown", "batch_size": B, "L": L,
          "preprocess_ms_per_page": prep_ms,
          "forward_enqueue_ms": statistics.median(enqueue),
          "forward_wall_ms": statistics.median(wall),
          "profiled_forward_wall_ms": prof_wall_ms,
          "device_busy_ms": device_ms, "biacm_attention_ms": attn_ms,
          "device_idle_share": 1 - device_ms / prof_wall_ms,
          "top_kernels": [[k[:90], round(ms, 3), n] for k, ms, n in rows[:12]]})


def phase_parity(svc, img_dir, ocr_dir):
    import numpy as np
    import torch

    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    ids, bbox, attn = (torch.from_numpy(np.stack([p[0][k] for p in pages]))
                       .cuda() for k in ("input_ids", "bbox", "attention_mask"))
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            svc.model.set_attention_impl(impl)
            hidden = svc.model.backbone(ids, bbox, attn)["last_hidden_state"]
            logits = svc.model(ids, bbox, attn, return_logits=True)[
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
    emit({"phase": "parity", "rel_err": rel, "tol": PARITY_TOL,
          "shape": list(ids.shape)})


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

    fwd_err, grad_abs, grad_rel = {}, {}, {}
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
    stats = ba.biacm_attention_train_fwd_cuda(*args)[2]
    timing = {
        "fwd_ms": time_ms(lambda: ba.biacm_attention_train_fwd_cuda(*args)),
        "bwd_ms": time_ms(lambda: ba.biacm_attention_train_bwd_cuda(
            *qkv, bias, SEED, stats, *dctx, st, sl, DROP)),
        "fwd_rate0_ms": time_ms(lambda: ba.biacm_attention_train_fwd_cuda(
            *qkv, bias, SEED, st, sl, 0.0)),
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

    def sdpa():
        return F.scaled_dot_product_attention(q80, k80, v80, attn_mask=mask,
                                              scale=1.0)

    with torch.no_grad():
        timing["library_fwd_ms"] = time_ms(sdpa)
    o80 = sdpa()
    timing["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        o80, (q80, k80, v80), d80, retain_graph=True))
    timing["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa(), (q80, k80, v80), d80))
    del o80

    io = bt * NH * L * (3 * 64 + 3 * 16) * 2     # q/k/v of both streams
    ctx_bytes = bt * NH * L * (64 + 16) * 2
    stats_bytes = bt * NH * L * 2 * 4
    bounds = {
        "fwd": bound_of(io + bt * L * 4 + ctx_bytes + stats_bytes,
                        4 * bt * NH * L * L * 80, peaks),
        # reads q/k/v, bias, dctx, stats; writes the six gradients
        "bwd": bound_of(io + bt * L * 4 + ctx_bytes + stats_bytes + io,
                        5 * 2 * bt * NH * L * L * 80, peaks),
    }
    emit({"phase": "kernel_train", "fwd_max_abs_err": fwd_err,
          "grad_max_abs_err": grad_abs, "grad_rel_err": grad_rel,
          "tol": TRAIN_KERNEL_TOL, "kept_share": kept,
          "streams_differ_share": differ, "rate": DROP,
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
    gradients at the same inputs and dropout bits, so that a run keeps
    kernel #2's forward and takes the twin's backward."""
    import torch

    def bwd(q_t, k_t, v_t, q_l, k_l, v_l, bias, rng, stats, dct, dcl,
            scale_t, scale_l, rate=0.0):
        B, nh, length, _ = q_t.shape
        bits = None
        if rate > 0.0:
            bits = tuple(rng) if isinstance(rng, (tuple, list)) else \
                ba.attention_dropout_bits(rng, B, nh, length, q_t.device)
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
    m = attention_mask.float()[:, :, None, None]
    mean = (k * m).sum(1, keepdim=True) / m.sum(1, keepdim=True)
    rms = (((k - mean) ** 2).sum(-1, keepdim=True) * m).sum(1) \
        / m.sum(1)
    return torch.median(rms.sqrt().squeeze(-1)
                        / mean.norm(dim=-1).squeeze(1)).item()


def phase_train_parity(ba, model, batch):
    """One training step's loss and gradients from the same weights and
    seeds: through the kernels, through the plain twins, and through kernel
    #2's forward with the twin's backward. The last pair differs only in
    kernel #3's arithmetic; the first also in the forwards' rounding."""
    import torch

    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    proj = ("query", "key", "value", "layout_query", "layout_key",
            "layout_value")
    last = model.cfg.backbone().num_hidden_layers - 1
    weights = {f"layer{i}.{n}":
               f"backbone.encoder.layer.{i}.attention.self.{n}.weight"
               for i in (0, last) for n in proj}
    weights["combine_fc"] = \
        "peneo_decoder.handshaking_kernel.combine_fc.weight"
    layers = model.backbone.encoder.layer
    keys = {}
    hooks = [layers[i].attention.self.key.register_forward_hook(
        lambda mod, inp, out, i=i: keys.__setitem__(i, out.detach()))
        for i in (0, last)]
    kernel_bwd = ba.biacm_attention_train_bwd_cuda
    res = {}
    try:
        for run in ("kernel", "plain", "twin_backward"):
            model.load_state_dict(state0)
            model.set_attention_impl("plain" if run == "plain" else "kernel")
            if run == "twin_backward":
                ba.biacm_attention_train_bwd_cuda = twin_backward(ba)
            model.train()
            model.zero_grad(set_to_none=True)
            torch.manual_seed(SEED)
            gen = torch.Generator().manual_seed(SEED)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                losses = model(batch["input_ids"], batch["bbox"],
                               batch["attention_mask"],
                               labels=batch["labels"], generator=gen)
            losses["total"].backward()
            params = dict(model.named_parameters())
            res[run] = (losses["total"].item(),
                        {k: params[n].grad.clone()
                         for k, n in weights.items()})
            if run == "kernel":
                spread = {f"layer{i}": key_spread(k, batch["attention_mask"])
                          for i, k in keys.items()}
    finally:
        ba.biacm_attention_train_bwd_cuda = kernel_bwd
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
    emit({"phase": "train_parity",
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
                           f"kernel #3 vs the twin's backward {backward}")


def phase_train_breakdown(model, batch, profile_dir):
    """Where one training step's device time goes (torch.profiler,
    device-side events only)."""
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
    rows, device_ms = device_rows(prof, wall_ms, profile_dir, "train_step")
    fwd_ms = sum(r[1] for r in rows if "biacm_train_fwd" in r[0])
    bwd_ms = sum(r[1] for r in rows if "biacm_train_dkdv" in r[0]
                 or "biacm_train_dq" in r[0])
    emit({"phase": "train_breakdown", "batch_size": TRAIN_B, "L": L,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": device_ms,
          "train_fwd_kernel_ms": fwd_ms, "train_bwd_kernels_ms": bwd_ms,
          "train_kernels_share": (fwd_ms + bwd_ms) / device_ms,
          "device_idle_share": 1 - device_ms / wall_ms,
          "top_kernels": [[k[:90], round(ms, 3), n] for k, ms, n in rows[:15]]})


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
    build_libraries([ba.SOURCE, ba.TRAIN_SOURCE])  # one nvcc each, at once
    ba.load_kernel()
    ba.load_train_kernel()
    ptxas = {src: [ln.strip() for ln in build_log(src).splitlines()
                   if "registers" in ln or "spill" in ln
                   or "entry function" in ln]
             for src in (ba.SOURCE, ba.TRAIN_SOURCE)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    max_err, timing, bound = phase_kernel(ba, peaks)
    train_err, train_timing, train_bounds = phase_kernel_train(ba, peaks)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-", dir=BUILD_DIR) as tmp:
        svc, img_dir, ocr_dir, docs, launches = phase_serve(ba, tmp)
        phase_parity(svc, img_dir, ocr_dir)
        phase_decode(svc, img_dir, ocr_dir, docs)
        phase_breakdown(svc, img_dir, ocr_dir, args.profile)
        del svc
        train_launches, train_out = phase_train(ba, tmp)
        model, batch = train_batch(train_out)
        phase_train_parity(ba, model, batch)
        phase_train_breakdown(model, batch, args.profile)

    train_src = "peneo_tpu_torch/csrc/biacm_attention_train.cu"
    emit({"kernels": [{
        "name": "biacm_attention", "route": "cuda",
        "source": "peneo_tpu_torch/csrc/biacm_attention.cu",
        "replaces": "peneo_tpu/ops/biacm_attention.py:49",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": timing["library_ms"],
        "us": timing["ms"] * 1e3, "plain_us": timing["plain_ms"] * 1e3,
        "sdpa_us": timing["library_ms"] * 1e3}, {
        "name": "biacm_attention_train_fwd", "route": "cuda",
        "source": train_src,
        "replaces": "peneo_tpu/ops/biacm_attention.py:295",
        "launches": train_launches["fwd"],
        "max_abs_err": train_err["fwd_max_abs_err"],
        "ms": train_timing["fwd_ms"], "plain_ms": train_timing["plain_fwd_ms"],
        "bound_ms": train_bounds["fwd"]["bound_ms"],
        "bound_by": train_bounds["fwd"]["bound_by"],
        "library_ms": train_timing["library_fwd_ms"]}, {
        "name": "biacm_attention_train_bwd", "route": "cuda",
        "source": train_src,
        "replaces": "peneo_tpu/ops/biacm_attention.py:327",
        "launches": train_launches["bwd"],
        # over the six gradients; the gate is each one's error over its
        # own max |reference| (max_rel_err)
        "max_abs_err": train_err["grad_max_abs_err"],
        "max_rel_err": train_err["grad_max_rel_err"],
        "ms": train_timing["bwd_ms"], "plain_ms": train_timing["plain_bwd_ms"],
        "bound_ms": train_bounds["bwd"]["bound_ms"],
        "bound_by": train_bounds["bwd"]["bound_by"],
        "library_ms": train_timing["library_bwd_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
