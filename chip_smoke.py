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
   And one page of L = 4096 (B = 1, the last 300 keys masked: the long
   pages of serve_sp_long) against the twin, with its time and bound.
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
   same weights bit for bit and serves the first 32 pages to the same records
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
- serve_v3_procs — LayoutLMv3-base over 192 pages (the 96 under 2
   names): 4 threads, then min(8, cpu_count) spawned preprocessing
   processes; whole-run pages/s, the pool's start time, the same records.
- serve_int8_v3 — one LayoutLMv3-base forward with both int8 switches:
   kernel #4 12 times behind the int8 projections, the int8 launches, the
   logits against bf16's within the backbone gate.

The serving artifact (after serve_api, and in the LayoutLMv3 path after
breakdown_v3; each resets every kernel count just before it):

- serve_artifact, serve_artifact_v3 — the family's operator
   (``peneo::biacm_attention`` or ``peneo::bias_attention``) on the card's
   tensors at the main path's shape passes ``torch.library.opcheck``'s
   schema and fake-tensor tests; the serving phase's model directory
   exported on the card (``export_artifact``, B = 32, L = 512, bf16; no
   launch during the export; the graph holds the operator), loaded into
   ``ArtifactInferenceService`` and run over the 96 pages: #1 (or #4) 12
   times a forward, the records of the live service on every page, one
   batch's spots bit-identical to the live forward's (otherwise
   ``spot_gate``), ``check_run_artifact`` printing ``End``. Prints the
   export, save and load seconds, the ``.pt2`` bytes, warm pages/s and one
   batch's forward wall ms beside the live service's, and the operator's
   host ms per call in one batch of each traced by ``utils/profiling.trace``.

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
   own; every launch's ranks start while the launch before runs, import
   torch and the port, make their context and wait for their spec), global
   B = 8 (4 a rank), L = 512, bf16, dropout 0: 4 steps of
   plain CE, then 4 of OHEM 128/512, each with an eval over the 16 dev pages
   listed twice and a save; the same global batches in this process. Gates:
   every step's loss within 1e-3 of the one process's and the same on both
   ranks; step 1's all-reduced gradient (layers 0 and 11's attention
   projections, combine_fc, the classifiers) within 1e-2 of each tensor's
   max |g|; both ranks' eval metrics alike, over 16 pages, equal to the one
   process's; kernel #2's flags at rate 0.1 differ between the ranks and
   equal the plain bits of each rank's offset seed; rank 0's saved weights
   are the ones it ended with, bit for bit, and serve the first 32 pages to
   the same records (the CE run over one NCCL rank at world 1, the one
   process's losses within 1e-6, is train_fsdp's DDP run). Any
   rank that fails or outlives its timeout fails the script (all ranks are
   killed). ms/step for the ranks and one process: between the logged
   steps, and steady (3 more steps on one batch after each CE run, past
   DDP's bucket rebuild at its second step).

Sequence parallelism (after train_dp; ``parallel/seq_parallel.py``: the
pair grid's rows over the ranks of an sp group, the backbone replicated;
each phase resets every kernel count just before it, in every process):

- train_sp — 2 ranks of ``run_rfund --distributed --sp 2`` (dp 1) on the
   card over gloo, LiLT-base, global B = 8, L = 512, bf16, dropout 0: 4
   steps of plain CE and 4 of OHEM 128/512, each with an eval of the 16
   dev pages (listed twice) and no save, against train_dp's one-process
   runs. Gates: each step's loss within 1e-3 of one process's and alike
   on both ranks; step 1's gradient within 1e-2 of each tensor's max;
   eval P/R/F1 equal to one process's and alike on both ranks; #2/#3 12
   times a step and #1 12 times an eval forward on each rank; kernel #2's
   flags at rate 0.1 under each rank's dp-index seed identical on both
   ranks and equal to that seed's bits. ms/step, peak per rank.
- serve_sp — 2 gloo ranks of ``InferenceService(dp=1, sp=2)``, LiLT-base
   at CUT_LAYERS, L = 512, B = 32, bf16, the first 32 pages (#1 4 times a
   forward on each rank, a record per page); one batch's merged spots
   against one
   process's (``spot_gate``: ``spot_count`` equal, the tags equal and the
   scores within 2e-2 where both keep a position, the k sorted scores
   within 2e-2, every spot clear of the k-th score by more than 2e-2 kept
   by both; at the k-th score sp keeps the lowest flat indices, one
   process's ``torch.topk`` an unspecified subset) and alike on both
   ranks; each rank's shard of the pair grid (device ms, profiled while
   the other rank waits), the decoder's device and wall ms with both ranks
   on the card and one batch's wall ms, beside one process's decoder and
   its grid whole and split in two shards in turns.
- serve_sp_long — LiLT-base widths and depth at 4098 positions, one
   random page of L = 4096 (B = 1): one process against the 2 sp ranks (run
   in serve_sp's launch); spots gated as serve_sp's, each head's
   ``spot_count`` apart by at most the positions whose two largest class
   probabilities in one process are within 1e-4 (bf16 rounding on
   near-ties of a random model, ``close_calls``); the same device ms and
   the forward's peak memory above the weights beside one process's.

Tensor parallelism (``parallel/tensor_parallel.py``: the backbones and
the pair head split Megatron-style, each rank on nh / tp = 6 heads; after
phase 25, each part resets every kernel count just before it, in every
process):

- kernel_tp (after phase 13) — kernels #1-#6 at 6 heads, at the main
   path's shapes otherwise (#1 and #4 at B = 32, #2/#3 and #5/#6 at B = 8
   and rates 0 and 0.1; #4-#6 at L' = 709 and 561 on the padded bias
   stride), each against its fp32 twin with the gates of phases 3, 4, 12
   and 13; each one's device ms.
- serve_tp, serve_tp_v3, serve_tp_v2 — 2 gloo ranks at tp 2, the first 32
   pages (one batch, for the script's time) at B = 32, L = 512, bf16, each
   family's serving model cut to CUT_LAYERS (one process's too):
   LiLT-base through ``serve --tp 2``,
   LayoutLMv3-base and LayoutXLM-base through ``InferenceService(tp=2)``
   (one launch). Gates: the first 4 pages' line-extraction logits within
   2e-2 (relative) of one process's, and no further from an fp32 forward
   of them through the plain twins than 1.5 times one process's; one
   batch's spots against one process's (``spot_gate``, as serve_sp's, its
   spot counts reported: a random model puts ~10^5 spots a head above
   zero and its class probabilities crowd the argmax tie, which bf16
   rounding in another summation order crosses); the 32 pages' records
   alike on both ranks (and what ``serve`` wrote); #1 (or #4) 4 times a
   forward on each rank, fed 6 heads. Prints ms per forward, a profiled
   forward's device, GEMM and copy ms per rank beside one process's,
   pages/s over the run and the peak per rank beside one process's; v3,
   v2: the bias build's ms and its bytes per rank, which must be half one
   process's.
- train_tp, train_tp_v3 — 2 gloo ranks of ``run_rfund --distributed --tp
   2``, B = 8, L = 512, bf16, dropout 0, 3 steps and an eval, each from
   the seeded random model of its serving phase at the decoder's own
   learning rate (LiLT-base on train_dp's corpus; LayoutLMv3-base on phase
   16's), against the same steps here and
   in fp32 through the plain twins (the exact reference). Gates: each
   step's loss and grad norm within 1e-3 of one process's, alike on both
   ranks; step 1's gathered gradient within 1e-2 of each tensor's max of
   one process's (layer 11's query and key 5e-2, train_sp's spread; v3's
   bucket tables, summed over tp, included); the largest loss and grad
   norm errors and each step-1 gradient's against the fp32 run within the
   same tolerance or no more than twice one process's; eval equal; #2/#3
   (or #5/#6) 12 + 12 times a step on each rank; the first layer's
   dropout flags at rate 0.1 under each (dp, tp) shard's seed equal that
   seed's bits, kept within 2e-3 of 0.9, and different on the two ranks.
   ms/step and the peak per rank.
- grid_tp — dp 1 × tp 2 × sp 2, 4 gloo ranks, LiLT-base: step 1's loss
   and gathered gradient under ``--tp 2 --sp 2`` from train_tp's model
   against its one process and fp32 run, gated as train_tp's; one batch's
   spots through ``InferenceService(tp=2, sp=2)`` against one process's
   (``spot_gate``), alike on all ranks; #1 12 times.

fsdp (``parallel/fsdp.py``: FSDP2 over the dp ranks, each leaf on the dim
JAX's ``param_shardings(fsdp=True)`` picks) and K steps per CUDA graph in
a process group (after phase 29; each resets every kernel count just
before it, in every process):

``--fsdp`` at dp 1 is off, as JAX's fsdp at dp 1, so FSDP2 runs on the
card only in the gloo ranks that share it. One NCCL rank (world 1) runs the
work of train_fsdp and train_graph_dp in one launch (``nccl_world1``), each
gated after it:

- train_fsdp — ``run_rfund --distributed --fsdp`` at world 1: train_dp's
   CE run (LiLT-base, B = 8, L = 512, bf16, dropout 0, 4 steps, an eval
   and a save), beside the same run without ``--fsdp`` (DDP at world 1,
   with train_dp's NCCL gate) and train_dp's one
   process. Gates: the flag left off (dp 1), each step's loss within 1e-6
   (relative) of one process's, the saved tensors within 1e-6 of one
   process's (each over its own max), #1-#3 as in one process. Steady
   ms/step and the peak (allocated, reserved) of each.
- train_fsdp_ranks — train_dp's 2 gloo ranks (sharing the card) run its
   CE run again at dp 2 with ``--fsdp`` after its CE and OHEM runs (gloo
   moves FSDP2's collectives of CUDA tensors through the host): losses
   within 1e-3 of one process's, alike on both ranks, #1-#3 as under DDP;
   the peak per rank beside train_dp's DDP ranks' and one process's.
- train_fsdp_v3 — (after train_tp, beside grid_tp's ranks) 2 gloo ranks
   sharing the card run
   train_tp_v3's run (LayoutLMv3-base from its seeded model, L' = 709, 3
   steps, an eval, a save) at dp 2 with ``--fsdp``: losses within 1e-3
   of train_tp_v3's one process, alike on both ranks, #4-#6 as in one
   process; the peak per rank.
- train_graph_dp — ``--steps_per_call 4`` in a process group, one NCCL
   rank, LiLT-base, the gradient mean of each step ``replica_mean_grads``
   (at world 1 it returns before any all-reduce: no NCCL kernel is
   captured): 4 of the trainer's K = 1 steps (DDP) against one replay from
   the same state at dropout 0 (train_graph_parity's gates), the replays'
   seeds the rank's (dp, tp) shard's and fresh on each replay; then 64
   steps at dropout 0.1 through the trainer (ms/step over steps 17-64
   beside train_graph's one process at K = 4 and train_fsdp's DDP at K =
   1, world 1) and one profiled replay: 48 launches of each of #2/#3's
   kernels, device busy, idle share and NCCL's ms.

The port's benches, driven in process (``bench`` after kernel_tp,
``sp_pair`` after serve_sp_long; each resets every kernel count just
before it and reads them just after):

- bench — ``python -m peneo_tpu_torch.bench`` (the counterpart of
   ``bench.py``) for LiLT-base, LayoutLMv3-base and LayoutXLM-base at B =
   32, L = 512, bf16, 16 iterations with one batch in flight: each prints
   the device, the run (forward wall ms, pages/s, launches a forward, the
   host syncs inside one forward) and JAX's last line; #1 (LiLT) or #4 12
   times a forward over every forward of the run, the other never; the
   last line's keys and metric name JAX's.
- sp_pair — ``python -m peneo_tpu_torch.bench_sp_pair`` (the counterpart
   of ``tools/bench_sp_pair.py``) at L = 2048 and 4096, B = 1, hidden 768,
   k 256, 8 iterations (the tool's 16, halved for the script's time): one
   sp rank's pair grid at size 1 with the bf16 and the int8 pair head, ms
   per batch and the int8 speed-up; the bf16 spots against the same
   decoder's one-process grid (``spot_gate``), the int8 spots' agreement
   with bf16 reported.

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
SERVE_REPEATS = 2  # runs of the 96 pages; the first one is checked
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
    # now and then a profile records no device row at all (seen on this
    # card between profiles that record them): profile again, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
        if total > 0:
            return total / n / 1e3
    raise RuntimeError("the profiler recorded no device time in 3 "
                       "profiles")


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


def attention_inputs(batch, length, masked, gen, nh=NH):
    """q/k/v as (B, nh, L, d) views of (B, L, nh, d) bf16 buffers (the LiLT
    layer's layout; a tp rank's ``nh`` = NH / tp) and the (B, L) fp32 key
    mask with ``masked`` keys of each listed row set to finfo(f32).min/2."""
    import torch

    def heads(d):
        x = torch.randn((batch, length, nh, d), generator=gen, device="cuda",
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
    bound = biacm_bound(B, L, peaks)
    long = kernel_long(ba, gen, peaks)
    errs[KERNEL_LONG_L] = long["max_abs_err"]
    emit({"phase": "kernel", "max_abs_err": errs, "tol": KERNEL_TOL,
          "shape": [B, NH, L, 64, 16], **timing, **bound,
          "long": long})
    return max(errs.values()), timing, bound


def biacm_bound(batch, length, peaks):
    """The least time of one kernel #1 call at (batch, NH, length): each
    input read once, each output written once, against the bf16
    tensor-core FLOPs of the 4 products."""
    return bound_of(batch * NH * length * (3 * 64 + 3 * 16) * 2
                    + batch * length * 4
                    + batch * NH * length * (64 + 16) * 2,
                    4 * batch * NH * length * length * (64 + 16), peaks)


# kernel #1 at the long pages serve_sp_long serves: one page of 4096 tokens,
# its last 300 keys masked (in-head offsets up to 4096 rows of nh·d = 768)
KERNEL_LONG_B, KERNEL_LONG_L = 1, 4096


def kernel_long(ba, gen, peaks):
    """Kernel #1 at (KERNEL_LONG_B, NH, KERNEL_LONG_L) with a masked tail
    against its fp32 twin (KERNEL_TOL); its events and device ms beside
    its bound."""
    import torch

    st, sl = 1.0 / 8.0, 1.0 / 4.0
    n = KERNEL_LONG_L
    qkv, bias = attention_inputs(KERNEL_LONG_B, n,
                                 [(0, slice(n - 300, n))], gen)
    args = (*qkv, bias, st, sl)
    ct, cl = ba.biacm_attention_cuda(*args)
    rt, rl = ba.biacm_attention_reference(*(x.float() for x in qkv), bias,
                                          st, sl)
    torch.cuda.synchronize()
    if not (torch.isfinite(ct).all() and torch.isfinite(cl).all()):
        raise RuntimeError(f"non-finite kernel output at L={n}")
    err = max((ct.float() - rt).abs().max().item(),
              (cl.float() - rl).abs().max().item())
    del rt, rl
    if err > KERNEL_TOL:
        raise RuntimeError(f"kernel vs plain twin at L={n}: max abs err "
                           f"{err:.3e} > {KERNEL_TOL}")
    return {"shape": [KERNEL_LONG_B, NH, n, 64, 16], "max_abs_err": err,
            "masked_keys": 300,
            "ms": time_ms(lambda: ba.biacm_attention_cuda(*args)),
            "device_ms": device_ms(lambda: ba.biacm_attention_cuda(*args)),
            **biacm_bound(KERNEL_LONG_B, n, peaks)}


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

def bias_inputs(batch, length, masked, gen, collinear=False, nh=NH):
    """q/k/v as (B, nh, L, 64) views of (B, L, nh, 64) bf16 buffers (the
    LayoutLMv3 layer's layout; a tp rank's ``nh`` = NH / tp), a random fp32
    (B, nh, L, L) bias (contiguous, rows of L floats) and the (B, L) fp32
    key mask with ``masked`` keys of each listed row set to
    finfo(f32).min/2. ``collinear``: every row close to the first token's
    (spread 0.1, halved to keep values O(1)), where dq and dk are small
    differences of large terms."""
    import torch

    def heads():
        x = torch.randn((batch, length, nh, 64), generator=gen, device="cuda")
        if collinear:
            x = 0.5 * (x[:, :1] + 0.1 * x)
        return x.to(torch.bfloat16).transpose(1, 2)

    qkv = [heads() for _ in range(3)]
    bias = torch.randn((batch, nh, length, length), generator=gen,
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
    LayoutLMv3, "v2": LayoutXLM): serve, parity, breakdown (v3: then
    serve_artifact_v3), then train, train_parity and train_breakdown.
    Returns its launch counts, the train phase's line and its output
    directory."""
    import torch

    v2 = tag == "v2"
    svc, wdir, serve_launches = timed(
        f"serve_{tag}", phase_serve_rel, rb, ba, tmp, img_dir, ocr_dir, v2)
    timed(f"parity_{tag}", phase_parity, svc, img_dir, ocr_dir, tag)
    timed(f"breakdown_{tag}", phase_breakdown, svc, img_dir, ocr_dir,
          profile_dir, tag)
    artifact = None
    if not v2:  # the LayoutLMv3 artifact against this live service
        artifact = timed("serve_artifact_v3", phase_serve_artifact, ba, rb,
                         tmp, svc, wdir, img_dir, ocr_dir, "v3")
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
            "wdir": wdir, "artifact": artifact}


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
# the pages each checkpoint format serves: one batch (96 until the artifact
# phases came, for the 1200 s)
CKPT_PAGES = B
LONG_REPEATS = 2  # serve_v3_procs: the 96 pages under this many names (4
# before the artifact phases came, for the 1200 s)


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
    each loads the same weights bit for bit and serves the first 32 pages to the
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
    img_dir, ocr_dir = first_pages(tmp, img_dir, ocr_dir, CKPT_PAGES, "ckpt")
    reset_counts(ba, rb)
    for name, d in dirs.items():
        svc = InferenceService(d, batch_size=B, dtype="bfloat16")
        records[name] = records_of(svc.run(img_dir, ocr_dir))
        del svc
    counts = read_counts(ba, rb)
    n_forwards = math.ceil(CKPT_PAGES / B)
    expect_counts(counts, {"biacm_attention": 12 * n_forwards * len(dirs)},
                  "serving the three files")
    ref = records["pytorch_model.bin"]
    if len(ref) != CKPT_PAGES or any(r != ref for r in records.values()):
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


def first_pages(tmp, img_dir, ocr_dir, n, tag):
    """Directories of symlinks to the serve phase's first ``n`` pages under
    their own names (a phase that serves one batch of them)."""
    dst = (os.path.join(tmp, f"{tag}_img"), os.path.join(tmp, f"{tag}_ocr"))
    for d in dst:
        os.makedirs(d)
    for i in range(n):
        for src, link in zip(page_paths(img_dir, ocr_dir, i),
                             page_paths(*dst, i)):
            os.symlink(src, link)
    return dst


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


# ------------------------------------------------------------------------
# the serving artifact: a torch.export program of the serving forward whose
# graph holds kernel #1 (LiLT) or #4 (v3) as a peneo:: custom operator
# ------------------------------------------------------------------------
def op_fake_check(ba, rb, tag):
    """The family's operator on the card's tensors at the main path's shape
    (B = 32, 12 heads; #4 on the padded bias): its fake gives the kernel's
    output layout (``torch.library.opcheck``'s schema and fake-tensor
    tests). Launches made here are not the path's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    masked = [(1, slice(L - 100, L))]
    if tag == "v3":
        qkv, bias, mask = bias_inputs(B, LV, masked, gen)
        args = (rb.bias_attention_op, (*qkv, relbias_layout(bias), mask,
                                       0.125))
    else:
        qkv, bias = attention_inputs(B, L, masked, gen)
        args = (ba.biacm_attention_op, (*qkv, bias, 0.125, 0.25))
    torch.library.opcheck(*args, test_utils=("test_schema",
                                             "test_faketensor"))


def phase_serve_artifact(ba, rb, tmp, svc, wdir, img_dir, ocr_dir, tag=""):
    """``serve_artifact`` (LiLT-base, kernel #1) or ``serve_artifact_v3``
    (LayoutLMv3-base, kernel #4): the serving phase's model directory
    exported on the card (``export_artifact``: B = 32, L = 512, bf16), then
    loaded back into ``ArtifactInferenceService``, which serves the 96
    pages (v3: fp32 page images normalized on the host, as the artifact
    takes them). Gates: the export launches no kernel and its graph holds
    the family's operator; the artifact's run launches the kernel 12 times
    a forward and nothing else; its records equal the live service's
    (``svc``) on every page, and one batch's spots are bit-identical to the
    live forward's (if not, each output's largest difference is printed and
    the spots go through ``spot_gate``); ``check_run_artifact`` ends with
    ``End``. Prints the seconds to export, save and load, the ``.pt2``
    bytes, warm pages/s and one batch's forward wall ms beside the live
    service's, and, from one batch of each under ``utils/profiling.trace``
    (which must write its trace file), the operator's host ms per call."""
    import contextlib
    import io

    import numpy as np
    import torch

    from peneo_tpu_torch.check_run_artifact import main as check_run
    from peneo_tpu_torch.export_artifact import export_artifact
    from peneo_tpu_torch.inference_artifact import ArtifactInferenceService
    from peneo_tpu_torch.models.decoder import HEAD_NAMES
    from peneo_tpu_torch.utils.profiling import trace

    kernel = "bias_attention" if tag else "biacm_attention"
    name = "serve_artifact" + (f"_{tag}" if tag else "")
    op_fake_check(ba, rb, tag)
    art = os.path.join(tmp, name)
    reset_counts(ba, rb)
    t0 = time.perf_counter()
    export_artifact(wdir, art, batch_size=B, max_seq_len=L)
    export_wall = time.perf_counter() - t0
    expect_counts(read_counts(ba, rb), {}, f"{name}: the export")
    with open(os.path.join(art, "artifact_meta.json")) as f:
        meta = json.load(f)
    if meta["kernels"] != [f"peneo::{kernel}"] or meta["device"] != "cuda":
        raise RuntimeError(f"{name}: artifact meta {meta}")
    t0 = time.perf_counter()
    art_svc = ArtifactInferenceService(art)
    load_s = time.perf_counter() - t0

    reset_counts(ba, rb)
    results = art_svc.run(img_dir, ocr_dir)
    counts = read_counts(ba, rb)
    n_forwards = math.ceil(N_PAGES / B)
    expect_counts(counts, {kernel: 12 * n_forwards}, name)
    warm = [art_svc.last_run["warm_pages"] / art_svc.last_run["warm_seconds"]]
    live = svc.run(img_dir, ocr_dir)
    live_warm = svc.last_run["warm_pages"] / svc.last_run["warm_seconds"]
    art_svc.run(img_dir, ocr_dir)
    warm.append(art_svc.last_run["warm_pages"]
                / art_svc.last_run["warm_seconds"])

    # one batch through both forwards, each service preprocessing its way
    art_pages = [art_svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                 for i in range(B)]
    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    with torch.inference_mode():
        got_dev = art_svc.dispatch_batch(art_pages)
        want_dev = svc.dispatch_batch(pages)
        got = {n: {k: v.cpu().numpy() for k, v in got_dev[n].items()}
               for n in HEAD_NAMES}
    want = svc._fetch(want_dev)
    diffs = {f"{n}.{k}": float(np.abs(got[n][k].astype(np.float64)
                                      - want[n][k]).max())
             for n in HEAD_NAMES for k in want[n]}
    bit_identical = all(np.array_equal(got[n][k], want[n][k])
                        for n in HEAD_NAMES for k in want[n])
    gate = None
    if not bit_identical:
        from peneo_tpu_torch.models.decoder import pack_spots

        errors, gate = spot_gate(
            [x.cpu() for x in svc.dispatch_batch(pages)],
            [x.cpu() for x in pack_spots(got_dev)],
            svc.cfg.max_spots_per_head)
        if errors:
            raise RuntimeError(f"{name}: spots differ from the live "
                               f"forward's: {errors} (diffs {diffs})")
    ours, theirs = records_of(results), records_of(live)
    records_equal = ours == theirs
    if not records_equal:
        differ = sum(ours.get(k) != r for k, r in theirs.items())
        raise RuntimeError(f"{name}: records differ from the live service's "
                           f"on {differ} of {len(theirs)} pages (one "
                           f"batch bit-identical: {bit_identical}, its "
                           f"differences {diffs})")

    reset_counts(ba, rb)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        check_run(art)
    check_counts = read_counts(ba, rb)
    lines = printed.getvalue().splitlines()
    if lines[-1:] != ["End"] or len(lines) != 6:
        raise RuntimeError(f"{name}: check_run_artifact printed {lines}")
    expect_counts(check_counts, {kernel: 12}, f"{name}: check_run_artifact")
    walls = {"forward_wall_ms": batch_wall_ms(art_svc, art_pages),
             "live_forward_wall_ms": batch_wall_ms(svc, pages)}
    # one batch of each under utils/profiling.trace: the operator's host
    # ms per call (the graph module against the live model)
    op_host_ms = {}
    for who, server, batch in (("artifact", art_svc, art_pages),
                               ("live", svc, pages)):
        logdir = os.path.join(tmp, f"{name}_{who}_trace")
        with trace(logdir) as prof:
            server._fetch(server.dispatch_batch(batch))
        if not [f for f in os.listdir(logdir)
                if f.endswith(".pt.trace.json")]:
            raise RuntimeError(f"{name}: trace wrote no file in {logdir}")
        ops = [e for e in prof.key_averages()
               if e.key == f"peneo::{kernel}"]
        op_host_ms[who] = (ops[0].self_cpu_time_total / 1e3 / ops[0].count
                           if ops else None)
    emit({"phase": name, "batch_size": B, "L": L, "dtype": "bfloat16",
          "export_seconds": meta["export_seconds"],
          "save_seconds": meta["save_seconds"],
          "export_artifact_wall_seconds": export_wall,
          "load_seconds": load_s,
          "pt2_bytes": os.path.getsize(os.path.join(art, "forward.pt2")),
          "kernels": meta["kernels"], "torch": meta["torch"],
          "pages": len(results), "forwards": n_forwards, "launches": counts,
          "records_equal_live": records_equal,
          "batch_bit_identical_live": bit_identical,
          "batch_max_abs_diff_live": diffs, "spot_gate": gate,
          "warm_pages_per_s_runs": warm, "live_warm_pages_per_s": live_warm,
          **walls, "op_host_ms_per_call": op_host_ms,
          "check_run_artifact": lines[-1]})
    del art_svc
    shutil.rmtree(art)
    torch.cuda.empty_cache()
    return counts


def phase_serve_v3_procs(ba, rb, tmp, img_dir, ocr_dir):
    """LayoutLMv3-base serving over 192 pages (the 96 under 2 names each),
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


# the depth of the gloo-rank serving phases (serve_tp*, serve_sp): 4 of the
# 12 layers at full width, their one-process references alike (12 before the
# bench phases came, for the 1200 s). A cut pays there: gloo's host sums of
# each layer take most of a tp rank's forward, and the reference runs in the
# phase anyway. train_dp (with train_fsdp_ranks and the NCCL world-1 runs),
# grid_tp and train_fsdp_v3 stay at full depth: cut, each needed a
# reference of its own at that depth (train_tp's and train_dp's are full),
# and the whole script measured 24, 4 and 3 s slower; train_tp and
# train_sp, whose bf16 gates have little headroom, stay at full depth too.
CUT_LAYERS = 4
LAYER_KEY = re.compile(r"(?:^|\.)encoder\.layer\.(\d+)\.")


def cut_model(tmp, name, model_dir):
    """``model_dir``'s model cut to its first CUT_LAYERS backbone layers,
    every other weight and the tokenizer as they are (its config with
    ``num_hidden_layers`` = CUT_LAYERS, its ``pytorch_model.bin`` without
    the deeper layers' tensors): written once under ``tmp`` as
    ``cut_<name>`` and shared by the phases that run it."""
    import torch

    dst = os.path.join(tmp, f"cut_{name}")
    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    for f in os.listdir(model_dir):
        src = os.path.join(model_dir, f)
        if f not in ("config.json", "pytorch_model.bin") \
                and os.path.isfile(src):
            os.symlink(os.path.realpath(src), os.path.join(dst, f))
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["backbone_config"]["num_hidden_layers"] = CUT_LAYERS
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    state = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                       weights_only=True)
    torch.save({k: v for k, v in state.items()
                if not (m := LAYER_KEY.search(k))
                or int(m.group(1)) < CUT_LAYERS},
               os.path.join(dst, "pytorch_model.bin"))
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


PROFILE_MARGIN_S = 0.05


def profiled_replay(step_fn, group, family, profile_dir, name, layers=12):
    """One replay of a K-step graph (``step_fn`` warmed and captured) under
    torch.profiler, expected to trace ``layers · GRAPH_K`` launches of each
    of ``family``'s kernels and none of the port's others. A trace has been
    seen to miss a replay's first kernels (47 of 48) when the replay began
    as the window opened, with 50 ms of idle host time before it too, so
    each window records the second of two replays (the profiler's warm-up
    step runs the first), with PROFILE_MARGIN_S of idle host time around
    each, and up to 3 windows are profiled, until one traces what is
    expected. Returns (device rows, busy ms, replay ms, each profiled
    replay's traced launches, the expected launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    for _ in range(3):
        replay_ms, got = [], []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.append(device_rows(
                         p, replay_ms[-1], profile_dir, name))) as prof:
            for _ in range(2):
                # the profiler drops device events it places outside its
                # window: idle host time at both ends keeps the replay in
                time.sleep(PROFILE_MARGIN_S)
                t0 = time.perf_counter()
                step_fn(group)
                torch.cuda.synchronize()
                replay_ms.append((time.perf_counter() - t0) * 1e3)
                time.sleep(PROFILE_MARGIN_S)
                prof.step()
        rows, busy_ms = got[0]
        traces.append(trace_launches(rows))
        want = {k: (layers * GRAPH_K if k in family else 0)
                for k in traces[-1]}
        if traces[-1] == want:
            break
    return rows, busy_ms, replay_ms[-1], traces, want


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
    family = STEP_KERNELS["rel" if tag else ""]
    rows, busy_ms, replay_ms, traces, want_traced = profiled_replay(
        step_fn, group, family, profile_dir, name, layers)
    traced = traces[-1]
    if traced != want_traced:
        raise RuntimeError(f"the profiled replays launched {traces}, "
                           f"expected {want_traced}")
    del model, group, optimizer, scheduler, step_fn
    torch.cuda.empty_cache()
    emit({"phase": name, "steps": GRAPH_STEPS, "steps_per_call": GRAPH_K,
          "batch_size": TRAIN_B, "L": L, "dropout": DROP,
          "wrapper_calls": launches, "replay_trace_launches": traced,
          "profiled_replays": len(traces),
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
DP_PAGES = B  # the pages train_dp's save serves (96 before the long-page
# phases came, for the 1200 s)


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
    11's attention projections of both streams and their output denses,
    combine_fc, every classifier layer and the rel-bias bucket tables."""
    names = [n for n, _ in model.named_parameters()]
    keep = []
    for n in names:
        if re.fullmatch(r"backbone\.encoder\.layer\.(0|11)\.attention\.self"
                        r"\.(layout_)?(query|key|value)\.weight", n) \
                or re.fullmatch(r"backbone\.encoder\.layer\.(0|11)\."
                                r"attention\.(layout_)?output\.dense\.weight",
                                n) \
                or n == "peneo_decoder.handshaking_kernel.combine_fc.weight" \
                or re.fullmatch(r"peneo_decoder\.\w+_fc\.\d+\.weight", n) \
                or n in {f"backbone.encoder.{t}.weight" for t in TABLES}:
            keep.append(n)
    return keep


def first_step_grads(argv):
    """One trainer step (``train_step``, under DDP in a process group) on
    the first global batch of ``run_rfund``'s arguments: the loss and the
    (all-reduced) gradients of :func:`probe_names`, on the CPU."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.parallel import tensor_parallel as tpar
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import DataFeed, batch_to_device
    from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

    args = run_rfund.build_argparser().parse_args(argv)
    cfg, model, train_ds, _, collator, _ = run_rfund.setup(args)
    trainer = PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                           train_ds, None, collator)
    feed = DataFeed(train_ds, collator, args.per_device_train_batch_size,
                    shuffle=True, seed=args.seed, rank=trainer.dp_rank,
                    world=trainer.dp)
    batch = batch_to_device(next(iter(feed)), trainer.device)
    metrics = T.train_step(trainer.step_model, trainer.optimizer,
                           trainer.scheduler, batch,
                           trainer.args.max_grad_norm, trainer.seeds,
                           trainer.dtype)
    params = dict(model.named_parameters())
    grads = {}
    for n in probe_names(model):  # a tp shard gathered (every rank calls)
        g = params[n].grad.detach()
        if n in trainer.splits:
            g = tpar.gather_tensor(g, trainer.splits[n], trainer.tp)
        grads[n] = g.float().cpu()
    loss = metrics["total"].item()
    del trainer, model, params, batch
    torch.cuda.empty_cache()
    return loss, grads


def rank_keep_flags(ba, rank, batch=TRAIN_B // DP_WORLD, nh=NH, rb=None):
    """Kernel #2's packed keep flags at rate DROP on fixed inputs of
    ``batch`` rows and ``nh`` heads with (dp, tp) shard ``rank``'s first
    layer seed (``HostSeeds`` of SEED); with ``rb`` kernel #5's at L' =
    LV."""
    import torch

    from peneo_tpu_torch.models.dropout_seeds import HostSeeds

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    seed = HostSeeds(torch.Generator().manual_seed(SEED), rank).layer(0)
    if rb is not None:
        qkv, bias, mask = bias_inputs(batch, LV, [(0, slice(400, L))], gen,
                                      nh=nh)
        keep = rb.bias_attention_train_fwd_cuda(
            *qkv, relbias_layout(bias), mask, seed, 0.125, DROP)[2]
        return seed, keep.cpu()
    qkv, bias = attention_inputs(batch, L, [(0, slice(400, None))], gen, nh)
    keep = ba.biacm_attention_train_fwd_cuda(*qkv, bias, seed, 0.125, 0.25,
                                             DROP)[3]
    return seed, keep.cpu()


STEADY_STEPS = 4  # train_dp: steps timed after a run, the first not counted
# (6 before the artifact phases came, for the 1200 s)


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
                    seed=args.seed, rank=trainer.dp_rank, world=trainer.dp)
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


# rank processes start ahead of their launch (the launch before them
# starts them as it starts): by the time a launch begins, its ranks have
# imported torch and the port and made their CUDA context, and wait for
# their spec; LAUNCHES is the order in which the script starts launches
LAUNCHES = (("train_dp", 2), ("train_sp", 2), ("serve_sp", 2),
            ("serve_tp", 2), ("train_tp", 2), ("train_fsdp_v3", 2),
            ("grid_tp", 4), ("nccl_world1", 1))
AHEAD = {}  # launch tag → (its rank processes, their logs)
RUNNING = {}  # launch tag → its rank processes, started and not joined
SPEC_WAIT = 1500  # seconds a rank started ahead waits for its spec


def spawn_ranks(tag, world, tmp):
    """Start ``world`` rank processes for the launch ``tag``, each with
    torchrun's environment but the port (:func:`await_spec`)."""
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost")
        logs.append(os.path.join(tmp, f"{tag}.rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker",
                 os.path.join(tmp, f"{tag}.rank{r}.spec")], env=env,
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True))
    AHEAD[tag] = (procs, logs)


def spawn_next(tag, tmp):
    """Start the ranks of the launch after ``tag`` in LAUNCHES (of the
    first, given None)."""
    tags = [t for t, _ in LAUNCHES]
    i = 0 if tag is None else tags.index(tag) + 1
    if i < len(LAUNCHES):
        spawn_ranks(*LAUNCHES[i], tmp)


def stop_ranks():
    """Kill every rank process this script started that is still alive:
    those started ahead that no launch took, and those of a launch that was
    not joined."""
    for procs in [p for p, _ in AHEAD.values()] + list(RUNNING.values()):
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    AHEAD.clear()
    RUNNING.clear()


def await_spec(path):
    """A rank started ahead of its launch: import what the workers import,
    make the CUDA context, then wait for the spec at ``path`` (written
    whole by the launch) and take its port."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch import run_rfund  # noqa: F401
    from peneo_tpu_torch.pipeline import infer, trainer  # noqa: F401

    torch.zeros(1, device="cuda")
    deadline = time.time() + SPEC_WAIT
    while not os.path.exists(path):
        if time.time() > deadline:
            raise SystemExit(f"no spec at {path} after {SPEC_WAIT} s")
        time.sleep(0.05)
    with open(path) as f:
        spec = json.load(f)
    os.environ["MASTER_PORT"] = str(spec["port"])
    return spec


def start_ranks(spec, world, tmp, tag):
    """Start the launch ``tag``: ``world`` rank processes of
    :func:`dp_worker` (or ``spec``'s worker), each with torchrun's
    environment on a free local port and its own CUDA context (started
    ahead when LAUNCHES names ``tag``), given their spec; then starts the
    next launch's ranks. :func:`join_ranks` waits for them."""
    if tag not in AHEAD:
        spawn_ranks(tag, world, tmp)
    procs, logs = AHEAD.pop(tag)
    if len(procs) != world:
        raise RuntimeError(f"{tag}: {len(procs)} ranks started, not {world}")
    RUNNING[tag] = procs
    port = free_port()
    results = []
    for r in range(world):
        rspec = dict(spec, result=os.path.join(tmp, f"{tag}.rank{r}.json"),
                     port=port)
        path = os.path.join(tmp, f"{tag}.rank{r}.spec")
        with open(path + ".part", "w") as f:
            json.dump(rspec, f)
        os.replace(path + ".part", path)
        results.append(rspec["result"])
    if tag in dict(LAUNCHES):
        spawn_next(tag, tmp)
    return {"tag": tag, "procs": procs, "logs": logs, "results": results,
            "deadline": time.time() + DP_TIMEOUT}


def join_ranks(launch):
    """A started launch's results in rank order. A rank that fails, or a
    launch that outlives DP_TIMEOUT, kills every rank and raises with their
    output's tail."""
    procs, logs, tag = launch["procs"], launch["logs"], launch["tag"]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, launch["deadline"] - time.time()))
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    except subprocess.TimeoutExpired:
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
        RUNNING.pop(tag, None)
    if failed:
        tails = []
        for r in failed:
            with open(logs[r]) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError(f"{tag}: rank(s) {failed} failed or timed out "
                           f"after {DP_TIMEOUT} s\n" + "\n".join(tails))
    out = []
    for path in launch["results"]:
        with open(path) as f:
            out.append(json.load(f))
    return out


def launch_ranks(spec, world, tmp, tag):
    """:func:`start_ranks`, then :func:`join_ranks`."""
    return join_ranks(start_ranks(spec, world, tmp, tag))


def step_ms(steps):
    """ms per step between the first and the last logged step."""
    return ((steps[-1]["time"] - steps[0]["time"])
            / (steps[-1]["step"] - steps[0]["step"]) * 1e3)


def rel_close(a, b, rtol):
    return all(abs(x - y) <= rtol * abs(y) for x, y in zip(a, b)) \
        and len(a) == len(b)


def dp_argv(model_dir, data, out, per_rank, *extra, steps=DP_STEPS):
    """``run_rfund``'s arguments of the data-, sequence- and
    tensor-parallel phases: ``steps`` steps, then an eval, then the model
    saved only when asked (``--do_train`` saves it); no checkpoint (3.3 GB
    with the optimizer's state: the machine's disk writes are bounded; the
    CPU tests check rank 0's checkpoints)."""
    return ["--synthetic_data", "--model_name_or_path", model_dir,
            "--data_dir", data, "--output_dir", out, "--do_train",
            "--max_steps", str(steps), "--max_seq_len", str(L),
            "--per_device_train_batch_size", str(per_rank),
            "--per_device_eval_batch_size", str(per_rank),
            "--logging_steps", "1", "--eval_steps", str(steps),
            "--save_steps", "0", "--seed", str(SEED), "--no_resume", *extra]


def phase_train_dp(ba, rb, tmp, train_out, img_dir, ocr_dir, smi):
    """Data-parallel fine-tuning of LiLT-base through ``run_rfund
    --distributed``: DP_WORLD ranks spawned with torchrun's environment
    (each its own CUDA context; over gloo when they share the card, NCCL
    when each has its own), global B = TRAIN_B, L = 512, bf16, dropout 0,
    DP_STEPS steps of plain CE, then of OHEM 128/512, each with an eval over
    the 16 dev pages listed twice and a save; the same global batches in
    one process (here). The ranks then run the CE run under ``--fsdp``
    (train_fsdp_ranks reads it); one NCCL rank (world 1) of the CE run is
    train_fsdp's DDP run (``phase_nccl_world1``), gated there."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.infer import InferenceService

    data = dp_data_dir(os.path.join(train_out, "synthetic_data"),
                       os.path.join(tmp, "dp_data"))
    img_dir, ocr_dir = first_pages(tmp, img_dir, ocr_dir, DP_PAGES, "dp")
    models = {"ce": graph_model_dir(train_out, os.path.join(tmp, "dp_ce"),
                                    0.0),
              "ohem": graph_model_dir(train_out,
                                      os.path.join(tmp, "dp_ohem"), 0.0,
                                      **ohem_keys())}

    def argv(loss, out, per_rank):
        return dp_argv(models[loss], data, out, per_rank)

    per_rank = TRAIN_B // DP_WORLD
    outs = {(run, loss): os.path.join(tmp, f"dp_{run}_{loss}")
            for run in ("solo", "ranks") for loss in ("ce", "ohem", "fsdp")}
    # the same global batches in this process
    parse = run_rfund.build_argparser().parse_args
    reset_counts(ba, rb)
    torch.cuda.reset_peak_memory_stats()
    solo_ms = {}
    for loss in ("ce", "ohem"):
        _, trainer = run_rfund.run(parse(argv(loss, outs["solo", loss],
                                              TRAIN_B)))
        if loss == "ce":
            solo_counts = read_counts(ba, rb)
            solo_peak = torch.cuda.max_memory_allocated()
            solo_ms = steady_ms(trainer)
            reset_counts(ba, rb)
        del trainer
    for k, v in read_counts(ba, rb).items():
        solo_counts[k] += v
    solo_loss, solo_grads = first_step_grads(
        argv("ce", os.path.join(tmp, "dp_probe_solo"), TRAIN_B))
    gc.collect()
    torch.cuda.empty_cache()

    # "fsdp": the CE run with --fsdp (train_fsdp_ranks), under a name of
    # its own: dp_worker times steady steps of "ce" only (~3.8 s each here)
    spec = {"argv": {**{loss: argv(loss, outs["ranks", loss], per_rank)
                        for loss in ("ce", "ohem")},
                     "fsdp": argv("ce", outs["ranks", "fsdp"], per_rank)
                     + ["--fsdp"]},
            "losses": ["ce", "ohem", "fsdp"],
            "probe": argv("ce", os.path.join(tmp, "dp_probe_ranks"),
                          per_rank),
            "grads": os.path.join(tmp, "dp_grads.pt"),
            "keep": os.path.join(tmp, "dp_keep.rank{rank}.pt"),
            "pages": [img_dir, ocr_dir]}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, DP_WORLD, tmp, "train_dp")
    ranks_wall = time.perf_counter() - t0
    backend = ranks[0]["backend"]
    if any(r["backend"] != backend for r in ranks):
        raise RuntimeError(f"backends: ranks {[r['backend'] for r in ranks]}")

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

    report["ms_per_step_steady"] = {
        "one_process": solo_ms,
        f"{backend}_{DP_WORLD}_ranks": ranks[0]["ce"]["steady_ms"],
        "steps": STEADY_STEPS - 1}

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
    if not identical or len(served) != DP_PAGES \
            or served != ranks[0]["final_records"]:
        errors.append(f"save: {report['save']}")

    report.update({"phase": "train_dp", "steps": DP_STEPS,
                   "global_batch": TRAIN_B, "per_rank_batch": per_rank,
                   "L": L, "dropout": 0.0, "ohem_k": list(OHEM_K),
                   "ranks_wall_seconds": ranks_wall,
                   "tol": {"loss": DP_LOSS_RTOL, "grad": DP_GRAD_TOL,
                           "nccl_loss": NCCL_LOSS_RTOL}})
    emit(report)
    if errors:
        raise RuntimeError("train_dp: " + "; ".join(errors))
    # the main path's launches: this process's runs and every rank's CE
    # and OHEM runs (train_fsdp_ranks counts the fsdp run's)
    total = dict(solo_counts)
    for r in ranks:
        for loss in ("ce", "ohem"):
            for k, v in r[loss]["launches"].items():
                total[k] += v
    # the one-process runs are train_sp's reference too
    reference = {"models": models, "data": data,
                 "logs": {loss: os.path.join(outs["solo", loss], "log.jsonl")
                          for loss in ("ce", "ohem")},
                 "grads": solo_grads, "loss": solo_loss,
                 "probe": argv("ce", os.path.join(tmp, "sp_probe"), TRAIN_B),
                 "ms_per_step": report["ce"]["ms_per_step_logged_one_process"],
                 # train_fsdp's and train_fsdp_ranks' references
                 "train_out": train_out, "solo_out": outs["solo", "ce"],
                 "solo_peak": solo_peak, "solo_steady_ms": solo_ms,
                 "backend": backend,
                 "ranks_peak": [r["ce"]["max_memory_allocated"]
                                for r in ranks],
                 "fsdp_ranks": [r["fsdp"] for r in ranks],
                 "fsdp_ranks_out": outs["ranks", "fsdp"]}
    return total, reference


SP_WORLD = 2  # sequence-parallel ranks sharing the card (dp 1)
SP_PAGES = B  # the pages serve_sp serves: one batch (96 before the artifact
# phases came, for the 1200 s)
# step 1's gradient under sp against one process's: each tensor within
# DP_GRAD_TOL of its max, but layer 11's query and key weights within
# SP_QK_TOL. Their gradients are small differences of large terms (the
# nearly collinear keys of PATH_QK_TOL), and sp sums the pair head's input
# gradients over other row blocks than one process does, so the bf16
# rounding of that sum shows there amplified; train_sp prints the same
# error for one process re-blocked (pair_block_size 64 against 128).
SP_QK_TOL = 5e-2
SP_QK = re.compile(r"backbone\.encoder\.layer\.11\.attention\.self\."
                   r"(query|key)\.weight")
SP_SCORE_TOL = 2e-2  # spot scores, one process against the sp ranks
# serve_sp_long: the pages sp exists for (2048 × 2 before the long pages of
# the sp pair bench came)
LONG_L, LONG_B = 4096, 1
# serve_sp_long's spot counts, one process against the sp ranks: per head,
# apart by at most the positions of one process's upper triangle whose two
# largest class probabilities are within SP_LONG_MARGIN (close_calls, the
# bound of tests/test_torch_long_sequence.py). A random model's class
# probabilities crowd the argmax tie, and the ranks' row blocks (64 rows of
# a strided shard) run other GEMM shapes than one process's (128 rows), so
# bf16 rounding may tag such a position otherwise (exact at 2048 × 2; 2 and
# 1 apart of 3.4 M and 7.4 M nonzero tags at 4096, common scores at most
# 6.8e-6 apart).
SP_LONG_MARGIN = 1e-4


def sp_train_worker(spec):
    """One rank of a ``train_sp`` launch: joins the process group as
    ``run_rfund --distributed --sp 2`` does, takes the step-1 gradient
    (rank 0 saves it) and kernel #2's flags under its dp index's seed, then
    fine-tunes for each loss of ``spec`` through ``run_rfund``'s setup and
    ``PEneoTrainer`` (no model saved: no gate reads it), the launch counts
    reset just before and read just after."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.parallel import dist as pdist
    from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

    parse = run_rfund.build_argparser().parse_args
    argvs = {k: v + ["--distributed"] for k, v in spec["argv"].items()}
    first = parse(argvs[spec["losses"][0]])
    run_rfund.init_parallel(first)
    me = pdist.rank()
    result = {"rank": me, "world": pdist.world(),
              "backend": pdist.dist.get_backend(),
              "device": str(pdist.rank_device()),
              "dp": [pdist.dp_index(), pdist.dp_size()],
              "sp": [pdist.sp_index(), pdist.sp_size()]}
    try:
        loss, grads = first_step_grads(spec["probe"] + ["--distributed"])
        result["step1_loss"] = loss
        if me == 0:
            torch.save(grads, spec["grads"])
        seed, keep = rank_keep_flags(ba, pdist.dp_index(), TRAIN_B)
        result["keep_seed"] = seed
        torch.save(keep, spec["keep"].format(rank=me))
        for name in spec["losses"]:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ba, rb)
            args = parse(argvs[name])
            cfg, model, train_ds, eval_ds, collator, tok = run_rfund.setup(
                args)
            trainer = PEneoTrainer(cfg, model,
                                   run_rfund.training_arguments(args),
                                   train_ds, eval_ds, collator, tokenizer=tok)
            trainer.train()
            result[name] = {"launches": read_counts(ba, rb),
                            "max_memory_allocated":
                                torch.cuda.max_memory_allocated(),
                            "seed_offset": trainer.seeds.offset}
            del trainer, model
        pdist.barrier()
    finally:
        pdist.shutdown()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def phase_train_sp(ba, rb, tmp, reference, smi):
    """Sequence-parallel fine-tuning of LiLT-base: SP_WORLD ranks of
    ``run_rfund --distributed --sp 2`` (dp 1) sharing the card over gloo,
    global B = TRAIN_B, L = 512, bf16, dropout 0, DP_STEPS steps of plain CE
    and of OHEM 128/512, each with an eval of the 16 dev pages (listed
    twice); against train_dp's one-process runs of the same global
    batches."""
    import torch

    spec = {"worker": "sp_train", "losses": ["ce", "ohem"],
            "argv": {loss: dp_argv(reference["models"][loss],
                                   reference["data"],
                                   os.path.join(tmp, f"sp_{loss}"), TRAIN_B,
                                   "--sp", str(SP_WORLD))
                     for loss in ("ce", "ohem")},
            "probe": reference["probe"] + ["--sp", str(SP_WORLD)],
            "grads": os.path.join(tmp, "sp_grads.pt"),
            "keep": os.path.join(tmp, "sp_keep.rank{rank}.pt")}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, SP_WORLD, tmp, "train_sp")
    wall = time.perf_counter() - t0
    report = {"phase": "train_sp", "nvidia_smi": smi, "world": SP_WORLD,
              "backend": ranks[0]["backend"],
              "grid": [[r["dp"], r["sp"]] for r in ranks],
              "devices": [r["device"] for r in ranks]}
    errors = []
    if [r["sp"] for r in ranks] != [[s, SP_WORLD] for s in range(SP_WORLD)]:
        errors.append(f"grid {report['grid']}")
    layers, n_dev = 12, 16
    per_run = {"fwd": layers * DP_STEPS, "bwd": layers * DP_STEPS,
               "biacm_attention": layers * 2 * n_dev // TRAIN_B}
    for loss in ("ce", "ohem"):
        solo_steps, solo_evals = log_records(reference["logs"][loss])
        out = os.path.join(tmp, f"sp_{loss}")
        logs = [log_records(os.path.join(out, "log.jsonl" if r == 0
                                         else f"log.rank{r}.jsonl"))
                for r in range(SP_WORLD)]
        want = [r["loss/total"] for r in solo_steps]
        got = [[r["loss/total"] for r in steps] for steps, _ in logs]
        keys = ("eval/precision", "eval/recall", "eval/f1",
                "eval/num_sample_processed")
        evals = [{k: e[0][k] for k in keys} for _, e in logs]
        solo_eval = {k: solo_evals[0][k] for k in keys}
        eval_losses = [[v for k, v in sorted(e[0].items()) if "loss" in k]
                       for _, e in logs]
        solo_eval_losses = [v for k, v in sorted(solo_evals[0].items())
                            if "loss" in k]
        report[loss] = {
            "losses_one_process": want, "losses_ranks": got,
            "max_rel_err": max(abs(a - b) / abs(b)
                               for a, b in zip(got[0], want)),
            "ms_per_step_logged_ranks": step_ms(logs[0][0]),
            "ms_per_step_logged_one_process": step_ms(solo_steps),
            "eval_ranks": evals, "eval_one_process": solo_eval,
            "eval_losses_rank0": eval_losses[0],
            "eval_losses_one_process": solo_eval_losses,
            "launches_ranks": [r[loss]["launches"] for r in ranks],
            "seed_offsets": [r[loss]["seed_offset"] for r in ranks],
            "max_memory_allocated_ranks":
                [r[loss]["max_memory_allocated"] for r in ranks]}
        if any(g != got[0] for g in got) \
                or not rel_close(got[0], want, DP_LOSS_RTOL):
            errors.append(f"{loss}: rank losses {got} vs one process {want}")
        if any(e != solo_eval for e in evals) \
                or evals[0]["eval/num_sample_processed"] != n_dev \
                or any(e != eval_losses[0] for e in eval_losses) \
                or not rel_close(eval_losses[0], solo_eval_losses,
                                 DP_LOSS_RTOL):
            errors.append(f"{loss}: eval {evals} {eval_losses} vs one "
                          f"process {solo_eval} {solo_eval_losses}")
        if len(set(report[loss]["seed_offsets"])) != 1:
            errors.append(f"{loss}: seed offsets {report[loss]['seed_offsets']}")
        for r in ranks:
            expect_counts(r[loss]["launches"], per_run,
                          f"train_sp rank {r['rank']} {loss}")

    # step 1's gradient (DDP's mean of the ranks' world-scaled shares),
    # and one process's re-blocked (the rounding floor of another order)
    grads = torch.load(spec["grads"], weights_only=True)
    solo_grads = reference["grads"]

    def err(other):
        return {n: ((other[n] - g).abs().max() / g.abs().max()).item()
                for n, g in solo_grads.items()}

    grad_err = err(grads)
    reblocked = graph_model_dir(reference["models"]["ce"],
                                os.path.join(tmp, "sp_block64"), 0.0,
                                pair_block_size=64)
    _, floor_grads = first_step_grads(dp_argv(
        reblocked, reference["data"], os.path.join(tmp, "sp_probe64"),
        TRAIN_B))
    report["step1_grad_err_over_max"] = grad_err
    report["step1_grad_err_one_process_block64"] = err(floor_grads)
    report["step1_loss"] = {"ranks": [r["step1_loss"] for r in ranks],
                            "one_process": reference["loss"]}
    if set(grads) != set(solo_grads) or len(grads) < 20 \
            or any(v > (SP_QK_TOL if SP_QK.fullmatch(n) else DP_GRAD_TOL)
                   for n, v in grad_err.items()):
        errors.append(f"step-1 gradients: {grad_err}")

    # the sp ranks of one dp index draw the same attention-dropout flags
    flags, same = [], []
    for r in ranks:
        keep = torch.load(spec["keep"].format(rank=r["rank"]),
                          weights_only=True)
        bits = ba.attention_dropout_bits(r["keep_seed"], TRAIN_B, NH, L,
                                         device="cuda")
        want = ba.pack_keep_mask(torch.stack(bits)
                                 < ba.keep_threshold(DROP)).cpu()
        same.append(torch.equal(keep, want))
        flags.append(keep)
    report["dropout_flags"] = {
        "rate": DROP, "seeds": [r["keep_seed"] for r in ranks],
        "equal_to_seed_bits": same,
        "ranks_identical": all(torch.equal(f, flags[0]) for f in flags)}
    if not all(same) or not report["dropout_flags"]["ranks_identical"] \
            or len({r["keep_seed"] for r in ranks}) != 1:
        errors.append(f"dropout flags {report['dropout_flags']}")
    report.update({"steps": DP_STEPS, "global_batch": TRAIN_B, "L": L,
                   "dropout": 0.0, "ohem_k": list(OHEM_K),
                   "ranks_wall_seconds": wall,
                   "tol": {"loss": DP_LOSS_RTOL, "grad": DP_GRAD_TOL,
                           "grad_layer11_query_key": SP_QK_TOL}})
    emit(report)
    if errors:
        raise RuntimeError("train_sp: " + "; ".join(errors))
    total = {k: 0 for k in ranks[0]["ce"]["launches"]}
    for r in ranks:
        for loss in ("ce", "ohem"):
            for k, v in r[loss]["launches"].items():
                total[k] += v
    return total


def long_model(sp_index=0, sp=1, group=None):
    """LiLT-base widths and depth at max_position_embeddings LONG_L + 2
    (seeded random init, as tests/test_long_sequence.py builds its
    configs), bf16 on the card, in eval mode; with ``sp`` > 1 its pair grid
    split over the sp group."""
    import torch

    from peneo_tpu_torch.config import LiltConfig, PEneoConfig
    from peneo_tpu_torch.models.peneo import PEneoModel

    cfg = PEneoConfig(
        backbone_name="lilt-infoxlm-base",
        backbone_config=LiltConfig(
            vocab_size=250002, max_position_embeddings=LONG_L + 2,
            pad_token_id=0, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0).to_dict(),
        max_seq_len=LONG_L)
    # drawn on the card: the same weights in every process that builds it
    model = PEneoModel(cfg).cuda().init_weights(
        torch.Generator(device="cuda").manual_seed(SEED))
    if sp > 1:
        model.set_sequence_parallel(sp_index, sp, group)
    return model.cast(torch.bfloat16).eval()


def long_inputs():
    """LONG_B pages of LONG_L tokens (random ids and boxes, seeded)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    ids = rng.integers(3, 250002, (LONG_B, LONG_L))
    x0 = rng.integers(0, 900, (LONG_B, LONG_L))
    y0 = rng.integers(0, 950, (LONG_B, LONG_L))
    bbox = np.stack([x0, y0, x0 + rng.integers(5, 100, x0.shape),
                     y0 + rng.integers(5, 50, y0.shape)], -1)
    return (torch.from_numpy(ids).cuda(), torch.from_numpy(bbox).cuda(),
            torch.ones((LONG_B, LONG_L), dtype=torch.int64, device="cuda"))


def decoder_device_ms(model, ids, bbox, attn):
    """Device ms, wall ms and the largest device rows (name, ms, count) of
    one decoder forward (shrink, combine, this rank's pair grid, the spot
    selection and, under sp, the merge) on the backbone's output of one
    batch (profiled after a warm call); under sp every rank of the group
    calls it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        hidden = model.backbone(ids, bbox, attn)["last_hidden_state"]
        hidden = hidden[:, 1:ids.shape[1]]
        model.peneo_decoder(hidden)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.peneo_decoder(hidden)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    rows, device = device_rows(prof, wall, None, "")
    return device, wall, [[k[:80], round(ms, 3), n] for k, ms, n in rows[:8]]


def pair_inputs(model, ids, bbox, attn):
    """One batch's combine features (a, b) and Ld, as the decoder forms
    them (inference mode)."""
    import torch

    dec = model.peneo_decoder
    with torch.inference_mode():
        hidden = model.backbone(ids, bbox, attn)["last_hidden_state"]
        hidden = hidden[:, 1:ids.shape[1]]
        a, b = dec.handshaking_kernel(dec.shrink_projection(
            hidden.to(dec.handshaking_kernel.combine_fc.weight.dtype)))
    return a, b, hidden.shape[1]


def profiled_shard(model, a, b, valid_len, index, size):
    """Device ms and the largest device rows of shard ``index`` of ``size``
    of the pair grid: ``sp_partials`` (the shard's rows, every block, the
    five heads, the spot keys) and its packed top k, no collective."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dec = model.peneo_decoder
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dec.sp_partials(a, b, valid_len, index, size)[0].packed()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    rows, device = device_rows(prof, wall, None, "")
    return device, [[k[:80], round(ms, 3), n] for k, ms, n in rows[:6]]


def shard_device_ms(model, ids, bbox, attn, index, size, barrier):
    """This sp rank's shard of one batch's pair grid (``profiled_shard``,
    after a warm call), the ranks of the card taking turns (``barrier``) so
    that each profile sees the card alone."""
    a, b, valid_len = pair_inputs(model, ids, bbox, attn)
    profiled_shard(model, a, b, valid_len, index, size)
    for turn in range(size):
        barrier()
        if turn == index:
            out = profiled_shard(model, a, b, valid_len, index, size)
    barrier()
    return out


def split_device_ms(model, ids, bbox, attn, repeats=3):
    """In one process, one batch's pair grid through ``sp_partials`` whole
    (size 1) and as its two sp shards, in turns (whole, shard 0, shard 1)
    ``repeats`` times after a warm call of each: the medians of their device
    ms, and the largest rows of the last whole and shard-0 calls."""
    a, b, valid_len = pair_inputs(model, ids, bbox, attn)
    parts = {"whole": (0, 1), "shard0": (0, SP_WORLD), "shard1": (1, SP_WORLD)}
    times = {name: [] for name in parts}
    for rep in range(repeats + 1):
        for name, (index, size) in parts.items():
            ms, top = profiled_shard(model, a, b, valid_len, index, size)
            if rep:
                times[name].append(ms)
                if name != "shard1":
                    times[name + "_top"] = top
    return {name: statistics.median(v) if not name.endswith("_top") else v
            for name, v in times.items()}


def shard_spots(model, ids, bbox, attn):
    """The sp ranks' arithmetic in one process: the pair grid's SP_WORLD
    shards (``sp_partials``) on this process's a, b, merged by
    ``merge_spots`` as the ranks merge their gathered keys; packed as
    :func:`packed_spots`."""
    import torch

    from peneo_tpu_torch.models.decoder import HEAD_NAMES
    from peneo_tpu_torch.parallel.seq_parallel import merge_spots

    dec = model.peneo_decoder
    a, b, valid_len = pair_inputs(model, ids, bbox, attn)
    with torch.inference_mode():
        keys = torch.stack([dec.sp_partials(a, b, valid_len, i, SP_WORLD)[0]
                            .packed() for i in range(SP_WORLD)])
        out = merge_spots(keys, a.shape[0], dec.cfg.max_spots_per_head,
                          valid_len, HEAD_NAMES)
    return packed_spots(out)


def packed_spots(out):
    """The model's compact spots as two host int32 arrays (pack_spots)."""
    from peneo_tpu_torch.models.decoder import pack_spots

    return [x.cpu().numpy().tolist() for x in pack_spots(out)]


def sp_serve_worker(spec):
    """One rank of the ``serve_sp`` launch (two gloo ranks, sp 2): serves
    the first 32 pages through ``InferenceService(dp=1, sp=2)``, then one batch's
    spots, wall ms and decoder device ms; then (``serve_sp_long``) the long
    model's spots at LONG_L, its decoder device ms and peak memory. The
    launch counts are reset just before each part and read just after."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.parallel import dist as pdist
    from peneo_tpu_torch.pipeline.infer import InferenceService

    pdist.init_distributed()
    me = pdist.rank()
    result = {"rank": me, "backend": pdist.dist.get_backend(),
              "device": str(pdist.rank_device())}
    img_dir, ocr_dir = spec["pages"]
    try:
        reset_counts(ba, rb)
        svc = InferenceService(spec["model"], batch_size=B, dtype="bfloat16",
                               dp=1, sp=SP_WORLD)
        results = svc.run(img_dir, ocr_dir)
        serve = {"launches": read_counts(ba, rb), "pages": len(results),
                 "seconds": svc.last_run["seconds"],
                 "records": json.loads(json.dumps(records_of(results)))}
        pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                 for i in range(B)]
        serve["spots"] = [x.cpu().numpy().tolist()
                          for x in svc.dispatch_batch(pages)]
        serve["forward_wall_ms"] = batch_wall_ms(svc, pages)
        tensors = batch_tensors(svc, pages)[:3]
        (serve["decoder_device_ms"], serve["decoder_wall_ms"],
         serve["decoder_top"]) = decoder_device_ms(svc.model, *tensors)
        serve["shard_device_ms"], serve["shard_top"] = shard_device_ms(
            svc.model, *tensors, pdist.sp_index(), SP_WORLD, pdist.barrier)
        result["serve"] = serve
        del svc
        torch.cuda.empty_cache()

        reset_counts(ba, rb)
        model = long_model(pdist.sp_index(), SP_WORLD, pdist.sp_group())
        ids, bbox, attn = long_inputs()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = model(ids, bbox, attn)
        long = {"launches": read_counts(ba, rb),
                "spots": packed_spots(out),
                "forward_peak_bytes":
                    torch.cuda.max_memory_allocated() - base}
        del out
        (long["decoder_device_ms"], long["decoder_wall_ms"],
         long["decoder_top"]) = decoder_device_ms(model, ids, bbox, attn)
        long["shard_device_ms"], long["shard_top"] = shard_device_ms(
            model, ids, bbox, attn, pdist.sp_index(), SP_WORLD,
            pdist.barrier)
        result["long"] = long
        pdist.barrier()
    finally:
        pdist.shutdown()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def batch_wall_ms(svc, pages, n=3):
    """Median wall ms of one batch's dispatch and fetch (host clock)."""
    import torch

    svc._fetch(svc.dispatch_batch(pages))  # warm
    wall = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc._fetch(svc.dispatch_batch(pages))
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(wall)


def spot_gate(ref, got, k, tol=SP_SCORE_TOL, count_rtol=0.0, close=None):
    """One process's compact spots (``ref``) against the sp ranks' merged
    ones (``got``), both as ``pack_spots`` lists. The tie rule: where scores
    tie at the k-th place, the sp merge keeps the lowest flat indices (the
    JAX order, score descending then flat index ascending) and
    ``torch.topk`` in one process an unspecified subset. So per head and
    sample: ``spot_count`` equal (within ``count_rtol`` relative; None:
    reported only, where the logits differ by rounding and a random
    model's positions crowd the tie of two classes, so that some take the
    other argmax; ``close``, per head a list per sample of
    :func:`close_calls`: apart by at most that many, ``count_rtol``
    unread); on the positions both keep, the tags equal and
    the scores within ``tol``; the k kept scores, sorted, within ``tol``;
    and every spot whose score clears the k-th by more than ``tol`` kept by
    both. Returns (errors, summary)."""
    import numpy as np

    from peneo_tpu_torch.models.decoder import HEAD_NAMES
    from peneo_tpu_torch.pipeline.decode import unpack_spots

    r, g = (unpack_spots(np.asarray(x[0], np.int32), np.asarray(x[1],
                                                                 np.int32))
            for x in (ref, got))
    errors, common, differ, clear, max_diff, bit_equal = [], 0, 0, 0, 0.0, \
        True
    count_err, count_diff = 0.0, {}
    for name in HEAD_NAMES:
        rc, gc_ = (x[name]["spot_count"].astype(np.int64) for x in (r, g))
        err = float((np.abs(rc - gc_) / np.maximum(rc, 1)).max())
        count_err = max(count_err, err)
        count_diff[name] = np.abs(rc - gc_).tolist()
        if (np.abs(rc - gc_) > np.asarray(close[name])).any() \
                if close is not None \
                else count_rtol is not None and err > count_rtol:
            errors.append(f"{name}: spot_count {rc} vs {gc_}")
        for bi in range(len(r[name]["spot_count"])):
            rs, gs = r[name]["spot_score"][bi], g[name]["spot_score"][bi]
            ri = dict(zip(r[name]["spot_idx"][bi][rs > -0.5],
                          zip(r[name]["spot_tag"][bi][rs > -0.5],
                              rs[rs > -0.5])))
            gi = dict(zip(g[name]["spot_idx"][bi][gs > -0.5],
                          zip(g[name]["spot_tag"][bi][gs > -0.5],
                              gs[gs > -0.5])))
            both = set(ri) & set(gi)
            common += len(both)
            differ += len(set(ri) ^ set(gi))
            for i in both:
                d = abs(float(ri[i][1]) - float(gi[i][1]))
                max_diff = max(max_diff, d)
                bit_equal &= ri[i][1] == gi[i][1]
                if ri[i][0] != gi[i][0] or d > tol:
                    errors.append(f"{name}[{bi}] at {i}: {ri[i]} vs {gi[i]}")
                    break
            a, b = np.sort(rs)[::-1], np.sort(gs)[::-1]
            if np.abs(a - b).max() > tol:
                errors.append(f"{name}[{bi}]: sorted scores differ by "
                              f"{np.abs(a - b).max()}")
            kth = float(a[k - 1]) if int(r[name]["spot_count"][bi]) >= k \
                else -1.0
            above = ({i for i, (_, s) in ri.items() if s > kth + tol}
                     | {i for i, (_, s) in gi.items() if s > kth + tol})
            clear += len(above)
            if not above <= both:
                errors.append(f"{name}[{bi}]: {len(above - both)} spots "
                              "clear of the k-th score kept by one side")
    summary = {"spot_count_max_rel_err": count_err,
               "spot_count_abs_diff": count_diff,
               "spot_count_rtol": None if close is not None else count_rtol,
               "close_calls": close,
               "common_spots": common, "differing_at_boundary": differ,
               "clear_of_boundary": clear, "max_score_diff": max_diff,
               "common_scores_bit_identical": bool(bit_equal),
               "tie_rule": "sp keeps the lowest flat indices among spots "
                           "tied at the k-th score; one process's "
                           "torch.topk an unspecified subset",
               "score_tol": tol}
    return errors[:10], summary


def phase_serve_sp(ba, rb, tmp, img_dir, ocr_dir, smi):
    """Sequence-parallel serving of LiLT-base at CUT_LAYERS (L = 512, B =
    32, bf16, the first 32 pages): two gloo ranks on the card at sp 2 (the
    ranks also run serve_sp_long's part, at full depth: one launch), against
    this process's ``InferenceService`` on the same model directory."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    model_dir = cut_model(tmp, "lilt", os.path.join(tmp, "model"))
    img_dir, ocr_dir = first_pages(tmp, img_dir, ocr_dir, SP_PAGES, "sp")
    spec = {"worker": "sp_serve", "model": model_dir,
            "pages": [img_dir, ocr_dir]}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, SP_WORLD, tmp, "serve_sp")
    wall = time.perf_counter() - t0

    reset_counts(ba, rb)
    svc = InferenceService(model_dir, batch_size=B, dtype="bfloat16")
    records = json.loads(json.dumps(records_of(svc.run(img_dir, ocr_dir))))
    solo_counts = read_counts(ba, rb)
    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    spots = [x.cpu().numpy().tolist() for x in svc.dispatch_batch(pages)]
    solo_wall = batch_wall_ms(svc, pages)
    tensors = batch_tensors(svc, pages)[:3]
    solo_device, solo_dec_wall, solo_top = decoder_device_ms(svc.model,
                                                             *tensors)
    split = split_device_ms(svc.model, *tensors)
    k = svc.cfg.max_spots_per_head
    del svc
    torch.cuda.empty_cache()

    errors, summary = spot_gate(spots, ranks[0]["serve"]["spots"], k)
    if any(r["serve"]["spots"] != ranks[0]["serve"]["spots"] for r in ranks):
        errors.append("the ranks' merged spots differ")
    n_forwards = math.ceil(SP_PAGES / B)
    for r in ranks:
        expect_counts(r["serve"]["launches"],
                      {"biacm_attention": CUT_LAYERS * n_forwards},
                      f"serve_sp rank {r['rank']}")
        if r["serve"]["pages"] != SP_PAGES:
            errors.append(f"rank {r['rank']}: {r['serve']['pages']} pages")
    report = {
        "phase": "serve_sp", "nvidia_smi": smi, "sp": SP_WORLD,
        "layers": CUT_LAYERS,
        "backend": ranks[0]["backend"], "batch_size": B, "L": L,
        "max_spots_per_head": k, "spots": summary,
        "launches_ranks": [r["serve"]["launches"] for r in ranks],
        "decoder_device_ms_ranks":
            [r["serve"]["decoder_device_ms"] for r in ranks],
        "decoder_device_ms_one_process": solo_device,
        "decoder_top_kernels_rank0": ranks[0]["serve"]["decoder_top"],
        "decoder_top_kernels_one_process": solo_top,
        "shard_device_ms_ranks": [r["serve"]["shard_device_ms"]
                                  for r in ranks],
        "shard_top_kernels_rank0": ranks[0]["serve"]["shard_top"],
        "split_device_ms_one_process": split,
        "decoder_wall_ms_ranks": [r["serve"]["decoder_wall_ms"]
                                  for r in ranks],
        "decoder_wall_ms_one_process": solo_dec_wall,
        "forward_wall_ms_ranks": [r["serve"]["forward_wall_ms"]
                                  for r in ranks],
        "forward_wall_ms_one_process": solo_wall,
        "run_seconds_ranks": [r["serve"]["seconds"] for r in ranks],
        "records_equal_one_process": ranks[0]["serve"]["records"] == records,
        "ranks_wall_seconds": wall}
    emit(report)
    if errors:
        raise RuntimeError("serve_sp: " + "; ".join(errors))
    total = dict(solo_counts)
    for r in ranks:
        for key, v in r["serve"]["launches"].items():
            total[key] += v
    return total, ranks


def close_calls(out):
    """Per head, a list per sample of the positions of the upper triangle
    whose two largest class probabilities in ``out``'s dense logits are
    within SP_LONG_MARGIN: those that rounding may tag otherwise."""
    import torch

    from peneo_tpu_torch.models.decoder import HEAD_NAMES

    close = {}
    for name in HEAD_NAMES:
        z = out[name]["logits"]
        top2 = torch.softmax(z.float(), -1).topk(2, -1).values
        near = (top2[..., 0] - top2[..., 1]) <= SP_LONG_MARGIN
        del top2
        triu = torch.ones(z.shape[1:3], dtype=torch.bool,
                          device=z.device).triu()
        close[name] = (near & triu).sum((1, 2)).tolist()
    return close


def phase_serve_sp_long(ba, rb, ranks, smi):
    """The long pages sp exists for: LiLT-base widths and depth at
    L = LONG_L, B = LONG_B, one process here against serve_sp's two sp
    ranks (which ran their part in serve_sp's launch): the ranks' merged
    spots equal to the same two shards merged here (the ranks' arithmetic:
    any difference is a fault of the distributed path); against this
    process's whole grid, spots as serve_sp gates them but each head's
    ``spot_count`` apart by at most its :func:`close_calls` (the grid's
    blocks and the shards' run other GEMM shapes); each rank's decoder
    device ms and peak memory of the forward against one process's."""
    import torch

    reset_counts(ba, rb)
    model = long_model()
    ids, bbox, attn = long_inputs()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = model(ids, bbox, attn)
    spots = packed_spots(out)
    peak = torch.cuda.max_memory_allocated() - base
    counts = read_counts(ba, rb)
    del out
    with torch.inference_mode():  # the dense logits of the same forward
        close = close_calls(model(ids, bbox, attn, return_logits=True))
    shards = shard_spots(model, ids, bbox, attn)
    device, dec_wall, top = decoder_device_ms(model, ids, bbox, attn)
    split = split_device_ms(model, ids, bbox, attn, repeats=1)
    k = model.cfg.max_spots_per_head
    del model
    torch.cuda.empty_cache()

    errors, summary = spot_gate(spots, ranks[0]["long"]["spots"], k,
                                close=close)
    if any(r["long"]["spots"] != ranks[0]["long"]["spots"] for r in ranks):
        errors.append("the ranks' merged spots differ")
    if ranks[0]["long"]["spots"] != shards:
        errors.append("the ranks' merged spots differ from the same two "
                      "shards merged in one process")
    for r in [{"rank": "one process", "long": {"launches": counts}}] + ranks:
        expect_counts(r["long"]["launches"], {"biacm_attention": 12},
                      f"serve_sp_long {r['rank']}")
    report = {
        "phase": "serve_sp_long", "nvidia_smi": smi, "sp": SP_WORLD,
        "batch_size": LONG_B, "L": LONG_L, "max_spots_per_head": k,
        "spots": summary, "close_margin": SP_LONG_MARGIN,
        "ranks_equal_shards_in_one_process":
            ranks[0]["long"]["spots"] == shards,
        "decoder_device_ms_ranks": [r["long"]["decoder_device_ms"]
                                    for r in ranks],
        "decoder_device_ms_one_process": device,
        "decoder_top_kernels_rank0": ranks[0]["long"]["decoder_top"],
        "decoder_top_kernels_one_process": top,
        "shard_device_ms_ranks": [r["long"]["shard_device_ms"]
                                  for r in ranks],
        "shard_top_kernels_rank0": ranks[0]["long"]["shard_top"],
        "split_device_ms_one_process": split,
        "decoder_wall_ms_ranks": [r["long"]["decoder_wall_ms"]
                                  for r in ranks],
        "decoder_wall_ms_one_process": dec_wall,
        "forward_peak_bytes_ranks": [r["long"]["forward_peak_bytes"]
                                     for r in ranks],
        "forward_peak_bytes_one_process": peak,
        "launches_ranks": [r["long"]["launches"] for r in ranks]}
    emit(report)
    if errors:
        raise RuntimeError("serve_sp_long: " + "; ".join(errors))
    total = dict(counts)
    for r in ranks:
        for key, v in r["long"]["launches"].items():
            total[key] += v
    return total


# ------------------------------------------------------------------------
# the port's benches: the batched forward (peneo_tpu_torch/bench.py) and
# the sp pair path (peneo_tpu_torch/bench_sp_pair.py), driven in process
# ------------------------------------------------------------------------
BENCH_ITERS = 16  # bench.py's
SP_PAIR_LENGTHS = (2048, 4096)
SP_PAIR_ITERS = 8  # tools/bench_sp_pair.py's 16, halved for the 1200 s


def phase_bench(ba, rb, smi):
    """``python -m peneo_tpu_torch.bench`` for LiLT-base, LayoutLMv3-base
    and LayoutXLM-base at B = 32, L = 512, bf16, BENCH_ITERS iterations
    (each prints its lines). Gates: the family's kernel (#1, or #4)
    launched 12 times a forward and the other never, over every forward of
    the run and over the timed ones; no host sync inside a forward; the
    JAX tool's last-line keys and metric name. Returns the launches."""
    import torch

    from peneo_tpu_torch import bench

    total, report, errors = {}, {}, []
    for family, kernel in (("lilt", "biacm_attention"),
                           ("layoutlmv3", "bias_attention"),
                           ("layoutlmv2", "bias_attention")):
        reset_counts(ba, rb)
        t0 = time.perf_counter()
        run, line = bench.run(["--backbone", family, "--iters",
                               str(BENCH_ITERS)])
        seconds = time.perf_counter() - t0
        counts = read_counts(ba, rb)
        gc.collect()
        torch.cuda.empty_cache()
        expect_counts(counts, {kernel: 12 * run["forwards"]},
                      f"bench {family}")
        tag = "" if family == "lilt" else f"_{family}"
        want = f"pages_per_sec_per_chip{tag}_L{L}_bf16_batch_inference"
        if set(line) != {"metric", "value", "unit", "vs_baseline"} \
                or line["metric"] != want or not line["value"] > 0:
            errors.append(f"{family}: last line {line}")
        if run["host_syncs_per_forward"] != 0 \
                or run["launches_per_forward"][kernel] != 12:
            errors.append(f"{family}: {run['host_syncs_per_forward']} host "
                          f"syncs ({run['host_sync_sites']}), launches "
                          f"{run['launches_per_forward']} a timed forward")
        report[family] = {"line": line, "seconds": seconds,
                          "launches": counts,
                          "forward_wall_ms": run["forward_wall_ms"],
                          "ms_per_batch_in_flight":
                              run["ms_per_batch_in_flight"]}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "bench", "nvidia_smi": smi, "batch_size": B, "L": L,
          "iters": BENCH_ITERS, **report})
    if errors:
        raise RuntimeError("bench: " + "; ".join(errors))
    return total


def phase_sp_pair(ba, rb, smi):
    """``python -m peneo_tpu_torch.bench_sp_pair`` at L = 2048 and 4096, B
    = 1, hidden 768, k 256 (each prints its lines): one sp rank's pair grid
    at size 1 (``sp_partials``, ``merge_spots``), bf16 then int8 pair head.
    Gate: the bf16 spots against the same decoder's one-process grid on
    the same a, b (``spot_gate``); the int8 spots' agreement with bf16 is
    reported, not gated. No attention kernel runs here."""
    import torch

    from peneo_tpu_torch import bench_sp_pair

    reset_counts(ba, rb)
    report, errors = {}, []
    for length in SP_PAIR_LENGTHS:
        t0 = time.perf_counter()
        out = bench_sp_pair.main(["--L", str(length), "--iters",
                                  str(SP_PAIR_ITERS)], reference=True)
        seconds = time.perf_counter() - t0
        k = 256
        err, summary = spot_gate(out["one_process"], out["bf16"][1], k)
        int8_err, int8_summary = spot_gate(out["bf16"][1], out["int8"][1],
                                           k, count_rtol=None)
        errors += [f"L={length}: {e}" for e in err]
        report[str(length)] = {
            "bf16": out["bf16"][0], "int8": out["int8"][0],
            "int8_speedup": out["speedup"]["int8_speedup"],
            "spots_bf16_vs_one_process": summary,
            "spots_int8_vs_bf16": dict(int8_summary,
                                       outside_gate=len(int8_err)),
            "seconds": seconds}
        del out
        gc.collect()
        torch.cuda.empty_cache()
    counts = read_counts(ba, rb)
    emit({"phase": "sp_pair", "nvidia_smi": smi, "batch_size": 1,
          "hidden": 768, "k": 256, "iters": SP_PAIR_ITERS,
          "launches": counts, **report})
    if errors:
        raise RuntimeError("sp_pair: " + "; ".join(errors[:10]))
    return counts


# ------------------------------------------------------------------------
# tensor parallelism (tp): the backbones and the pair head split
# Megatron-style over TP_WORLD ranks sharing the card over gloo (NCCL
# refuses two ranks on one card); four ranks with sp in grid_tp
# ------------------------------------------------------------------------
TP_WORLD = 2
TP_NH = NH // TP_WORLD  # the heads a tp rank runs
TP_STEPS = 3  # 10 before the artifact phases came (the 1200 s)
TP_GRAD_NORM_RTOL = 1e-3
TP_LOGIT_TOL = 2e-2  # relative error of one batch's logits, as parity's
TP_LOGIT_PAGES = 4   # the pages of the first batch whose logits are kept
TP_PAGES = B  # the pages serve_tp* serves: one batch
# tp's distance from an fp32 run through the plain twins, over one
# process's bf16 distance from it: serving logits (a norm over ~10^7
# values) and, in training, the losses, grad norms and each step-1 gradient
# where tp is not within the one-process tolerance of fp32 (PERF.md §6)
TP_FP32_LOGIT_FACTOR = 1.5
TP_FP32_FACTOR = 2.0


def phase_kernel_tp(ba, rb, peaks):
    """Kernels #1-#6 at a tp rank's TP_NH heads, at the main path's shapes
    otherwise, against their fp32 twins with the gates of the kernel*
    phases (#2/#3 and #5/#6 at rates 0 and DROP, the seed drawn in the
    kernel, the twin fed the same bits; #4-#6 at the model's padded bias
    stride); each one's device ms."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    nh, bt = TP_NH, TRAIN_B
    st, sl, scale = 1.0 / 8.0, 1.0 / 4.0, 1.0 / 8.0
    errs, ms = {}, {}

    def gate(key, err, tol):
        errs[key] = err
        if not err <= tol:
            raise RuntimeError(f"kernel_tp {key}: error {err} > {tol}")

    def rel_grads(got_g, want_g):
        return max(((g.float() - w).abs().max() / w.abs().max()).item()
                   for g, w in zip(got_g, want_g))

    # #1 at the serving shape
    qkv, bias = attention_inputs(
        B, L, [(r, slice(L - 100, L)) for r in range(0, B, 2)], gen, nh)
    args = (*qkv, bias, st, sl)
    got = ba.biacm_attention_cuda(*args)
    want = ba.biacm_attention_reference(*(x.float() for x in qkv), bias, st,
                                        sl)
    gate("biacm_attention", max((g.float() - w).abs().max().item()
                                for g, w in zip(got, want)), KERNEL_TOL)
    ms["biacm_attention"] = device_ms(lambda: ba.biacm_attention_cuda(*args))
    del qkv, bias, args, got, want

    # #2/#3 at the training shape
    qkv, bias = attention_inputs(
        bt, L, [(r, slice(L - 100, L)) for r in range(0, bt, 2)], gen, nh)
    dctx = tuple(torch.randn((bt, L, nh, d), generator=gen, device="cuda")
                 .to(torch.bfloat16).transpose(1, 2) for d in (64, 16))
    seed = SEED + 11
    for rate in (0.0, DROP):
        bits = ba.attention_dropout_bits(seed, bt, nh, L, "cuda")
        leaves = [x.float().requires_grad_() for x in qkv]
        want = ba.biacm_attention_train_reference(*leaves, bias, bits, st,
                                                  sl, rate)
        want_g = torch.autograd.grad(want, leaves, dctx)
        ins = [x.detach().requires_grad_() for x in qkv]
        got = ba.biacm_attention_train(*ins, bias, seed, st, sl, rate)
        got_g = torch.autograd.grad(got, ins, dctx)
        gate(f"biacm_train_fwd_rate{rate}",
             max((g.float() - w).abs().max().item()
                 for g, w in zip(got, want)), TRAIN_KERNEL_TOL)
        gate(f"biacm_train_bwd_rate{rate}", rel_grads(got_g, want_g),
             TRAIN_KERNEL_TOL)
        del bits, leaves, want, want_g, ins, got, got_g

    def fwd():
        return ba.biacm_attention_train_fwd_cuda(*qkv, bias, seed, st, sl,
                                                 DROP)

    *_, stats, keep = fwd()
    ms["biacm_train_fwd"] = device_ms(fwd)
    ms["biacm_train_bwd"] = device_ms(
        lambda: ba.biacm_attention_train_bwd_cuda(*qkv, bias, keep, stats,
                                                  *dctx, st, sl, DROP))
    del qkv, bias, dctx, stats, keep

    # #4 at the serving shapes, #5/#6 at the training ones (709 and 561)
    for length in (LV, LV2):
        cases = bias_cases(B)[length]
        (q, k, v), natural, mask = bias_inputs(B, length, cases, gen, nh=nh)
        padded = relbias_layout(natural)
        got = rb.bias_attention_cuda(q, k, v, padded, mask, scale)
        want = rb.bias_attention_reference(q.float(), k.float(), v.float(),
                                           natural, mask, scale)
        gate(f"bias_attention_L{length}",
             (got.float() - want).abs().max().item(), KERNEL_TOL)
        ms[f"bias_attention_L{length}"] = device_ms(
            lambda: rb.bias_attention_cuda(q, k, v, padded, mask, scale))
        del q, k, v, natural, padded, got, want

        qkv, natural, mask = bias_inputs(bt, length, bias_cases(bt)[length],
                                         gen, nh=nh)
        dctx = torch.randn((bt, length, nh, 64), generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)
        for rate in (0.0, DROP):
            bits = ba.element_dropout_bits(seed, bt, nh, length, "cuda")
            leaves = [x.float().requires_grad_() for x in qkv] \
                + [natural.clone().requires_grad_()]
            want = rb.bias_attention_train_reference(*leaves, mask, bits,
                                                     scale, rate)
            want_g = torch.autograd.grad(want, leaves, dctx.float())
            ins = [x.detach().requires_grad_() for x in qkv] \
                + [relbias_layout(natural).requires_grad_()]
            got = rb.bias_attention_train(*ins, mask, seed, scale, rate)
            got_g = torch.autograd.grad(got, ins, dctx)
            gate(f"bias_train_fwd_L{length}_rate{rate}",
                 (got.float() - want).abs().max().item(), TRAIN_KERNEL_TOL)
            gate(f"bias_train_bwd_L{length}_rate{rate}",
                 rel_grads(got_g, want_g), TRAIN_KERNEL_TOL)
            del bits, leaves, want, want_g, ins, got, got_g
        bias = relbias_layout(natural)

        def bias_fwd():
            return rb.bias_attention_train_fwd_cuda(*qkv, bias, mask, seed,
                                                    scale, DROP)

        _, stats, keep = bias_fwd()
        ms[f"bias_train_fwd_L{length}"] = device_ms(bias_fwd)
        ms[f"bias_train_bwd_L{length}"] = device_ms(
            lambda: rb.bias_attention_train_bwd_cuda(
                *qkv, bias, mask, keep, stats, dctx, scale, DROP))
        del qkv, natural, mask, dctx, bias, stats, keep
    torch.cuda.empty_cache()
    emit({"phase": "kernel_tp", "heads": nh, "serve_batch": B,
          "train_batch": bt, "L": L, "L_v3": LV, "L_v2": LV2,
          "max_err": errs, "tol": {"forward": KERNEL_TOL,
                                   "train": TRAIN_KERNEL_TOL},
          "device_ms": ms})
    return errs, ms


def head_counts(model, dh=64):
    """Forward pre-hooks on every layer's attention output dense (the
    row-parallel layer fed the attention kernels' output, (B, L, nh·dh)):
    the set of head counts its inputs held, filled as the model runs."""
    seen = set()
    for layer in model.backbone.encoder.layer:
        layer.attention.output.dense.register_forward_pre_hook(
            lambda _, args: seen.add(args[0].shape[-1] // dh))
    return seen


def tp_serve_worker(spec):
    """One rank of the ``serve_tp*`` launch (TP_WORLD gloo ranks on the
    card, tp 2): per family of ``spec["models"]``, the pages through
    ``serve --tp 2`` (LiLT) or ``InferenceService(tp=2)`` (LayoutLMv3,
    LayoutXLM), the launch counts reset just before and read just after,
    with the peak allocated; then a service's batch wall ms, the attention
    kernels' head counts, the first pages' logits and (v3, v2) the bias
    build's ms and bytes. Writes its results to ``spec["result"]``."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch import serve
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.parallel import dist as pdist
    from peneo_tpu_torch.pipeline.infer import InferenceService

    pdist.init_distributed()
    me = pdist.rank()
    result = {"rank": me, "backend": pdist.dist.get_backend(),
              "device": str(pdist.rank_device())}
    img_dir, ocr_dir = spec["pages"]
    try:
        for fam, model_dir in spec["models"].items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ba, rb)
            t0 = time.perf_counter()
            if fam == "lilt":  # the serving CLI a user runs
                results = serve.main([
                    "--model_name_or_path", model_dir, "--dir_image",
                    img_dir, "--dir_ocr", ocr_dir, "--dir_save",
                    spec["save"], "--batch_size", str(B), "--max_seq_len",
                    str(L), "--tp", str(TP_WORLD), "--distributed"])
                wall = time.perf_counter() - t0
                svc = InferenceService(model_dir, batch_size=B,
                                       dtype="bfloat16", tp=TP_WORLD)
            else:
                svc = InferenceService(model_dir, batch_size=B,
                                       dtype="bfloat16", tp=TP_WORLD)
                results = svc.run(img_dir, ocr_dir)
                wall = time.perf_counter() - t0
            part = {"launches": read_counts(ba, rb),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "pages": len(results), "seconds": wall,
                    "records": json.loads(json.dumps(records_of(results)))}
            heads = head_counts(svc.model)
            pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                     for i in range(B)]
            part["spots"] = [x.cpu().numpy().tolist()
                             for x in svc.dispatch_batch(pages)]
            # one timed forward: each takes ~2 s of gloo's host sums
            part["forward_wall_ms"] = batch_wall_ms(svc, pages, n=1)
            if fam == "lilt":
                part["profile"] = forward_profile(svc, pages)
            part["heads"] = sorted(heads)
            ids, bbox, attn, kw = batch_tensors(svc, pages)
            with torch.inference_mode():
                logits = svc.model(ids, bbox, attn, return_logits=True, **kw)[
                    "line_extraction"]["logits"][:TP_LOGIT_PAGES]
                if me == 0:
                    torch.save(logits.float().cpu(),
                               spec["logits"].format(fam=fam))
                del logits
                if fam != "lilt":
                    backbone = svc.model.backbone
                    n_vis = N_VIS_V2 if fam == "v2" else N_VIS
                    boxes = rel_boxes(backbone, bbox)
                    rel = backbone.rel_bias(boxes, L, n_vis)
                    part["rel_bias_shape"] = list(rel.shape)
                    part["rel_bias_bytes"] = rel.untyped_storage().nbytes()
                    del rel
                    part["rel_bias_build_ms"] = time_ms(
                        lambda: backbone.rel_bias(boxes, L, n_vis), n=5)
            result[fam] = part
            del svc
            pdist.barrier()
    finally:
        pdist.shutdown()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def forward_profile(svc, pages):
    """One batch's dispatch and fetch under torch.profiler (after
    ``batch_wall_ms`` warmed it): wall ms, device ms and its parts (GEMMs,
    copies between host and card), and the largest rows; under tp every
    rank of the group calls it at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc._fetch(svc.dispatch_batch(pages))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, device = device_rows(prof, wall, None, "")
    return {"wall_ms": wall, "device_ms": device,
            "gemm_ms": sum(ms for k, ms, _ in rows if "gemm" in k.lower()),
            "copy_ms": sum(ms for k, ms, _ in rows if k.startswith("Memcpy")),
            "top": [[k[:80], round(ms, 3), n] for k, ms, n in rows[:8]]}


def fp32_logits(model_dir, ids, bbox, attn, kw):
    """The line-extraction logits of the first TP_LOGIT_PAGES pages in
    fp32, attention through the plain twins and no TF32 (the exact
    reference of both bf16 services)."""
    import torch

    from peneo_tpu_torch.config import PEneoConfig
    from peneo_tpu_torch.models.peneo import PEneoModel
    from peneo_tpu_torch.pipeline.infer import load_weights

    model = PEneoModel(PEneoConfig.from_pretrained(model_dir))
    load_weights(model, model_dir)
    model = model.cast(torch.float32).cuda().eval()
    model.set_attention_impl("plain")
    n = TP_LOGIT_PAGES
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # v3's patch conv, v2's tower
    try:
        with torch.inference_mode():
            out = model(ids[:n], bbox[:n], attn[:n], return_logits=True,
                        **{k: v[:n] for k, v in kw.items()})[
                "line_extraction"]["logits"].float().cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del model
    torch.cuda.empty_cache()
    return out


def logit_rel_err(got, want):
    """‖got − want‖ / ‖want‖ over the first pages' logits."""
    return ((got - want).norm() / want.norm()).item()


def phase_serve_tp(ba, rb, tmp, img_dir, ocr_dir, models, smi):
    """Tensor-parallel serving at B = 32, L = 512, bf16 over TP_PAGES of the
    96 pages (one batch, cut for the script's 1200 s), the serving phases'
    models (``models``) cut to CUT_LAYERS:
    TP_WORLD gloo ranks on the card at tp 2, LiLT-base through ``serve --tp
    2`` (``serve_tp``), LayoutLMv3-base (``serve_tp_v3``) and LayoutXLM-base
    (``serve_tp_v2``) through ``InferenceService(tp=2)``, one launch;
    against one process's ``InferenceService`` here on the same model
    directories and an fp32 forward of the first pages through the plain
    twins. Returns the launch counts of both."""
    import numpy as np
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    models = {fam: cut_model(tmp, fam, d) for fam, d in models.items()}
    img_dir, ocr_dir = first_pages(tmp, img_dir, ocr_dir, TP_PAGES, "tp")
    spec = {"worker": "tp_serve", "models": models,
            "pages": [img_dir, ocr_dir],
            "save": os.path.join(tmp, "serve_tp.json"),
            "logits": os.path.join(tmp, "serve_tp_logits_{fam}.pt")}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, TP_WORLD, tmp, "serve_tp")
    ranks_wall = time.perf_counter() - t0
    with open(spec["save"]) as f:  # what serve --tp 2 wrote (rank 0)
        written = json.loads(json.dumps(records_of(json.load(f))))
    total = {k: 0 for k in ranks[0]["lilt"]["launches"]}
    errors = []
    n_forwards = math.ceil(TP_PAGES / B)
    for fam, model_dir in models.items():
        tag = "serve_tp" if fam == "lilt" else f"serve_tp_{fam}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ba, rb)
        t0 = time.perf_counter()
        svc = InferenceService(model_dir, batch_size=B, dtype="bfloat16")
        records = json.loads(json.dumps(records_of(svc.run(img_dir,
                                                           ocr_dir))))
        solo_wall = time.perf_counter() - t0
        solo_counts = read_counts(ba, rb)
        solo_peak = torch.cuda.max_memory_allocated()
        pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                 for i in range(B)]
        spots = [x.cpu().numpy().tolist() for x in svc.dispatch_batch(pages)]
        k = svc.cfg.max_spots_per_head
        solo_ms = batch_wall_ms(svc, pages)
        ids, bbox, attn, kw = batch_tensors(svc, pages)
        extra = {}
        with torch.inference_mode():
            want = svc.model(ids, bbox, attn, return_logits=True, **kw)[
                "line_extraction"]["logits"][:TP_LOGIT_PAGES].float().cpu()
            solo_profile = (forward_profile(svc, pages) if fam == "lilt"
                            else None)
            if fam != "lilt":
                backbone = svc.model.backbone
                n_vis = N_VIS_V2 if fam == "v2" else N_VIS
                boxes = rel_boxes(backbone, bbox)
                rel = backbone.rel_bias(boxes, L, n_vis)
                extra = {"rel_bias_bytes_one_process":
                         rel.untyped_storage().nbytes(),
                         "rel_bias_build_ms_one_process": time_ms(
                             lambda: backbone.rel_bias(boxes, L, n_vis),
                             n=5)}
                del rel
        del svc
        exact = fp32_logits(model_dir, ids, bbox, attn, kw)
        got = torch.load(spec["logits"].format(fam=fam), weights_only=True)
        rel_err = logit_rel_err(got, want)
        fp32_err = {"tp": logit_rel_err(got, exact),
                    "one_process": logit_rel_err(want, exact)}
        kernel = "biacm_attention" if fam == "lilt" else "bias_attention"
        mine = [r[fam] for r in ranks]
        spot_errors, summary = spot_gate(spots, mine[0]["spots"], k,
                                         count_rtol=None)
        errors += [f"{tag}: {e}" for e in spot_errors]
        report = {
            "phase": tag, "nvidia_smi": smi, "tp": TP_WORLD,
            "layers": CUT_LAYERS,
            "backend": ranks[0]["backend"], "batch_size": B, "L": L,
            "spots": summary,
            "pages_with_records_equal_one_process":
                [sum(m["records"][p] == v for p, v in records.items())
                 for m in mine],
            "logits_rel_err": rel_err, "logits_tol": TP_LOGIT_TOL,
            "logits_rel_err_vs_fp32": fp32_err,
            "logits_fp32_factor": TP_FP32_LOGIT_FACTOR,
            "heads_ranks": [m["heads"] for m in mine],
            "launches_ranks": [m["launches"] for m in mine],
            "launches_one_process": solo_counts,
            "forward_wall_ms_ranks": [m["forward_wall_ms"] for m in mine],
            "forward_wall_ms_one_process": solo_ms,
            "pages_per_s_ranks": [TP_PAGES / m["seconds"] for m in mine],
            "run_seconds_ranks": [m["seconds"] for m in mine],
            "pages_per_s_one_process": TP_PAGES / solo_wall,
            "max_memory_allocated_ranks":
                [m["max_memory_allocated"] for m in mine],
            "max_memory_allocated_one_process": solo_peak,
            "ranks_wall_seconds": ranks_wall, **extra}
        if fam != "lilt":
            report["rel_bias_bytes_ranks"] = [m["rel_bias_bytes"]
                                              for m in mine]
            report["rel_bias_build_ms_ranks"] = [m["rel_bias_build_ms"]
                                                 for m in mine]
            report["rel_bias_shape_ranks"] = [m["rel_bias_shape"]
                                              for m in mine]
            if any(2 * b != extra["rel_bias_bytes_one_process"]
                   for b in report["rel_bias_bytes_ranks"]):
                errors.append(f"{tag}: bias bytes "
                              f"{report['rel_bias_bytes_ranks']} vs one "
                              f"process {extra['rel_bias_bytes_one_process']}")
        else:  # what the CLI wrote is what its ranks served
            report["cli_wrote_the_ranks_records"] = \
                written == mine[0]["records"]
            report["forward_profile_ranks"] = [m["profile"] for m in mine]
            report["forward_profile_one_process"] = solo_profile
            if written != mine[0]["records"] or len(written) != TP_PAGES:
                errors.append(f"{tag}: serve --tp 2 wrote other records")
        emit(report)
        if any(m["spots"] != mine[0]["spots"] or m["records"]
               != mine[0]["records"] for m in mine):
            errors.append(f"{tag}: the ranks' spots or records differ")
        if not np.isfinite(got.numpy()).all() or rel_err > TP_LOGIT_TOL \
                or fp32_err["tp"] > TP_FP32_LOGIT_FACTOR * \
                fp32_err["one_process"]:
            errors.append(f"{tag}: logits rel err {rel_err}, against fp32 "
                          f"{fp32_err}")
        for m in mine:
            if m["heads"] != [TP_NH] or m["pages"] != TP_PAGES:
                errors.append(f"{tag}: heads {m['heads']}, pages "
                              f"{m['pages']}")
            expect_counts(m["launches"], {kernel: CUT_LAYERS * n_forwards},
                          f"{tag} rank")
            for k, v in m["launches"].items():
                total[k] += v
        for k, v in solo_counts.items():
            total[k] += v
    if errors:
        raise RuntimeError("serve_tp: " + "; ".join(errors))
    return total


def tp_train_worker(spec):
    """One rank of the ``train_tp*`` launch (TP_WORLD gloo ranks, tp 2) or,
    with ``spec["sp"]``, of ``grid_tp`` (dp 1 × tp 2 × sp 2): per family,
    the step-1 gradient (gathered; rank 0 saves it) and loss, the first
    layer's attention-dropout flags under its (dp, tp) shard's seed, then
    (not in grid_tp) TP_STEPS steps and an eval through ``run_rfund``'s
    setup and ``PEneoTrainer`` with the launch counts reset just before and
    read just after; in grid_tp one batch's spots through
    ``InferenceService(tp=2, sp=2)`` instead."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.parallel import dist as pdist
    from peneo_tpu_torch.pipeline.infer import InferenceService
    from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

    pdist.init_distributed()
    me = pdist.rank()
    result = {"rank": me, "backend": pdist.dist.get_backend(),
              "device": str(pdist.rank_device())}
    parse = run_rfund.build_argparser().parse_args
    try:
        for fam, part in spec["families"].items():
            mine = {}
            loss, grads = first_step_grads(part["probe"] + ["--distributed"])
            mine["grid"] = [pdist.dp_index(), pdist.tp_index(),
                            pdist.sp_index()]
            mine["step1_loss"] = loss
            if me == 0:
                torch.save(grads, part["grads"])
            seed, keep = rank_keep_flags(ba, pdist.seed_shard(), TRAIN_B,
                                         TP_NH, rb if fam == "v3" else None)
            mine["keep_seed"] = seed
            torch.save(keep, part["keep"].format(rank=me))
            torch.cuda.empty_cache()
            if spec.get("sp"):
                img_dir, ocr_dir = spec["pages"]
                reset_counts(ba, rb)
                svc = InferenceService(part["model"], batch_size=B,
                                       dtype="bfloat16", dp=1, tp=TP_WORLD,
                                       sp=spec["sp"])
                pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
                         for i in range(B)]
                mine["spots"] = [x.cpu().numpy().tolist()
                                 for x in svc.dispatch_batch(pages)]
                mine["launches"] = read_counts(ba, rb)
                del svc
            else:
                torch.cuda.reset_peak_memory_stats()
                reset_counts(ba, rb)
                args = parse(part["argv"] + ["--distributed"])
                cfg, model, train_ds, eval_ds, collator, tok = \
                    run_rfund.setup(args)
                trainer = PEneoTrainer(cfg, model,
                                       run_rfund.training_arguments(args),
                                       train_ds, eval_ds, collator,
                                       tokenizer=tok)
                trainer.train()
                mine["launches"] = read_counts(ba, rb)
                mine["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated()
                mine["seed_offset"] = trainer.seeds.offset
                del trainer, model
            result[fam] = mine
            torch.cuda.empty_cache()
            pdist.barrier()
    finally:
        pdist.shutdown()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def fp32_trajectory(argv, steps=TP_STEPS):
    """The exact reference of ``argv``'s bf16 steps: the same first
    ``steps`` steps in this process in fp32, attention through the plain
    twins (the CUDA kernels take bf16), on the trainer's batches in the
    trainer's order, with its optimizer: each step's loss and grad norm,
    and step 1's probe gradients (:func:`probe_names`)."""
    import torch

    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.models.dropout_seeds import HostSeeds
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import DataFeed, batch_to_device

    args = run_rfund.build_argparser().parse_args(argv)
    targs = run_rfund.training_arguments(args)
    cfg, model, train_ds, _, collator, _ = run_rfund.setup(args)
    model.cuda().set_attention_impl("plain")
    optimizer, scheduler = T.make_optimizer(
        model, lr=targs.learning_rate, total_steps=targs.max_steps,
        warmup_ratio=targs.warmup_ratio, weight_decay=targs.weight_decay,
        downstream_speedup_ratio=cfg.peneo_downstream_speedup_ratio)
    feed = DataFeed(train_ds, collator, targs.per_device_train_batch_size,
                    shuffle=True, seed=targs.seed)
    seeds = HostSeeds(torch.Generator().manual_seed(targs.seed))
    out = {"losses": [], "grad_norms": []}
    it = iter(feed)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # v3's patch conv, v2's tower
    for step in range(steps):
        try:
            raw = next(it)
        except StopIteration:  # the trainer's epoch wrap
            it = iter(feed)
            raw = next(it)
        metrics = T.train_step(model, optimizer, scheduler,
                               batch_to_device(raw, torch.device("cuda")),
                               targs.max_grad_norm, seeds, torch.float32)
        out["losses"].append(metrics["total"].item())
        out["grad_norms"].append(metrics["grad_norm"].item())
        if step == 0:
            params = dict(model.named_parameters())
            out["grads"] = {n: params[n].grad.detach().float().cpu()
                            for n in probe_names(model)}
    torch.backends.cudnn.allow_tf32 = tf32
    del model, optimizer, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def max_rel_err(got, want):
    """The largest ``|g − w| / |w|`` over paired values."""
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def near_fp32(tp_err, one_err, tol):
    """The second gate: tp's error against the fp32 run within ``tol`` or
    no more than TP_FP32_FACTOR times one process's."""
    return tp_err <= max(tol, TP_FP32_FACTOR * one_err)


def train_solo(argv):
    """``argv``'s steps and eval in this process through ``run_rfund``'s
    setup and ``PEneoTrainer`` (no model saved)."""
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

    args = run_rfund.build_argparser().parse_args(argv)
    cfg, model, train_ds, eval_ds, collator, tok = run_rfund.setup(args)
    trainer = PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                           train_ds, eval_ds, collator, tokenizer=tok)
    trainer.train()
    del trainer, model
    gc.collect()


def grad_errors(grads, want):
    """Each tensor's max abs error over its own max |reference|."""
    return {n: ((grads[n] - g).abs().max() / g.abs().max()).item()
            for n, g in want.items()}


def grad_tol(name):
    """The step-1 gradient tolerance of ``name`` (over its max)."""
    return SP_QK_TOL if SP_QK.fullmatch(name) else DP_GRAD_TOL


def grads_gate(err, fp32_err, one_fp32_err, errors, what):
    """Step-1 gradients: each tensor's error against one process's ``err``
    within DP_GRAD_TOL (layer 11's query and key SP_QK_TOL, train_sp's
    spread), and its error against the fp32 run's ``fp32_err`` within the
    same or TP_FP32_FACTOR times one process's ``one_fp32_err``."""
    bad = {n: v for n, v in err.items() if v > grad_tol(n)}
    far = {n: (v, one_fp32_err[n]) for n, v in fp32_err.items()
           if not near_fp32(v, one_fp32_err[n], grad_tol(n))}
    if bad or far or len(err) < 20 or set(err) != set(fp32_err):
        errors.append(f"{what}: step-1 gradients against one process "
                      f"{bad or len(err)}, against fp32 (tp, one process) "
                      f"{far}")


def phase_train_tp(ba, rb, tmp, inits, datas, smi):
    """Tensor-parallel fine-tuning at B = 8, L = 512, bf16, dropout 0:
    TP_WORLD gloo ranks of ``run_rfund --distributed --tp 2`` on the card,
    TP_STEPS steps and an eval of LiLT-base (``train_tp``, on train_dp's
    corpus) and of LayoutLMv3-base at the 224 px geometry (``train_tp_v3``,
    train_v3's corpus), one launch, each from the seeded random model its
    serving phase wrote (``inits``) at the decoder's own learning rate;
    against the same steps in one process here (losses and grad norms
    within 1e-3, step-1 gradients within 1e-2 of each tensor's max, layer
    11's query and key 5e-2) and in fp32 through the plain twins (the
    exact reference: tp within those tolerances of it or no further from
    it than TP_FP32_FACTOR times one process's bf16 run). Returns the launch
    counts of both and the LiLT reference: its model and corpus, one
    process's step-1 loss and gradients and the fp32 run."""
    import torch

    # both at the decoder's own learning rate (LiLT's default): at v3's ×30
    # any two bf16 runs part by more than 1e-3 within 6 steps (PERF.md §6)
    models = {fam: graph_model_dir(init, os.path.join(
        tmp, f"tp_{fam}_model"), 0.0, peneo_downstream_speedup_ratio=1.0)
        for fam, init in inits.items()}
    fams = {}
    for fam in inits:
        def argv(out, *extra, f=fam):
            return dp_argv(models[f], datas[f], os.path.join(tmp, out),
                           TRAIN_B, *extra, steps=TP_STEPS)
        fams[fam] = {
            "argv": argv(f"tp_{fam}", "--tp", str(TP_WORLD)),
            "solo": argv(f"tp_{fam}_solo"),
            "probe": dp_argv(models[fam], datas[fam],
                             os.path.join(tmp, f"tp_probe_{fam}"), TRAIN_B,
                             "--tp", str(TP_WORLD)),
            "grads": os.path.join(tmp, f"tp_grads_{fam}.pt"),
            "keep": os.path.join(tmp, f"tp_keep_{fam}.rank{{rank}}.pt")}
    spec = {"worker": "tp_train",
            "families": {f: {k: v for k, v in p.items() if k != "solo"}
                         for f, p in fams.items()}}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, TP_WORLD, tmp, "train_tp")
    ranks_wall = time.perf_counter() - t0

    total = {k: 0 for k in ranks[0][next(iter(inits))]["launches"]}
    reference = None
    errors = []
    layers = 12
    for fam, part in fams.items():
        tag = "train_tp" if fam == "lilt" else "train_tp_v3"
        # one process: the same steps, and (v3) the step-1 probe
        reset_counts(ba, rb)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_solo(part["solo"])
        solo_wall = time.perf_counter() - t0
        solo_counts = read_counts(ba, rb)
        solo_peak = torch.cuda.max_memory_allocated()
        solo_loss, solo_grads = first_step_grads(dp_argv(
            models[fam], datas[fam], os.path.join(tmp, f"tp_probe_solo_{fam}"),
            TRAIN_B))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        exact = fp32_trajectory(part["solo"])
        fp32_wall = time.perf_counter() - t0
        if fam == "lilt":
            reference = {"model": models[fam], "data": datas[fam],
                         "loss": solo_loss, "grads": solo_grads,
                         "exact": exact}
        for k, v in solo_counts.items():
            total[k] += v
        solo_steps, solo_evals = log_records(os.path.join(
            tmp, f"tp_{fam}_solo", "log.jsonl"))
        logs = [log_records(os.path.join(tmp, f"tp_{fam}", "log.jsonl"
                                         if r == 0 else f"log.rank{r}.jsonl"))
                for r in range(TP_WORLD)]
        want = [r["loss/total"] for r in solo_steps]
        got = [[r["loss/total"] for r in steps] for steps, _ in logs]
        norms = [[r["loss/grad_norm"] for r in steps] for steps, _ in logs]
        solo_norms = [r["loss/grad_norm"] for r in solo_steps]
        keys = ("eval/precision", "eval/recall", "eval/f1",
                "eval/num_sample_processed")
        evals = [{k: e[0][k] for k in keys} for _, e in logs]
        solo_eval = {k: solo_evals[0][k] for k in keys}
        grads = torch.load(part["grads"], weights_only=True)
        grad_err = grad_errors(grads, solo_grads)
        tp_fp32_err = grad_errors(grads, exact["grads"])
        one_fp32_err = grad_errors(solo_grads, exact["grads"])
        flags, same, kept = [], [], []
        for r in ranks:
            keep = torch.load(part["keep"].format(rank=r["rank"]),
                              weights_only=True)
            seed = r[fam]["keep_seed"]
            if fam == "lilt":
                bits = torch.stack(ba.attention_dropout_bits(
                    seed, TRAIN_B, TP_NH, L, device="cuda"))
            else:
                bits = ba.element_dropout_bits(seed, TRAIN_B, TP_NH, LV,
                                               device="cuda")
            keep_bits = bits < ba.keep_threshold(DROP)
            same.append(torch.equal(keep, ba.pack_keep_mask(keep_bits).cpu()))
            kept.append(keep_bits.float().mean().item())
            flags.append(keep)
            del bits, keep_bits
        mine = [r[fam] for r in ranks]
        fp32 = {"losses": exact["losses"], "grad_norms": exact["grad_norms"],
                "wall_seconds": fp32_wall,
                "loss_max_rel_err_ranks": max_rel_err(got[0],
                                                      exact["losses"]),
                "loss_max_rel_err_one_process": max_rel_err(
                    want, exact["losses"]),
                "grad_norm_max_rel_err_ranks": max_rel_err(
                    norms[0], exact["grad_norms"]),
                "grad_norm_max_rel_err_one_process": max_rel_err(
                    solo_norms, exact["grad_norms"]),
                "step1_grad_err_ranks": tp_fp32_err,
                "step1_grad_err_one_process": one_fp32_err}
        report = {
            "phase": tag, "nvidia_smi": smi, "tp": TP_WORLD,
            "backend": ranks[0]["backend"], "steps": TP_STEPS,
            "global_batch": TRAIN_B, "L": LV if fam == "v3" else L,
            "dropout": 0.0, "grid": [m["grid"] for m in mine],
            "losses_one_process": want, "losses_ranks": got,
            "loss_max_rel_err": max_rel_err(got[0], want),
            "grad_norm_one_process": solo_norms, "grad_norm_rank0": norms[0],
            "grad_norm_max_rel_err": max_rel_err(norms[0], solo_norms),
            "step1_loss": {"ranks": [m["step1_loss"] for m in mine],
                           "one_process": solo_loss},
            "step1_grad_err_over_max": grad_err,
            "fp32": fp32,
            "eval_ranks": evals, "eval_one_process": solo_eval,
            "dropout_flags": {"rate": DROP, "heads": TP_NH,
                              "seeds": [m["keep_seed"] for m in mine],
                              "equal_to_seed_bits": same,
                              "kept_share": kept,
                              "ranks_differ": not torch.equal(flags[0],
                                                              flags[1])},
            "seed_offsets": [m["seed_offset"] for m in mine],
            "launches_ranks": [m["launches"] for m in mine],
            "launches_one_process": solo_counts,
            "ms_per_step_logged_ranks": step_ms(logs[0][0]),
            "ms_per_step_logged_one_process": step_ms(solo_steps),
            "max_memory_allocated_ranks":
                [m["max_memory_allocated"] for m in mine],
            "max_memory_allocated_one_process": solo_peak,
            "one_process_wall_seconds": solo_wall,
            "ranks_wall_seconds": ranks_wall,
            "tol": {"loss": DP_LOSS_RTOL, "grad": DP_GRAD_TOL,
                    "grad_layer11_query_key": SP_QK_TOL,
                    "grad_norm": TP_GRAD_NORM_RTOL, "kept_share": KEEP_TOL,
                    "fp32_factor": TP_FP32_FACTOR}}
        emit(report)
        if len(want) != TP_STEPS or any(g != got[0] for g in got) \
                or not rel_close(got[0], want, DP_LOSS_RTOL) \
                or not near_fp32(fp32["loss_max_rel_err_ranks"],
                                 fp32["loss_max_rel_err_one_process"],
                                 DP_LOSS_RTOL):
            errors.append(f"{tag}: losses {got} vs one process {want}, "
                          f"fp32 {exact['losses']}")
        if not rel_close(norms[0], solo_norms, TP_GRAD_NORM_RTOL) \
                or not near_fp32(fp32["grad_norm_max_rel_err_ranks"],
                                 fp32["grad_norm_max_rel_err_one_process"],
                                 TP_GRAD_NORM_RTOL):
            errors.append(f"{tag}: grad norms {norms[0]} vs {solo_norms}, "
                          f"fp32 {exact['grad_norms']}")
        if any(e != solo_eval for e in evals):
            errors.append(f"{tag}: eval {evals} vs one process {solo_eval}")
        if set(grads) != set(solo_grads) or set(grads) != set(exact["grads"]):
            errors.append(f"{tag}: probed {sorted(grads)}")
        grads_gate(grad_err, tp_fp32_err, one_fp32_err, errors, tag)
        if not all(same) or not report["dropout_flags"]["ranks_differ"] \
                or any(abs(k - (1.0 - DROP)) > KEEP_TOL for k in kept):
            errors.append(f"{tag}: dropout flags {report['dropout_flags']}")
        if report["seed_offsets"] != [t * 1000003 for t in range(TP_WORLD)]:
            errors.append(f"{tag}: seed offsets {report['seed_offsets']}")
        with open(os.path.join(datas[fam], "en.val.json")) as f:
            n_eval = math.ceil(len(json.load(f)["documents"]) / TRAIN_B)
        per_run = ({"fwd": layers * TP_STEPS, "bwd": layers * TP_STEPS,
                    "biacm_attention": layers * n_eval} if fam == "lilt" else
                   {"bias_fwd": layers * TP_STEPS,
                    "bias_bwd": layers * TP_STEPS,
                    "bias_attention": layers * n_eval})
        for m in mine:
            expect_counts(m["launches"], per_run, f"{tag} rank")
            for k, v in m["launches"].items():
                total[k] += v
    if errors:
        raise RuntimeError("train_tp: " + "; ".join(errors))
    return total, reference


def phase_grid_tp(ba, rb, tmp, ref, img_dir, ocr_dir, smi):
    """dp 1 × tp 2 × sp 2: four gloo ranks on the card (rank = (d·2 + t)·2
    + s) with LiLT-base, bf16, dropout 0: the step-1 loss and gradients
    under ``run_rfund --tp 2 --sp 2`` (CE) from train_tp's model and corpus
    ``ref`` against one process's and the fp32 run's, gated as train_tp's,
    and one batch of the 96 pages' spots through ``InferenceService(tp=2,
    sp=2)`` against one process's (``spot_gate``)."""
    import torch

    from peneo_tpu_torch.pipeline.infer import InferenceService

    world = TP_WORLD * SP_WORLD
    model_dir = os.path.join(tmp, "model")
    spec = {"worker": "tp_train", "sp": SP_WORLD,
            "pages": [img_dir, ocr_dir],
            "families": {"lilt": {
                "model": model_dir,
                "probe": dp_argv(ref["model"], ref["data"],
                                 os.path.join(tmp, "grid_tp_probe"), TRAIN_B,
                                 "--tp", str(TP_WORLD), "--sp",
                                 str(SP_WORLD)),
                "grads": os.path.join(tmp, "grid_tp_grads.pt"),
                "keep": os.path.join(tmp, "grid_tp_keep.rank{rank}.pt")}}}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, world, tmp, "grid_tp")
    ranks_wall = time.perf_counter() - t0
    reset_counts(ba, rb)
    svc = InferenceService(model_dir, batch_size=B, dtype="bfloat16")
    pages = [svc.preprocess_page(*page_paths(img_dir, ocr_dir, i))
             for i in range(B)]
    spots = [x.cpu().numpy().tolist() for x in svc.dispatch_batch(pages)]
    solo_counts = read_counts(ba, rb)
    k = svc.cfg.max_spots_per_head
    del svc
    torch.cuda.empty_cache()
    mine = [r["lilt"] for r in ranks]
    errors, summary = spot_gate(spots, mine[0]["spots"], k,
                                count_rtol=None)
    if any(m["spots"] != mine[0]["spots"] for m in mine):
        errors.append("the ranks' merged spots differ")
    grads = torch.load(spec["families"]["lilt"]["grads"], weights_only=True)
    exact = ref["exact"]
    grad_err = grad_errors(grads, ref["grads"])
    fp32_err = grad_errors(grads, exact["grads"])
    one_err = grad_errors(ref["grads"], exact["grads"])
    grads_gate(grad_err, fp32_err, one_err, errors, "grid_tp")
    losses = [m["step1_loss"] for m in mine]
    loss1 = exact["losses"][0]
    if not rel_close(losses, [ref["loss"]] * world, DP_LOSS_RTOL) \
            or not near_fp32(max_rel_err(losses, [loss1] * world),
                             abs(ref["loss"] - loss1) / abs(loss1),
                             DP_LOSS_RTOL):
        errors.append(f"step-1 losses {losses} vs {ref['loss']}, fp32 "
                      f"{loss1}")
    want_grid = [[0, t, s] for t in range(TP_WORLD) for s in range(SP_WORLD)]
    if [m["grid"] for m in mine] != want_grid:
        errors.append(f"grid {[m['grid'] for m in mine]}")
    for m in mine:
        expect_counts(m["launches"], {"biacm_attention": 12}, "grid_tp rank")
    emit({"phase": "grid_tp", "nvidia_smi": smi, "dp": 1, "tp": TP_WORLD,
          "sp": SP_WORLD, "backend": ranks[0]["backend"],
          "grid": [m["grid"] for m in mine],
          "step1_loss": {"ranks": losses, "one_process": ref["loss"],
                         "fp32": loss1},
          "step1_grad_err_over_max": grad_err,
          "step1_grad_err_vs_fp32": {"ranks": fp32_err,
                                     "one_process": one_err},
          "spots": summary,
          "launches_ranks": [m["launches"] for m in mine],
          "ranks_wall_seconds": ranks_wall,
          "tol": {"loss": DP_LOSS_RTOL, "grad": DP_GRAD_TOL,
                  "grad_layer11_query_key": SP_QK_TOL,
                  "fp32_factor": TP_FP32_FACTOR}})
    if errors:
        raise RuntimeError("grid_tp: " + "; ".join(errors))
    total = dict(solo_counts)
    for m in mine:
        for key, v in m["launches"].items():
            total[key] += v
    return total


# fsdp and K steps per call in a process group -------------------------------

# --fsdp at NCCL world 1 (off: dp 1) against one process: train_dp's NCCL gate, for the
# losses and for the saved tensors (each over its own max |value|)
FSDP_RTOL = NCCL_LOSS_RTOL
# train_graph_dp: the parity trainers' schedule (8 steps with 2 of warmup:
# every one of the K steps moves the parameters); ms/step over the steps
# after the first log (48 of GRAPH_STEPS: LiLT's feed keeps up from there)
GRAPH_DP_PARITY_STEPS = 8
GRAPH_DP_FROM = GRAPH_LOG


def graph_parity(trainer, group, gen):
    """From the trainer's state and the GRAPH_K batches of ``group``:
    GRAPH_K of its K = 1 steps (``train_step`` on its step model, with its
    gradient mean), then one replay of a K-step graph (``MultiTrainStep``
    with the trainer's shard and gradient mean) from that state again,
    every dropout 0. Returns train_graph_parity's comparison and the step
    function."""
    import torch

    from peneo_tpu_torch.parallel import dist as pdist
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import tree_map

    optimizer, scheduler = trainer.optimizer, trainer.scheduler
    names, params = zip(*[(n, p) for n, p in trainer.model.named_parameters()
                          if p.requires_grad])
    start = [p.detach().clone() for p in params]

    def reset():  # in place: the graph keeps these tensors
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        for state in optimizer.state.values():
            for v in state.values():
                v.zero_()
        scheduler.count.zero_()

    names3 = ("total", "learning_rate", "grad_norm")
    reset()
    rows = [T.train_step(trainer.step_model, optimizer, scheduler,
                         tree_map(lambda t, k=k: t[k], group), 1.0, gen,
                         torch.bfloat16, trainer.grad_sync)
            for k in range(GRAPH_K)]
    eager = {k: [float(m[k]) for m in rows] for k in names3}
    reference = [p.detach().clone() for p in params]
    step_fn = T.MultiTrainStep(trainer.step_model, optimizer, scheduler,
                               GRAPH_K, 1.0, gen, torch.bfloat16, SEED,
                               pdist.seed_shard(), trainer.grad_sync)
    reset()
    step_fn(group)  # the warm-up's eager steps, then the capture
    reset()
    step_fn(group)  # one replay
    torch.cuda.synchronize()
    graph = {k: step_fn.per_step[k].tolist() for k in names3}
    diffs = sorted(((p - r).abs().max().item(), n)
                   for n, p, r in zip(names, params, reference))
    return {"eager": eager, "graph": graph,
            "loss_max_rel_diff": max(abs(x - y) / abs(y) for x, y
                                     in zip(graph["total"], eager["total"])),
            "learning_rates_equal":
                graph["learning_rate"] == eager["learning_rate"],
            "param_max_abs_diff": diffs[-1][0],
            "bit_identical": diffs[-1][0] == 0.0 and graph == eager}, step_fn


def nccl_worker(spec):
    """The one NCCL rank (world 1; ``chip_smoke.py --dp-worker``) of
    train_fsdp and train_graph_dp, one launch for the two.
    1. ``spec["runs"]``: each ``run_rfund``'s steps, eval and save with the
       launch counts reset just before and read just after.
    2. ``spec["parity"]``: per layout a K-step trainer at dropout 0 and
       :func:`graph_parity`, the seeds of two replays, the replays' ms.
    3. ``spec["graph_argv"]``: the K-step trainer's GRAPH_STEPS steps and
       eval (counts reset just before), then one profiled replay of a
       K-step graph of the model it trained.
    Writes the results to ``spec["result"]``."""
    import torch

    sys.path.insert(0, REPO)
    from peneo_tpu_torch import run_rfund
    from peneo_tpu_torch.models.dropout_seeds import (LAYERS_PER_STEP,
                                                      RANK_STRIDE)
    from peneo_tpu_torch.ops import biacm_attention as ba
    from peneo_tpu_torch.ops import bias_attention as rb
    from peneo_tpu_torch.parallel import dist as pdist
    from peneo_tpu_torch.pipeline import train as T
    from peneo_tpu_torch.pipeline.loader import stack_batches, \
        to_host_tensors, tree_map
    from peneo_tpu_torch.pipeline.trainer import PEneoTrainer

    def parse(argv):
        return run_rfund.build_argparser().parse_args(argv + ["--distributed"])

    def trainer_of(argv):
        args = parse(argv)
        cfg, model, train_ds, eval_ds, collator, _ = run_rfund.setup(args)
        return PEneoTrainer(cfg, model, run_rfund.training_arguments(args),
                            train_ds, eval_ds, collator)

    def group_of(trainer):  # GRAPH_K batches of its corpus, stacked
        items = [[trainer.train_dataset[j * TRAIN_B + i]
                  for i in range(TRAIN_B)] for j in range(GRAPH_K)]
        return tree_map(lambda t: t.cuda(), to_host_tensors(stack_batches(
            [trainer.collator(x) for x in items]), pin=True))

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ba, rb)

    run_rfund.init_parallel(parse(spec["graph_argv"]))
    result = {"rank": pdist.rank(), "world": pdist.world(),
              "backend": pdist.dist.get_backend(), "runs": {},
              "parity": {}}
    try:
        for run in spec["runs"]:
            fresh()
            t0 = time.perf_counter()
            _, trainer = run_rfund.run(parse(run["argv"]))
            result["runs"][run["name"]] = {
                "fsdp": trainer.fsdp,
                "wall_seconds": time.perf_counter() - t0,
                "launches": read_counts(ba, rb),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "max_memory_reserved": torch.cuda.max_memory_reserved(),
                "steady_ms": steady_ms(trainer)}
            del trainer
        for name, argv in spec["parity"].items():
            fresh()
            trainer = trainer_of(argv)
            group = group_of(trainer)
            report, step_fn = graph_parity(
                trainer, group, torch.Generator().manual_seed(SEED))
            seeds = []
            for _ in range(2):
                seeds.append(int(step_fn.seeds.layer(0)))
                step_fn(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step_fn(group)
            torch.cuda.synchronize()
            report.update({
                "fsdp": trainer.fsdp,
                "grad_sync": trainer.grad_sync is not None,
                "seed_base": step_fn.seeds.base,
                "seed_base_expected": (SEED << 32)
                + pdist.seed_shard() * RANK_STRIDE,
                "layer0_seeds_of_two_replays": seeds,
                "seed_advance_expected": GRAPH_K * LAYERS_PER_STEP,
                "replay_ms_per_step":
                    (time.perf_counter() - t0) / (3 * GRAPH_K) * 1e3})
            result["parity"][name] = report
            del trainer, group, step_fn
        fresh()
        trainer = trainer_of(spec["graph_argv"])
        t0 = time.perf_counter()
        trainer.train()
        result["graph_run"] = {
            "wall_seconds": time.perf_counter() - t0,
            "grad_sync": trainer.grad_sync is not None,
            "launches": read_counts(ba, rb),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved()}
        # one profiled replay of a K-step graph of the trained model
        group = group_of(trainer)
        step_fn = T.MultiTrainStep(
            trainer.step_model, trainer.optimizer, trainer.scheduler,
            GRAPH_K, 1.0, None, torch.bfloat16, SEED, pdist.seed_shard(),
            trainer.grad_sync)
        step_fn(group)  # warm-up and capture
        step_fn(group)
        torch.cuda.synchronize()
        rows, busy_ms, replay_ms, traces, _ = profiled_replay(
            step_fn, group, STEP_KERNELS[""], spec.get("profile"),
            "train_graph_dp")
        result["replay"] = {
            "ms": replay_ms, "busy_ms": busy_ms,
            "trace_launches": traces[-1], "profiled_replays": len(traces),
            "nccl_ms": sum(ms for k, ms, _ in rows if "nccl" in k.lower()),
            "top_kernels": [[k[:90], round(ms, 3), n]
                            for k, ms, n in rows[:8]]}
        del trainer, step_fn, group
        pdist.barrier()
    finally:
        pdist.dist.destroy_process_group()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def phase_nccl_world1(tmp, reference, train_record, profile_dir):
    """One NCCL rank (world 1) for train_fsdp and train_graph_dp
    (``nccl_worker``; one launch, the kernel libraries loaded once):
    LiLT-base at train_dp's CE run's arguments under DDP (train_dp's NCCL
    world-1 run) and with ``--fsdp`` (off at dp 1); K = GRAPH_K steps per
    CUDA graph: a parity trainer at dropout 0, and train's arguments for
    GRAPH_STEPS steps at dropout 0.1. Returns the rank's results and the
    runs' arguments."""
    lilt, data = reference["models"]["ce"], reference["data"]

    def out(name):
        return os.path.join(tmp, name)

    runs = [{"name": "ddp", "argv": dp_argv(lilt, data, out("fsdp_ddp"),
                                            TRAIN_B)},
            {"name": "fsdp", "argv": dp_argv(lilt, data, out("fsdp_fsdp"),
                                             TRAIN_B, "--fsdp")}]
    free = graph_model_dir(reference["train_out"], out("graph_dp_free"), 0.0)
    parity = ["--synthetic_data", "--model_name_or_path", free,
              "--data_dir", data, "--output_dir", out("graph_dp_parity"),
              "--max_seq_len", str(L),
              "--per_device_train_batch_size", str(TRAIN_B),
              "--steps_per_call", str(GRAPH_K),
              "--max_steps", str(GRAPH_DP_PARITY_STEPS),
              "--warmup_ratio", "0.25", "--learning_rate", "5e-5",
              "--save_steps", "0", "--seed", str(SEED), "--no_resume"]
    graph_argv = list(train_record["argv"]) + [
        "--output_dir", out("train_graph_dp"),
        "--max_steps", str(GRAPH_STEPS), "--logging_steps", str(GRAPH_LOG),
        "--eval_steps", str(GRAPH_STEPS), "--save_steps", "0",
        "--steps_per_call", str(GRAPH_K), "--no_resume"]
    spec = {"worker": "nccl", "runs": runs, "graph_argv": graph_argv,
            "parity": {"dp": parity},
            "profile": profile_dir}
    t0 = time.perf_counter()
    rank = launch_ranks(spec, 1, tmp, "nccl_world1")[0]
    if rank["backend"] != "nccl" or rank["world"] != 1:
        raise RuntimeError(f"nccl_world1: backend {rank['backend']}, world "
                           f"{rank['world']}")
    return {"rank": rank, "runs": {r["name"]: r for r in runs},
            "graph_out": out("train_graph_dp"),
            "wall_seconds": time.perf_counter() - t0}


def check_runs(tag, nccl, names, solo_log, per_run, errors):
    """The NCCL rank's training runs ``names`` against one process's losses
    (``solo_log``, FSDP_RTOL) and launches (``per_run``), fsdp off (dp 1);
    their report by name, and their launches summed."""
    want = [r["loss/total"] for r in log_records(solo_log)[0]]
    report, launches = {"losses_one_process": want}, {}
    if not want or not all(map(math.isfinite, want)):
        errors.append(f"one-process losses {want}")
    for name in names:
        got = nccl["rank"]["runs"][name]
        argv = nccl["runs"][name]["argv"]
        logged, _ = log_records(os.path.join(
            argv[argv.index("--output_dir") + 1], "log.jsonl"))
        losses = [x["loss/total"] for x in logged]
        report[name] = dict(got, losses=losses,
                            max_rel_err=max(abs(a - b) / abs(b) for a, b
                                            in zip(losses, want)),
                            ms_per_step_logged=step_ms(logged))
        if got["fsdp"] or not rel_close(losses, want, FSDP_RTOL):
            errors.append(f"{tag} {name}: fsdp {got['fsdp']}, losses "
                          f"{losses} vs one process {want}")
        expect_counts(got["launches"], per_run, f"{tag} {name}")
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return report, launches


def phase_train_fsdp(ba, rb, tmp, reference, nccl, smi):
    """``run_rfund --fsdp --distributed`` of LiLT-base at NCCL world 1
    (train_dp's CE run: its model at dropout 0 and corpus, B=8, L=512,
    bf16, DP_STEPS steps, an eval and a save) beside the same run without
    the flag (DDP: train_dp's NCCL world-1 run) and train_dp's one-process
    run. Gates: fsdp off at dp 1 (as JAX's), each step's loss within
    FSDP_RTOL of one process's (DDP's too: train_dp's NCCL gate), the
    ``--fsdp`` run's saved tensors within FSDP_RTOL of one process's, #1-#3
    launched as in one process. Reports steady ms/step and the peak of
    each."""
    layers, n_dev = 12, 16
    per_run = {"fwd": layers * DP_STEPS, "bwd": layers * DP_STEPS,
               "biacm_attention": layers * 2 * n_dev // TRAIN_B}
    errors = []
    runs, launches = check_runs("train_fsdp", nccl, ("ddp", "fsdp"),
                                reference["logs"]["ce"], per_run, errors)
    saved = saved_rel_err(os.path.join(tmp, "fsdp_fsdp"),
                          reference["solo_out"])
    if saved > FSDP_RTOL:
        errors.append(f"saved tensors {saved} off one process's")
    report = {"phase": "train_fsdp", "steps": DP_STEPS,
              "batch_size": TRAIN_B, "L": L, "dropout": 0.0,
              "nvidia_smi": smi, "world": 1, "backend": "nccl", **runs,
              "one_process": {
                  "max_memory_allocated": reference["solo_peak"],
                  "steady_ms": reference["solo_steady_ms"]},
              "saved_max_rel_err": saved,
              "ms_per_step_steady": {
                  "one_process": reference["solo_steady_ms"],
                  "ddp": runs["ddp"]["steady_ms"],
                  "fsdp": runs["fsdp"]["steady_ms"],
                  "steps": STEADY_STEPS - 1},
              "tol": FSDP_RTOL}
    emit(report)
    if errors:
        raise RuntimeError("train_fsdp: " + "; ".join(errors))
    return launches, report


def saved_rel_err(a_dir, b_dir):
    """The largest over tensors of max |a − b| / max |b| between two saved
    ``pytorch_model.bin`` files (compared on the card); inf when their keys
    differ."""
    import torch

    a = torch.load(os.path.join(a_dir, "pytorch_model.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(b_dir, "pytorch_model.bin"),
                   weights_only=True)
    if set(a) != set(b):
        return float("inf")
    worst = 0.0
    for k in b:
        x, y = a[k].cuda().float(), b[k].cuda().float()
        worst = max(worst, (x - y).abs().max().item()
                    / (y.abs().max().item() or 1.0))
    return worst


def start_train_fsdp_v3(tmp, v3_data):
    """Start train_fsdp_v3's ranks (they run while grid_tp's do: both wait
    on gloo's host copies for most of a step)."""
    out = os.path.join(tmp, "fsdp_v3")
    argv = dp_argv(os.path.join(tmp, "tp_v3_model"), v3_data, out,
                   TRAIN_B // DP_WORLD, "--fsdp", steps=TP_STEPS)
    return {"launch": start_ranks({"argv": {"fsdp": argv},
                                   "losses": ["fsdp"]}, DP_WORLD, tmp,
                                  "train_fsdp_v3"),
            "out": out, "data": v3_data, "t0": time.perf_counter()}


def phase_train_fsdp_v3(tmp, started, smi):
    """LayoutLMv3-base under FSDP2 on DP_WORLD gloo ranks sharing the card
    (``run_rfund --fsdp`` at dp 2, started by :func:`start_train_fsdp_v3`):
    train_tp_v3's run (its seeded model at the decoder's own learning rate,
    train_v3's corpus, L' = 709, global B = 8, TP_STEPS steps, an eval, a
    save) against its one process (run by train_tp). Gates: both ranks'
    losses alike and within DP_LOSS_RTOL of one process's, #4-#6 launched
    on each rank as in one process. Reports the peak per rank."""
    layers = 12
    with open(os.path.join(started["data"], "en.val.json")) as f:
        n_eval = math.ceil(len(json.load(f)["documents"]) / TRAIN_B)
    per_run = {"bias_fwd": layers * TP_STEPS, "bias_bwd": layers * TP_STEPS,
               "bias_attention": layers * n_eval}
    out = started["out"]
    ranks = join_ranks(started["launch"])
    wall = time.perf_counter() - started["t0"]
    want = [r["loss/total"] for r in log_records(os.path.join(
        tmp, "tp_v3_solo", "log.jsonl"))[0]]
    got = [[r["loss/total"] for r in log_records(os.path.join(
        out, "log.jsonl" if r == 0 else f"log.rank{r}.jsonl"))[0]]
        for r in range(DP_WORLD)]
    emit({"phase": "train_fsdp_v3", "world": DP_WORLD,
          "backend": ranks[0]["backend"], "nvidia_smi": smi,
          "steps": TP_STEPS, "global_batch": TRAIN_B,
          "per_rank_batch": TRAIN_B // DP_WORLD, "attention_length": LV,
          "dropout": 0.0, "losses_one_process": want, "losses_ranks": got,
          "max_rel_err": max_rel_err(got[0], want),
          "max_memory_allocated_ranks":
              [r["fsdp"]["max_memory_allocated"] for r in ranks],
          "ms_per_step_logged": step_ms(log_records(os.path.join(
              out, "log.jsonl"))[0]),
          "launches_ranks": [r["fsdp"]["launches"] for r in ranks],
          "ranks_wall_seconds": wall, "beside": "grid_tp",
          "tol": DP_LOSS_RTOL})
    if len(want) != TP_STEPS or any(g != got[0] for g in got) \
            or not rel_close(got[0], want, DP_LOSS_RTOL):
        raise RuntimeError(f"train_fsdp_v3: rank losses {got} vs one "
                           f"process {want}")
    total = {}
    for i, r in enumerate(ranks):
        expect_counts(r["fsdp"]["launches"], per_run,
                      f"train_fsdp_v3 rank {i}")
        for k, v in r["fsdp"]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_train_fsdp_ranks(reference, smi):
    """``run_rfund --fsdp`` on DP_WORLD gloo ranks sharing the card (run in
    train_dp's launch, after its CE and OHEM runs; gloo moves FSDP2's
    all-gathers and reduce-scatters of CUDA tensors through the host):
    train_dp's CE run (global B=8, 4 a rank, DP_STEPS steps, an eval, a
    save) with the parameters and the AdamW state sharded over dp. Gates:
    both ranks' losses within DP_LOSS_RTOL of one process's, #1-#3 as
    under DDP. Reports each rank's peak against train_dp's DDP ranks' and
    one process's."""
    ranks, out = reference["fsdp_ranks"], reference["fsdp_ranks_out"]
    layers, n_dev = 12, 16
    per_run = {"fwd": layers * DP_STEPS, "bwd": layers * DP_STEPS,
               "biacm_attention": layers * 2 * n_dev // TRAIN_B}
    want = [r["loss/total"] for r in log_records(reference["logs"]["ce"])[0]]
    got = [[r["loss/total"] for r in log_records(os.path.join(
        out, "log.jsonl" if r == 0 else f"log.rank{r}.jsonl"))[0]]
        for r in range(DP_WORLD)]
    peaks = [r["max_memory_allocated"] for r in ranks]
    emit({"phase": "train_fsdp_ranks", "world": DP_WORLD,
          "backend": reference["backend"], "nvidia_smi": smi,
          "steps": DP_STEPS, "global_batch": TRAIN_B,
          "per_rank_batch": TRAIN_B // DP_WORLD, "dropout": 0.0,
          "losses_one_process": want, "losses_ranks": got,
          "max_rel_err": max(abs(a - b) / abs(b)
                             for a, b in zip(got[0], want)),
          "max_memory_allocated_ranks": peaks,
          "ddp_max_memory_allocated_ranks": reference["ranks_peak"],
          "one_process_max_memory_allocated": reference["solo_peak"],
          "peak_over_ddp": [a / b for a, b in zip(peaks,
                                                  reference["ranks_peak"])],
          "ms_per_step_logged": step_ms(log_records(os.path.join(
              out, "log.jsonl"))[0]),
          "launches_ranks": [r["launches"] for r in ranks],
          "tol": DP_LOSS_RTOL})
    errors = []
    if any(g != got[0] for g in got) or not rel_close(got[0], want,
                                                      DP_LOSS_RTOL):
        errors.append(f"rank losses {got} vs one process {want}")
    total = {}
    for i, r in enumerate(ranks):
        expect_counts(r["launches"], per_run, f"train_fsdp_ranks rank {i}")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    if errors:
        raise RuntimeError("train_fsdp_ranks: " + "; ".join(errors))
    return total


def phase_train_graph_dp(nccl, graph, smi):
    """K = GRAPH_K steps per CUDA graph inside a process group (the NCCL
    rank at world 1, LiLT-base, B=8, L=512; each step's gradient mean
    ``replica_mean_grads`` in place of DDP, which at world 1 returns before
    any all-reduce, so the graph holds no collective). Parity at dropout 0:
    the trainer's GRAPH_K steps (DDP) against one replay,
    ``train_graph_parity``'s gates; the attention seeds of the rank's (dp,
    tp) shard, fresh on each replay. Speed at dropout 0.1:
    ``--steps_per_call GRAPH_K`` over GRAPH_STEPS steps (logged every
    GRAPH_LOG; ms/step over the steps after the first log) beside one
    process at K = GRAPH_K (``train_graph``) and DDP at K = 1
    (``train_fsdp``'s DDP run, steady), the run's wrapper calls (the first
    call's warm-up and capture, the eval), and one profiled replay: 12
    launches a step of each of #2/#3's kernels, busy, idle and NCCL's ms."""
    rank = nccl["rank"]
    errors = []
    for name, p in rank["parity"].items():
        if p["loss_max_rel_diff"] > GRAPH_LOSS_RTOL \
                or not p["learning_rates_equal"] \
                or p["param_max_abs_diff"] > GRAPH_PARAM_ATOL:
            errors.append(f"{name}: the K-step graph differs from K eager "
                          f"steps: {p}")
        a, b = p["layer0_seeds_of_two_replays"]
        if p["seed_base"] != p["seed_base_expected"] \
                or b - a != p["seed_advance_expected"] \
                or p["fsdp"] or not p["grad_sync"]:
            errors.append(f"{name}: seeds or layout {p}")
    steps, evals = log_records(os.path.join(nccl["graph_out"], "log.jsonl"))
    logged = list(range(GRAPH_LOG, GRAPH_STEPS + 1, GRAPH_LOG))
    losses = [r["loss/total"] for r in steps]
    if [r["step"] for r in steps] != logged \
            or not all(map(math.isfinite, losses)) \
            or steps[-1]["nonfinite_loss_steps"] != 0 or len(evals) != 1 \
            or not rank["graph_run"]["grad_sync"]:
        errors.append(f"logged steps {[r['step'] for r in steps]}, losses "
                      f"{losses}, evals {len(evals)}, captured gradient "
                      f"mean {rank['graph_run']['grad_sync']}")
    layers, n_dev = 12, 16
    expect_counts(rank["graph_run"]["launches"],
                  {"fwd": layers * 2 * GRAPH_K, "bwd": layers * 2 * GRAPH_K,
                   "biacm_attention": layers * math.ceil(n_dev / TRAIN_B)},
                  "train_graph_dp run")
    replay = rank["replay"]
    traced = replay["trace_launches"]
    want = {k: (layers * GRAPH_K if k in STEP_KERNELS[""] else 0)
            for k in traced}
    if traced != want:
        errors.append(f"the profiled replay launched {traced}, expected "
                      f"{want}")
    times = {r["step"]: r["time"] for r in steps}
    ms_step = ((times[GRAPH_STEPS] - times[GRAPH_DP_FROM])
               / (GRAPH_STEPS - GRAPH_DP_FROM) * 1e3
               if GRAPH_STEPS in times and GRAPH_DP_FROM in times else None)
    emit({"phase": "train_graph_dp", "world": 1, "backend": "nccl",
          "nvidia_smi": smi, "steps_per_call": GRAPH_K,
          "batch_size": TRAIN_B, "L": L, "parity": rank["parity"],
          "dropout": DROP, "steps": GRAPH_STEPS, "ms_per_step": ms_step,
          "ms_per_step_window": [GRAPH_DP_FROM + 1, GRAPH_STEPS],
          "ms_per_step_one_process_k4": graph["ms_per_step"],
          "ms_per_step_ddp_k1_world1":
              rank["runs"]["ddp"]["steady_ms"],
          "profiled_replay_ms_per_step": replay["ms"] / GRAPH_K,
          "device_busy_ms_per_step": replay["busy_ms"] / GRAPH_K,
          "device_idle_share": 1 - replay["busy_ms"] / replay["ms"],
          "nccl_device_ms_per_step": replay["nccl_ms"] / GRAPH_K,
          "replay_trace_launches": traced,
          "top_kernels": replay["top_kernels"], "run": rank["graph_run"],
          "losses": losses,
          "tol": {"loss": GRAPH_LOSS_RTOL, "param": GRAPH_PARAM_ATOL}})
    if errors:
        raise RuntimeError("train_graph_dp: " + "; ".join(errors))
    launches = dict(rank["graph_run"]["launches"])
    launches["fwd"] += traced[STEP_KERNELS[""][1]]
    launches["bwd"] += traced[STEP_KERNELS[""][2]]
    return launches


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
    if args.dp_worker:  # one rank of a launch (launch_ranks)
        spec = await_spec(args.dp_worker)
        return {"dp": dp_worker, "sp_train": sp_train_worker,
                "sp_serve": sp_serve_worker, "tp_serve": tp_serve_worker,
                "tp_train": tp_train_worker,
                "nccl": nccl_worker}[spec.get("worker", "dp")](spec)

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
    timed("kernel_tp", phase_kernel_tp, ba, rb, peaks)  # nh / tp heads
    # the port's flagship forward bench, three families
    bench_counts = timed("bench", phase_bench, ba, rb, smi)
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
                  ocr_dir),
            timed("serve_artifact", phase_serve_artifact, ba, rb, tmp, svc,
                  os.path.join(tmp, "model"), img_dir, ocr_dir)]
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
        spawn_next(None, tmp)  # train_dp's ranks, ahead of its launch
        dp_counts, dp_reference = timed("train_dp", phase_train_dp, ba, rb,
                                        tmp, train_out, img_dir, ocr_dir, smi)
        surface.append(dp_counts)
        # sequence parallelism: the pair grid's rows over two ranks
        surface.append(timed("train_sp", phase_train_sp, ba, rb, tmp,
                             dp_reference, smi))
        sp_counts, sp_ranks = timed("serve_sp", phase_serve_sp, ba, rb, tmp,
                                    img_dir, ocr_dir, smi)
        surface.append(sp_counts)
        surface.append(timed("serve_sp_long", phase_serve_sp_long, ba, rb,
                             sp_ranks, smi))
        surface.append(timed("sp_pair", phase_sp_pair, ba, rb, smi))

        launches_v3 = run_rel_path(rb, ba, tmp, img_dir, ocr_dir,
                                   args.profile, "v3")
        surface.append(launches_v3["artifact"])
        surface.append(timed("serve_v3_procs", phase_serve_v3_procs, ba, rb,
                             tmp, img_dir, ocr_dir))
        surface.append(timed("serve_int8_v3", phase_serve_int8_v3, ba, rb,
                             tmp, img_dir, ocr_dir))
        launches_v2 = run_rel_path(rb, ba, tmp, img_dir, ocr_dir,
                                   args.profile, "v2")

        # tensor parallelism: the backbones and the pair head over 2 ranks
        surface.append(timed(
            "serve_tp", phase_serve_tp, ba, rb, tmp, img_dir, ocr_dir,
            {"lilt": os.path.join(tmp, "model"), "v3": launches_v3["wdir"],
             "v2": launches_v2["wdir"]}, smi))
        tp_counts, tp_reference = timed(
            "train_tp", phase_train_tp, ba, rb, tmp,
            {"lilt": os.path.join(tmp, "model"), "v3": launches_v3["wdir"]},
            {"lilt": dp_reference["data"],
             "v3": os.path.join(launches_v3["train_out"], "synthetic_data")},
            smi)
        surface.append(tp_counts)
        # fsdp of LayoutLMv3 at dp 2: train_tp_v3's run over 2 gloo ranks,
        # beside grid_tp's four
        fsdp_v3 = start_train_fsdp_v3(
            tmp, os.path.join(launches_v3["train_out"], "synthetic_data"))
        surface.append(timed("grid_tp", phase_grid_tp, ba, rb, tmp,
                             tp_reference, img_dir, ocr_dir, smi))
        surface.append(timed("train_fsdp_v3", phase_train_fsdp_v3, tmp,
                             fsdp_v3, smi))

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

        # fsdp (ZeRO-3 over dp) and K steps per CUDA graph in a process
        # group: one NCCL rank (world 1) runs the two NCCL phases' work,
        # each gated after it; train_dp's gloo ranks ran the fsdp one's
        nccl = timed("nccl_world1", phase_nccl_world1, tmp, dp_reference,
                     train_record, args.profile)
        surface.append(timed("train_fsdp", phase_train_fsdp, ba, rb, tmp,
                             dp_reference, nccl, smi)[0])
        surface.append(timed("train_fsdp_ranks", phase_train_fsdp_ranks,
                             dp_reference, smi))
        surface.append(timed("train_graph_dp", phase_train_graph_dp, nccl,
                             graph[""], smi))
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
    # and the checkpoint, int8, serving-surface and bench phases'
    for counts in surface + [bench_counts]:
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
    try:
        sys.exit(main())
    finally:
        stop_ranks()
