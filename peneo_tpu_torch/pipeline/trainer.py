"""PEneoTrainer: the fine-tuning loop, on one device or data-parallel across
processes.

Counterpart of ``peneo_tpu/pipeline/trainer.py:36-80,248-427,464-663``
(reference: ``PEneoTrainer(transformers.Trainer)``, pipeline/trainer.py):

train: a background thread collates batches and copies them to the device
(pinned memory, non-blocking), double-buffered, while the main thread runs
:func:`~peneo_tpu_torch.pipeline.train.train_step`; with ``steps_per_call``
K > 1 it collates and stacks K batches into pinned memory instead, and the
main thread runs K steps per call
(:class:`~peneo_tpu_torch.pipeline.train.MultiTrainStep`: one replay
of a CUDA graph of the K steps on the card, its static inputs filled on the
stream it replays on), counting K steps a call, so that ``max_steps``
rounds up to a multiple of K and logging, eval and saving follow the JAX
trainer's ``crossed`` rule; logs every ``logging_steps`` to ``log.jsonl``
(the call's mean losses, and the count of steps so far whose loss was not
finite, kept on the device so that unlogged steps never wait for the host)
and, with ``logging_dir``, the same scalars to TensorBoard; evaluates (eagerly,
between calls) and saves at their intervals (eval gated by
``start_eval_epoch``); resumes onto the next unconsumed batch, at any K;
loads the best checkpoint at the end. eval: one batch in
flight (the next forward is launched before the previous one's outputs are
fetched), host decode on two threads, the ragged last batch edge-padded with a
``row_mask`` that keeps the padding out of the losses, KVPE metrics
(pipeline/evaluation.py). ``save_model`` writes a directory the port's
``InferenceService`` serves: ``config.json``, ``pytorch_model.bin`` (the
reference's torch keys) and the tokenizer.

Data parallelism (``peneo_tpu/pipeline/trainer.py:105-150,236-237,
430-640``): in a process group (``parallel/dist.py``
``init_distributed``) the steps run under ``DistributedDataParallel`` (at
any world size) and, with more than one rank, the decoder reduces the
losses over the global batch; each rank collates its rows of every global
batch (``per_device_train_batch_size × world``) and draws its own dropout
(seeds offset by its rank). Rank 0 owns ``log.jsonl``, TensorBoard and
every saved file (the unwrapped module's ``state_dict``, then a barrier);
the other ranks log to ``log.rank{i}.jsonl``. All ranks resume from the same
checkpoint, which holds every rank's RNG states. Evaluation splits each
global batch over the ranks, gathers the metric rows and dedups them by file
name, so every rank returns the same metrics. Saving needs one
``output_dir`` on every rank (a shared filesystem), checked at start
(``PENEO_ALLOW_DIVERGENT_OUTPUT_DIR=1`` on every rank waives it).

Sequence parallelism (``sp`` > 1; ``peneo_tpu/pipeline/trainer.py:182-206,
572-579``): the ranks form a ``dp × sp`` grid (``parallel/dist.py``
``grid``); the sp ranks of one dp index collate the same rows, run the same
backbone forward (seeds offset by the dp index, so their dropout is alike)
and split the pair grid's rows (``parallel/seq_parallel.py``). DDP runs over
the whole world and the losses are reduced over it. Eval runs spots and
losses in one pass; the metric rows come from each dp index's sp rank 0
(the other sp ranks hold the same records and decode nothing).

Tensor parallelism (``tp`` > 1; ``peneo_tpu/pipeline/trainer.py:57,159``):
the ranks form a ``dp × tp × sp`` grid; the tp ranks of one (dp, sp) cell
hold the shards of a Megatron-split model (``parallel/tensor_parallel.py``),
collate the same rows and compute the same logits. DDP runs over the replica
group (the ranks that hold the same shard, ``parallel/dist.py``), never
over the world, and the losses are reduced over it. The attention-dropout
seeds are offset per (dp, tp) shard; the hidden dropout, which acts on
activations every tp rank holds whole, draws alike on the tp ranks of a dp
index. Checkpoints are sharding-agnostic, as orbax's are: every rank gathers
the model and the AdamW moments to full tensors, rank 0 writes them, and a
run at another tp size cuts them again on resume; ``pytorch_model.bin``
holds the full tensors. Only the rank with t = 0 and s = 0 of each dp index
decodes in eval.

Fully sharded data parallelism (``fsdp``; ``peneo_tpu/pipeline/trainer.py:
62,239-246``): in a process group the model, cut to this rank's tp shards,
is sharded over its dp column by FSDP2 (``parallel/fsdp.py``; HSDP at sp >
1) instead of wrapped by DDP, before the optimizer is built, so the AdamW
moments are sharded like the parameters. The global norm sums the local
shards' squares over the dp group; checkpoints and ``pytorch_model.bin``
stay full (the shards gathered before the tp gather, cut after the tp cut),
so a run resumes at another layout, with or without fsdp. At dp 1 (and
without a process group) ``fsdp`` changes nothing, as JAX's
(``peneo_tpu/parallel/mesh.py:125``).

``steps_per_call`` K > 1 in a process group (``peneo_tpu/pipeline/
trainer.py:181-191``): the gradient mean of each step is one all-reduce of
the gradients over the replica group (``parallel/dist.py``
``replica_mean_grads``) in place of DDP, or FSDP2's own reduce-scatter. On
the CPU the K steps run eagerly; on the card they are one CUDA graph that
holds every collective of the K steps, which needs NCCL (with gloo on the
card the trainer raises). The attention seeds are the (dp, tp) shard's,
as at K = 1; the feed thread only pins host memory, and the K batches are
copied into the graph's buffers on the main thread. FSDP2 and the K-step
mean take every rank's model as it comes (``run_rfund`` builds it from one
seed on every rank), where DDP's constructor broadcasts rank 0's.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import PEneoConfig
from ..models.decoder import pack_spots
from ..models.dropout_seeds import RANK_STRIDE, HostSeeds
from ..models.peneo import PEneoModel
from ..parallel import dist as pdist
from ..parallel import fsdp
from ..parallel import tensor_parallel as tpar
from . import decode as dec
from . import evaluation as ev
from . import train as T
from .checkpoint import CheckpointManager
from .infer import DTYPES, resolve_device
from .loader import (DataFeed, batch_arrays, batch_to_device, stack_batches,
                     to_host_tensors, tree_map)


@dataclass
class TrainingArguments:
    """The reference's HF TrainingArguments subset (README.md:206-241).
    Batch sizes are per rank. ``device`` None means ``cuda`` (raising
    without a GPU; under data parallelism the rank's card); the compute dtype
    is the config's ``dtype``."""

    output_dir: str = "output"
    learning_rate: float = 5e-5
    warmup_ratio: float = 0.1
    max_steps: int = 25000
    per_device_train_batch_size: int = 4
    per_device_eval_batch_size: int = 16
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    logging_steps: int = 100
    logging_dir: Optional[str] = None  # TensorBoard event files
    eval_steps: int = 1000
    save_steps: int = 1000
    save_total_limit: Optional[int] = 1
    metric_for_best_model: Optional[str] = "f1"
    start_eval_epoch: int = 0
    seed: int = 42
    detail_eval: bool = False
    save_eval_detail: bool = False
    resume: bool = True
    device: Optional[str] = None
    # K optimizer steps per call (one CUDA graph replay of the K steps on
    # the card); max_steps rounds up to a multiple of K
    steps_per_call: int = 1
    # sequence-parallel ranks: the pair grid's rows split over sp ranks of
    # a process group of dp × tp × sp ranks
    sp: int = 1
    # tensor-parallel ranks: the backbone and the pair head split over them
    tp: int = 1
    # shard the parameters and the optimizer state over dp (ZeRO-3; FSDP2)
    fsdp: bool = False


class PEneoTrainer:
    def __init__(self, cfg: PEneoConfig, model: PEneoModel,
                 args: TrainingArguments, train_dataset=None,
                 eval_dataset=None, collator=None, tokenizer=None,
                 source_dir: Optional[str] = None) -> None:
        self.cfg = cfg
        self.args = args
        self.rank, self.world = pdist.rank(), pdist.world()
        # in a process group (any size) the steps run under DDP, or FSDP2
        self.distributed = pdist.initialized()
        for flag, size in (("sp", args.sp), ("tp", args.tp)):
            if size > 1 and not self.distributed:
                raise ValueError(
                    f"{flag} {size} needs a process group of dp × tp × sp "
                    "ranks: torchrun --nproc_per_node N -m "
                    f"peneo_tpu_torch.run_rfund --distributed --{flag} "
                    f"{size} ..., or --coordinator_address host:port "
                    "--num_processes N --process_id i")
        if self.distributed:
            pdist.grid(tp=args.tp, sp=args.sp)
        # this rank's share of every batch, and the number of shares
        self.dp_rank, self.dp = pdist.dp_index(), pdist.dp_size()
        self.device = (pdist.rank_device(args.device) if self.distributed
                       else resolve_device(args.device))
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[cfg.dtype]
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise ValueError("the CUDA attention kernels (BiACM, rel-bias) "
                             "take bfloat16: train with dtype='bfloat16'")
        # K steps as one CUDA graph, which must hold the steps' collectives
        graph = args.steps_per_call > 1 and self.device.type == "cuda"
        if graph and self.distributed \
                and pdist.dist.get_backend() != "nccl":
            raise ValueError(
                f"steps_per_call {args.steps_per_call} on the card in a "
                f"process group needs NCCL, not {pdist.dist.get_backend()}: "
                "the K steps are one CUDA graph, and gloo's collectives run "
                "on the host, outside any graph. Give each rank a card of "
                "its own (--dist_backend nccl), or run steps_per_call 1")
        self.model = model.to(self.device)  # fp32 master parameters
        self.tp = tpar.NO_TP
        if args.tp > 1:
            self.tp = tpar.TpShard(pdist.tp_index(), args.tp,
                                   pdist.tp_group())
            self.model.set_tensor_parallel(self.tp.index, self.tp.size,
                                           self.tp.group)
        self.splits = getattr(self.model, "tp_splits", {})
        if self.distributed:
            self.model.set_data_parallel(self.world > 1)
            if args.sp > 1:
                self.model.set_sequence_parallel(
                    pdist.sp_index(), args.sp, pdist.sp_group())
        # fsdp: the parameters sharded before the optimizer sees them; at
        # dp 1 nothing is sharded, and it is off (as JAX's, mesh.py:125)
        self.fsdp = args.fsdp and self.distributed and self.dp > 1
        if self.fsdp:
            fsdp.apply_fsdp(self.model, self.device)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.collator = collator
        self.tokenizer = tokenizer
        self.source_dir = source_dir
        os.makedirs(args.output_dir, exist_ok=True)
        if self.world > 1 and args.save_steps:
            self._check_output_dir()
        log_name = ("log.jsonl" if self.rank == 0
                    else f"log.rank{self.rank}.jsonl")
        self._log_file = open(os.path.join(args.output_dir, log_name), "a")
        self._tb = None
        if args.logging_dir and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(args.logging_dir)
            except Exception as e:  # TB is best-effort, as in JAX
                print(f"[peneo] tensorboard disabled: {e}")
        # hidden dropout draws from the device's default generator; each
        # layer's attention-dropout seed from this one in an eager step (a
        # CUDA graph of K steps computes them on the card: StepSeeds); a
        # dp index draws its own hidden masks, its tp and sp ranks the same
        # ones; a (dp, tp) shard its own attention masks
        torch.manual_seed(args.seed + self.dp_rank * RANK_STRIDE)
        self.generator = torch.Generator().manual_seed(args.seed)
        self.seeds = HostSeeds(self.generator, pdist.seed_shard())
        self.optimizer, self.scheduler = T.make_optimizer(
            self.model, lr=args.learning_rate, total_steps=args.max_steps,
            warmup_ratio=args.warmup_ratio, weight_decay=args.weight_decay,
            downstream_speedup_ratio=cfg.peneo_downstream_speedup_ratio)
        self.step = 0
        # the module the steps run: DDP's wrapper at K = 1 (self.model
        # stays the plain module: state dicts without a "module." prefix,
        # eval forwards); FSDP2 averages the gradients itself, and K > 1
        # steps average them with one all-reduce each (captured in the
        # card's graph, where DDP's reducer cannot be)
        self.step_model = self.model
        self.grad_sync = None
        if self.distributed and not self.fsdp:
            if args.steps_per_call > 1:
                params = [p for p in self.model.parameters()
                          if p.requires_grad]
                self.grad_sync = lambda: pdist.replica_mean_grads(params)
            else:
                from torch.nn.parallel import DistributedDataParallel

                cards = [self.device.index] if self.device.type == "cuda" \
                    else None
                # over the ranks holding this rank's shards (the world at
                # tp 1)
                self.step_model = DistributedDataParallel(
                    self.model, device_ids=cards,
                    process_group=pdist.replica_group())
        self.ckpt = CheckpointManager(
            os.path.join(args.output_dir, "checkpoints"),
            save_total_limit=args.save_total_limit,
            best_metric_key=args.metric_for_best_model)

    # ------------------------------------------------------------------ utils
    def _check_output_dir(self) -> None:
        """Every rank must save into one directory (rank 0 writes it, the
        others resume from it), unless ``PENEO_ALLOW_DIVERGENT_OUTPUT_DIR``
        is set on every rank (one filesystem under different paths). Raises
        on every rank (``peneo_tpu/pipeline/trainer.py:111-140``)."""
        allow = os.environ.get("PENEO_ALLOW_DIVERGENT_OUTPUT_DIR",
                               "") not in ("", "0")
        probes = pdist.gather_objects(
            (os.path.abspath(self.args.output_dir), allow))
        if len({d for d, _ in probes}) > 1 and not all(a for _, a in probes):
            raise ValueError(
                "data-parallel training with save_steps > 0 needs the SAME "
                f"output_dir on every rank (a shared filesystem); rank "
                f"{self.rank} has {self.args.output_dir!r}, the ranks "
                f"{[d for d, _ in probes]}. If the ranks reach one shared "
                "filesystem through different paths, set "
                "PENEO_ALLOW_DIVERGENT_OUTPUT_DIR=1 on EVERY rank.")

    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        record["time"] = time.time()
        self._log_file.write(json.dumps(record) + "\n")
        self._log_file.flush()
        if self._tb is not None and "step" in record:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k not in ("step", "time"):
                    self._tb.add_scalar(k, v, record["step"])
            self._tb.flush()
        if self.rank == 0:
            brief = {k: (round(v, 5) if isinstance(v, float) else v)
                     for k, v in record.items() if k != "time"}
            print(f"[peneo] {brief}", flush=True)

    def _rng_state(self) -> Dict[str, Any]:
        state = {"cpu_rng": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda_rng"] = torch.cuda.get_rng_state(self.device)
        return state

    def _full_model_state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the fsdp shards, then the tp splits,
        gathered to full tensors (a collective under either: every rank
        calls it)."""
        return tpar.gather_state_dict(fsdp.full_state(
            self.model.state_dict()), self.splits, self.tp)

    def _load_model(self, full: Dict[str, torch.Tensor]) -> None:
        """Load a full state dict, cut to this rank's tp, then fsdp,
        shards."""
        fsdp.load_full_state(self.model, tpar.shard_state_dict(
            full, self.splits, self.tp.index, self.tp.size))

    def _state(self) -> Dict[str, Any]:
        """The checkpoint's state, every tensor full; under data parallelism
        every rank's RNG states too (a collective: every rank calls it)."""
        state = {"model": self._full_model_state(),
                 "optimizer": tpar.gather_optimizer_state(
                     fsdp.full_optimizer_state(self.optimizer.state_dict()),
                     self.splits, self.tp),
                 "scheduler": self.scheduler.state_dict(),
                 "generator": self.generator.get_state(),
                 **self._rng_state()}
        if self.world > 1:
            state["rank_rng"] = pdist.gather_objects(self._rng_state())
        return state

    def _save(self, state: Dict[str, Any], **kw) -> None:
        """Rank 0 writes the checkpoint (and prunes); the others wait."""
        if self.rank == 0:
            self.ckpt.save(self.step, state, **kw)
        pdist.barrier()

    def _load_state(self, state: Dict[str, Any]) -> None:
        self._load_model(state["model"])
        T.load_optimizer_state(self.optimizer, tpar.shard_optimizer_state(
            state["optimizer"], self.splits, self.tp.index, self.tp.size))
        fsdp.shard_optimizer_moments(self.optimizer)
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        rng = state
        if len(state.get("rank_rng", ())) == self.world:
            rng = state["rank_rng"][self.rank]
        torch.set_rng_state(rng["cpu_rng"])
        if "cuda_rng" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda_rng"], self.device)
        self.step = int(state["step"])

    # ------------------------------------------------------------------ train
    def train(self) -> None:
        args = self.args
        feed = DataFeed(self.train_dataset, self.collator,
                        batch_size=args.per_device_train_batch_size,
                        shuffle=True, seed=args.seed, rank=self.dp_rank,
                        world=self.dp)
        # the feed position (epoch, batches consumed this epoch) travels in
        # every checkpoint: resume continues on the next unconsumed batch
        pos = {"epoch": 0, "batch": 0}
        if args.resume:
            state = self.ckpt.restore(map_location="cpu")
            if state is not None:
                self._load_state(state)
                fe, fb = state["feed"]
                feed.set_state(fe, fb)
                pos = {"epoch": fe, "batch": fb}
                self.log({"event": "resumed", "step": self.step,
                          "feed_epoch": fe, "feed_batch": fb})

        def next_raw():
            nonlocal it
            for _ in range(2):  # at most one epoch wrap per call
                if it is None:
                    it = iter(feed)
                try:
                    b = next(it)
                    pos["batch"] += 1
                    return b
                except StopIteration:
                    it = None
                    pos["epoch"] += 1
                    pos["batch"] = 0
            raise RuntimeError(
                "empty train feed (dataset smaller than the batch size?)")

        # collate (+ for K > 1 stack K batches) and copy to the device (K >
        # 1: into pinned host memory) in a background thread, double
        # buffered; each item carries the feed position AFTER its batches
        k = max(1, args.steps_per_call)
        cuda = self.device.type == "cuda"
        step_fn = None
        if k > 1:
            step_fn = T.MultiTrainStep(
                self.step_model, self.optimizer, self.scheduler, k,
                args.max_grad_norm, self.seeds, self.dtype, args.seed,
                pdist.seed_shard(), self.grad_sync)
        it = None
        items: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def produce():
            try:
                while not stop.is_set():
                    batches = [next_raw() for _ in range(k)]
                    group = (batch_to_device(batches[0], self.device)
                             if k == 1 else
                             to_host_tensors(stack_batches(batches), cuda))
                    item = (group, sum(b.input_ids.shape[0] for b in batches),
                            (pos["epoch"], pos["batch"]))
                    while not stop.is_set():
                        try:
                            items.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surface feed errors to the loop
                items.put(e)

        feeder = threading.Thread(target=produce, daemon=True)
        feeder.start()
        t_last, seen = time.time(), 0
        # steps of this run whose total loss was not finite, counted on the
        # device: only a logged step fetches losses to the host
        nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        try:
            while self.step < args.max_steps:
                item = items.get()
                if isinstance(item, BaseException):
                    raise item
                group, n, feed_pos = item
                if k == 1:
                    metrics = T.train_step(
                        self.step_model, self.optimizer, self.scheduler,
                        group, args.max_grad_norm, self.seeds, self.dtype,
                        self.grad_sync)
                    nonfinite += ~torch.isfinite(metrics["total"])
                else:
                    metrics = step_fn(group)
                    nonfinite += (~torch.isfinite(
                        step_fn.per_step["total"])).sum()
                prev = self.step
                self.step += k
                seen += n * self.dp

                def crossed(every):
                    return every and (self.step // every) > (prev // every)

                if crossed(args.logging_steps):
                    values = {name: float(v) for name, v in metrics.items()}
                    dt = time.time() - t_last
                    self.log({"step": self.step,
                              **{f"loss/{name}": v
                                 for name, v in values.items()},
                              "nonfinite_loss_steps": int(nonfinite),
                              "throughput_samples_per_s": seen / dt})
                    t_last, seen = time.time(), 0
                # the reference's epoch gate, as start_eval_epoch × batches
                # per epoch steps
                eval_allowed = (self.step
                                >= args.start_eval_epoch * max(len(feed), 1))
                if crossed(args.eval_steps) and self.eval_dataset is not None \
                        and eval_allowed:
                    eval_metrics = self.evaluate()
                    self.log({"step": self.step,
                              **{f"eval/{name}": v
                                 for name, v in eval_metrics.items()}})
                    if crossed(args.save_steps):
                        self._save(self._state(), metrics=eval_metrics,
                                   feed_state=feed_pos)
                    t_last, seen = time.time(), 0
                elif crossed(args.save_steps):
                    self._save(self._state(), feed_state=feed_pos)
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    items.get_nowait()
            except queue.Empty:
                pass
            feeder.join(timeout=30)

        # load the best checkpoint at the end when tracking a metric
        # (reference: --load_best_model_at_end, README.md:277-278)
        if args.metric_for_best_model:
            best = self.ckpt.best_step()
            if best is not None and best != self.step:
                state = self.ckpt.restore(best, map_location="cpu")
                self._load_model(state["model"])
                self.log({"event": "loaded_best", "step": best})

    # ------------------------------------------------------------------- eval
    def evaluate(self, score_thresh: float = 0.0) -> Dict[str, float]:
        """KVPE metrics and the mean losses over the eval set. Under data
        parallelism each global batch (``per_device_eval_batch_size × dp``,
        the ragged last one edge-padded) is split over the dp indices; a
        rank decodes its real rows, the metric rows are gathered and deduped
        by file name, and every rank returns the same metrics. Under
        sequence parallelism only sp rank 0 of each dp index decodes and
        sends metric rows (its sp ranks hold the same spots); under tensor
        parallelism only tp rank 0 of each (dp, sp) cell.

        One batch stays in flight while the previous one is fetched and
        decoded on a pool; ``PENEO_EVAL_SEQUENTIAL=1`` (read at each call,
        as ``peneo_tpu/pipeline/trainer.py:507-510``) restores the strictly
        sequential loop, fetch and decode of a batch before the next is
        dispatched, for the A/B of ``bench_eval``. The metrics are the
        same either way."""
        args = self.args
        pipelined = os.environ.get("PENEO_EVAL_SEQUENTIAL") != "1"
        per_rank = args.per_device_eval_batch_size
        full = per_rank * self.dp
        mine = slice(self.dp_rank * per_rank, (self.dp_rank + 1) * per_rank)
        decodes = pdist.sp_index() == 0 and pdist.tp_index() == 0
        feed = DataFeed(self.eval_dataset, self.collator, batch_size=full,
                        shuffle=False, drop_last=False)
        all_pred, all_gt, all_fname = [], [], []
        # eval losses are averaged over the whole eval set, weighted by the
        # true batch size (the reference keeps only the last batch's,
        # pipeline/trainer.py:185-200)
        loss_sums: Dict[str, float] = {}
        loss_weight, n_eval = 0.0, 0
        t0 = time.time()
        in_flight: deque = deque()
        decode_futs = []
        spots: Dict[str, list] = {}  # per head: found, dropped
        pool = ThreadPoolExecutor(max_workers=2,
                                  thread_name_prefix="eval-decode")

        def collect_one():
            nonlocal loss_weight
            batch, bsz, packed, losses = in_flight.popleft()
            if losses is not None:
                for k, v in losses.items():
                    loss_sums[k] = loss_sums.get(k, 0.0) + float(v) * bsz
                loss_weight += bsz
            if not decodes:
                return
            if isinstance(packed, tuple):
                out = dec.unpack_spots(*(x.cpu().numpy() for x in packed))
            else:  # dense maps (max_spots_per_head = 0)
                out = {name: {k: v.cpu().numpy() for k, v in head.items()}
                       for name, head in packed.items()}
            # this rank's real rows of the global batch
            rows = range(mine.start, min(mine.stop, bsz))
            dec.count_spots(out, slice(0, len(rows)), spots)
            decode_futs.append(pool.submit(
                dec.decode_batch, [batch.texts[i] for i in rows], out,
                {k: v[rows.start:rows.stop]
                 for k, v in batch.labels.items()},
                [int(batch.seq_len[i]) for i in rows],
                [batch.fnames[i] for i in rows], score_thresh=score_thresh))

        try:
            for batch in feed:
                # the ragged final batch is edge-padded to the full size
                # (its decoded rows are dropped; row_mask drops its losses)
                bsz = batch.input_ids.shape[0]
                arrays = batch_arrays(batch)
                if bsz != full:
                    def pad(x):
                        return np.pad(x, [(0, full - bsz)]
                                      + [(0, 0)] * (x.ndim - 1), mode="edge")

                    arrays = {k: ({n: pad(m) for n, m in v.items()}
                                  if isinstance(v, dict) else pad(v))
                              for k, v in arrays.items()}
                row_mask = np.zeros((full,), np.float32)
                row_mask[:bsz] = 1.0
                arrays["row_mask"] = row_mask
                if self.dp > 1:
                    arrays = tree_map(lambda x: x[mine], arrays)
                dev_batch = batch_to_device(arrays, self.device)
                with_loss = bool(batch.labels)
                res = T.eval_step(self.model, dev_batch, with_loss=with_loss,
                                  dtype=self.dtype)
                out, losses = res if with_loss else (res, None)
                if self.cfg.max_spots_per_head > 0:
                    out = pack_spots(out)  # two device→host copies
                in_flight.append((batch, bsz, out, losses))
                n_eval += bsz
                while len(in_flight) > (1 if pipelined else 0):
                    collect_one()
                if not pipelined and decode_futs:
                    decode_futs[-1].result()  # decode inline
            while in_flight:
                collect_one()
            for fut in decode_futs:  # in dispatch order
                preds, gts, fnames = fut.result()
                all_pred.extend(preds)
                all_gt.extend(gts)
                all_fname.extend(fnames)
        finally:
            pool.shutdown(wait=True)
        dec.warn_spots_dropped(spots, len(all_pred),
                               self.cfg.max_spots_per_head)
        calc = (ev.calculate_detail_kvpe_metric if args.detail_eval
                else ev.calculate_kvpe_metric)
        summary, detail = calc(all_pred, all_gt, all_fname,
                               gather_fn=pdist.gather_rows)
        summary = dict(summary)
        summary["num_sample_processed"] = detail.get("num_sample_processed")
        if loss_weight > 0:
            for k, v in loss_sums.items():
                summary[f"loss_{k}"] = v / loss_weight
        summary["eval_samples_per_second"] = n_eval / (time.time() - t0)
        if args.save_eval_detail and self.rank == 0:
            with open(os.path.join(args.output_dir, "detail.json"), "w",
                      encoding="utf-8") as f:
                json.dump(detail, f, ensure_ascii=False, indent=1)
        return summary

    # ------------------------------------------------------------------- save
    def save_model(self) -> None:
        """A servable model directory: ``config.json``,
        ``pytorch_model.bin`` (fp32, the reference's torch keys) and the
        tokenizer file(s) (reference: trainer.save_model() +
        processor.save_pretrained(), start/run_rfund.py:323-327). Under
        data parallelism rank 0 writes it and every rank waits for it; under
        tensor parallelism every rank first gathers the full tensors."""
        state = self._full_model_state()
        if self.rank == 0:
            self._write_model(self.args.output_dir, state)
        pdist.barrier()

    def _write_model(self, out_dir: str, state) -> None:
        self.cfg.save_pretrained(out_dir)
        torch.save({k: v.detach().to("cpu", torch.float32)
                    for k, v in state.items()},
                   os.path.join(out_dir, "pytorch_model.bin"))
        if self.tokenizer is not None and hasattr(self.tokenizer,
                                                  "save_pretrained"):
            self.tokenizer.save_pretrained(out_dir)
        elif self.source_dir and os.path.isdir(self.source_dir):
            import shutil

            from ..registry import TOKENIZER_FILES

            for fname in TOKENIZER_FILES:
                src = os.path.join(self.source_dir, fname)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(out_dir, fname))
