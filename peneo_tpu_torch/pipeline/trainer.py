"""PEneoTrainer: the fine-tuning loop on one device.

Counterpart of ``peneo_tpu/pipeline/trainer.py:36-80,248-427,464-663``
(reference: ``PEneoTrainer(transformers.Trainer)``, pipeline/trainer.py):

train: a background thread collates batches and copies them to the device
(pinned memory, non-blocking), double-buffered, while the main thread runs
:func:`~peneo_tpu_torch.pipeline.train.train_step`; logs every
``logging_steps`` to ``log.jsonl`` (the step's losses, and the count of
steps so far whose loss was not finite, kept on the device so that
unlogged steps never wait for the host); evaluates and saves at their
intervals (eval gated by ``start_eval_epoch``); resumes onto the next
unconsumed batch; loads the best checkpoint at the end. eval: one batch in
flight (the next forward is launched before the previous one's outputs are
fetched), host decode on two threads, the ragged last batch edge-padded with a
``row_mask`` that keeps the padding out of the losses, KVPE metrics
(pipeline/evaluation.py). ``save_model`` writes a directory the port's
``InferenceService`` serves: ``config.json``, ``pytorch_model.bin`` (the
reference's torch keys) and the tokenizer.

Not ported here (single device): the mesh, fsdp and sequence-parallel
arguments, multi-process runs, ``steps_per_call`` and TensorBoard logging.
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
from ..models.peneo import PEneoModel
from . import decode as dec
from . import evaluation as ev
from . import train as T
from .checkpoint import CheckpointManager
from .infer import DTYPES, resolve_device
from .loader import DataFeed, batch_arrays, batch_to_device


@dataclass
class TrainingArguments:
    """The reference's HF TrainingArguments subset (README.md:206-241), one
    device. ``device`` None means ``cuda`` (raising without a GPU); the
    compute dtype is the config's ``dtype``."""

    output_dir: str = "output"
    learning_rate: float = 5e-5
    warmup_ratio: float = 0.1
    max_steps: int = 25000
    per_device_train_batch_size: int = 4
    per_device_eval_batch_size: int = 16
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    logging_steps: int = 100
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


class PEneoTrainer:
    def __init__(self, cfg: PEneoConfig, model: PEneoModel,
                 args: TrainingArguments, train_dataset=None,
                 eval_dataset=None, collator=None, tokenizer=None,
                 source_dir: Optional[str] = None) -> None:
        self.cfg = cfg
        self.args = args
        self.device = resolve_device(args.device)
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[cfg.dtype]
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise ValueError("the CUDA attention kernels (BiACM, rel-bias) "
                             "take bfloat16: train with dtype='bfloat16'")
        self.model = model.to(self.device)  # fp32 master parameters
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.collator = collator
        self.tokenizer = tokenizer
        self.source_dir = source_dir
        os.makedirs(args.output_dir, exist_ok=True)
        self._log_file = open(os.path.join(args.output_dir, "log.jsonl"), "a")
        # hidden dropout draws from the device's default generator; each
        # layer's attention-dropout seed from this one
        torch.manual_seed(args.seed)
        self.generator = torch.Generator().manual_seed(args.seed)
        self.optimizer, self.scheduler = T.make_optimizer(
            self.model, lr=args.learning_rate, total_steps=args.max_steps,
            warmup_ratio=args.warmup_ratio, weight_decay=args.weight_decay,
            downstream_speedup_ratio=cfg.peneo_downstream_speedup_ratio)
        self.step = 0
        self.ckpt = CheckpointManager(
            os.path.join(args.output_dir, "checkpoints"),
            save_total_limit=args.save_total_limit,
            best_metric_key=args.metric_for_best_model)

    # ------------------------------------------------------------------ utils
    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        record["time"] = time.time()
        self._log_file.write(json.dumps(record) + "\n")
        self._log_file.flush()
        brief = {k: (round(v, 5) if isinstance(v, float) else v)
                 for k, v in record.items() if k != "time"}
        print(f"[peneo] {brief}", flush=True)

    def _state(self) -> Dict[str, Any]:
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "scheduler": self.scheduler.state_dict(),
                 "generator": self.generator.get_state(),
                 "cpu_rng": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda_rng"] = torch.cuda.get_rng_state(self.device)
        return state

    def _load_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        torch.set_rng_state(state["cpu_rng"])
        if "cuda_rng" in state and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["cuda_rng"], self.device)
        self.step = int(state["step"])

    # ------------------------------------------------------------------ train
    def train(self) -> None:
        args = self.args
        feed = DataFeed(self.train_dataset, self.collator,
                        batch_size=args.per_device_train_batch_size,
                        shuffle=True, seed=args.seed)
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

        # collate + host→device copy in a background thread, double
        # buffered; each item carries the feed position AFTER its batch
        it = None
        items: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def produce():
            try:
                while not stop.is_set():
                    batch = next_raw()
                    item = (batch_to_device(batch, self.device),
                            batch.input_ids.shape[0],
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
                dev_batch, n, feed_pos = item
                metrics = T.train_step(
                    self.model, self.optimizer, self.scheduler, dev_batch,
                    args.max_grad_norm, self.generator, self.dtype)
                nonfinite += ~torch.isfinite(metrics["total"])
                prev = self.step
                self.step += 1
                seen += n

                def crossed(every):
                    return every and (self.step // every) > (prev // every)

                if crossed(args.logging_steps):
                    values = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_last
                    self.log({"step": self.step,
                              **{f"loss/{k}": v for k, v in values.items()},
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
                              **{f"eval/{k}": v
                                 for k, v in eval_metrics.items()}})
                    if crossed(args.save_steps):
                        self.ckpt.save(self.step, self._state(),
                                       metrics=eval_metrics,
                                       feed_state=feed_pos)
                    t_last, seen = time.time(), 0
                elif crossed(args.save_steps):
                    self.ckpt.save(self.step, self._state(),
                                   feed_state=feed_pos)
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
                self.model.load_state_dict(state["model"])
                self.log({"event": "loaded_best", "step": best})

    # ------------------------------------------------------------------- eval
    def evaluate(self, score_thresh: float = 0.0) -> Dict[str, float]:
        args = self.args
        full = args.per_device_eval_batch_size
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
        pool = ThreadPoolExecutor(max_workers=2,
                                  thread_name_prefix="eval-decode")

        def collect_one():
            nonlocal loss_weight
            batch, bsz, packed, losses = in_flight.popleft()
            if losses is not None:
                for k, v in losses.items():
                    loss_sums[k] = loss_sums.get(k, 0.0) + float(v) * bsz
                loss_weight += bsz
            if isinstance(packed, tuple):
                out = dec.unpack_spots(*(x.cpu().numpy() for x in packed))
            else:  # dense maps (max_spots_per_head = 0)
                out = {name: {k: v.cpu().numpy() for k, v in head.items()}
                       for name, head in packed.items()}
            decode_futs.append(pool.submit(
                dec.decode_batch, batch.texts, out, batch.labels,
                [int(s) for s in batch.seq_len], batch.fnames,
                score_thresh=score_thresh))

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
                dev_batch = batch_to_device(arrays, self.device)
                with_loss = bool(batch.labels)
                res = T.eval_step(self.model, dev_batch, with_loss=with_loss,
                                  dtype=self.dtype)
                out, losses = res if with_loss else (res, None)
                if self.cfg.max_spots_per_head > 0:
                    out = pack_spots(out)  # two device→host copies
                in_flight.append((batch, bsz, out, losses))
                n_eval += bsz
                while len(in_flight) > 1:  # one batch in flight
                    collect_one()
            while in_flight:
                collect_one()
            for fut in decode_futs:  # in dispatch order
                preds, gts, fnames = fut.result()
                all_pred.extend(preds)
                all_gt.extend(gts)
                all_fname.extend(fnames)
        finally:
            pool.shutdown(wait=True)
        calc = (ev.calculate_detail_kvpe_metric if args.detail_eval
                else ev.calculate_kvpe_metric)
        summary, detail = calc(all_pred, all_gt, all_fname)
        summary = dict(summary)
        summary["num_sample_processed"] = detail.get("num_sample_processed")
        if loss_weight > 0:
            for k, v in loss_sums.items():
                summary[f"loss_{k}"] = v / loss_weight
        summary["eval_samples_per_second"] = n_eval / (time.time() - t0)
        if args.save_eval_detail:
            with open(os.path.join(args.output_dir, "detail.json"), "w",
                      encoding="utf-8") as f:
                json.dump(detail, f, ensure_ascii=False, indent=1)
        return summary

    # ------------------------------------------------------------------- save
    def save_model(self) -> None:
        """A servable model directory: ``config.json``,
        ``pytorch_model.bin`` (fp32, the reference's torch keys) and the
        tokenizer file(s) (reference: trainer.save_model() +
        processor.save_pretrained(), start/run_rfund.py:323-327)."""
        out_dir = self.args.output_dir
        self.cfg.save_pretrained(out_dir)
        torch.save({k: v.detach().to("cpu", torch.float32)
                    for k, v in self.model.state_dict().items()},
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
