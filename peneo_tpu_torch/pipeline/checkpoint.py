"""Training checkpoints: model, optimizer, scheduler, random generators,
step and data-feed position (epoch, batches consumed), with keep-last-N and
best-by-metric retention.

Counterpart of ``peneo_tpu/pipeline/checkpoint.py:20-113`` (orbax there;
``torch.save`` here). Each save is ``<dir>/checkpoint-<step>/state.pt`` and
``meta.json`` (step, metrics, feed). Retention follows the reference's HF
Trainer (``--save_total_limit K --load_best_model_at_end``): the newest K
checkpoints are kept, and the best one by ``best_metric_key`` is never
deleted.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: Optional[int] = None,
                 best_metric_key: Optional[str] = None) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_total_limit = save_total_limit
        self.best_metric_key = best_metric_key

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def _meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._path(step), "meta.json")) as f:
            return json.load(f)

    def steps(self) -> List[int]:
        """Steps of the complete checkpoints, ascending."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("checkpoint-") and os.path.exists(
                    os.path.join(self.directory, name, "meta.json")):
                out.append(int(name[len("checkpoint-"):]))
        return sorted(out)

    def save(self, step: int, state: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None,
             feed_state=None) -> None:
        """``state`` holds state_dicts (model, optimizer, scheduler) and RNG
        states; ``feed_state`` is ``(epoch, batches_consumed)`` so resume
        continues on the batches an uninterrupted run would see next."""
        path = self._path(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(state, os.path.join(path, "state.pt"))
        e, b = feed_state if feed_state is not None else (0, 0)
        meta = {"step": step, "metrics": metrics or {}, "feed": [e, b]}
        # meta.json last: a checkpoint without it is incomplete
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
        self._prune()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step with the highest ``best_metric_key`` (the earliest on a
        tie); None without a key or a checkpoint that has the metric."""
        if not self.best_metric_key:
            return None
        best = None
        for step in self.steps():
            value = self._meta(step)["metrics"].get(self.best_metric_key)
            if value is not None and (best is None or value > best[0]):
                best = (value, step)
        return None if best is None else best[1]

    def _prune(self) -> None:
        if not self.save_total_limit or self.save_total_limit <= 0:
            return
        steps = self.steps()
        keep = set(steps[-self.save_total_limit:])
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._path(step))

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Dict[str, Any]]:
        """The saved state of ``step`` (default the latest), with ``step``
        and ``feed`` ``(epoch, batches_consumed)`` added; None when there is
        no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self._path(step), "state.pt"),
                           map_location=map_location, weights_only=False)
        meta = self._meta(step)
        state["step"] = meta["step"]
        state["feed"] = tuple(meta["feed"])
        return state
