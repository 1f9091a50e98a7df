"""Host data feed: shuffled batching + background prefetch + device placement.

The port's copy of ``peneo_tpu/pipeline/loader.py:19-145`` (the
reference's torch DataLoader workers, SURVEY.md §3.1): the collator output
is a set of fixed-shape numpy arrays, so the feed thread overlaps host-side
parsing/label-building with device compute, and :func:`batch_to_device`
copies through pinned memory with ``non_blocking=True`` so the host→device
copy overlaps the previous step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


class DataFeed:
    """Iterate (shuffled) fixed-size batches from a map-style dataset through
    a collator, with items parsed in a pool of worker threads and batches
    prefetched into a bounded queue.

    Under data parallelism (``world`` > 1) a global batch is ``batch_size ×
    world`` items: every rank shuffles with the same seed and collates rows
    ``[rank·b, (rank+1)·b)`` of each global batch, as a JAX process feeds
    its addressable shard (``peneo_tpu/pipeline/trainer.py:236-237``). The
    feed position (epoch, batches consumed) counts global batches, the same
    on every rank. Under sequence parallelism ``rank`` and ``world`` are
    the dp index and the dp size: the sp ranks of one dp index take the
    same rows, in the same order."""

    def __init__(
        self,
        dataset,
        collator,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 4,
        rank: int = 0,
        world: int = 1,
    ) -> None:
        if world > 1 and not drop_last:
            raise ValueError("a data-parallel feed drops the ragged last "
                             "batch (evaluation pads the global one)")
        self.dataset = dataset
        self.rank = rank
        self.world = world
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        # Cache parsed items across epochs: __getitem__ re-tokenizes and
        # rebuilds label spots every epoch (the reference's DataLoader does
        # too — torch re-parses per epoch). The parse is GIL-bound python;
        # on small corpora it can otherwise bound the whole train step.
        # Enabled by the dataset's own ``deterministic`` property
        # (RFUND/SIBR datasets declare it; augmentation makes it False) —
        # a dataset without the property is assumed deterministic, matching
        # plain item lists.
        self._cache: Optional[dict] = (
            {} if getattr(dataset, "deterministic", True) else None)
        self._epoch = 0
        self._skip = 0

    def _get_item(self, i):
        i = int(i)
        if self._cache is None:
            return self.dataset[i]
        v = self._cache.get(i)
        if v is None:
            v = self.dataset[i]
            self._cache[i] = v
        return v

    def set_state(self, epoch: int, batches_consumed: int) -> None:
        """Restore feed position (checkpoint resume): the next ``iter(self)``
        replays epoch ``epoch``'s shuffle order and skips its first
        ``batches_consumed`` batches — training continues on exactly the data
        an uninterrupted run would have seen next (HF Trainer's
        ``ignore_data_skip=False`` behavior)."""
        self._epoch = int(epoch)
        self._skip = int(batches_consumed)

    def __len__(self) -> int:
        n = len(self.dataset)
        size = self.batch_size * self.world
        return n // size if self.drop_last else -(-n // size)

    def _index_batches(self) -> Sequence[Sequence[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        size = self.batch_size * self.world
        n_full = len(idx) // size
        mine = slice(self.rank * self.batch_size,
                     (self.rank + 1) * self.batch_size)
        batches = [idx[i * size:(i + 1) * size][mine] for i in range(n_full)]
        if not self.drop_last and len(idx) % size:
            batches.append(idx[n_full * size:])
        return batches

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        if self._skip:
            batches = batches[self._skip:]
            self._skip = 0
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=2)  # batches ahead
        stop = threading.Event()

        def produce():
            try:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        feats = list(pool.map(self._get_item, b))
                        out_q.put(self.collator(feats))
            except BaseException as e:  # surface worker errors to consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def batch_arrays(batch):
    """Collator Batch → host numpy dict (model inputs only)."""
    arrays = {
        "input_ids": batch.input_ids,
        "bbox": batch.bbox,
        "attention_mask": batch.attention_mask,
        "labels": batch.labels,
    }
    if batch.image is not None:
        arrays["image"] = batch.image
    return arrays


def stack_batches(batches) -> dict:
    """K collator Batches → one host numpy dict whose every array has a
    leading axis of K (the layout of a ``steps_per_call`` group)."""
    arrays = [batch_arrays(b) for b in batches]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([x[k] for x in items]) for k in items[0]}
        return np.stack(items)

    return stack(arrays)


def tree_map(fn, tree):
    """``fn`` over the leaves of a (nested) dict of a batch."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a (nested) dict of a batch, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def to_host_tensors(arrays, pin: bool) -> dict:
    """A dict of numpy arrays → CPU tensors, in pinned memory with ``pin``
    (for an asynchronous copy to the card later)."""
    import torch

    def tensor(value):
        t = torch.from_numpy(np.ascontiguousarray(value))
        return t.pin_memory() if pin else t

    return tree_map(tensor, arrays)


def batch_to_device(batch, device) -> dict:
    """Collator Batch (or a dict of numpy arrays) → dict of tensors on
    ``device``; CUDA copies go through pinned memory, asynchronously."""
    import torch

    arrays = batch_arrays(batch) if not isinstance(batch, dict) else batch
    device = torch.device(device)
    return tree_map(lambda t: t.to(device, non_blocking=True),
                    to_host_tensors(arrays, pin=device.type == "cuda"))
