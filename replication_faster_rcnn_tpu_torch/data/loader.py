"""Batch assembly, a threaded loader and the dataset factory (counterpart of
the JAX package's ``data/loader.py``: ``collate``, the ``worker_mode="thread"``
loader with its epoch order, and ``make_dataset``).

A producer thread builds batches ahead of the consumer into a bounded
queue; a pool of worker threads builds the samples of each batch. Samples
are numpy only: the JPEG decode and the resize are ctypes calls into the
host library, which release the interpreter lock, so the workers run them in
parallel. Workers never touch a CUDA tensor: every device call stays on the
consumer's thread. Batches come out in the epoch's order: the dataset's
order, or with ``shuffle`` a ``RandomState(seed + epoch)`` permutation;
``set_epoch(epoch, start_batch)`` selects the epoch and starts it at a batch,
so a resumed epoch skips its trained prefix without building it.

With a span tracer installed (``telemetry/spans.py::set_tracer``, as a
``Trainer`` with a ``telemetry_dir`` does), each batch's build is a
``data/build`` span on the producer's thread and each hand-over samples the
``loader/queue_depth`` counter.

Not ported yet: worker processes, the RAM cache, augmentation, sample-fault
containment and multi-process sharding.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent import futures
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Iterable over collated batches of a map-style dataset.

    ``shuffle``: each epoch's order is ``RandomState(seed + epoch)``'s
    permutation (else the dataset's order). ``drop_last``: drop the trailing
    partial batch. ``prefetch``: batches built ahead (0 builds each batch on
    the consumer's thread). ``num_workers``: threads building the samples of
    a batch; negative means min(4, the cores this process may run on)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 4,
        seed: int = 0,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        if num_workers < 0:
            num_workers = min(4, len(os.sched_getaffinity(0)))
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self.start_batch = 0  # mid-epoch offset (set_epoch)
        self._q: Optional["queue.Queue"] = None  # the live prefetch queue

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Select the epoch, and optionally a mid-epoch offset: iteration
        starts at batch ``start_batch`` of the epoch's order, so the trained
        prefix is never built and the rest is the uninterrupted epoch's."""
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.epoch = epoch
        self.start_batch = int(start_batch)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.RandomState(self.seed + self.epoch).permutation(n)

    def queue_depth(self) -> int:
        """Batches built ahead and waiting (0 when no iteration is live): a
        gauge for the stall watchdog."""
        q = self._q
        return q.qsize() if q is not None else 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[np.ndarray]:
        order = self._order()
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_last else 0)
        for i in range(self.start_batch * bs, end, bs):
            yield order[i:i + bs]

    def _build(self, idxs: np.ndarray,
               pool: Optional[futures.ThreadPoolExecutor]) -> Dict[str, np.ndarray]:
        # on the producer thread under prefetch, so these spans overlap the
        # step's in the trace: parallel lanes, not a serial pipeline
        with tspans.current_tracer().span("data/build", cat="data", batch=len(idxs)):
            if pool is None or len(idxs) == 1:
                return collate([self.dataset[int(i)] for i in idxs])
            return collate(list(pool.map(lambda i: self.dataset[int(i)], idxs)))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = futures.ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None
        try:
            if self.prefetch <= 0:
                for idxs in self._batches():
                    yield self._build(idxs, pool)
                return
            yield from self._prefetched(pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def _prefetched(self, pool) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for idxs in self._batches():
                    if stop.is_set() or not put(self._build(idxs, pool)):
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                err.append(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, name="data-loader", daemon=True)
        thread.start()
        self._q = q
        tracer = tspans.current_tracer()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if err:
                        raise err[0]
                    return
                tracer.counter("loader/queue_depth", q.qsize())
                yield batch
        finally:
            stop.set()
            self._q = None
            thread.join(timeout=60)


def make_dataset(cfg, split: str = "train", **kwargs):
    """The dataset ``cfg.dataset`` names (a ``DataConfig``), for ``split``."""
    kind = cfg.dataset
    if kind == "voc":
        from replication_faster_rcnn_tpu_torch.data.voc import VOCDataset

        return VOCDataset(cfg, split, **kwargs)
    if kind == "coco":
        raise NotImplementedError(
            "dataset='coco': the COCO reader (data/coco.py) is not ported yet")
    if kind == "synthetic":
        from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(cfg, split, **kwargs)
    raise ValueError(f"unknown dataset kind {kind!r}")
