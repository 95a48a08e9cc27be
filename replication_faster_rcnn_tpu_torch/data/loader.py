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

Each epoch's samples come through :meth:`DataLoader._epoch_dataset`: the
dataset itself, the host augmentations keyed on (seed, epoch, index)
(``data/augment.py::AugmentedView``: flip, scale jitter, or with
``augment_scale_device`` the jitter's geometry for the card), or with
``augment_device`` the raw samples tagged with ``[idx, epoch]`` for the
step's own draws. ``cache_ram`` memoizes decoded samples
(``data/cache.py``). With ``train_resolutions`` each batch is assigned a
resolution bucket by :meth:`DataLoader.bucket_of`.

Not ported yet: worker processes, sample-fault containment and
multi-process sharding.
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
    a batch; negative means min(4, the cores this process may run on).
    ``augment_*``: the epoch's augmentation view (:meth:`_epoch_dataset`);
    ``cache_ram``: decoded samples kept in host RAM (``data/cache.py``);
    ``train_resolutions`` / ``bucket_chunk``: the buckets of
    :meth:`bucket_of`."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 4,
        seed: int = 0,
        augment_hflip: bool = False,
        augment_scale=None,
        augment_scale_device: bool = False,
        augment_device: bool = False,
        augment_translate: float = 0.0,
        cache_ram: bool = False,
        train_resolutions=(),
        bucket_chunk: int = 1,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.augment_hflip = augment_hflip
        self.augment_scale = augment_scale
        self.augment_scale_device = augment_scale_device
        self.augment_device = augment_device
        self.augment_translate = float(augment_translate)
        if cache_ram:
            from replication_faster_rcnn_tpu_torch.data.cache import CachedView

            dataset = CachedView(dataset)
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
        # multi-scale buckets: the feed only assigns each global batch a
        # bucket (bucket_of); the resample runs on the card in that bucket's
        # step. bucket_chunk = train.steps_per_dispatch, so the K batches of
        # one dispatch share a bucket
        self.train_resolutions = tuple(
            (int(r[0]), int(r[1])) for r in (train_resolutions or ())
        )
        self.bucket_chunk = max(1, int(bucket_chunk))

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Select the epoch, and optionally a mid-epoch offset: iteration
        starts at batch ``start_batch`` of the epoch's order, so the trained
        prefix is never built and the rest is the uninterrupted epoch's."""
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.epoch = epoch
        self.start_batch = int(start_batch)

    def bucket_of(self, batch_pos: int) -> int:
        """Resolution-bucket index of the batch at ``batch_pos`` of the
        current epoch: a pure function of (seed, epoch, batch_pos //
        bucket_chunk), so a ``set_epoch(epoch, start_batch=)`` resume replays
        the same sequence. 0 when bucketing is off."""
        if len(self.train_resolutions) <= 1:
            return 0
        from replication_faster_rcnn_tpu_torch.data.augment import bucket_index

        return bucket_index(self.seed, self.epoch, int(batch_pos),
                            len(self.train_resolutions), chunk=self.bucket_chunk)

    def _epoch_dataset(self):
        """The dataset view for the current epoch: identity, or the
        deterministic augmentations keyed on (seed, epoch, idx), made per
        iteration so set_epoch() re-rolls the draws and a resume replays
        them."""
        if self.augment_device and (
            self.augment_hflip or self.augment_scale or self.augment_translate
        ):
            # on the card: raw pixels plus the int32 (idx, epoch) row the
            # step's draws key on
            from replication_faster_rcnn_tpu_torch.data.augment import AugmentTagView

            return AugmentTagView(self.dataset, self.epoch)
        if not (self.augment_hflip or self.augment_scale):
            return self.dataset
        from replication_faster_rcnn_tpu_torch.data.augment import AugmentedView

        return AugmentedView(
            self.dataset,
            self.seed,
            self.epoch,
            hflip=self.augment_hflip,
            scale_range=self.augment_scale,
            scale_on_device=self.augment_scale_device,
        )

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

    def _build(self, idxs: np.ndarray, pool: Optional[futures.ThreadPoolExecutor],
               ds) -> Dict[str, np.ndarray]:
        # on the producer thread under prefetch, so these spans overlap the
        # step's in the trace: parallel lanes, not a serial pipeline
        with tspans.current_tracer().span("data/build", cat="data", batch=len(idxs)):
            if pool is None or len(idxs) == 1:
                return collate([ds[int(i)] for i in idxs])
            return collate(list(pool.map(lambda i: ds[int(i)], idxs)))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = futures.ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None
        ds = self._epoch_dataset()
        try:
            if self.prefetch <= 0:
                for idxs in self._batches():
                    yield self._build(idxs, pool, ds)
                return
            yield from self._prefetched(pool, ds)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def _prefetched(self, pool, ds) -> Iterator[Dict[str, np.ndarray]]:
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
                    if stop.is_set() or not put(self._build(idxs, pool, ds)):
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
        from replication_faster_rcnn_tpu_torch.data.coco import COCODataset

        split_map = {"train": "train2017", "val": "val2017"}
        return COCODataset(cfg, split_map.get(split, split), **kwargs)
    if kind == "synthetic":
        from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(cfg, split, **kwargs)
    raise ValueError(f"unknown dataset kind {kind!r}")
