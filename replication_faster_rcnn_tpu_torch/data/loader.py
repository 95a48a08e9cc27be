"""Batch assembly, the loader and the dataset factory (counterpart of the
JAX package's ``data/loader.py``: ``collate``, ``fetch_sample``, the
loader's ``worker_mode="thread"`` and ``"process"`` workers with its epoch
order, and ``make_dataset``).

Thread mode: a producer thread builds batches ahead of the consumer into a
bounded queue; a pool of worker threads builds the samples of each batch.
Samples are numpy only: the JPEG decode and the resize are ctypes calls into
the host library, which release the interpreter lock, so the workers run
them in parallel. Process mode (:func:`_mp_worker`): forked worker
processes build whole batches, for sample work that holds the interpreter
lock (Python augmentations, the PIL decode). Workers of either kind never
touch torch or a CUDA tensor: every device call stays on the consumer's
thread. Batches come out in the epoch's order in both modes: the dataset's
order, or with ``shuffle`` a ``RandomState(seed + epoch)`` permutation;
``set_epoch(epoch, start_batch)`` selects the epoch and starts it at a
batch, so a resumed epoch skips its trained prefix without building it.

Sample faults (:func:`fetch_sample`): a sample whose read raises is retried
once, then replaced by the nearest following index that loads; each
replacement spends one of ``sample_skip_budget`` skips an epoch (per worker
in process mode), and past the budget the epoch raises. The
``loader.fetch`` failpoint (``faultlib/failpoints.py``) wraps every dataset
access, so an injected ``ioerror`` rides the same containment.

With a span tracer installed (``telemetry/spans.py::set_tracer``, as a
``Trainer`` with a ``telemetry_dir`` does), each batch's build is a
``data/build`` span (on the producer's thread; in process mode timed in the
worker and emitted by the consumer with ``worker="process"``), each hand-over
samples the ``loader/queue_depth`` counter and each substitution is a
``data/sample_skipped`` instant in thread mode.

Each epoch's samples come through :meth:`DataLoader._epoch_dataset`: the
dataset itself, the host augmentations keyed on (seed, epoch, index)
(``data/augment.py::AugmentedView``: flip, scale jitter, or with
``augment_scale_device`` the jitter's geometry for the card), or with
``augment_device`` the raw samples tagged with ``[idx, epoch]`` for the
step's own draws. ``cache_ram`` memoizes decoded samples
(``data/cache.py``). With ``train_resolutions`` each batch is assigned a
resolution bucket by :meth:`DataLoader.bucket_of`.

Not ported yet: multi-process sharding (``process_index`` /
``process_count``).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import threading
import time
import traceback
from concurrent import futures
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans

# Process mode: seconds the consumer waits for the next batch, with every
# worker alive, before it raises.
STALL_TIMEOUT_S = 120.0


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def fetch_sample(ds, idx: int, on_skip=None):
    """``ds[idx]`` with fault containment: one retry (truncated reads and
    network file system hiccups pass), then the nearest following index
    that loads, so one unreadable image costs one sample, not the run.

    ``on_skip(idx, exc)`` is called once per abandoned index (after the
    failed retry) and may raise to enforce a skip budget. With no
    ``on_skip`` the substitution is unbudgeted. Raises the last error only
    if every index of the dataset fails.

    The ``loader.fetch`` failpoint wraps every dataset access (the
    original, the retry and each substitution probe): an injected
    ``ioerror`` rides this containment, and an injected ``nan`` poisons the
    sample as a corrupt image would."""

    def _get(i: int):
        inj = failpoints.fire("loader.fetch", index=int(i))  # ioerror raises
        sample = ds[int(i)]
        if inj is not None and inj.kind == "nan":
            sample = failpoints.poison_batch(sample)
        return sample

    try:
        return _get(idx)
    except Exception:
        try:
            return _get(idx)  # the one retry
        except Exception as exc:
            if on_skip is not None:
                on_skip(int(idx), exc)
            n = len(ds)
            for delta in range(1, n):
                j = (int(idx) + delta) % n
                try:
                    return _get(j)
                except Exception:
                    continue
            raise


def _mp_worker(dataset, task_q, result_q, skip_budget: int = 0) -> None:
    """A worker process's loop: one collated batch per task ``(seq,
    idxs)``, put back as ``(seq, batch, start, end)`` (``time.perf_counter``
    of the build; the clock is the parent's, a forked child shares it), or
    ``(seq, ("__error__", traceback), start, end)`` when the build raises
    (exception objects do not always pickle).

    Numpy and the dataset only: a child forked from a process that holds a
    CUDA context or torch's thread pools must never call into torch.
    Samples that fail get :func:`fetch_sample`'s retry and substitution,
    with a budget per worker (a per-epoch count cannot be shared cheaply
    across processes; workers are forked anew each epoch, so the budget
    still holds per epoch)."""
    skips = 0

    def on_skip(idx, exc):
        nonlocal skips
        skips += 1
        if skip_budget and skips > skip_budget:
            raise RuntimeError(
                f"loader worker sample-skip budget exhausted: {skips} "
                f"failed samples (> {skip_budget}); last at index {idx}: "
                f"{exc!r}"
            )

    while True:
        item = task_q.get()
        if item is None:
            return
        seq, idxs = item
        start = time.perf_counter()
        try:
            if skip_budget:
                batch = collate([fetch_sample(dataset, i, on_skip) for i in idxs])
            else:  # containment off
                batch = collate([dataset[int(i)] for i in idxs])
            result_q.put((seq, batch, start, time.perf_counter()))
        except BaseException:  # noqa: BLE001 - reported, the worker goes on
            result_q.put((seq, ("__error__", traceback.format_exc()), start,
                          time.perf_counter()))


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
    :meth:`bucket_of`.

    ``worker_mode``: ``"thread"`` (default) or ``"process"``: forked
    worker processes (``num_workers`` of them; one worker falls back to the
    thread path), one whole batch per task, the results put back into the
    epoch's order, at most ``num_workers + max(prefetch, 1)`` batches in
    flight. Fork, not spawn: a spawned child would import torch and start
    its own CUDA runtime; a forked one inherits the parent's modules and
    runs only numpy code (:func:`_mp_worker`). The consumer raises after
    ``STALL_TIMEOUT_S`` seconds without the next batch while every worker
    is alive (a lock a fork inherited held can leave workers silent).

    ``sample_skip_budget``: substituted samples an epoch (per worker in
    process mode) before the epoch raises; 0 turns the containment off
    (:func:`fetch_sample`)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 4,
        seed: int = 0,
        worker_mode: str = "thread",
        augment_hflip: bool = False,
        augment_scale=None,
        augment_scale_device: bool = False,
        augment_device: bool = False,
        augment_translate: float = 0.0,
        cache_ram: bool = False,
        sample_skip_budget: int = 8,
        train_resolutions=(),
        bucket_chunk: int = 1,
    ) -> None:
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, got {worker_mode!r}")
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
        self.worker_mode = worker_mode
        self.epoch = 0
        self.start_batch = 0  # mid-epoch offset (set_epoch)
        self._q: Optional["queue.Queue"] = None  # the live prefetch queue
        # fetch_sample's budget: substitutions an epoch before it raises
        self.sample_skip_budget = int(sample_skip_budget)
        self._epoch_skips = 0
        self._skip_lock = threading.Lock()
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
        with self._skip_lock:  # the skip budget is per epoch
            self._epoch_skips = 0

    def _on_sample_skip(self, idx: int, exc: Exception) -> None:
        """The budget and the telemetry of one abandoned sample (thread
        path; the pool's workers land here concurrently, hence the lock)."""
        with self._skip_lock:
            self._epoch_skips += 1
            skips = self._epoch_skips
        if skips > self.sample_skip_budget:
            raise RuntimeError(
                f"loader sample-skip budget exhausted: {skips} failed "
                f"samples this epoch (> {self.sample_skip_budget}); last "
                f"at index {idx}: {exc!r}"
            )
        print(
            f"warning: sample {idx} failed twice, substituting neighbor "
            f"({skips}/{self.sample_skip_budget} skips this epoch): {exc!r}",
            file=sys.stderr,
        )
        tspans.current_tracer().instant(
            "data/sample_skipped", cat="data", idx=int(idx),
            skips=skips, error=repr(exc)[:200],
        )

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
            if not self.sample_skip_budget:  # containment off
                get = lambda i: ds[int(i)]  # noqa: E731
            else:
                get = lambda i: fetch_sample(ds, i, self._on_sample_skip)  # noqa: E731
            if pool is None or len(idxs) == 1:
                return collate([get(i) for i in idxs])
            return collate(list(pool.map(get, idxs)))

    def _iter_processes(self) -> Iterator[Dict[str, np.ndarray]]:
        """Process-mode iteration: whole batches built by forked workers,
        yielded in the epoch's order (a reorder buffer keyed on the batch's
        sequence number, so a resume never depends on worker scheduling)."""
        from replication_faster_rcnn_tpu_torch.data.cache import CachedView

        if isinstance(self.dataset, CachedView):
            # a forked worker's cache fills copy-on-write pages that die with
            # it: warm the parent's first, so every epoch's workers share it
            self.dataset.warm()
        ctx = multiprocessing.get_context("fork")
        task_q, result_q = ctx.Queue(), ctx.Queue()
        ds = self._epoch_dataset()
        procs = [ctx.Process(target=_mp_worker, args=(ds, task_q, result_q,
                                                      self.sample_skip_budget), daemon=True)
                 for _ in range(self.num_workers)]
        for p in procs:
            p.start()
        tracer = tspans.current_tracer()
        try:
            batches = list(self._batches())
            cap = self.num_workers + max(self.prefetch, 1)
            next_submit = next_yield = 0
            buf: Dict[int, tuple] = {}
            while next_yield < len(batches):
                while next_submit < len(batches) and next_submit - next_yield < cap:
                    task_q.put((next_submit, batches[next_submit]))
                    next_submit += 1
                # the time spent waiting on this batch, not since the last
                # one: the consumer's own time (steps, captures) is not a stall
                waited_from = time.monotonic()
                while next_yield not in buf:
                    try:
                        seq, *payload = result_q.get(timeout=min(5.0, STALL_TIMEOUT_S))
                    except queue.Empty:
                        dead = [p for p in procs if not p.is_alive()]
                        if dead:  # killed (out of memory, a native crash) unreported
                            raise RuntimeError(
                                f"{len(dead)} loader worker(s) died (exitcodes "
                                f"{[p.exitcode for p in dead]}) before batch {next_yield} "
                                "arrived")
                        if time.monotonic() - waited_from > STALL_TIMEOUT_S:
                            raise RuntimeError(
                                f"loader made no progress for {STALL_TIMEOUT_S:.0f}s "
                                f"waiting on batch {next_yield} with all {len(procs)} workers "
                                "alive - likely a lock a fork inherited held; use "
                                "worker_mode='thread'")
                        continue
                    buf[seq] = tuple(payload)
                    waited_from = time.monotonic()
                batch, start, end = buf.pop(next_yield)
                next_yield += 1
                if isinstance(batch, tuple) and batch and batch[0] == "__error__":
                    raise RuntimeError(f"loader worker failed:\n{batch[1]}")
                # the worker's build on this tracer's clock (perf_counter is
                # one clock across a fork)
                tracer.complete("data/build", tracer.now_us() - (time.perf_counter() - start)
                                * 1e6, (end - start) * 1e6, cat="data",
                                batch=len(batches[next_yield - 1]), worker="process")
                yield batch
        finally:
            for _ in procs:
                task_q.put(None)
            # drain while the workers exit: a worker whose results nobody
            # reads (an iteration stopped early) cannot flush its queue and exit
            deadline = time.monotonic() + 2.0
            for p in procs:
                while p.is_alive() and time.monotonic() < deadline:
                    try:
                        result_q.get(timeout=0.05)
                    except queue.Empty:
                        pass
                if p.is_alive():
                    p.terminate()
                p.join(timeout=2)
            task_q.close()
            result_q.close()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.worker_mode == "process" and self.num_workers > 1:
            yield from self._iter_processes()
            return
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
