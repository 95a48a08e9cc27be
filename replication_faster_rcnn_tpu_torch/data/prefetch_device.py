"""Double-buffered device staging: host batch work off the critical path
(counterpart of the JAX package's ``data/prefetch_device.py``).

A producer thread assembles batch K+1, stages it on the card and waits for
the copy to land while dispatch K runs; the trainer's next dispatch dequeues
an already-staged batch. On the card the trainer's ``stage`` callable copies
the batch into a pinned host buffer, issues a non-blocking copy on a copy
stream of its own, records an event and waits on it here, on the producer
thread; the consumer's stream waits on that event before it reads the batch
(``train/trainer.py::Trainer._stage_batch``).

Semantics the trainer depends on:

* **Deterministic order.** The producer consumes the feed iterator in
  exactly the order a synchronous loop would, so training consumes the
  same batches in the same order: bitwise the run with prefetch off.
* **Replay skip.** ``skip`` batches are drawn from the feed and discarded
  without staging; the skipped draws still advance the feed's order.
* **No batch consumed twice.** On preemption (``fault.Preempted`` at a
  dispatch boundary) staged-but-undequeued items are dropped by
  :meth:`close`; a resume re-derives them from the feed. The stager never
  re-emits an item.
* **Bounded depth.** At most ``depth`` staged items exist at once; the
  producer blocks when the queue is full.
* **Error transparency.** A producer-side exception (feed or staging)
  re-raises in the consumer at the point of the failed item, not as a
  silent end of the epoch.

The stager is chunk-aware: with ``chunk=K`` (K steps per dispatch) it stages
full K-batch chunks through ``stage`` and hands an epoch tail shorter than K
back as raw host batches (``HOST`` items), for the trainer's per-step path.

Not ported yet: the ``prefetch.stage`` fault-injection point.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans

# queue item kinds (first tuple element)
STAGED = "staged"  # (STAGED, staged_obj, n_steps, n_images)
HOST = "host"  # (HOST, raw_host_batch) — epoch tail shorter than `chunk`
_END = ("__end__",)
_ERROR = "__error__"  # (_ERROR, exception)


def _batch_images(batch) -> int:
    """Image count of one host batch (selection dicts carry `idx`)."""
    return int(batch["idx" if "idx" in batch else "image"].shape[0])


class DevicePrefetcher:
    """Iterator over staged device batches produced by a background thread.

    Parameters
    ----------
    source:
        Iterable of host batches (loader batches or device-cache
        selection dicts) in deterministic epoch order.
    stage:
        Callable mapping a list of ``chunk`` host batches to a
        device-resident object (stacked and staged, the copy landed; the
        trainer passes a closure that also owns the ``data/device_put``
        telemetry span). For ``chunk == 1`` it is
        called with a single-element list.
    depth:
        Maximum staged items buffered ahead (>= 1).
    chunk:
        Batches per staged item (the trainer's ``steps_per_dispatch``).
    skip:
        Leading batches to draw-and-discard (mid-epoch resume replay).
    """

    def __init__(
        self,
        source: Iterable[Any],
        stage: Callable[[List[Any]], Any],
        depth: int = 2,
        chunk: int = 1,
        skip: int = 0,
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        self._source = iter(source)
        self._stage = stage
        self._chunk = chunk
        self._skip = skip
        self._q: "queue.Queue[Tuple]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        # the producer inherits the caller's process-wide tracer: spans are
        # thread-safe and carry tids, so `data/fetch`/`data/device_put` here
        # land in the same trace, overlapping the consumer's `step/dispatch`
        self._tracer = tspans.current_tracer()
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _put(self, item: Tuple) -> bool:
        """Blocking put with stop-responsiveness; False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        tracer = self._tracer
        skip = self._skip
        pending: List[Any] = []
        try:
            while not self._stop.is_set():
                with tracer.span("data/fetch", cat="data"):
                    try:
                        batch = next(self._source)
                    except StopIteration:
                        break
                if skip > 0:
                    skip -= 1
                    continue
                pending.append(batch)
                if len(pending) < self._chunk:
                    continue
                n_images = sum(_batch_images(b) for b in pending)
                staged = self._stage(pending)
                if not self._put((STAGED, staged, len(pending), n_images)):
                    return
                pending = []
            # epoch tail (< chunk batches): hand back raw host batches for
            # the trainer's per-step path (the K-step graph takes exactly K)
            for batch in pending:
                if not self._put((HOST, batch)):
                    return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 — relay to the consumer
            self._put((_ERROR, e))

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> Iterator[Tuple]:
        return self

    def __next__(self) -> Tuple:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item[0] == _END[0]:
            self._done = True
            raise StopIteration
        if item[0] == _ERROR:
            self._done = True
            raise item[1]
        return item

    def queue_depth(self) -> Optional[int]:
        """Staged items currently buffered (telemetry provider)."""
        return self._q.qsize()

    def close(self) -> None:
        """Stop the producer and drop staged-but-unconsumed buffers.

        Safe to call at any point (preemption, crash, normal epoch end);
        idempotent. Dropped items are NOT consumed — on resume the feed
        replay regenerates them deterministically."""
        self._stop.set()
        # drain so a producer blocked on a full queue observes the stop
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30.0)
        self._done = True


class PinnedStager:
    """Host batches -> device tensors through a ring of pinned host buffers.

    :meth:`stage` copies a batch's arrays into the next pinned buffer set of
    its signature (``slots`` sets each) and issues non-blocking copies to the
    device, then records an event: on the caller's current stream
    (``wait=False``: returns at once, the synchronous trainer path), or on a
    copy stream of the stager's own followed by a wait for the event on the
    calling thread (``wait=True``: the producer thread of
    :class:`DevicePrefetcher`). A buffer set is rewritten only after the
    event of its previous copy has completed. The consumer of a ``wait=True``
    batch makes its stream wait on the returned event and calls
    ``record_stream`` on each tensor (:func:`consume`). On the CPU the
    arrays pass through as tensors (no copy). Use one stager per thread."""

    def __init__(self, device, slots: int = 3) -> None:
        self.device = torch.device(device)
        self.slots = int(slots)
        self._rings = {}  # signature -> [[buffers, event], ...]
        self._turn = {}  # signature -> next slot
        self._copy_stream = None

    def _slot(self, sig):
        ring = self._rings.setdefault(sig, [])
        turn = self._turn.get(sig, 0)
        self._turn[sig] = (turn + 1) % self.slots
        if turn == len(ring):
            ring.append([{k: torch.empty(shape, dtype=dtype, pin_memory=True)
                          for k, dtype, shape in sig}, None])
        slot = ring[turn]
        if slot[1] is not None:
            slot[1].synchronize()  # the buffers' previous copy has landed
        return slot

    def stage(self, batch, wait: bool = False):
        """-> (dict of device tensors, the copy's CUDA event or None)."""
        host = {k: np.ascontiguousarray(v) for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in host.items()}, None
        sig = tuple((k, torch.from_numpy(v[:0]).dtype, v.shape) for k, v in host.items())
        slot = self._slot(sig)
        for k, v in host.items():
            np.copyto(slot[0][k].numpy(), v)
        if wait:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
        else:
            stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            out = {k: buf.to(self.device, non_blocking=True) for k, buf in slot[0].items()}
            event = torch.cuda.Event()
            event.record(stream)
        slot[1] = event
        if wait:
            event.synchronize()
        return out, event


def consume(staged):
    """A :class:`PinnedStager` ``wait=True`` item, made safe for the
    current stream: the stream waits on the copy's event and each tensor is
    recorded on it, so the allocator does not hand the block back to the
    copy stream before the current stream's reads are done. No host wait."""
    tensors, event = staged
    if event is not None:
        stream = torch.cuda.current_stream(next(iter(tensors.values())).device)
        stream.wait_event(event)
        for t in tensors.values():
            t.record_stream(stream)
    return tensors
