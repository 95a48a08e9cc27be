"""Continuous micro-batching queue — bounded producer/consumer with
size- and deadline-triggered flushes (a copy of the JAX package's
``serving/batcher.py``).

Same discipline as `data/prefetch_device.py::DevicePrefetcher`: a
bounded ``queue.Queue`` between submitters and one worker thread (so the
queue itself is the backpressure — a full queue makes ``submit`` block
or raise instead of buffering unboundedly), a sentinel-driven clean
shutdown that drains everything already accepted, and error
transparency (a failing ``process`` call fails exactly the requests in
that flush, through their futures, and the worker keeps serving).

The worker groups waiting requests by ``key`` (the engine keys by
resolution bucket) and flushes a group when it reaches ``max_batch(key)``
requests OR when its oldest request has waited ``max_delay_s`` — the
classic continuous-batching tradeoff knob between per-request latency
and per-dispatch amortization. ``max_delay_s=0`` degrades to greedy
batching: flush whatever has accumulated the moment the queue idles.
``max_delay_s`` may be a ``key -> seconds`` callable, re-read at every
deadline decision — the seam the SLO-driven deadline controller
(serving/slo.py) tunes per-bucket deadlines through while the worker
runs.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
from replication_faster_rcnn_tpu_torch.telemetry import tracecontext

__all__ = ["DeadlineExceeded", "MicroBatcher"]

_CLOSE = object()  # shutdown sentinel; queue order guarantees drain


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed while it waited in the queue; it was
    dropped at flush time instead of being dispatched (abandoned work is
    never computed)."""


class MicroBatcher:
    """Coalesce ``submit`` calls into batched ``process`` calls.

    ``process(key, items) -> results`` runs on the worker thread with
    ``len(results) == len(items)``; result ``i`` resolves the future of
    item ``i``. ``max_batch`` is an int or a ``key -> int`` callable.
    """

    def __init__(
        self,
        process: Callable[[Any, List[Any]], List[Any]],
        max_batch,
        max_delay_s: float = 0.01,
        depth: int = 64,
        name: str = "micro-batcher",
        clock: Callable[[], float] = time.monotonic,
        start: bool = True,
        poll_hook: Optional[Callable[[], None]] = None,
        on_expired: Optional[Callable[[int], None]] = None,
        on_flush_result: Optional[Callable[[bool], None]] = None,
        on_flush_stats: Optional[Callable[[Any, List[float]], None]] = None,
    ) -> None:
        """``clock``, ``start`` and ``poll_hook`` are test seams:
        ``clock`` replaces ``time.monotonic`` for deadline math (inject
        scheduler delay without sleeping), ``start=False`` skips the
        worker thread so tests drive :meth:`_service_once` directly, and
        ``poll_hook`` runs at the top of every worker iteration (an
        Event-based rendezvous point — deterministic, no sleep races).

        ``on_expired(n)`` is called on the worker thread each time a
        flush drops ``n`` deadline-expired entries; ``on_flush_result(ok)``
        after every processed flush — the engine's hooks for its shed /
        degraded-health accounting (both must be cheap and non-raising).
        ``on_flush_stats(key, waits_s)`` fires before each dispatched
        flush with every live entry's queue-wait seconds — the gauge feed
        for the SLO deadline controller and /healthz depth reporting."""
        if not callable(max_batch):
            if max_batch < 1:
                raise ValueError(f"max_batch must be >= 1, got {max_batch}")
            _n = int(max_batch)
            max_batch = lambda key: _n  # noqa: E731
        if not callable(max_delay_s):
            if max_delay_s < 0:
                raise ValueError(
                    f"max_delay_s must be >= 0, got {max_delay_s}"
                )
            _d = float(max_delay_s)
            max_delay_s = lambda key: _d  # noqa: E731
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._process = process
        self._max_batch = max_batch
        self._max_delay_s = max_delay_s
        self._clock = clock
        self._poll_hook = poll_hook
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = False
        self._on_expired = on_expired
        self._on_flush_result = on_flush_result
        self._on_flush_stats = on_flush_stats
        # worker appends while flush_log snapshots from other threads
        self._log_lock = threading.Lock()
        self._flushes: List[Tuple[Any, int]] = []  # (key, size) history
        self._expired_total = 0  # deadline-dropped entries, ever
        # submitted-but-not-yet-flushed entries per key: incremented by
        # submitter threads, decremented by the worker's flush — both
        # under _log_lock (the /healthz per-bucket depth gauge)
        self._key_depth: Dict[Any, int] = {}
        # worker-loop state; touched by the controlling thread only in
        # the threadless (start=False) test mode.
        # entries: (item, future, submit_time, absolute_deadline|None,
        #           trace_context|None)
        self._pending: Dict[Any, List[Tuple[Any, Future, float, Optional[float], Any]]] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=name
            )
            self._thread.start()

    # ------------------------------------------------------------- producer

    def submit(
        self,
        key: Any,
        item: Any,
        timeout: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Enqueue one request; returns its Future.

        Blocks while the queue is at depth (bounded-queue backpressure);
        with ``timeout`` raises ``queue.Full`` instead of waiting
        forever (``timeout=0`` is pure admission control: accept or shed,
        never wait). ``deadline_s`` is a time-to-live from now: if the
        entry is still queued when its deadline passes, the flush drops
        it with :class:`DeadlineExceeded` instead of computing it.
        Raises ``RuntimeError`` once closed.
        """
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        now = self._clock()
        deadline = None if deadline_s is None else now + deadline_s
        # the submitter's trace context rides the entry so the worker can
        # attribute the queue-wait hop to the request that paid it
        trace = tracecontext.current_trace()
        self._queue.put((key, item, fut, now, deadline, trace), timeout=timeout)
        with self._log_lock:
            self._key_depth[key] = self._key_depth.get(key, 0) + 1
        return fut

    def close(self, join_timeout: float = 60.0) -> None:
        """Drain-and-stop: everything accepted before close is processed
        (partial groups flush), then the worker exits. Idempotent."""
        if self._closed:
            if self._thread is not None:
                self._thread.join(timeout=join_timeout)
            return
        self._closed = True
        # the sentinel rides the same queue, so FIFO order guarantees the
        # worker sees every accepted request first; put() may need to wait
        # for the worker to free a slot, in a loop that notices worker death
        while True:
            try:
                self._queue.put(_CLOSE, timeout=0.1)
                break
            except queue.Full:
                if self._thread is None:
                    # threadless test mode: make room inline
                    self._service_once(block=False)
                elif not self._thread.is_alive():  # pragma: no cover - crashed
                    break
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
        else:
            # threadless test mode: run the drain loop to the sentinel
            # (each iteration consumes one queue entry, so this terminates)
            while self._service_once(block=False):
                pass
        # requests that raced past the closed flag after the sentinel: fail
        # them explicitly rather than leaving their futures pending forever
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            if entry is not _CLOSE:
                entry[2].set_exception(
                    RuntimeError("MicroBatcher closed before processing")
                )
                with self._log_lock:
                    self._key_depth[entry[0]] = (
                        self._key_depth.get(entry[0], 0) - 1
                    )

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def flush_log(self) -> List[Tuple[Any, int]]:
        """(key, n_requests) per flush, oldest first (introspection/tests)."""
        with self._log_lock:
            return list(self._flushes)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def key_depths(self) -> Dict[Any, int]:
        """Submitted-but-unflushed entry count per key (queued + grouped
        on the worker) — the per-bucket depth gauge /healthz reports."""
        with self._log_lock:
            return {k: n for k, n in self._key_depth.items() if n > 0}

    def delay_s(self, key: Any) -> float:
        """The currently-effective flush deadline for ``key`` (resolves
        the callable form — introspection for /stats and tests)."""
        return self._max_delay_s(key)

    @property
    def expired_total(self) -> int:
        """Entries dropped at flush time because their deadline passed."""
        with self._log_lock:
            return self._expired_total

    # --------------------------------------------------------------- worker

    def _run(self) -> None:
        while self._service_once(block=True):
            pass

    def _service_once(self, block: bool = True) -> bool:
        """One worker iteration: take at most one queue entry (waiting up
        to the nearest group deadline when ``block``), then flush every
        size-complete or deadline-expired group. Returns False once the
        close sentinel has been processed (pending fully drained).

        The deadline scan runs EVERY iteration, not only when the get
        times out: under a sustained backlog the get always returns an
        entry immediately, and a scan gated on ``queue.Empty`` (the
        original shape of this loop) never runs — one hot key's arrivals
        starve every other key's deadline flush indefinitely.
        """
        if self._poll_hook is not None:
            self._poll_hook()
        # _pending preserves insertion order (dict), so deadline scans
        # see oldest groups first
        pending = self._pending
        timeout = None
        if pending:
            nearest = min(
                group[0][2] + self._max_delay_s(key)
                for key, group in pending.items()
            )
            timeout = max(0.0, nearest - self._clock())
        try:
            if block:
                entry = self._queue.get(timeout=timeout)
            else:
                entry = self._queue.get_nowait()
        except queue.Empty:
            entry = None  # a group's deadline expired (or nothing queued)
        if entry is _CLOSE:
            for key in list(pending):
                self._flush(key, pending)
            return False
        if entry is not None:
            key, item, fut, t0, deadline, trace = entry
            group = pending.setdefault(key, [])
            group.append((item, fut, t0, deadline, trace))
            if len(group) >= self._max_batch(key):
                self._flush(key, pending)
        now = self._clock()
        for key in list(pending):
            group = pending[key]
            if group and now >= group[0][2] + self._max_delay_s(key):
                self._flush(key, pending)
        return True

    def _flush(
        self,
        key: Any,
        pending: Dict[Any, List[Tuple[Any, Future, float, Optional[float], Any]]],
    ) -> None:
        group = pending.pop(key)
        with self._log_lock:
            self._key_depth[key] = self._key_depth.get(key, 0) - len(group)
        # deadline-expired entries are dropped HERE, before any compute:
        # the waiter that owned the request has already timed out, so
        # dispatching its slot would burn accelerator time on abandoned
        # work (and delay the live requests batched behind it)
        now = self._clock()
        live = []
        expired = 0
        for item, fut, t0, deadline, trace in group:
            if deadline is not None and now > deadline:
                expired += 1
                fut.set_exception(
                    DeadlineExceeded(
                        f"request deadline expired after {now - t0:.3f}s in "
                        f"queue (key={key!r}); dropped before dispatch"
                    )
                )
            else:
                live.append((item, fut, t0, deadline, trace))
        if expired:
            with self._log_lock:
                self._expired_total += expired
            if self._on_expired is not None:
                self._on_expired(expired)
        if not live:
            return
        with self._log_lock:
            self._flushes.append((key, len(live)))
        if self._on_flush_stats is not None:
            self._on_flush_stats(key, [now - t0 for _, _, t0, _, _ in live])
        # queue-wait hop spans: the wait started on the submitter's
        # thread and ended here, so the event is emitted retroactively
        # (ts = flush time - wait) with the request's trace identity
        tracer = tspans.current_tracer()
        if tracer.enabled:
            end_us = tracer.now_us()
            for _, _, t0, _, trace in live:
                if trace is not None:
                    dur_us = max(0.0, (now - t0) * 1e6)
                    tracer.complete(
                        "serve/queue_wait",
                        end_us - dur_us,
                        dur_us,
                        cat="serve",
                        key=str(key),
                        **trace.span_args(),
                    )
        try:
            failpoints.fire("batcher.flush", key=str(key), n=len(live))
            results = self._process(key, [item for item, _, _, _, _ in live])
            if len(results) != len(live):
                raise RuntimeError(
                    f"process returned {len(results)} results for "
                    f"{len(live)} items (key={key!r})"
                )
        except BaseException as e:  # noqa: BLE001 - relayed through futures
            for _, fut, _, _, _ in live:
                fut.set_exception(e)
            if self._on_flush_result is not None:
                self._on_flush_result(False)
            return
        if self._on_flush_result is not None:
            self._on_flush_result(True)
        for (_, fut, _, _, _), res in zip(live, results):
            fut.set_result(res)
