"""In-process load generator for the serving engine and the fleet router (a
copy of the JAX package's ``serving/loadgen.py``).

Two canonical load shapes (the serving-benchmark literature's pair):

* **closed loop** — submit every request as fast as the engine's bounded
  queue accepts them; measures capacity (max throughput) and the latency
  distribution under saturation. With a deadline-triggered micro-batcher
  this is the regime where flushes run at full bucket batch size.
* **open loop** — submit at a fixed offered rate regardless of
  completions (sleep-paced); measures the latency a user sees at a given
  traffic level, including queueing. Offered > capacity shows up as
  latency blowing past ``max_delay_ms`` — the signature of an overloaded
  tier, which a closed loop structurally cannot show.

Latency is measured per request from submit to future resolution
(``Future.add_done_callback`` stamps completion on the worker thread),
so it includes queue wait + batching delay + dispatch + de-normalization
— the full engine-side request path.

Client-side hardening (so a wedged or overloaded server costs the
benchmark a bounded wait, never a hang):

* every result wait carries a deadline (``timeout_s``, default 120 s);
  expired waits are counted and reported as ``timeout_fraction``;
* with ``admission=True`` submits are non-blocking with seeded jittered
  exponential backoff (serving/overload.py); requests still shed after
  the retry budget are counted as ``shed`` instead of blocking forever.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from replication_faster_rcnn_tpu_torch.serving.overload import (
    DeadlineExceeded,
    backoff_delays,
)
from replication_faster_rcnn_tpu_torch.telemetry import tracecontext

__all__ = [
    "percentile_ms",
    "run_closed_loop",
    "run_fleet_loop",
    "run_open_loop",
]

# generous per-request result deadline: far above any sane serving
# latency, small enough that a wedged engine fails the run in minutes
DEFAULT_TIMEOUT_S = 120.0


def percentile_ms(latencies_s: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) of a latency list, in milliseconds."""
    if not latencies_s:
        return 0.0
    return float(np.percentile(np.asarray(latencies_s, np.float64), q) * 1e3)


def _summarize(
    latencies_s: List[float], wall_s: float, n: int, **extra: Any
) -> Dict[str, Any]:
    return {
        "n_requests": n,
        "wall_s": round(wall_s, 4),
        "images_per_sec": round(n / wall_s, 3) if wall_s > 0 else 0.0,
        "p50_ms": round(percentile_ms(latencies_s, 50), 3),
        "p99_ms": round(percentile_ms(latencies_s, 99), 3),
        "mean_ms": round(float(np.mean(latencies_s)) * 1e3, 3)
        if latencies_s
        else 0.0,
        **extra,
    }


class _Counters:
    """Shed/retry/timeout/error tallies shared with done-callbacks."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.latencies: List[float] = []
        self.shed = 0
        self.retries = 0
        self.timeouts = 0
        self.errors = 0


def _submit_timed(engine, image, counters: _Counters):
    t0 = time.monotonic()

    def _done(fut) -> None:
        dt = time.monotonic() - t0
        with counters.lock:
            if fut.exception() is None:
                counters.latencies.append(dt)

    fut = engine.submit(image)
    fut.add_done_callback(_done)
    return fut


def _submit_admission(engine, image, counters: _Counters, seed: int):
    """Non-blocking submit with jittered-backoff retries; returns the
    Future or None once the retry budget sheds the request."""
    import queue

    attempt = 0
    while True:
        try:
            t0 = time.monotonic()
            fut = engine.submit(image, timeout=0)
        except queue.Full:
            delays = list(backoff_delays(seed=seed))
            if attempt >= len(delays):
                with counters.lock:
                    counters.shed += 1
                return None
            with counters.lock:
                counters.retries += 1
            time.sleep(delays[attempt])
            attempt += 1
            continue

        def _done(f, t0=t0) -> None:
            dt = time.monotonic() - t0
            with counters.lock:
                if f.exception() is None:
                    counters.latencies.append(dt)

        fut.add_done_callback(_done)
        return fut


def _await_all(
    futures: Sequence, timeout_s: Optional[float], counters: _Counters
) -> None:
    """Wait for every future, bounding each wait by ``timeout_s``;
    timeouts and per-request errors are counted, not raised — the
    summary is the report."""
    for f in futures:
        if f is None:
            continue
        try:
            f.result(timeout=timeout_s)
        except (FutureTimeoutError, TimeoutError, DeadlineExceeded):
            with counters.lock:
                counters.timeouts += 1
        except Exception:  # noqa: BLE001 - tallied in the summary
            with counters.lock:
                counters.errors += 1


def _extra(counters: _Counters, n: int) -> Dict[str, Any]:
    with counters.lock:
        return {
            "timeouts": counters.timeouts,
            "timeout_fraction": round(counters.timeouts / n, 4) if n else 0.0,
            "shed": counters.shed,
            "submit_retries": counters.retries,
            "errors": counters.errors,
        }


def run_closed_loop(
    engine,
    images: Sequence[np.ndarray],
    n_requests: int,
    timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
    admission: bool = False,
    seed: int = 0,
    concurrency: Optional[int] = None,
) -> Dict[str, Any]:
    """Saturation: fire ``n_requests`` submits back-to-back (the bounded
    queue throttles the producer — or sheds, with ``admission=True``)
    and wait for all results under the per-request deadline.

    ``concurrency=K`` runs K client threads instead, each submitting its
    static share (client ``k`` takes requests ``k, k+K, ...``) one at a
    time and waiting for each result before the next: K requests in
    flight, each client resizing its own images. The summary then also
    carries ``concurrency``."""
    if concurrency is not None:
        return _closed_loop_clients(engine, images, n_requests, timeout_s, admission, seed,
                                    concurrency)
    counters = _Counters()
    t0 = time.monotonic()
    futures = []
    for i in range(n_requests):
        image = images[i % len(images)]
        if admission:
            futures.append(_submit_admission(engine, image, counters, seed + i))
        else:
            futures.append(_submit_timed(engine, image, counters))
    _await_all(futures, timeout_s, counters)
    wall = time.monotonic() - t0
    return _summarize(
        counters.latencies, wall, n_requests, mode="closed",
        **_extra(counters, n_requests),
    )


def _closed_loop_clients(engine, images, n_requests, timeout_s, admission, seed,
                         concurrency: int) -> Dict[str, Any]:
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    counters = _Counters()

    def _client(start: int) -> None:
        for i in range(start, n_requests, concurrency):
            image = images[i % len(images)]
            if admission:
                fut = _submit_admission(engine, image, counters, seed + i)
            else:
                fut = _submit_timed(engine, image, counters)
            _await_all([fut], timeout_s, counters)

    threads = [threading.Thread(target=_client, args=(k,), name=f"loadgen-client-{k}")
               for k in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    return _summarize(
        counters.latencies, wall, n_requests, mode="closed", concurrency=concurrency,
        **_extra(counters, n_requests),
    )


def run_fleet_loop(
    dispatch,
    requests: Sequence,
    concurrency: int = 4,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Dict[str, Any]:
    """Closed-loop load over a fleet router: ``concurrency`` client
    threads each walk their static share of ``requests`` (worker ``k``
    takes indices ``k, k+K, ...`` — deterministic partition, no shared
    iterator) calling ``dispatch(payload, content_hash)`` synchronously.

    The headline number is **availability** — the fraction of requests
    that returned a result, which is what the fleet's failover/hedging
    machinery is supposed to hold through a replica kill; throughput and
    latency percentiles ride along.  ``timeout_s`` bounds each worker
    join, so a wedged fleet costs the run a bounded wait (workers still
    stuck at the deadline are counted as hung and their remaining
    requests as failures).

    Each request runs under its own root trace context (the way a real
    client front door would mint one), so with a tracer installed the
    router's attempt spans group per request in the merged timeline;
    the first few failed requests' trace ids come back under
    ``failed_trace_ids`` — paste one into
    the ``telemetry --trace-id`` subcommand to see where the request died.
    """
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    counters = _Counters()
    n = len(requests)
    failed_traces: List[str] = []

    def _worker(start: int) -> None:
        for i in range(start, n, concurrency):
            payload, content_hash = requests[i]
            trace = tracecontext.new_trace_context()
            t0 = time.monotonic()
            try:
                with tracecontext.bind(trace):
                    dispatch(payload, content_hash)
            except Exception:  # noqa: BLE001 - tallied as unavailability
                with counters.lock:
                    counters.errors += 1
                    if len(failed_traces) < 16:
                        failed_traces.append(trace.trace_id)
                continue
            dt = time.monotonic() - t0
            with counters.lock:
                counters.latencies.append(dt)

    threads = [
        threading.Thread(
            target=_worker, args=(k,), name=f"fleet-loadgen-{k}"
        )
        for k in range(concurrency)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    hung = 0
    for t in threads:
        t.join(timeout=timeout_s)
        if t.is_alive():
            hung += 1
    wall = time.monotonic() - t0
    with counters.lock:
        ok = len(counters.latencies)
        errors = counters.errors
    summary = _summarize(
        list(counters.latencies), wall, n, mode="fleet",
        concurrency=concurrency, errors=errors, hung_workers=hung,
    )
    summary["ok"] = ok
    summary["availability"] = round(ok / n, 6) if n else 0.0
    with counters.lock:
        summary["failed_trace_ids"] = list(failed_traces)
    return summary


def run_open_loop(
    engine,
    images: Sequence[np.ndarray],
    offered_rate: float,
    n_requests: Optional[int] = None,
    duration_s: Optional[float] = None,
    timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
    admission: bool = False,
    seed: int = 0,
) -> Dict[str, Any]:
    """Fixed offered load: one submit every ``1/offered_rate`` seconds
    (absolute schedule, so a slow submit doesn't silently lower the
    offered rate), for ``n_requests`` or ``duration_s``."""
    if offered_rate <= 0:
        raise ValueError(f"offered_rate must be > 0, got {offered_rate}")
    if n_requests is None:
        if duration_s is None:
            raise ValueError("need n_requests or duration_s")
        n_requests = max(1, int(offered_rate * duration_s))
    counters = _Counters()
    interval = 1.0 / offered_rate
    t0 = time.monotonic()
    futures = []
    for i in range(n_requests):
        target = t0 + i * interval
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        image = images[i % len(images)]
        if admission:
            futures.append(_submit_admission(engine, image, counters, seed + i))
        else:
            futures.append(_submit_timed(engine, image, counters))
    _await_all(futures, timeout_s, counters)
    wall = time.monotonic() - t0
    return _summarize(
        counters.latencies, wall, n_requests, mode="open",
        offered_rate=offered_rate, **_extra(counters, n_requests),
    )
