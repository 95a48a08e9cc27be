"""Host-side span tracer emitting Chrome-trace JSON (a copy of the JAX
package's ``telemetry/spans.py``; it imports neither JAX nor PyTorch).

The output is the ``{"traceEvents": [...]}`` object format that
``chrome://tracing`` and Perfetto load directly: complete events
(``ph: "X"``) with microsecond ``ts``/``dur``, instant events
(``ph: "i"``) for marks, and counter events (``ph: "C"``) for gauges
like prefetch-queue depth.

Instrumented code does not take a tracer parameter — it calls
``current_tracer().span("data/fetch", cat="data")`` and gets either the
process-wide active tracer or ``NULL_TRACER``, whose span is a reusable
no-op context manager. That keeps the loader/evaluator call sites
unconditional and free when telemetry is off.

What the dispatch and sync spans mean under CUDA's asynchronous launches:
``step/dispatch`` covers the host's work for one train step (enqueueing
its kernels, and every wait for the card inside the step: the guarded
update reads its non-finite count on the host), while ``step/sync``
covers the conversion of the step's metrics to Python floats, the wait
for the card to drain. Feed-bound runs show fat ``data/*`` spans;
host-bound steps a fat dispatch and a thin sync.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional


class _NullSpan:
    """Reusable no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Inert tracer: every operation is a no-op."""

    enabled = False

    def span(self, name: str, cat: str = "phase", **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "mark", **args: Any) -> None:
        pass

    def counter(self, name: str, value: float, cat: str = "counter") -> None:
        pass

    def now_us(self) -> float:
        return 0.0

    def complete(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        cat: str = "phase",
        **args: Any,
    ) -> None:
        pass

    def flush(self, path: Optional[str] = None) -> None:
        pass

    @property
    def last_span(self) -> None:
        return None


NULL_TRACER = NullTracer()


class SpanTracer:
    """Thread-safe in-memory Chrome-trace event collector.

    Events are buffered in RAM (bounded by ``max_events``; overflow
    increments a drop counter rather than growing without bound — a
    wedged producer must not OOM the host on top of everything else) and
    written with :meth:`flush`, atomically via a temp file + rename so a
    crash mid-write never leaves a truncated JSON behind.
    """

    enabled = True

    def __init__(
        self,
        path: Optional[str] = None,
        max_events: int = 200_000,
        rank: Optional[int] = None,
    ):
        self.path = path
        self.max_events = max_events
        # process_index of a multi-process run: stamped on every event (so
        # merged per-rank traces stay attributable) and into otherData
        self.rank = rank
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._pid = os.getpid()
        self._dropped = 0
        # Written lock-free on span entry; the watchdog reads it to report
        # what the process was last doing when a stall fires.
        self._last_span: Optional[Dict[str, Any]] = None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, event: Dict[str, Any]) -> None:
        if self.rank is not None:
            event.setdefault("args", {})["process_index"] = self.rank
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(event)
            else:
                self._dropped += 1

    @contextmanager
    def span(self, name: str, cat: str = "phase", **args: Any) -> Iterator[None]:
        ts = self._now_us()
        self._last_span = {"name": name, "cat": cat, "started_wall": time.time()}
        try:
            yield
        finally:
            event = {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": ts,
                "dur": self._now_us() - ts,
                "pid": self._pid,
                "tid": threading.get_ident(),
            }
            if args:
                event["args"] = args
            self._emit(event)

    def now_us(self) -> float:
        """This tracer's clock, for callers that measure a span whose
        start and end happen on different threads (queue-wait hops) and
        emit it afterwards with :meth:`complete`."""
        return self._now_us()

    def complete(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        cat: str = "phase",
        **args: Any,
    ) -> None:
        """Emit a complete event with an explicit start/duration — the
        non-contextmanager twin of :meth:`span` for cross-thread hops."""
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            event["args"] = args
        self._emit(event)

    def instant(self, name: str, cat: str = "mark", **args: Any) -> None:
        event = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            event["args"] = args
        self._emit(event)

    def counter(self, name: str, value: float, cat: str = "counter") -> None:
        self._emit(
            {
                "name": name,
                "cat": cat,
                "ph": "C",
                "ts": self._now_us(),
                "pid": self._pid,
                "args": {"value": value},
            }
        )

    @property
    def last_span(self) -> Optional[Dict[str, Any]]:
        snap = self._last_span
        if snap is None:
            return None
        out = dict(snap)
        out["age_s"] = round(time.time() - out.pop("started_wall"), 3)
        return out

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        other: Dict[str, Any] = {
            "start_unix_time": self._wall0,
            "dropped_events": dropped,
        }
        if self.rank is not None:
            other["process_index"] = self.rank
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def flush(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            return
        tmp = f"{path}.tmp.{self._pid}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)


_active: Any = NULL_TRACER
_active_lock = threading.Lock()


def set_tracer(tracer: Optional[Any]) -> Any:
    """Install ``tracer`` as the process-wide tracer; returns the previous
    one (pass it back, or ``None``, to restore)."""
    global _active
    with _active_lock:
        prev = _active
        _active = NULL_TRACER if tracer is None else tracer
    return prev if prev is not NULL_TRACER else None


def current_tracer() -> Any:
    return _active
