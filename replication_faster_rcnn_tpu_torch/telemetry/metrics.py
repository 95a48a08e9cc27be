"""Dependency-free unified metrics registry (a copy of the JAX package's
``telemetry/metrics.py``).

One :class:`MetricsRegistry` per process tier (engine, fleet router)
replaces the hand-rolled ``_stats_lock``-guarded dicts that the
batcher, engine, router, replica registry, and breakers each grew on
their own.  Three instrument types:

- :class:`Counter` — monotonically increasing event count;
- :class:`Gauge` — point-in-time level (queue depth, breaker state);
- :class:`Histogram` — fixed-upper-bound buckets with running
  sum/count, from which p50/p95/p99 are derived by linear
  interpolation inside the landing bucket.  Memory is O(buckets)
  forever — unlike the raw-latency lists it replaces, sustained load
  cannot grow it.

Every instrument owns its own lock and never calls out while holding
it; the registry lock only guards the instrument table.  No lock is
ever taken while another is held, so the whole module is clean under
``frcnn check``'s threadlint.

Two render paths, one source of truth: :meth:`MetricsRegistry.snapshot`
feeds the JSON ``/stats`` bodies and ``fleet.jsonl``, and
:meth:`MetricsRegistry.render_prometheus` feeds ``GET /metrics`` in the
Prometheus text exposition format — the numbers cannot disagree
because both walk the same instruments.

Gauges that mirror external state (registry leases, breaker states)
are refreshed by *collectors*: callables registered with
:meth:`register_collector` and invoked at snapshot/render time, so
scrapes always see current state without the owning object pushing on
every transition.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_S",
    "PROMETHEUS_CONTENT_TYPE",
    "STATS_SCHEMA",
    "stats_payload",
]

# both HTTP tiers serve GET /metrics with this content type
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# the unified /stats envelope version (serving/server.py and
# serving/fleet/server.py both emit it; README documents the shape)
STATS_SCHEMA = "frcnn-stats/v1"

# Latency histogram upper bounds in seconds: 1 ms .. 60 s, roughly
# log-spaced (the +Inf bucket is implicit). Chosen so serving-tier
# latencies (single-digit ms to tens of s under chaos) land mid-range.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_INF = float("inf")


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape_label(value: Any) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _format_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class Counter:
    """Monotonic event counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Settable point-in-time level."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with derived percentiles.

    ``buckets`` are inclusive upper bounds in ascending order; the
    ``+Inf`` bucket is implicit.  Percentiles interpolate linearly
    within the landing bucket (the standard Prometheus
    ``histogram_quantile`` estimate), so they are approximations whose
    error is bounded by the bucket width — and whose memory is bounded
    by the bucket COUNT, which is the point.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
    ):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be ascending")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """The q-th percentile estimate (q in [0, 100]); 0.0 when empty."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        cum: Dict[str, int] = {}
        running = 0
        for bound, c in zip(self.bounds, counts[:-1]):
            running += c
            cum[_format_value(bound)] = running
        cum["+Inf"] = total
        return {
            "buckets": cum,
            "sum": s,
            "count": total,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


def stats_payload(
    tier: str, registry: "MetricsRegistry", /, **sections: Any
) -> Dict[str, Any]:
    """The unified ``/stats`` envelope both HTTP tiers render::

        {"schema": "frcnn-stats/v1", "tier": <tier>,
         "metrics": <registry snapshot>, ...tier sections}

    ``sections`` carry each tier's structured views (the historical
    keys — ``stats``/``queue_depth`` on a replica, ``router``/
    ``replicas``/``registry``/``slo`` on the fleet front) so existing
    consumers keep working; the ``metrics`` block is the same registry
    that renders ``GET /metrics``, so JSON and Prometheus cannot
    disagree."""
    payload: Dict[str, Any] = {
        "schema": STATS_SCHEMA,
        "tier": tier,
        "metrics": registry.snapshot(),
    }
    payload.update(sections)
    return payload


class MetricsRegistry:
    """Thread-safe instrument table with one get-or-create per type."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get_or_create(self, cls, name: str, help: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
        **labels: str,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Register a callable run before every snapshot/render; it
        should ``set()`` gauges from current external state."""
        with self._lock:
            self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:  # outside the lock: collectors may create gauges
            fn()

    def _instruments(self) -> List[Any]:
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str) -> List[Any]:
        """Every instrument registered under ``name`` (one per label
        set) — for consumers that rebuild structured views (per-replica
        tables) from labeled counters."""
        return [m for m in self._instruments() if m.name == name]

    def counters_flat(self) -> Dict[str, float]:
        """``{name{labels}: value}`` for counters only — the compat
        surface older ``/stats`` consumers read."""
        out: Dict[str, float] = {}
        for m in self._instruments():
            if m.kind == "counter":
                out[m.name + _format_labels(m.labels)] = m.value
        return out

    def snapshot(self) -> Dict[str, Any]:
        """All instruments as plain JSON-able dicts, grouped by kind."""
        self._run_collectors()
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self._instruments():
            key = m.name + _format_labels(m.labels)
            if m.kind == "counter":
                out["counters"][key] = m.value
            elif m.kind == "gauge":
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.snapshot()
        return out

    def render_prometheus(self) -> str:
        """The Prometheus text exposition format (version 0.0.4)."""
        self._run_collectors()
        by_name: Dict[str, List[Any]] = {}
        for m in self._instruments():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            family = sorted(by_name[name], key=lambda m: _label_key(m.labels))
            first = family[0]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            lines.append(f"# TYPE {name} {first.kind}")
            for m in family:
                lbl = _format_labels(m.labels)
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{name}{lbl} {_format_value(m.value)}")
                else:
                    snap = m.snapshot()
                    for le, cum in snap["buckets"].items():
                        blabels = dict(m.labels)
                        blabels["le"] = le
                        lines.append(
                            f"{name}_bucket{_format_labels(blabels)} {cum}"
                        )
                    lines.append(
                        f"{name}_sum{lbl} {_format_value(snap['sum'])}"
                    )
                    lines.append(f"{name}_count{lbl} {snap['count']}")
        return "\n".join(lines) + "\n"
