"""The fleet dispatcher: consistent hashing, result cache, breakers,
failover, hedging, canary and shadow traffic (a copy of the JAX package's
``serving/fleet/router.py``).

One request's path through :meth:`FleetRouter.dispatch`:

1. **Cache** — the content hash answers exact-duplicate images from the
   router's LRU without touching a replica.
2. **Placement** — the request's ring key ``content_hash:bucket`` walks
   the consistent-hash ring (``fleet.vnodes`` points per replica) over
   the replicas currently in rotation; the ordered walk IS the failover
   order, so retries of the same image hit the same replicas in the
   same order while membership is stable, and membership changes move
   only ~1/N of the keyspace.  A deterministic ``canary_fraction``
   slice of the hash space tries the canary replica first.
3. **Dispatch** — attempts run against the walk order, skipping
   replicas whose circuit breaker refuses.  Every attempt consults the
   ``router.dispatch`` failpoint: an injected ``drop`` invokes the
   router's kill hook (the chaos/benchmark seam that makes the selected
   replica actually die) and then fails the attempt as a dropped
   connection — which the machinery below must absorb.
4. **Failover** — a failed attempt records into that replica's breaker
   and re-dispatches to the next replica in the walk, up to
   ``fleet.max_attempts``.
5. **Hedging** — with ``fleet.hedge``, if the primary attempt has not
   resolved after ``hedge_multiplier x observed p99`` (clamped to the
   configured floor/ceiling), a second copy goes to the next replica
   and the first result wins — tail tolerance against a slow-but-alive
   replica, which failover alone cannot see.
6. **Shadow** — successful responses are mirrored to shadow replicas
   and diffed (counters only; the client's response is already gone).

Hedging needs real concurrency, so it runs attempts on a thread pool;
with ``hedge=False`` (or no pool) dispatch is strictly sequential and
single-threaded — the mode the chaos leg replays deterministically.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from bisect import bisect_right
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from replication_faster_rcnn_tpu_torch.config import FleetConfig
from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.serving.fleet.breaker import CircuitBreaker
from replication_faster_rcnn_tpu_torch.serving.fleet.client import ReplicaDown
from replication_faster_rcnn_tpu_torch.serving.fleet.registry import (
    CANARY,
    SERVING,
    SHADOW,
    ReplicaRegistry,
)
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
from replication_faster_rcnn_tpu_torch.telemetry import tracecontext
from replication_faster_rcnn_tpu_torch.telemetry.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    MetricsRegistry,
)
from replication_faster_rcnn_tpu_torch.telemetry.slo_burn import BurnRateTracker

__all__ = ["FleetRouter", "FleetUnavailable", "HashRing", "content_key"]

# a canary's own burn-rate tracker must see at least this many attempt
# outcomes in the long window before its alarm can demote it — a canary
# judged on three requests is an unfair trial
CANARY_SLO_MIN_SAMPLES = 20

# the router's request/attempt counters, in /stats order; each is a
# registry counter named fleet_<key>_total
_STAT_KEYS = (
    "requests",
    "cache_hits",
    "attempts",
    "failed_attempts",
    "failovers",
    "hedges",
    "hedge_wins",
    "canary_requests",
    "canary_demotions",
    "shadow_requests",
    "shadow_diffs",
    "unavailable",
)


class FleetUnavailable(ConnectionError):
    """Every eligible replica refused or failed the request."""


_CACHE_MISS = object()


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


def content_key(data: bytes) -> str:
    """Stable content hash for a request payload (cache + ring key)."""
    return hashlib.sha256(data).hexdigest()


class HashRing:
    """Consistent hash ring with virtual nodes.

    ``ordered(key)`` walks clockwise from the key's position and returns
    every distinct node once — position 0 is the owner, the rest are the
    failover/hedge order.  Stateless w.r.t. membership: build one per
    membership set (cheap — ``vnodes x N`` hashes) and cache by set.
    """

    def __init__(self, nodes: List[str], vnodes: int = 64) -> None:
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        points: List[Tuple[int, str]] = []
        for node in nodes:
            for v in range(vnodes):
                points.append((_hash64(f"{node}#{v}"), node))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]
        self._n_nodes = len(set(nodes))

    def ordered(self, key: str) -> List[str]:
        if not self._points:
            return []
        start = bisect_right(self._hashes, _hash64(key))
        seen: Set[str] = set()
        out: List[str] = []
        for i in range(len(self._points)):
            _, node = self._points[(start + i) % len(self._points)]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) == self._n_nodes:
                    break
        return out


class FleetRouter:
    """Self-healing dispatcher over a :class:`ReplicaRegistry`.

    ``kill_hook(replica_id)`` is called when a ``router.dispatch`` drop
    fault selects a replica — the chaos leg and the fleet's loaded checks
    wire it to ``LocalReplicaClient.kill`` so the injected death is
    real for every subsequent attempt and probe.
    """

    def __init__(
        self,
        registry: ReplicaRegistry,
        config: FleetConfig,
        clock: Callable[[], float] = time.monotonic,
        kill_hook: Optional[Callable[[str], None]] = None,
    ) -> None:
        self._registry = registry
        self._config = config
        self._clock = clock
        self._kill_hook = kill_hook
        # guards cache, breakers table, ring cache, canary-tracker table
        # — written from dispatch callers (HTTP handler threads) AND the
        # hedge pool's attempt/shadow tasks; counters/histograms carry
        # their own registry-internal locks
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._cache: "OrderedDict[str, Any]" = OrderedDict()
        self._ring_cache: Tuple[Tuple[str, ...], Optional[HashRing]] = ((), None)
        # unified metrics core: one registry renders /stats JSON,
        # /metrics Prometheus text, and fleet.jsonl snapshots
        self.metrics = MetricsRegistry()
        self._counters = {
            key: self.metrics.counter(f"fleet_{key}_total", help=f"fleet {key}")
            for key in _STAT_KEYS
        }
        # attempt latency histogram: bounded memory under sustained load
        # (the raw-latency deque it replaces kept every sample) AND the
        # p99 source for the hedge delay
        self._attempt_hist = self.metrics.histogram(
            "fleet_attempt_seconds",
            help="replica attempt latency (successful attempts)",
            buckets=DEFAULT_LATENCY_BUCKETS_S,
        )
        self.metrics.register_collector(self._collect_gauges)
        # SLO burn-rate over ATTEMPT outcomes: with failover absorbing
        # most failures before clients see them, attempts — not final
        # request results — are where a dying replica shows up first
        self.slo = BurnRateTracker(
            availability_target=config.slo_availability_target,
            latency_target_s=config.slo_latency_target_ms / 1000.0,
            short_window_s=config.slo_short_window_s,
            long_window_s=config.slo_long_window_s,
            clock=clock,
        )
        # per-canary trackers driving the auto-demote hook
        self._canary_slo: Dict[str, BurnRateTracker] = {}
        # hedging needs attempts in flight concurrently; sequential mode
        # (hedge=False) never touches the pool
        self._pool: Optional[ThreadPoolExecutor] = None
        if config.hedge:
            self._pool = ThreadPoolExecutor(
                max_workers=max(4, 2 * config.max_attempts),
                thread_name_prefix="fleet-hedge",
            )

    @property
    def stats(self) -> Dict[str, int]:
        """The router counters as a plain dict (the historical shape) —
        a registry snapshot, not mutable state."""
        return {k: int(c.value) for k, c in self._counters.items()}

    # ---------------------------------------------------------------- reads

    def breaker(self, replica_id: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(replica_id)
            if b is None:
                b = CircuitBreaker(
                    threshold=self._config.breaker_threshold,
                    cooldown_s=self._config.breaker_cooldown_s,
                    clock=self._clock,
                )
                self._breakers[replica_id] = b
            return b

    def hedge_delay_s(self) -> float:
        """``hedge_multiplier x observed p99`` clamped to the configured
        floor/ceiling; before any samples exist, the ceiling (hedge
        conservatively until there is evidence of the tail).  The p99
        comes from the attempt histogram — O(buckets) memory however
        long the router runs, unlike the raw-sample list it replaced."""
        cfg = self._config
        if self._attempt_hist.count == 0:
            return cfg.hedge_ceiling_ms / 1000.0
        raw = self._attempt_hist.percentile(99) * cfg.hedge_multiplier
        return min(
            max(raw, cfg.hedge_floor_ms / 1000.0),
            cfg.hedge_ceiling_ms / 1000.0,
        )

    def _collect_gauges(self) -> None:
        with self._lock:
            breakers = list(self._breakers.items())
            cache_size = len(self._cache)
        self.metrics.gauge(
            "fleet_cache_size", help="content-hash result cache entries"
        ).set(cache_size)
        self.metrics.gauge(
            "fleet_hedge_delay_seconds", help="current hedge trigger delay"
        ).set(self.hedge_delay_s())
        state_code = {"closed": 0, "half_open": 1, "open": 2}
        for rid, b in breakers:
            snap = b.snapshot()
            self.metrics.gauge(
                "fleet_breaker_state",
                help="circuit breaker state (0 closed, 1 half-open, 2 open)",
                replica=rid,
            ).set(state_code.get(snap["state"], -1))
        for rates_name, burn in self.slo.burn_rates().items():
            self.metrics.gauge(
                "fleet_slo_burn_rate",
                help="error-budget burn rate per window",
                window=rates_name,
            ).set(burn)
        # info-style gauge: mixed-precision fleets expose each replica's
        # reported residency dtype as a label (value is always 1)
        for rid, info in self._registry.snapshot().items():
            dtype = info.get("params_dtype")
            if dtype:
                self.metrics.gauge(
                    "fleet_replica_params_dtype",
                    help="replica resident params dtype (info gauge)",
                    replica=rid,
                    params_dtype=dtype,
                ).set(1)
            version = info.get("model_version")
            if version:
                # version-skew view during a rolling rollout: each
                # replica's current version as a label series (1 = the
                # version it reports now, stale series drop to 0)
                for c in self.metrics.find("fleet_replica_model_version"):
                    if (
                        c.labels.get("replica") == rid
                        and c.labels.get("model_version") != version
                    ):
                        c.set(0)
                self.metrics.gauge(
                    "fleet_replica_model_version",
                    help="replica resident model version (info gauge)",
                    replica=rid,
                    model_version=version,
                ).set(1)

    def _replica_counter(self, replica_id: str, outcome: str):
        return self.metrics.counter(
            "fleet_replica_attempts_total",
            help="per-replica attempt outcomes",
            replica=replica_id,
            outcome=outcome,
        )

    def snapshot(self) -> Dict[str, Any]:
        """Router + per-replica gauges for /stats and telemetry — every
        number is read back out of the metrics registry, so this JSON
        view and the Prometheus /metrics text cannot disagree."""
        per_replica: Dict[str, Dict[str, Any]] = {}
        for c in self.metrics.find("fleet_replica_attempts_total"):
            entry = per_replica.setdefault(
                c.labels["replica"], {"ok": 0, "fail": 0}
            )
            entry[c.labels["outcome"]] = int(c.value)
        with self._lock:
            breakers = list(self._breakers.items())
        for rid, b in breakers:
            per_replica.setdefault(rid, {"ok": 0, "fail": 0})["breaker"] = (
                b.snapshot()
            )
        return {
            "router": {
                **self.stats,
                "cache_size": self._cache_size(),
                "hedge_delay_ms": round(self.hedge_delay_s() * 1e3, 3),
            },
            "replicas": per_replica,
            "registry": self._registry.snapshot(),
            "slo": self.slo.snapshot(),
        }

    def _cache_size(self) -> int:
        with self._lock:
            return len(self._cache)

    # ------------------------------------------------------------ placement

    def _ring(self) -> HashRing:
        members = tuple(self._registry.in_rotation())
        with self._lock:
            cached_members, ring = self._ring_cache
            if ring is not None and cached_members == members:
                return ring
        ring = HashRing(list(members), vnodes=self._config.vnodes)
        with self._lock:
            self._ring_cache = (members, ring)
        return ring

    def _canary_first(self, content_hash: str) -> List[str]:
        """The canary replicas this request should try first: a stable
        ``canary_fraction`` slice of the content-hash space (the same
        image always lands on the same side of the split)."""
        cfg = self._config
        if cfg.canary_fraction <= 0:
            return []
        canaries = self._registry.in_rotation(role=CANARY)
        if not canaries:
            return []
        slot = _hash64(f"{content_hash}:canary") / float(1 << 64)
        if slot >= cfg.canary_fraction:
            return []
        return [canaries[_hash64(content_hash) % len(canaries)]]

    def candidates(self, content_hash: str, bucket: str = "") -> List[str]:
        """Dispatch order for a request: optional canary first, then the
        consistent-hash walk over the serving rotation."""
        order = self._canary_first(content_hash)
        for rid in self._ring().ordered(f"{content_hash}:{bucket}"):
            if rid not in order:
                order.append(rid)
        return order

    # ------------------------------------------------------------- dispatch

    def dispatch(
        self, payload: Any, content_hash: str, bucket: str = ""
    ) -> Any:
        """Route one request through cache -> canary/ring -> breakers ->
        failover/hedging.  Raises :class:`FleetUnavailable` when no
        replica could serve it.

        The request's trace context is the one already bound on this
        thread (the fleet HTTP front door extracts the caller's
        ``traceparent``) or a fresh root; every attempt below runs as a
        child span of it, so the whole failover/hedge fan-out shares one
        trace id in the merged timeline."""
        cfg = self._config
        trace = tracecontext.current_trace() or tracecontext.new_trace_context()
        tracer = tspans.current_tracer()
        self._counters["requests"].inc()
        hit = _CACHE_MISS
        with self._lock:
            if cfg.cache_entries > 0 and content_hash in self._cache:
                self._cache.move_to_end(content_hash)
                hit = self._cache[content_hash]
        if hit is not _CACHE_MISS:
            self._counters["cache_hits"].inc()
            return hit
        order = self.candidates(content_hash, bucket)
        if not order:
            self._counters["unavailable"].inc()
            raise FleetUnavailable(
                f"no replicas in rotation (trace {trace.trace_id})"
            )
        if order[0] in self._registry.in_rotation(role=CANARY):
            self._counters["canary_requests"].inc()
        t_req = tracer.now_us()
        try:
            with tracecontext.bind(trace):
                if self._pool is not None and cfg.hedge:
                    result = self._dispatch_hedged(payload, order, trace)
                else:
                    result = self._dispatch_sequential(payload, order, trace)
        finally:
            if tracer.enabled:
                tracer.complete(
                    "fleet/request",
                    t_req,
                    tracer.now_us() - t_req,
                    cat="fleet",
                    content_hash=content_hash[:16],
                    **trace.span_args(),
                )
        with self._lock:
            if cfg.cache_entries > 0:
                self._cache[content_hash] = result
                self._cache.move_to_end(content_hash)
                while len(self._cache) > cfg.cache_entries:
                    self._cache.popitem(last=False)
        self._mirror_to_shadows(payload, result)
        return result

    def _next_allowed(
        self, order: List[str], tried: Set[str]
    ) -> Optional[str]:
        for rid in order:
            if rid not in tried and self.breaker(rid).allow():
                return rid
        return None

    def _attempt(
        self,
        replica_id: str,
        payload: Any,
        ctx: Optional[tracecontext.TraceContext] = None,
        hedge: bool = False,
    ) -> Any:
        """One replica call: failpoint consult, predict, accounting.
        Runs on the caller thread (sequential mode) or a hedge-pool
        thread — every shared write below is lock-guarded.

        ``ctx`` is this attempt's span: bound to the executing thread so
        the transport (HTTP traceparent header / in-process thread-local)
        carries it into the replica, and stamped on the attempt's span
        event.  Hedged/failover attempts arrive as siblings — same trace
        id and parent, distinct span ids."""
        self._counters["attempts"].inc()
        tracer = tspans.current_tracer()
        t_us = tracer.now_us()
        t0 = self._clock()
        ok = False
        try:
            with tracecontext.bind(ctx):
                inj = failpoints.fire("router.dispatch", replica=replica_id)
                if inj is not None and inj.kind == "drop":
                    # the selected replica dies mid-request: make it real
                    # through the kill hook, then fail this attempt the way
                    # a dropped TCP connection would
                    if self._kill_hook is not None:
                        self._kill_hook(replica_id)
                    raise ReplicaDown(
                        f"injected replica kill mid-request on {replica_id!r}"
                    )
                client = self._registry.client_of(replica_id)
                result = client.predict(
                    payload, timeout_s=self._config.request_timeout_s
                )
            ok = True
        except BaseException:
            self.breaker(replica_id).record_failure()
            self._counters["failed_attempts"].inc()
            self._replica_counter(replica_id, "fail").inc()
            raise
        finally:
            dt = self._clock() - t0
            self.slo.record(ok, dt)
            self._note_canary_outcome(replica_id, ok, dt)
            if tracer.enabled and ctx is not None:
                tracer.complete(
                    "fleet/attempt",
                    t_us,
                    tracer.now_us() - t_us,
                    cat="fleet",
                    replica=replica_id,
                    hedge=hedge,
                    ok=ok,
                    **ctx.span_args(),
                )
        self.breaker(replica_id).record_success()
        self._attempt_hist.observe(dt)
        self._replica_counter(replica_id, "ok").inc()
        return result

    def _note_canary_outcome(
        self, replica_id: str, ok: bool, latency_s: float
    ) -> None:
        """Feed a canary's private burn tracker; an alarming canary is
        demoted back to plain serving traffic (the auto-demote hook —
        a bad rollout stops taking its deterministic slice without an
        operator in the loop)."""
        try:
            if self._registry.role_of(replica_id) != CANARY:
                return
        except KeyError:
            return
        cfg = self._config
        with self._lock:
            tracker = self._canary_slo.get(replica_id)
            if tracker is None:
                tracker = BurnRateTracker(
                    availability_target=cfg.slo_availability_target,
                    latency_target_s=cfg.slo_latency_target_ms / 1000.0,
                    short_window_s=cfg.slo_short_window_s,
                    long_window_s=cfg.slo_long_window_s,
                    clock=self._clock,
                )
                self._canary_slo[replica_id] = tracker
        tracker.record(ok, latency_s)
        snap = tracker.snapshot()
        if (
            snap["alarm"]
            and snap["samples"]["long"] >= CANARY_SLO_MIN_SAMPLES
        ):
            self._registry.set_role(
                replica_id,
                SERVING,
                reason=(
                    "slo burn-rate alarm: short="
                    f"{snap['burn_rates']['short']:.1f}x long="
                    f"{snap['burn_rates']['long']:.1f}x"
                ),
            )
            self._counters["canary_demotions"].inc()
            tspans.current_tracer().instant(
                "fleet/canary_demoted", cat="fleet", replica=replica_id
            )

    def canary_report(self, replica_id: str) -> Dict[str, Any]:
        """The rollout controller's promote/rollback evidence for one
        canary: its private burn-tracker snapshot (or ``None`` before
        any canary traffic landed), the routed canary request count,
        and the fleet-wide shadow-diff counters over the same period."""
        with self._lock:
            tracker = self._canary_slo.get(replica_id)
        counters = {
            k: int(v)
            for k, v in self.metrics.counters_flat().items()
            if "{" not in k
        }
        return {
            "slo": tracker.snapshot() if tracker is not None else None,
            "canary_requests": counters.get("fleet_canary_requests_total", 0),
            "shadow_requests": counters.get("fleet_shadow_requests_total", 0),
            "shadow_diffs": counters.get("fleet_shadow_diffs_total", 0),
        }

    def _dispatch_sequential(
        self,
        payload: Any,
        order: List[str],
        trace: tracecontext.TraceContext,
    ) -> Any:
        """Deterministic failover walk — the chaos-replayable mode.
        Every attempt is a sibling child span of the request."""
        errors: List[str] = []
        tried: Set[str] = set()
        for _ in range(self._config.max_attempts):
            rid = self._next_allowed(order, tried)
            if rid is None:
                break
            tried.add(rid)
            try:
                result = self._attempt(rid, payload, ctx=trace.child())
            except Exception as e:  # noqa: BLE001 - absorbed by failover
                errors.append(f"{rid}: {type(e).__name__}: {e}")
                self._counters["failovers"].inc()
                continue
            return result
        self._counters["unavailable"].inc()
        raise FleetUnavailable(
            f"all attempts failed ({len(errors)}): "
            f"{'; '.join(errors) or 'no eligible replica'} "
            f"(trace {trace.trace_id})"
        )

    def _dispatch_hedged(
        self,
        payload: Any,
        order: List[str],
        trace: tracecontext.TraceContext,
    ) -> Any:
        """Concurrent mode: primary attempt, a hedge copy after the
        p99-derived delay, failover relaunch on failures; first success
        wins.  Late losers still resolve on the pool and record into
        their own breakers/stats (all lock-guarded).  All attempts —
        winner, loser, abandoned — are sibling spans under one trace
        id, which is what makes a hedge race legible afterwards."""
        cfg = self._config
        errors: List[str] = []
        tried: Set[str] = set()
        inflight: Dict[Any, str] = {}
        hedge_futs: Set[Any] = set()

        def _launch(is_hedge: bool) -> bool:
            rid = self._next_allowed(order, tried)
            if rid is None or len(tried) >= cfg.max_attempts:
                return False
            tried.add(rid)
            fut = self._pool.submit(
                self._attempt, rid, payload,
                ctx=trace.child(), hedge=is_hedge,
            )
            inflight[fut] = rid
            if is_hedge:
                hedge_futs.add(fut)
            return True

        if not _launch(is_hedge=False):
            self._counters["unavailable"].inc()
            raise FleetUnavailable(
                f"no eligible replica (breakers open) (trace {trace.trace_id})"
            )
        deadline = self._clock() + cfg.request_timeout_s
        hedge_at = self._clock() + self.hedge_delay_s()
        hedged = False
        while inflight:
            now = self._clock()
            if now >= deadline:
                break
            timeout = (deadline if hedged else min(hedge_at, deadline)) - now
            done, _ = futures_wait(
                set(inflight), timeout=max(0.0, timeout),
                return_when=FIRST_COMPLETED,
            )
            if not done:
                if not hedged and self._clock() >= hedge_at:
                    hedged = True
                    if _launch(is_hedge=True):
                        self._counters["hedges"].inc()
                continue
            for fut in done:
                rid = inflight.pop(fut)
                exc = fut.exception()
                if exc is None:
                    if fut in hedge_futs:
                        self._counters["hedge_wins"].inc()
                    return fut.result()
                errors.append(f"{rid}: {type(exc).__name__}: {exc}")
                self._counters["failovers"].inc()
                _launch(is_hedge=False)
        self._counters["unavailable"].inc()
        raise FleetUnavailable(
            f"all attempts failed ({len(errors)}): "
            f"{'; '.join(errors) or 'request deadline exceeded'} "
            f"(trace {trace.trace_id})"
        )

    # --------------------------------------------------------------- shadow

    def _mirror_to_shadows(self, payload: Any, primary_result: Any) -> None:
        """Mirror a served request to every shadow replica and diff the
        responses — counters only, the client response is unaffected.
        Async on the hedge pool when present, inline otherwise."""
        shadows = self._registry.in_rotation(role=SHADOW)
        for rid in shadows:
            if self._pool is not None:
                self._pool.submit(self._shadow_probe, rid, payload, primary_result)
            else:
                self._shadow_probe(rid, payload, primary_result)

    def _shadow_probe(
        self, replica_id: str, payload: Any, primary_result: Any
    ) -> None:
        self._counters["shadow_requests"].inc()
        try:
            client = self._registry.client_of(replica_id)
            shadow_result = client.predict(
                payload, timeout_s=self._config.request_timeout_s
            )
            same = json.dumps(shadow_result, sort_keys=True, default=str) == (
                json.dumps(primary_result, sort_keys=True, default=str)
            )
        except Exception:  # noqa: BLE001 - a failing shadow is a diff
            same = False
        if not same:
            self._counters["shadow_diffs"].inc()

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
