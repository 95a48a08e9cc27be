"""Rolling rollout controller: hold → swap → rejoin → canary → decide (a
copy of the JAX package's ``serving/rollout/controller.py``).

One *wave* upgrades the fleet to one version, one replica at a time,
through the registry's probe-driven state machine — never around it:

1. **Pre-drain gate.** The version must already be eligible
   (:class:`~replication_faster_rcnn_tpu_torch.serving.rollout.versions.VersionFeed`):
   manifest readable + internally consistent, topology recorded, config
   hash compatible, int8 quant sidecar CRC-clean. Nothing drains for a
   version that could not be served.
2. **Per-replica swap.** ``registry.hold`` parks the replica in
   DRAINING (the lease keeps renewing — DRAINING keeps the lease), its
   queues drain, the ``rollout.swap`` failpoint fires (chaos drills the
   mid-swap kill), then ``client.swap(version)`` flips the engine's
   resident params (``InferenceEngine.swap_params``: on the card the new
   version's CUDA graphs are captured before admission moves to it). ``registry.release`` restarts the
   consecutive-OK streak, so re-admission is the same
   ``fleet.rejoin_probes`` gate every recovering replica passes — and
   the controller additionally requires the replica to *report* the new
   version before calling it converged.
3. **Gated promotion.** The first upgraded replica takes the CANARY
   role on the router's existing deterministic hash slice. Through the
   hold window the controller watches the router's private canary
   burn tracker, the router's own auto-demote (a demoted canary is a
   rollback verdict, never resurrected), and the fleet shadow-diff
   counters; the ``rollout.promote`` failpoint can force the rollback
   path. Promotion rolls the remaining replicas; rollback is a
   first-class REVERSE rollout through the same hold/swap/rejoin steps.

Determinism seams: ``clock``, ``sleep``, and ``probe`` are injectable —
the chaos leg and unit tests drive a fake clock and call
``registry.probe_once`` by hand, so two passes over the same seed
produce identical event logs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.serving.fleet.registry import (
    CANARY,
    HEALTHY,
    SERVING,
)
from replication_faster_rcnn_tpu_torch.telemetry.metrics import MetricsRegistry

__all__ = ["RolloutController", "RolloutError", "RolloutWatcher", "WaveResult"]


class RolloutError(RuntimeError):
    """A wave step failed (swap RPC, rejoin timeout, injected kill)."""


@dataclass
class WaveResult:
    """What one rollout wave did, for callers and the rollout log."""

    version: str
    # promoted | rolled_back | aborted | ineligible | noop
    outcome: str
    reason: Optional[str] = None
    swapped: List[str] = field(default_factory=list)
    rolled_back: List[str] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "outcome": self.outcome,
            "reason": self.reason,
            "swapped": list(self.swapped),
            "rolled_back": list(self.rolled_back),
        }


class RolloutController:
    """Drives rolling weight rollouts over one fleet.

    ``config`` is the full FasterRCNNConfig — the controller reads
    ``config.rollout`` (wave knobs) and ``config.fleet`` (probe cadence
    + rejoin gate). Counters land in ``metrics`` (default: the router's
    registry, so the ``fleet`` subcommand's /metrics exposes them).
    """

    def __init__(
        self,
        registry,
        router,
        config,
        feed=None,
        metrics: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        probe: Optional[Callable[[], None]] = None,
    ) -> None:
        self._registry = registry
        self._router = router
        self._config = config
        self._feed = feed
        self._clock = clock
        self._sleep = sleep
        self._probe = probe if probe is not None else registry.probe_once
        self.metrics = metrics if metrics is not None else router.metrics
        self._swaps = self.metrics.counter(
            "rollout_swaps_total", help="successful per-replica hot-swaps"
        )
        self._rollbacks = self.metrics.counter(
            "rollout_rollbacks_total", help="per-replica reverse swaps"
        )
        self._promotions = self.metrics.counter(
            "rollout_promotions_total", help="canaries promoted to serving"
        )
        # one wave at a time: the watcher thread and a CLI `--once` may
        # coexist against one fleet
        self._wave_lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- plumbing

    def _note(self, event: str, **kw: Any) -> Dict[str, Any]:
        entry = {"event": event, **kw}
        self.events.append(entry)
        return entry

    def _tick(self) -> None:
        """One probe round: advance (injected) time by the probe cadence
        and run the registry state machine."""
        self._sleep(self._config.fleet.probe_interval_s)
        self._probe()

    def _await(
        self,
        predicate: Callable[[], bool],
        timeout_s: float,
        what: str,
    ) -> None:
        deadline = self._clock() + timeout_s
        while not predicate():
            if self._clock() >= deadline:
                raise RolloutError(f"timed out waiting for {what}")
            self._tick()

    def _converged(self, replica_id: str, version: Optional[str]) -> bool:
        snap = self._registry.snapshot().get(replica_id)
        if snap is None:
            return False
        if snap["state"] != HEALTHY:
            return False
        return version is None or snap["model_version"] == version

    # ------------------------------------------------------------ wave steps

    def _drain(self, replica_id: str) -> None:
        """Wait for the held replica's queued work to flush (bounded) —
        a swap never races admitted-but-unflushed requests for ordering;
        the engine's version-keyed batches make this a latency nicety,
        not a correctness requirement."""
        client = self._registry.client_of(replica_id)

        def _quiet() -> bool:
            try:
                health = client.healthz(
                    timeout_s=self._config.fleet.probe_interval_s
                )
            except Exception:  # noqa: BLE001 - a dead replica is "quiet"
                return True
            depths = health.get("bucket_queue_depths") or {}
            return sum(depths.values()) == 0

        try:
            self._await(
                _quiet, self._config.rollout.drain_timeout_s, "queue drain"
            )
        except RolloutError:
            # drain is best-effort by design (see docstring): proceed,
            # the leftover entries complete on their admission version
            self._note("drain_timeout", replica=replica_id)

    def _swap_replica(self, replica_id: str, version: str) -> None:
        """hold → drain → swap → release → converge-at-version. Raises
        RolloutError mid-way with the replica still HELD — the caller
        owns recovery (it recorded the prior version before calling)."""
        rcfg = self._config.rollout
        self._registry.hold(replica_id, reason=f"rollout to {version}")
        self._note("replica_hold", replica=replica_id, version=version)
        self._tick()  # propagate DRAINING before judging queue depth
        self._drain(replica_id)
        # chaos: a drop here is the mid-swap kill (controller dies/loses
        # the replica between drain and swap); ioerror raises ChaosError
        inj = failpoints.fire(
            "rollout.swap", replica=replica_id, version=version
        )
        if inj is not None and inj.kind == "drop":
            raise RolloutError(
                f"injected mid-swap kill at replica {replica_id!r}"
            )
        try:
            self._registry.client_of(replica_id).swap(
                version, timeout_s=rcfg.swap_timeout_s
            )
        except Exception as e:
            raise RolloutError(
                f"swap RPC failed at {replica_id!r}: "
                f"{type(e).__name__}: {e}"
            ) from e
        self._swaps.inc()
        self._note("replica_swapped", replica=replica_id, version=version)
        self._registry.release(replica_id)
        self._await(
            lambda: self._converged(replica_id, version),
            rcfg.rejoin_timeout_s,
            f"replica {replica_id!r} to rejoin at version {version}",
        )
        self._note("replica_rejoined", replica=replica_id, version=version)

    def _recover_replica(
        self, replica_id: str, prior: Optional[str]
    ) -> None:
        """Reverse one replica to its prior version after a failed step
        (the replica may or may not have applied the new version — the
        reverse swap is idempotent either way), then re-admit it."""
        try:
            if prior is not None:
                self._registry.client_of(replica_id).swap(
                    prior, timeout_s=self._config.rollout.swap_timeout_s
                )
                self._rollbacks.inc()
                self._note(
                    "replica_rolled_back", replica=replica_id, version=prior
                )
        except Exception as e:  # noqa: BLE001 - recovery is best-effort
            self._note(
                "rollback_swap_failed",
                replica=replica_id,
                error=f"{type(e).__name__}: {e}",
            )
        self._registry.release(replica_id)
        try:
            self._await(
                lambda: self._converged(replica_id, prior),
                self._config.rollout.rejoin_timeout_s,
                f"replica {replica_id!r} to reconverge at {prior}",
            )
        except RolloutError:
            self._note("reconverge_timeout", replica=replica_id)

    # --------------------------------------------------------- canary gate

    def _canary_decision(
        self, replica_id: str, version: str, baseline: Dict[str, Any]
    ) -> Optional[str]:
        """Watch the canary through the hold window; return a rollback
        reason, or ``None`` to promote. The router's own auto-demote is
        a rollback verdict — a demoted role is never resurrected."""
        rcfg = self._config.rollout

        def _verdict() -> Optional[str]:
            if self._registry.role_of(replica_id) != CANARY:
                return "router auto-demoted the canary (burn-rate alarm)"
            report = self._router.canary_report(replica_id)
            slo = report["slo"]
            if slo is not None and slo["alarm"]:
                rates = slo["burn_rates"]
                return (
                    "canary slo burn-rate alarm: "
                    f"short={rates['short']:.1f}x long={rates['long']:.1f}x"
                )
            shadow_n = report["shadow_requests"] - baseline["shadow_requests"]
            shadow_d = report["shadow_diffs"] - baseline["shadow_diffs"]
            if (
                shadow_n > 0
                and shadow_d / shadow_n > rcfg.max_shadow_diff_fraction
            ):
                return (
                    f"shadow diff fraction {shadow_d}/{shadow_n} exceeds "
                    f"{rcfg.max_shadow_diff_fraction}"
                )
            return None

        deadline = self._clock() + rcfg.canary_hold_s
        while self._clock() < deadline:
            bad = _verdict()
            if bad is not None:
                return bad
            self._tick()
        bad = _verdict()
        if bad is not None:
            return bad
        # low-traffic guard: promotion (not rollback) needs evidence —
        # give the slice one extra window to accumulate it
        if rcfg.canary_min_requests > 0:
            extra = self._clock() + rcfg.canary_hold_s

            def _enough() -> bool:
                report = self._router.canary_report(replica_id)
                delta = (
                    report["canary_requests"] - baseline["canary_requests"]
                )
                return delta >= rcfg.canary_min_requests

            while not _enough() and self._clock() < extra:
                bad = _verdict()
                if bad is not None:
                    return bad
                self._tick()
            if not _enough():
                self._note(
                    "canary_low_traffic",
                    replica=replica_id,
                    version=version,
                )
        # chaos: the promote decision itself can be killed — drop and
        # ioerror both force the rollback path
        try:
            inj = failpoints.fire(
                "rollout.promote", replica=replica_id, version=version
            )
        except failpoints.ChaosError as e:
            return f"injected promote failure: {e}"
        if inj is not None and inj.kind == "drop":
            return "injected promote failure: dropped"
        return None

    # --------------------------------------------------------------- waves

    def rollout(self, version: str, verdict=None) -> WaveResult:
        """Run one full wave to ``version``. Returns a
        :class:`WaveResult`; never raises for a failed wave — failure IS
        a result (aborted / rolled_back), with the fleet reconverged on
        the prior version."""
        with self._wave_lock:
            result = self._rollout_locked(str(version), verdict)
        self.metrics.counter(
            "rollout_waves_total",
            help="rollout waves by outcome",
            outcome=result.outcome,
        ).inc()
        return result

    def _rollout_locked(self, version: str, verdict) -> WaveResult:
        events_start = len(self.events)

        def _done(outcome: str, **kw: Any) -> WaveResult:
            self._note("wave_done", version=version, outcome=outcome)
            res = WaveResult(version=version, outcome=outcome, **kw)
            res.events = self.events[events_start:]
            return res

        # pre-drain eligibility gate
        if verdict is None and self._feed is not None:
            verdict = self._feed.validate(int(version))
        if verdict is not None and not verdict.eligible:
            self._note(
                "wave_ineligible", version=version, reasons=verdict.reasons
            )
            return _done("ineligible", reason="; ".join(verdict.reasons))
        self._note("wave_started", version=version)

        snap = self._registry.snapshot()
        targets = sorted(
            rid
            for rid, info in snap.items()
            if info["role"] in (SERVING, CANARY)
            and info["model_version"] != version
        )
        if not targets:
            return _done("noop", reason="fleet already at version")

        swapped: List[str] = []
        priors: Dict[str, Optional[str]] = {}

        # ---- first replica: the canary slot
        first = targets[0]
        orig_role = self._registry.role_of(first)
        baseline = self._router.canary_report(first)
        priors[first] = self._registry.model_version_of(first)
        try:
            self._swap_replica(first, version)
        except (RolloutError, failpoints.ChaosError) as e:
            self._note("wave_aborted", version=version, error=str(e))
            self._recover_replica(first, priors.get(first))
            return _done(
                "aborted",
                reason=str(e),
                rolled_back=[first] if priors.get(first) else [],
            )
        swapped.append(first)
        self._registry.set_role(
            first, CANARY, reason=f"rollout {version} canary"
        )
        bad = self._canary_decision(first, version, baseline)
        if bad is not None:
            self._note("wave_rollback", version=version, reason=bad)
            if not self._config.rollout.auto_rollback:
                return _done("aborted", reason=bad, swapped=swapped)
            self._rollback_wave(swapped, priors, first, orig_role)
            return _done(
                "rolled_back", reason=bad, swapped=swapped,
                rolled_back=list(reversed(swapped)),
            )
        self._promotions.inc()
        self._note("canary_promoted", replica=first, version=version)
        self._registry.set_role(
            first, orig_role, reason=f"rollout {version} promoted"
        )

        # ---- remaining replicas, one at a time
        for rid in targets[1:]:
            priors[rid] = self._registry.model_version_of(rid)
            try:
                self._swap_replica(rid, version)
                swapped.append(rid)
            except (RolloutError, failpoints.ChaosError) as e:
                self._note("wave_rollback", version=version, error=str(e))
                self._recover_replica(rid, priors.get(rid))
                if not self._config.rollout.auto_rollback:
                    return _done("aborted", reason=str(e), swapped=swapped)
                self._rollback_wave(swapped, priors, first, orig_role)
                rolled = list(reversed(swapped))
                if priors.get(rid):
                    rolled.insert(0, rid)
                return _done(
                    "rolled_back", reason=str(e), swapped=swapped,
                    rolled_back=rolled,
                )
        return _done("promoted", swapped=swapped)

    def _rollback_wave(
        self,
        swapped: List[str],
        priors: Dict[str, Optional[str]],
        canary: str,
        orig_role: str,
    ) -> None:
        """The reverse rollout: walk the swapped replicas newest-first
        back to their prior versions through the same hold/swap/rejoin
        discipline (best-effort per replica — one stuck replica must
        not stop the others from reverting)."""
        if self._registry.role_of(canary) == CANARY:
            # the canary slice must stop before its weights revert; if
            # the router already demoted it, leave the demotion alone
            self._registry.set_role(
                canary, orig_role, reason="rollout rolled back"
            )
        for rid in reversed(swapped):
            prior = priors.get(rid)
            try:
                self._registry.hold(rid, reason="rollout rollback")
                self._tick()
                self._recover_replica(rid, prior)
            except Exception as e:  # noqa: BLE001 - keep reverting others
                self._note(
                    "rollback_failed",
                    replica=rid,
                    error=f"{type(e).__name__}: {e}",
                )


class RolloutWatcher:
    """Polls a :class:`VersionFeed` and triggers waves on new versions.

    Same thread discipline as the fleet Prober: NON-daemon, Event-paced,
    joined in ``stop()`` — the watcher appends durable rollout records
    (``rollout.jsonl`` under the workdir), and a daemon thread doing
    durable writes could be reaped mid-write at interpreter exit, so this
    thread must die cleanly instead."""

    def __init__(
        self,
        feed,
        controller: RolloutController,
        poll_interval_s: Optional[float] = None,
        log_path: Optional[str] = None,
        name: str = "rollout-watcher",
    ) -> None:
        interval = (
            poll_interval_s
            if poll_interval_s is not None
            else controller._config.rollout.poll_interval_s
        )
        if interval <= 0:
            raise ValueError(f"poll_interval_s must be > 0, got {interval}")
        self._feed = feed
        self._controller = controller
        self._interval_s = interval
        self._log_path = log_path
        self._stop_event = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name)
        self._last_step: Optional[int] = None
        self.results: List[WaveResult] = []

    def start(self) -> "RolloutWatcher":
        self._thread.start()
        return self

    def poll_once(self) -> Optional[WaveResult]:
        """One poll → at most one wave (also the test seam)."""
        verdict = self._feed.latest_eligible(after=self._last_step)
        if verdict is None:
            return None
        self._last_step = verdict.step
        result = self._controller.rollout(verdict.version, verdict=verdict)
        self.results.append(result)
        self._log(result)
        return result

    def _log(self, result: WaveResult) -> None:
        if self._log_path is None:
            return
        import json

        try:
            with open(self._log_path, "a") as f:
                f.write(json.dumps(result.to_dict(), sort_keys=True) + "\n")
        except OSError:  # pragma: no cover - the log is advisory
            pass

    def _run(self) -> None:
        while True:
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - a failed poll is survivable
                pass
            if self._stop_event.wait(self._interval_s):
                return

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop_event.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)

    def __enter__(self) -> "RolloutWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
