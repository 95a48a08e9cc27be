"""Health-checked replica registry with lease-style staleness (a copy of
the JAX package's ``serving/fleet/registry.py``).

The elastic-training heartbeat discipline (parallel/elastic.py), applied
to serving:
every replica holds a lease that only a SUCCESSFUL ``/healthz`` probe
renews.  A replica that stops answering doesn't need to say goodbye —
its lease ages past ``fleet.lease_timeout_s`` and the registry declares
it DEAD, exactly like a training rank whose heartbeat file goes stale.
Recovery is probe-driven too: a DEAD (or newly added, or formerly
draining) replica must answer ``fleet.rejoin_probes`` consecutive
probes before it re-enters rotation, so a flapping replica cannot
bounce in and out of the serving set.

States::

    JOINING --ok x rejoin_probes--> HEALTHY --probe sees draining--> DRAINING
       ^                            |   ^                              |
       +---- add() ----             |   +----- ok x rejoin_probes -----+
                                    lease ages out
                                    v
                                  DEAD --ok x rejoin_probes--> HEALTHY

A replica probing ``degraded: true`` is parked in DRAINING as well —
alive (its lease renews) but routed around until it reports clean.
The rollout controller (serving/rollout/) parks replicas the same way
via :meth:`ReplicaRegistry.hold`: a *held* replica sits in DRAINING
with a renewing lease and cannot re-enter rotation until
:meth:`ReplicaRegistry.release` — clean probes accumulate but the
HEALTHY promotion is gated on the hold, so a mid-swap replica can
never take traffic no matter how healthy it looks.

The :class:`Prober` drives ``probe_once`` on a cadence from its own
thread (non-daemon, Event-stopped, joined — it may run forever but must
die cleanly); tests and the chaos leg call ``probe_once`` directly with
an injected clock instead.  Each probe consults the ``router.probe``
failpoint first: an injected ioerror is a failed probe (the lease keeps
aging), an injected delay is a stalled one.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from replication_faster_rcnn_tpu_torch.config import FleetConfig
from replication_faster_rcnn_tpu_torch.faultlib import failpoints

__all__ = [
    "CANARY",
    "DEAD",
    "DRAINING",
    "HEALTHY",
    "JOINING",
    "Prober",
    "Replica",
    "ReplicaRegistry",
    "SERVING",
    "SHADOW",
]

JOINING = "joining"
HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"

# replica roles: serving replicas take ring traffic; the canary takes a
# deterministic content-hash slice first; shadows get mirrored traffic
# whose responses never reach clients
SERVING = "serving"
CANARY = "canary"
SHADOW = "shadow"


class Replica:
    """One registry entry (mutated only under the registry lock)."""

    def __init__(self, replica_id: str, client, role: str) -> None:
        self.replica_id = replica_id
        self.client = client
        self.role = role
        self.state = JOINING
        self.last_ok = 0.0  # clock() of the last successful probe
        self.consecutive_ok = 0
        self.probes = 0
        self.failed_probes = 0
        self.detail: Optional[str] = None  # why it is out of rotation
        # resident params dtype the replica last reported via /healthz
        # (float32 | bfloat16 | int8) — mixed-precision fleets surface
        # it per replica in /stats and /metrics
        self.params_dtype: Optional[str] = None
        # model version the replica last reported via /healthz — the
        # rollout controller's convergence signal, and the version-skew
        # view in /stats + the fleet_replica_model_version info gauge
        self.model_version: Optional[str] = None
        # a held replica is parked in DRAINING by the rollout controller
        # (registry-side — the replica itself probes healthy) and cannot
        # re-enter rotation until release(), whatever its probes say
        self.held = False


class ReplicaRegistry:
    """Membership + probe-driven state machine for the fleet router."""

    def __init__(
        self,
        config: FleetConfig,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._config = config
        self._clock = clock
        # mutated from the prober thread, dispatch threads (lease checks)
        # and control code — every touch is under this one lock
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._events: List[Dict[str, Any]] = []

    # ----------------------------------------------------------- membership

    def add(self, replica_id: str, client, role: str = SERVING) -> None:
        """Register a replica in JOINING state; ``rejoin_probes``
        consecutive healthy probes admit it to rotation."""
        if role not in (SERVING, CANARY, SHADOW):
            raise ValueError(f"unknown replica role {role!r}")
        with self._lock:
            if replica_id in self._replicas:
                raise ValueError(f"replica {replica_id!r} already registered")
            rep = Replica(replica_id, client, role)
            rep.last_ok = self._clock()  # the join lease starts fresh
            self._replicas[replica_id] = rep
            self._events.append(
                {"event": "replica_added", "replica": replica_id, "role": role}
            )

    def remove(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(replica_id, None)
            self._events.append(
                {"event": "replica_removed", "replica": replica_id}
            )

    def client_of(self, replica_id: str):
        with self._lock:
            return self._replicas[replica_id].client

    # --------------------------------------------------------------- probing

    def probe_once(self) -> None:
        """Probe every replica once and run the state machine.  Health
        calls happen OUTSIDE the lock (a slow replica must not stall
        registry readers); state updates re-take it per replica."""
        with self._lock:
            targets = [
                (r.replica_id, r.client) for r in self._replicas.values()
            ]
        timeout = self._config.probe_interval_s
        for replica_id, client in targets:
            ok, draining, degraded, detail = False, False, False, None
            params_dtype = None
            model_version = None
            try:
                failpoints.fire("router.probe", replica=replica_id)
                health = client.healthz(timeout_s=timeout)
                ok = bool(health.get("ok", False))
                draining = bool(health.get("draining", False))
                degraded = bool(health.get("degraded", False))
                params_dtype = health.get("params_dtype")
                model_version = health.get("model_version")
                if degraded:
                    detail = health.get("degraded_reason") or "degraded"
                elif draining:
                    detail = "draining"
            except Exception as e:  # noqa: BLE001 - a failed probe is data
                detail = f"probe failed: {type(e).__name__}: {e}"
            self._note_probe(
                replica_id, ok, draining, degraded, detail,
                params_dtype=params_dtype, model_version=model_version,
            )

    def _note_probe(
        self,
        replica_id: str,
        ok: bool,
        draining: bool,
        degraded: bool,
        detail: Optional[str],
        params_dtype: Optional[str] = None,
        model_version: Optional[str] = None,
    ) -> None:
        now = self._clock()
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return  # removed while we probed
            rep.probes += 1
            rep.detail = detail
            if params_dtype is not None:
                # keep the last reported dtype across failed probes — a
                # dead replica's residency does not change by dying
                rep.params_dtype = str(params_dtype)
            if model_version is not None:
                # same rule: the last reported version sticks until a
                # successful probe reports a different one
                rep.model_version = str(model_version)
            if not ok:
                rep.failed_probes += 1
                rep.consecutive_ok = 0
                # the lease is NOT renewed; staleness below may kill it
            elif draining or degraded:
                # alive (lease renews) but must leave rotation; the way
                # back is the same rejoin_probes gate as a dead replica
                rep.last_ok = now
                rep.consecutive_ok = 0
                if rep.state != DRAINING:
                    self._events.append(
                        {
                            "event": "replica_draining",
                            "replica": replica_id,
                            "detail": detail,
                        }
                    )
                rep.state = DRAINING
            else:
                rep.last_ok = now
                rep.consecutive_ok += 1
                if (
                    rep.state != HEALTHY
                    and not rep.held
                    and rep.consecutive_ok >= self._config.rejoin_probes
                ):
                    self._events.append(
                        {
                            "event": "replica_joined",
                            "replica": replica_id,
                            "from": rep.state,
                        }
                    )
                    rep.state = HEALTHY
            self._expire_locked(rep, now)

    def _expire_locked(self, rep: Replica, now: float) -> None:
        # lock held: lease staleness — the self-healing trigger
        if (
            rep.state != DEAD
            and now - rep.last_ok >= self._config.lease_timeout_s
        ):
            self._events.append(
                {
                    "event": "replica_lease_expired",
                    "replica": rep.replica_id,
                    "from": rep.state,
                }
            )
            rep.state = DEAD
            rep.consecutive_ok = 0

    # ------------------------------------------------------------- rollout

    def hold(self, replica_id: str, reason: Optional[str] = None) -> None:
        """Park a replica in DRAINING under a registry-side hold (the
        rollout controller's drain step). The replica keeps probing
        healthy — its lease renews as usual, DRAINING keeps the lease —
        but it cannot be promoted back to HEALTHY until :meth:`release`,
        however many clean probes it accumulates."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            if rep.held:
                return
            rep.held = True
            rep.consecutive_ok = 0
            rep.detail = reason or "held for rollout"
            if rep.state == HEALTHY:
                rep.state = DRAINING
            self._events.append(
                {
                    "event": "replica_held",
                    "replica": replica_id,
                    "reason": reason,
                }
            )

    def release(self, replica_id: str) -> None:
        """Lift a rollout hold. The replica does NOT re-enter rotation
        here: its consecutive-OK streak restarts, so it must pass the
        same ``rejoin_probes`` gate as any recovering replica — now at
        whatever version it reports post-swap."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            if not rep.held:
                return
            rep.held = False
            rep.consecutive_ok = 0
            self._events.append(
                {"event": "replica_released", "replica": replica_id}
            )

    def model_version_of(self, replica_id: str) -> Optional[str]:
        with self._lock:
            return self._replicas[replica_id].model_version

    def model_versions(self) -> Dict[str, Optional[str]]:
        """``replica_id -> last reported model version`` — the fleet's
        version-skew view during a rolling upgrade."""
        with self._lock:
            return {
                rep.replica_id: rep.model_version
                for rep in self._replicas.values()
            }

    # ---------------------------------------------------------------- reads

    def in_rotation(self, role: str = SERVING) -> List[str]:
        """Replica ids eligible for traffic, sorted for determinism.
        Applies the lease-staleness check inline, so a stalled prober
        thread cannot keep a dead replica in rotation."""
        now = self._clock()
        with self._lock:
            out = []
            for rep in self._replicas.values():
                self._expire_locked(rep, now)
                if rep.role == role and rep.state == HEALTHY:
                    out.append(rep.replica_id)
            return sorted(out)

    def state_of(self, replica_id: str) -> str:
        with self._lock:
            return self._replicas[replica_id].state

    def role_of(self, replica_id: str) -> str:
        with self._lock:
            return self._replicas[replica_id].role

    def set_role(
        self, replica_id: str, role: str, reason: Optional[str] = None
    ) -> None:
        """Re-role a replica in place (the canary auto-demote hook:
        an alarming canary drops back to plain serving traffic without
        leaving rotation). Records a ``replica_role_changed`` event."""
        if role not in (SERVING, CANARY, SHADOW):
            raise ValueError(f"unknown replica role {role!r}")
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.role == role:
                return
            self._events.append(
                {
                    "event": "replica_role_changed",
                    "replica": replica_id,
                    "from": rep.role,
                    "to": role,
                    "reason": reason,
                }
            )
            rep.role = role

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> Dict[str, Any]:
        """Per-replica gauges for /stats and the ``telemetry`` subcommand."""
        with self._lock:
            return {
                rep.replica_id: {
                    "role": rep.role,
                    "state": rep.state,
                    "probes": rep.probes,
                    "failed_probes": rep.failed_probes,
                    "consecutive_ok": rep.consecutive_ok,
                    "lease_age_s": round(self._clock() - rep.last_ok, 3),
                    "detail": rep.detail,
                    "params_dtype": rep.params_dtype,
                    "model_version": rep.model_version,
                    "held": rep.held,
                }
                for rep in self._replicas.values()
            }


class Prober:
    """Runs ``probe_once`` on a cadence from its own thread.

    Non-daemon with an Event-based stop + join: the thread does no
    durable writes, but the fleet contract is that every service thread
    dies cleanly on shutdown rather than being reaped mid-anything at
    interpreter exit.  ``Event.wait(interval)`` paces the loop, so
    ``stop()`` interrupts a sleeping prober immediately.
    """

    def __init__(
        self,
        registry: ReplicaRegistry,
        interval_s: float,
        name: str = "fleet-prober",
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._registry = registry
        self._interval_s = interval_s
        self._stop_event = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name)

    def start(self) -> "Prober":
        self._thread.start()
        return self

    def _run(self) -> None:
        # probe immediately on start (a JOINING fleet should not wait a
        # full interval to admit its first replica), then on the cadence
        while True:
            self._registry.probe_once()
            if self._stop_event.wait(self._interval_s):
                return

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop_event.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)

    def __enter__(self) -> "Prober":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
