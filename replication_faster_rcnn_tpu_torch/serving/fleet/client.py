"""Replica transport abstraction for the fleet router.

The router never talks HTTP (or engines) directly — it sees a client
with exactly two calls:

* ``predict(payload, timeout_s)`` — one request, one result (any
  JSON-able object); raises :class:`ReplicaDown` when the replica is
  unreachable, ``TimeoutError`` when it exceeds the deadline, anything
  else for a request-level failure.
* ``healthz(timeout_s)`` — the replica's /healthz dict (must carry
  ``ok``; ``degraded``/``draining`` are honored when present); raises
  on an unreachable replica.

:class:`LocalReplicaClient` wraps plain callables and adds a
``kill()``/``revive()`` switch — the process-death stand-in the chaos
leg flips via the router's kill hook
(``router.dispatch`` drop faults), so "replica dies mid-request" is a
deterministic in-process event.  :func:`engine_client` binds one to a
live :class:`~replication_faster_rcnn_tpu_torch.serving.engine.InferenceEngine`
on the card (or the CPU, as the caller built it).
:class:`HTTPReplicaClient` is the real-fleet transport against ``serve``
replicas (stdlib urllib, no new dependencies).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, Optional

from replication_faster_rcnn_tpu_torch.telemetry import tracecontext

__all__ = [
    "HTTPReplicaClient",
    "LocalReplicaClient",
    "ReplicaDown",
    "engine_client",
]


class ReplicaDown(ConnectionError):
    """The replica is unreachable (dead process, refused connection) —
    the failure mode failover and lease-staleness exist for."""


class LocalReplicaClient:
    """In-process replica: ``predict_fn(payload) -> result`` plus an
    optional ``health_fn() -> dict``.  ``kill()`` makes every call raise
    :class:`ReplicaDown` until ``revive()`` — a dead process, minus the
    process."""

    def __init__(
        self,
        replica_id: str,
        predict_fn: Callable[[Any], Any],
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        swap_fn: Optional[Callable[[str], Any]] = None,
    ) -> None:
        self.replica_id = replica_id
        self._predict_fn = predict_fn
        self._health_fn = health_fn
        self._swap_fn = swap_fn
        # flipped by the router's kill hook (dispatch threads) and by
        # test/benchmark control code — one lock covers the switch
        self._lock = threading.Lock()
        self._killed = False

    def kill(self) -> None:
        with self._lock:
            self._killed = True

    def revive(self) -> None:
        with self._lock:
            self._killed = False

    @property
    def killed(self) -> bool:
        with self._lock:
            return self._killed

    def _check_alive(self) -> None:
        if self.killed:
            raise ReplicaDown(f"replica {self.replica_id!r} is down")

    def predict(self, payload: Any, timeout_s: float) -> Any:
        self._check_alive()
        return self._predict_fn(payload)

    def healthz(self, timeout_s: float) -> Dict[str, Any]:
        self._check_alive()
        if self._health_fn is None:
            return {"ok": True}
        return self._health_fn()

    def swap(self, version: str, timeout_s: float = 30.0) -> Any:
        """Hot-swap the replica's weights to ``version`` (the rollout
        controller's per-replica RPC). Raises on a replica with no swap
        path — the controller treats that as a failed wave."""
        self._check_alive()
        if self._swap_fn is None:
            raise RuntimeError(
                f"replica {self.replica_id!r} has no swap endpoint"
            )
        return self._swap_fn(str(version))


def engine_client(
    replica_id: str, engine, loader: Optional[Callable[[str], Any]] = None
) -> LocalReplicaClient:
    """A :class:`LocalReplicaClient` over a live InferenceEngine: the
    payload is an image array (the ``engine.submit`` contract), the
    health dict mirrors what server.py's /healthz reports. ``loader``
    maps a model version string to a state dict; when given, the
    client supports ``swap()`` via ``engine.swap_params``."""

    def _predict(payload):
        # bounded end-to-end: admission may block briefly, the result
        # wait is the engine's own request timeout discipline
        fut = engine.submit(payload)
        ttl = engine.config.serving.request_timeout_s
        return fut.result(timeout=ttl if ttl > 0 else None)

    def _health():
        return {
            "ok": True,
            "degraded": engine.degraded,
            "degraded_reason": engine.degraded_reason,
            "uptime_s": engine.uptime_s(),
            "bucket_queue_depths": engine.bucket_queue_depths(),
            "params_dtype": engine.params_dtype,
            "params_bytes": engine.params_bytes,
            "model_version": engine.model_version,
        }

    swap_fn = None
    if loader is not None:
        def swap_fn(version):
            return engine.swap_params(loader(version), version)

    return LocalReplicaClient(replica_id, _predict, _health, swap_fn=swap_fn)


class HTTPReplicaClient:
    """Transport to one ``serve`` replica.  The payload is an
    image path; the result is that path's detection list from the
    replica's POST /predict response."""

    def __init__(self, replica_id: str, base_url: str) -> None:
        self.replica_id = replica_id
        self.base_url = base_url.rstrip("/")

    def predict(self, payload: Any, timeout_s: float) -> Any:
        body = json.dumps({"paths": [str(payload)]}).encode()
        headers = {"Content-Type": "application/json"}
        # the router binds the attempt's trace context on this thread
        # before calling predict; inject it as the W3C traceparent header
        # so the replica's hop spans join the same trace
        trace = tracecontext.current_trace()
        if trace is not None:
            headers[tracecontext.TRACEPARENT_HEADER] = trace.to_traceparent()
        req = urllib.request.Request(
            f"{self.base_url}/predict",
            data=body,
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise RuntimeError(
                f"replica {self.replica_id!r} returned {e.code}: {detail}"
            ) from e
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None), TimeoutError):
                raise TimeoutError(
                    f"replica {self.replica_id!r} predict timed out"
                ) from e
            raise ReplicaDown(
                f"replica {self.replica_id!r} unreachable: {e.reason}"
            ) from e
        except TimeoutError as e:  # socket.timeout surfaced directly
            raise TimeoutError(
                f"replica {self.replica_id!r} predict timed out"
            ) from e
        dets = out.get("detections", {})
        if str(payload) not in dets:
            err = out.get("errors", {}).get(str(payload), "no result")
            raise RuntimeError(
                f"replica {self.replica_id!r} failed {payload!r}: {err}"
            )
        return dets[str(payload)]

    def healthz(self, timeout_s: float) -> Dict[str, Any]:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/healthz", timeout=timeout_s
            ) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            raise ReplicaDown(
                f"replica {self.replica_id!r} healthz unreachable: {e}"
            ) from e

    def swap(self, version: str, timeout_s: float = 30.0) -> Any:
        """POST /swap — ask the replica to hot-swap to ``version``."""
        body = json.dumps({"version": str(version)}).encode()
        req = urllib.request.Request(
            f"{self.base_url}/swap",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise RuntimeError(
                f"replica {self.replica_id!r} swap returned {e.code}: "
                f"{detail}"
            ) from e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            raise ReplicaDown(
                f"replica {self.replica_id!r} swap unreachable: {e}"
            ) from e
