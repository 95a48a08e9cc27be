"""Stdlib HTTP front for the fleet router (the ``fleet`` subcommand; a copy
of the JAX package's ``serving/fleet/server.py``).

The same minimal surface as serving/server.py, one level up: handler
threads hash the request content and hand it to the
:class:`~replication_faster_rcnn_tpu_torch.serving.fleet.router.FleetRouter`,
which owns placement, failover, hedging and caching.  Per-path
isolation matches the replica server: one failing path costs that one
entry, the rest of the request still returns detections.

Tracing: an incoming ``traceparent`` header is adopted as the request's
trace (a fresh root otherwise) and bound for the whole handler, so the
router's request/attempt spans — and, through the per-attempt
traceparent the HTTP replica client injects, the replica tier's hop
spans — all share one trace id; error responses carry it too.

Endpoints:
  POST /predict  {"paths": ["a.jpg", ...]} or {"path": "a.jpg"} —
                 per-path detections routed across the fleet; a fleet-
                 wide inability to serve a path returns 503 with a
                 Retry-After derived from the breaker cooldown; error
                 responses carry the request's "trace_id"
  GET  /healthz  fleet liveness: ok while any replica is in rotation,
                 plus the per-replica registry snapshot
  GET  /stats    unified frcnn-stats/v1 envelope: schema/tier/metrics +
                 the fleet's structured sections (router, replicas,
                 registry, slo)
  GET  /metrics  the router's registry in Prometheus text exposition
"""

from __future__ import annotations

import contextlib
import json
import math
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.serving.fleet.router import (
    FleetRouter,
    FleetUnavailable,
    content_key,
)
from replication_faster_rcnn_tpu_torch.telemetry import tracecontext
from replication_faster_rcnn_tpu_torch.telemetry.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    stats_payload,
)

__all__ = ["make_fleet_server"]


class _FleetHandler(BaseHTTPRequestHandler):
    # the router hangs off the server instance (make_fleet_server)

    def _reply(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, indent=2).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *fmt_args):  # quiet: one line per request
        pass  # noqa: D401 - stdlib signature

    def do_GET(self) -> None:  # noqa: N802 - stdlib casing
        router: FleetRouter = self.server.router
        if self.path == "/healthz":
            snap = router.snapshot()
            in_rotation = [
                rid
                for rid, r in snap["registry"].items()
                if r["state"] == "healthy"
            ]
            self._reply(
                200,
                {
                    "ok": bool(in_rotation),
                    "draining": bool(getattr(self.server, "draining", False)),
                    "in_rotation": sorted(in_rotation),
                    "replicas": snap["registry"],
                    # version-skew at a glance: replica -> last reported
                    # model version (None before its first clean probe)
                    "model_versions": {
                        rid: r.get("model_version")
                        for rid, r in snap["registry"].items()
                    },
                },
            )
        elif self.path == "/stats":
            self._reply(
                200, stats_payload("fleet", router.metrics, **router.snapshot())
            )
        elif self.path == "/metrics":
            body = router.metrics.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 - stdlib casing
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        # adopt the caller's trace or start a root, bound for the whole
        # handler so router.dispatch (and everything under it) joins it
        parent = tracecontext.parse_traceparent(
            self.headers.get(tracecontext.TRACEPARENT_HEADER)
        )
        trace = (
            parent.child()
            if parent is not None
            else tracecontext.new_trace_context()
        )
        with tracecontext.bind(trace):
            self._handle_predict(trace)

    def _handle_predict(self, trace) -> None:
        trace_id = trace.trace_id
        # the front shares the replica tier's handler failpoint site, so
        # one chaos spec can fault either layer of the serving stack
        try:
            inj = failpoints.fire("http.handler", path=self.path, tier="fleet")
        except failpoints.ChaosError as e:
            self._reply(500, {"error": str(e), "trace_id": trace_id})
            return
        if inj is not None and inj.kind == "drop":
            with contextlib.suppress(OSError):
                self.connection.shutdown(socket.SHUT_RDWR)
            return
        router: FleetRouter = self.server.router
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            paths = req.get("paths") or ([req["path"]] if "path" in req else [])
            if not paths:
                raise ValueError('need "path" or non-empty "paths"')
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e), "trace_id": trace_id})
            return
        results, errors = {}, {}
        unavailable = bad_input = 0
        for p in paths:
            try:
                with open(p, "rb") as fh:  # content hash = file bytes
                    digest = content_key(fh.read())
            except OSError as e:
                bad_input += 1
                errors[p] = f"{type(e).__name__}: {e}"
                continue
            try:
                results[p] = router.dispatch(p, content_hash=digest)
            except FleetUnavailable as e:
                unavailable += 1
                errors[p] = str(e)
            except Exception as e:  # noqa: BLE001 - surfaced per path
                errors[p] = f"{type(e).__name__}: {e}"
        if results:
            payload = {"detections": results}
            if errors:
                payload["errors"] = errors
            self._reply(200, payload)
            return
        if unavailable:
            cooldown = self.server.router._config.breaker_cooldown_s
            self._reply(
                503,
                {
                    "error": "fleet unavailable",
                    "errors": errors,
                    "trace_id": trace_id,
                },
                headers={"Retry-After": max(1, math.ceil(cooldown))},
            )
        elif bad_input == len(paths):
            self._reply(
                400, {"error": "; ".join(errors.values()), "trace_id": trace_id}
            )
        else:
            self._reply(
                500,
                {
                    "error": "all paths failed",
                    "errors": errors,
                    "trace_id": trace_id,
                },
            )


def make_fleet_server(
    router: FleetRouter, host: str = "127.0.0.1", port: int = 8010
) -> ThreadingHTTPServer:
    """A ready-to-``serve_forever`` front server bound to ``router``.
    ``port=0`` binds a free port (read ``server.server_address``)."""
    server = ThreadingHTTPServer((host, port), _FleetHandler)
    server.router = router
    server.draining = False
    return server
