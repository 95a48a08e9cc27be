"""Minimal stdlib HTTP front-end over the inference engine (a copy of the
JAX package's ``serving/server.py``).

Each request-handler thread submits its images to the engine and waits
on the futures — so concurrent clients' requests coalesce into shared
micro-batches inside the engine (ThreadingHTTPServer gives one thread
per connection; the engine's bounded queue is the backpressure).

Overload contract (serving/overload.py):

* submits are ADMISSION-CONTROLLED (``timeout=0`` against the bounded
  queue): a full queue sheds the request with **503** + ``Retry-After``
  instead of parking the handler thread;
* ``serving.request_timeout_s`` bounds each request end-to-end: the
  handler's wait times out to **504**, and entries whose deadline passed
  while queued are dropped at flush time, never dispatched;
* multi-path requests are isolated per path: one failing image costs
  that one entry an ``"error"`` value, the rest still return detections.

Tracing: an incoming W3C ``traceparent`` header (the fleet tier's
client injects one per attempt) is adopted as the request's trace —
the handler binds a child context for the duration, so the engine's
queue-wait/dispatch hop spans and any error response share the
caller's trace id.  Requests arriving without the header get a fresh
root trace.

Endpoints:
  POST /predict  {"paths": ["a.jpg", ...]} or {"path": "a.jpg"}, optional
                 "score_thresh" — detections per image (boxes in original
                 image coordinates, row-major [r1, c1, r2, c2]); per-path
                 failures come back under "errors"; error responses carry
                 the request's "trace_id"
  GET  /healthz  liveness + bucket inventory + degraded flag
  GET  /stats    unified frcnn-stats/v1 envelope: schema/tier/metrics +
                 the replica's structured sections (stats, queue depths,
                 compile_seconds, slo)
  GET  /metrics  the same registry in Prometheus text exposition format
  POST /swap     {"version": "<step>"} — hot-swap weights to a checkpoint
                 version via the server's swap_handler (501 without one);
                 in-flight requests finish on their admission version
"""

from __future__ import annotations

import contextlib
import json
import queue
import socket
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from replication_faster_rcnn_tpu_torch.config import VOC_CLASSES
from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.serving.overload import (
    DeadlineExceeded,
    retry_after_s,
)
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
from replication_faster_rcnn_tpu_torch.telemetry import tracecontext
from replication_faster_rcnn_tpu_torch.telemetry.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    stats_payload,
)

__all__ = ["make_server"]


def _detections_json(config, out, thresh: float):
    names = (
        VOC_CLASSES
        if config.model.num_classes == len(VOC_CLASSES)
        else [str(i) for i in range(config.model.num_classes)]
    )
    dets = []
    for i in range(out["valid"].shape[0]):
        if not out["valid"][i] or out["scores"][i] < thresh:
            continue
        cls = int(out["classes"][i])
        dets.append(
            {
                "box": out["boxes"][i].tolist(),
                "score": float(out["scores"][i]),
                "class_id": cls,
                "class_name": names[cls],
            }
        )
    dets.sort(key=lambda d: -d["score"])
    return dets


class _Handler(BaseHTTPRequestHandler):
    # the engine/config/default threshold hang off the server instance

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
        engine = self.server.engine
        if self.path == "/healthz":
            self._reply(
                200,
                {
                    "ok": True,
                    "degraded": engine.degraded,
                    "degraded_reason": engine.degraded_reason,
                    "draining": bool(getattr(self.server, "draining", False)),
                    "replica_id": getattr(self.server, "replica_id", None),
                    "uptime_s": round(engine.uptime_s(), 3),
                    "bucket_queue_depths": engine.bucket_queue_depths(),
                    "buckets": [list(b) for b in engine.buckets],
                    "batch_sizes": list(engine.batch_sizes),
                    "params_dtype": engine.params_dtype,
                    "params_bytes": engine.params_bytes,
                    "model_version": engine.model_version,
                },
            )
        elif self.path == "/stats":
            sections = {
                "stats": dict(engine.stats),
                "queue_depth": engine.queue_depth(),
                "bucket_queue_depths": engine.bucket_queue_depths(),
                "compile_seconds": dict(engine.compile_seconds),
                "params_dtype": engine.params_dtype,
                "params_bytes": engine.params_bytes,
                "model_version": engine.model_version,
                "resident_versions": engine.resident_versions(),
                "slo": engine.slo.snapshot(),
            }
            if engine.deadline_controller is not None:
                sections["adaptive_delay_ms"] = (
                    engine.deadline_controller.delays_ms()
                )
            self._reply(200, stats_payload("replica", engine.metrics, **sections))
        elif self.path == "/metrics":
            body = engine.metrics.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 - stdlib casing
        if self.path == "/swap":
            self._handle_swap()
            return
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        engine = self.server.engine
        # adopt the caller's trace (e.g. the fleet client's traceparent
        # header) as this request's parent, or start a fresh root; the
        # context is BOUND for the whole handler body so the engine's
        # hop spans, chaos events and error replies share the trace id
        trace = None
        if engine.config.telemetry.trace_propagation:
            parent = tracecontext.parse_traceparent(
                self.headers.get(tracecontext.TRACEPARENT_HEADER)
            )
            trace = (
                parent.child()
                if parent is not None
                else tracecontext.new_trace_context()
            )
        tracer = tspans.current_tracer()
        t_req = tracer.now_us()
        try:
            with tracecontext.bind(trace):
                self._handle_predict(trace)
        finally:
            if tracer.enabled and trace is not None:
                tracer.complete(
                    "serve/request",
                    t_req,
                    tracer.now_us() - t_req,
                    cat="serve",
                    **trace.span_args(),
                )

    def _handle_swap(self) -> None:
        """POST /swap {"version": "<step>"} — hot-swap the engine to a
        new model version via the server's ``swap_handler`` (wired by
        the `serve` subcommand's `--workdir`; 501 when the replica has no checkpoint
        source to swap from). In-flight requests finish on the version
        they were admitted under; the response reports both versions."""
        engine = self.server.engine
        handler = getattr(self.server, "swap_handler", None)
        if handler is None:
            self._reply(
                501, {"error": "this replica has no swap handler configured"}
            )
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            version = str(req["version"])
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"need a \"version\": {e}"})
            return
        try:
            prior = handler(version)
        except Exception as e:  # noqa: BLE001 - surfaced to the controller
            self._reply(
                500, {"error": f"swap failed: {type(e).__name__}: {e}"}
            )
            return
        self._reply(
            200,
            {
                "ok": True,
                "model_version": engine.model_version,
                "prior_version": prior,
            },
        )

    def _handle_predict(self, trace) -> None:
        engine = self.server.engine
        trace_id = trace.trace_id if trace is not None else None
        try:
            inj = failpoints.fire("http.handler", path=self.path)
        except failpoints.ChaosError as e:
            self._reply(500, {"error": str(e), "trace_id": trace_id})
            return
        if inj is not None and inj.kind == "drop":
            # simulate a dropped connection: shut the socket with no
            # response bytes; the keep-alive loop then reads EOF and exits
            with contextlib.suppress(OSError):
                self.connection.shutdown(socket.SHUT_RDWR)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            paths = req.get("paths") or ([req["path"]] if "path" in req else [])
            if not paths:
                raise ValueError('need "path" or non-empty "paths"')
            thresh = float(req.get("score_thresh", self.server.score_thresh))
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e), "trace_id": trace_id})
            return

        # submit everything first: same-bucket paths coalesce into shared
        # flushes (also across concurrent handler threads). timeout=0 is
        # the admission decision — accept or shed, never block the thread.
        timeout_s = engine.config.serving.request_timeout_s
        futures = []  # (path, future | None)
        shed = timed_out = bad_input = 0
        results, errors = {}, {}
        for p in paths:
            try:
                futures.append((p, engine.submit_path(p, timeout=0)))
            except queue.Full:
                shed += 1
                errors[p] = "shed: serving queue is full"
                futures.append((p, None))
            except (FileNotFoundError, OSError, ValueError) as e:
                bad_input += 1
                errors[p] = f"{type(e).__name__}: {e}"
                futures.append((p, None))

        # per-path isolation: one bad image costs one entry, not the wave
        for p, fut in futures:
            if fut is None:
                continue
            try:
                out = fut.result(timeout=timeout_s if timeout_s > 0 else None)
                results[p] = _detections_json(engine.config, out, thresh)
            except (FutureTimeoutError, DeadlineExceeded):
                timed_out += 1
                engine.incr_stat("timeouts")
                errors[p] = (
                    f"deadline exceeded (request_timeout_s={timeout_s})"
                )
            except Exception as e:  # noqa: BLE001 - surfaced per path
                errors[p] = f"{type(e).__name__}: {e}"

        if results:
            payload = {"detections": results}
            if errors:
                payload["errors"] = errors
            self._reply(200, payload)
            return
        # nothing succeeded: the status reflects the dominant failure
        if shed:
            self._reply(
                503,
                {
                    "error": "serving queue is full",
                    "errors": errors,
                    "trace_id": trace_id,
                },
                headers={
                    "Retry-After": retry_after_s(
                        engine.config.serving.max_delay_ms
                    )
                },
            )
        elif timed_out:
            # 504 carries Retry-After too: a deadline miss means the
            # replica is saturated right now, same as a shed — tell the
            # client when the queue should have turned over
            self._reply(
                504,
                {
                    "error": "request deadline exceeded",
                    "errors": errors,
                    "trace_id": trace_id,
                },
                headers={
                    "Retry-After": retry_after_s(
                        engine.config.serving.max_delay_ms
                    )
                },
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


def make_server(
    engine,
    host: str = "127.0.0.1",
    port: int = 8008,
    score_thresh: Optional[float] = None,
    replica_id: Optional[str] = None,
    swap_handler=None,
) -> ThreadingHTTPServer:
    """A ready-to-``serve_forever`` HTTP server bound to ``engine``.
    ``port=0`` binds a free port (read ``server.server_address``).
    ``replica_id`` names this replica in /healthz for fleet membership;
    setting ``server.draining = True`` (the SIGTERM grace window) makes
    /healthz advertise it so the fleet router stops routing here before
    the listener closes. ``swap_handler(version) -> prior_version``
    enables POST /swap (rolling weight rollout); without one the
    endpoint answers 501."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.engine = engine
    server.replica_id = replica_id
    server.draining = False
    server.swap_handler = swap_handler
    server.score_thresh = (
        engine.config.eval.score_thresh if score_thresh is None else score_thresh
    )
    return server
