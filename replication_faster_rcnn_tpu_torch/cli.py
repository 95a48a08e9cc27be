"""Command line of the PyTorch port (the JAX package's ``cli.py``, the
``serve`` subcommand only).

``python -m replication_faster_rcnn_tpu_torch serve --config voc_resnet18
--workdir DIR`` loads the newest verified checkpoint in ``DIR`` (the seeded
init when there is none), captures every (bucket, batch size) serving graph
on the card, prints the start-up JSON (capture seconds under JAX's
``compile_seconds`` key) and serves HTTP (``serving/server.py``) until
SIGTERM, which drains: ``/healthz`` advertises ``draining`` for
``fleet.drain_grace_s`` (with ``--replica-id``), then the listener closes and
the engine finishes every admitted request.

Not ported: ``--strict`` and ``--threadsan`` (their analyses are not ported)
and the other subcommands.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import sys
import threading
import time
import zlib
from typing import List, Optional

__all__ = ["main"]


def _build_config(args):
    from replication_faster_rcnn_tpu_torch.config import get_config

    cfg = get_config(args.config)
    if args.image_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=(args.image_size, args.image_size)))
    if args.seed is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=args.seed))
    serving = cfg.serving
    if args.max_delay_ms is not None:
        serving = dataclasses.replace(serving, max_delay_ms=args.max_delay_ms)
    if args.bucket_batch_sizes:
        serving = dataclasses.replace(
            serving, batch_sizes=tuple(int(b) for b in args.bucket_batch_sizes.split(",")))
    if args.resolutions:
        serving = dataclasses.replace(serving, resolutions=tuple(
            tuple(int(x) for x in r.split("x")) for r in args.resolutions.split(",")))
    if args.params_dtype:
        serving = dataclasses.replace(serving, params_dtype=args.params_dtype)
    if args.request_timeout_s is not None:
        serving = dataclasses.replace(serving, request_timeout_s=args.request_timeout_s)
    if args.adaptive_delay:
        serving = dataclasses.replace(serving, adaptive_delay=True)
    return cfg.replace(serving=serving)


def _replica_trace_rank(replica_id: str) -> int:
    """Stable nonzero rank for a replica's trace file name: the digits of
    an r<K> id shifted by one, else a crc of the id."""
    m = re.search(r"(\d+)$", replica_id)
    if m:
        return int(m.group(1)) + 1
    return zlib.crc32(replica_id.encode()) % 9000 + 1000


def cmd_serve(args) -> int:
    """Serve HTTP requests through the graph-replaying engine."""
    from replication_faster_rcnn_tpu_torch.quant import default_artifact_path
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
    from replication_faster_rcnn_tpu_torch.serving.server import make_server
    from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
    from replication_faster_rcnn_tpu_torch.train.trainer import load_eval_variables

    device = None if args.device in ("auto", "cuda") else args.device
    cfg = _build_config(args)
    if args.chaos_spec:
        from replication_faster_rcnn_tpu_torch.faultlib import failpoints

        failpoints.configure(args.chaos_spec)
    tracer = None
    if args.telemetry:
        os.makedirs(args.telemetry, exist_ok=True)
        rank = _replica_trace_rank(args.replica_id) if args.replica_id else None
        name = f"trace.rank{rank}.json" if rank else "trace.json"
        tracer = tspans.SpanTracer(os.path.join(args.telemetry, name), rank=rank,
                                   max_events=cfg.telemetry.trace_max_events)
        tspans.set_tracer(tracer)
    model = load_eval_variables(cfg, args.workdir, args.checkpoint_step, device=device)
    state = model.state_dict()
    del model
    artifact_path = None
    if cfg.serving.params_dtype == "int8":
        # the sidecar next to the served checkpoint; the engine raises
        # QuantArtifactError if it is missing
        artifact_path = default_artifact_path(cfg, args.workdir)
    engine = InferenceEngine(
        cfg, device=device, state_dict=state, warmup=True, artifact_path=artifact_path,
        model_version=str(args.checkpoint_step) if args.checkpoint_step is not None else "0",
    )
    del state
    print(json.dumps({
        "buckets": [list(b) for b in engine.buckets],
        "batch_sizes": list(engine.batch_sizes),
        "max_delay_ms": cfg.serving.max_delay_ms,
        "params_dtype": cfg.serving.params_dtype,
        "params_bytes": engine.params_bytes,
        "compile_seconds": engine.compile_seconds,
        "model_version": engine.model_version,
        "strict": False,
        "device": str(engine.device),
    }, indent=2), flush=True)

    def _swap_handler(version: str):
        # POST /swap: the requested step from this replica's workdir; the
        # engine validates and captures it before it flips, so a bad
        # version errors here and serving goes on with the current one
        prior = engine.model_version
        new = load_eval_variables(cfg, args.workdir, int(version), device=engine.device)
        engine.swap_params(new.state_dict(), version, artifact_path=artifact_path)
        return prior

    server = make_server(engine, args.host, args.port, score_thresh=args.score_thresh,
                         replica_id=args.replica_id,
                         swap_handler=_swap_handler if args.workdir else None)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}/ "
          "(POST /predict {\"paths\": [...]}, GET /healthz, GET /stats)", flush=True)
    # SIGTERM: advertise draining first, keep the listener for the grace
    # window, then stop accepting (shutdown must run off the serve_forever
    # thread); the finally block closes the listener and drains the engine
    grace_s = cfg.fleet.drain_grace_s if args.replica_id else 0.0

    def _drain(signum, frame):  # noqa: ARG001 - signal signature
        print(f"SIGTERM: draining (grace {grace_s}s, then stop accepting)...",
              file=sys.stderr, flush=True)
        server.draining = True

        def _stop() -> None:
            if grace_s > 0:
                time.sleep(grace_s)
            server.shutdown()

        threading.Thread(target=_stop, daemon=True).start()

    prev_term = signal.signal(signal.SIGTERM, _drain)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        server.server_close()
        engine.close()
        if tracer is not None:
            tracer.flush()
    print("drained: engine closed", file=sys.stderr, flush=True)
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="voc_resnet18",
                   help="preset name (replication_faster_rcnn_tpu_torch.config.CONFIGS)")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto = cuda (raises without a GPU); cpu runs the plain versions")
    p.add_argument("--chaos-spec", default=None, metavar="SPEC",
                   help="deterministic fault injection (faultlib): "
                        "'site:kind:prob:seed[:arg[:max_fires[:after]]]' comma list, or a "
                        "JSON schedule file; sites/kinds in faultlib.failpoints.SITES/KINDS")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="replication_faster_rcnn_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_serve = sub.add_parser(
        "serve",
        help="micro-batched HTTP serving: capture every (resolution x batch) CUDA graph, "
             "keep the params resident on the card, POST /predict",
    )
    _add_common(p_serve)
    p_serve.add_argument("--workdir", default="checkpoints")
    p_serve.add_argument("--checkpoint-step", type=int, default=None)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8008,
                         help="TCP port (0 = pick a free one)")
    p_serve.add_argument("--score-thresh", type=float, default=0.5)
    p_serve.add_argument("--max-delay-ms", type=float, default=None,
                         help="micro-batch deadline (serving.max_delay_ms)")
    p_serve.add_argument("--bucket-batch-sizes", default=None, metavar="N,M",
                         help="batch sizes per bucket, e.g. '1,8' (serving.batch_sizes)")
    p_serve.add_argument("--resolutions", default=None, metavar="HxW,HxW",
                         help="bucket resolutions, e.g. '300x300,600x600' "
                              "(default: image_size and its half)")
    p_serve.add_argument("--params-dtype", default=None,
                         choices=[None, "float32", "bfloat16", "int8"],
                         help="resident param dtype (serving.params_dtype); int8 needs the "
                              "calibration sidecar next to the checkpoint")
    p_serve.add_argument("--request-timeout-s", type=float, default=None,
                         help="per-request deadline (serving.request_timeout_s; 0 = none)")
    p_serve.add_argument("--adaptive-delay", action="store_true",
                         help="SLO-driven per-bucket deadlines (serving.adaptive_delay)")
    p_serve.add_argument("--replica-id", default=None, metavar="ID",
                         help="name this replica in /healthz; enables the SIGTERM "
                              "drain-grace window (fleet.drain_grace_s)")
    p_serve.add_argument("--telemetry", default=None, metavar="DIR",
                         help="write request hop spans to a Chrome trace in DIR")
    p_serve.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    return args.fn(args)
