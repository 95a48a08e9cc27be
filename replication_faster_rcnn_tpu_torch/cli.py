"""Command line of the PyTorch port (counterpart of the JAX package's
``cli.py``).

Subcommands, each a thin shell over the port's modules with the JAX
command's flags, defaults, printed output and exit codes:

  train      — ``Trainer.train`` (or ``--steps N`` bounded steps); exit 75
               after a verified emergency checkpoint on SIGTERM/SIGINT
  eval       — ``Evaluator`` over a dataset split (VOC or COCO mAP,
               ``--per-class`` table)
  quantize   — int8 calibration (+ ``--sweep``) -> the CRC-manifested
               sidecar that ``serve --params-dtype int8`` loads
  predict    — detections for image files through the serving engine
  serve      — HTTP serving through the captured graphs
  bench      — ``benchmark.main`` (the train or, with BENCH_MODE=eval, the
               eval line)
  telemetry  — the report of a ``--telemetry`` run directory, or one
               request's hop timeline (``--trace-id``)
  fleet      — the multi-replica router's HTTP front over ``serve`` replicas
               (registry, breakers, failover, hedging, canary, shadow)
  chaos      — ``--smoke``: the seeded six-leg fault schedule, run twice
               (exit 1 when a recovery invariant fails)
  rollout    — version eligibility (``--validate-only``) and rolling weight
               waves over ``serve`` replicas (exit 1 unless promoted)
  trace-summary — the device ms of each kernel and of each operator that
               launched kernels, from a ``--profile`` directory's
               ``torch.profiler`` capture (the CPU's ``cpu_op`` rows when it
               holds no device kernels)

``--config`` selects a preset (``config.CONFIGS``); flags override its
fields. Everything runs on the card unless ``--device cpu`` is given.

A JAX flag whose machinery the port does not have yet is an argparse
error naming the ROADMAP Queue A item that brings it (never silently
ignored): ``--strict``, ``--threadsan`` (also ``fleet --threadsan``; item 7);
the mesh, process and ZeRO flags and ``train --elastic`` (item 8);
``train --pretrained-backbone``, ``train --debug-nans`` and ``predict
--output`` (item 9). The ``check``, ``audit`` (item 7),
``warmup`` and ``viz`` (item 9) subcommands are not ported yet.
``--compile-cache`` has no counterpart: the CUDA kernels build once into
``build/``; nor has ``trace-summary --plane``: a ``torch.profiler`` capture
has no XPlane planes.

``predict`` takes ``--params-dtype`` as ``serve`` does, so it can serve the
int8 sidecar too; the JAX command has no such flag.
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

ITEM_7 = "ROADMAP Queue A item 7 (fault injection and static gates)"
ITEM_8 = "ROADMAP Queue A item 8 (distributed: parallel/)"
ITEM_9 = "ROADMAP Queue A item 9 (pretrain, warm-up, debug and viz utilities)"
NO_COMPILE_CACHE = ("no counterpart in the port: there is no XLA compile cache, the CUDA "
                    "kernels build once into build/")
NO_PLANE = ("no counterpart in the port: a torch.profiler capture has no XPlane planes; the "
            "table reads its kernel events and the cpu_op that launched each")


class _NotPorted(argparse.Action):
    """A JAX flag whose machinery the port does not have yet: giving it is
    an argparse error (exit code 2) that names where it comes from."""

    def __init__(self, option_strings, dest, item, nargs=0, **kwargs):
        self.item = item
        super().__init__(option_strings, dest, nargs=nargs, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: {self.item}")


def _device(args) -> Optional[str]:
    """``--device``: None (the card, raising without one) or ``cpu``."""
    return "cpu" if args.device == "cpu" else None


def _parse_resolutions(text: str, flag: str):
    try:
        return tuple(tuple(int(x) for x in r.split("x")) for r in text.split(","))
    except ValueError:
        raise SystemExit(f"{flag} expects 'HxW,HxW' with positive integers (e.g. "
                         f"300x300,600x600), got {text!r}")


def _build_config(args):
    """The preset with the flags' overrides (each flag only where the
    subcommand has it)."""
    from replication_faster_rcnn_tpu_torch.config import get_config

    def arg(name, default=None):
        return getattr(args, name, default)

    cfg = get_config(args.config)
    data_kw = {}
    if arg("dataset"):
        data_kw["dataset"] = args.dataset
    if arg("data_root"):
        data_kw["root_dir"] = args.data_root
    if arg("image_size"):
        data_kw["image_size"] = (args.image_size, args.image_size)
    if arg("loader_workers") is not None:
        data_kw["loader_workers"] = args.loader_workers
    if arg("loader_mode"):
        data_kw["loader_mode"] = args.loader_mode
    if arg("augment_hflip"):
        data_kw["augment_hflip"] = True
    elif arg("no_augment_hflip"):
        data_kw["augment_hflip"] = False
    if arg("augment_scale"):
        data_kw["augment_scale"] = tuple(args.augment_scale)
    if arg("augment_scale_device"):
        data_kw["augment_scale_device"] = True
    if arg("augment_device"):
        data_kw["augment_device"] = True
    if arg("augment_translate") is not None:
        data_kw["augment_translate"] = args.augment_translate
    if arg("cache_ram"):
        data_kw["loader_cache_ram"] = True
    if arg("cache_device"):
        data_kw["cache_device"] = True
    if arg("device_normalize"):
        data_kw["device_normalize"] = True
    if arg("prefetch_device") is not None:
        data_kw["prefetch_device"] = args.prefetch_device
    if arg("train_resolutions"):
        data_kw["train_resolutions"] = _parse_resolutions(args.train_resolutions,
                                                          "--train-resolutions")
    if data_kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    train_kw = {}
    for flag, field in (("lr", "lr"), ("batch_size", "batch_size"), ("epochs", "n_epoch"),
                        ("seed", "seed"), ("eval_every", "eval_every_epochs"),
                        ("mu_dtype", "adam_mu_dtype"),
                        ("steps_per_dispatch", "steps_per_dispatch"),
                        ("nonfinite_policy", "nonfinite_policy"),
                        ("max_consecutive_skips", "max_consecutive_skips"),
                        ("lr_scaling", "lr_scaling"), ("base_batch_size", "base_batch_size"),
                        ("warmup_epochs", "warmup_epochs"), ("optimizer", "optimizer"),
                        ("checkpoint_every_steps", "checkpoint_every_steps"),
                        ("sampling_strategy", "sampling_strategy")):
        if arg(flag) is not None:
            train_kw[field] = getattr(args, flag)
    if arg("async_checkpoint"):
        train_kw["async_checkpoint"] = True
    if arg("lars"):
        train_kw["lars"] = True
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    model_kw = {}
    if arg("backbone"):
        model_kw["backbone"] = args.backbone
    if arg("roi_op"):
        model_kw["roi_op"] = args.roi_op
    if arg("remat"):
        model_kw["remat"] = True
    if arg("frozen_bn"):
        model_kw["frozen_bn"] = True
    if arg("norm"):
        model_kw["norm"] = args.norm
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    eval_kw = {}
    if arg("iou_thresh") is not None:
        eval_kw["iou_thresh"] = args.iou_thresh
    if arg("use_07_metric"):
        eval_kw["use_07_metric"] = True
    if arg("metric"):
        eval_kw["metric"] = args.metric
    if arg("tta_hflip"):
        eval_kw["tta_hflip"] = True
    if eval_kw:
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, **eval_kw))
    serving_kw = {}
    if arg("max_delay_ms") is not None:
        serving_kw["max_delay_ms"] = args.max_delay_ms
    if arg("bucket_batch_sizes"):
        serving_kw["batch_sizes"] = tuple(int(b) for b in args.bucket_batch_sizes.split(","))
    if arg("resolutions"):
        serving_kw["resolutions"] = _parse_resolutions(args.resolutions, "--resolutions")
    if arg("params_dtype"):
        serving_kw["params_dtype"] = args.params_dtype
    if arg("request_timeout_s") is not None:
        serving_kw["request_timeout_s"] = args.request_timeout_s
    if arg("adaptive_delay"):
        serving_kw["adaptive_delay"] = True
    if serving_kw:
        cfg = cfg.replace(serving=dataclasses.replace(cfg.serving, **serving_kw))
    return cfg


def _configure_chaos(args) -> None:
    if getattr(args, "chaos_spec", None):
        from replication_faster_rcnn_tpu_torch.faultlib import failpoints

        failpoints.configure(args.chaos_spec)


# ------------------------------------------------------------------ train


def cmd_train(args) -> int:
    """Train: the epoch loop (then a final save), or exactly ``--steps``
    global steps over the feed cycled (no final save, as the JAX command).
    SIGTERM/SIGINT: a verified emergency checkpoint, then exit 75."""
    import itertools

    from replication_faster_rcnn_tpu_torch.train.fault import (
        EXIT_PREEMPTED,
        GracefulShutdown,
        Preempted,
        check_step_metrics,
    )
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer
    from replication_faster_rcnn_tpu_torch.utils.profiling import trace

    cfg = _build_config(args)
    _configure_chaos(args)
    trainer = Trainer(cfg, device=_device(args), workdir=args.workdir,
                      telemetry_dir=args.telemetry, stall_timeout_s=args.stall_timeout)
    if args.steps:
        # bounded-step mode: iterate the feed cyclically (the index sampler
        # with --cache-device, the loader otherwise); --steps N is a global
        # step target, so a --resume'd run does the rest
        feed = trainer.sampler if trainer.device_cache is not None else trainer.loader
        it = itertools.cycle(iter(feed))
        start = trainer.restore() if args.resume else 0
        if start:
            print(f"resumed from checkpoint at step {start}", file=sys.stderr)

        def _log(i, metrics, row=None):
            host = trainer._host_metrics(metrics)
            if row is not None:
                host = {k: v[row] for k, v in host.items()}
            trainer.logger.log(i, check_step_metrics(host, i))
            trainer.skip_monitor.drain()

        k = trainer.steps_per_dispatch
        log_every = max(1, args.log_every)
        try:
            with trainer.telemetry_session(), GracefulShutdown() as shutdown:
                with trace(args.profile):
                    done = start
                    while done < args.steps:
                        # full chunks ride the K-step graph; a remainder
                        # shorter than K takes the one-step path
                        fused = k > 1 and args.steps - done >= k
                        take = k if fused else 1
                        with trainer.tracer.span("data/fetch", cat="data"):
                            batches = [next(it) for _ in range(take)]
                        # no epoch loop here: the bucket keys off the global step
                        bucket = feed.bucket_of(done) if trainer._bucket_resolutions else None
                        if fused:
                            metrics = trainer.train_chunk(batches, bucket=bucket)
                        else:
                            metrics = trainer.train_one_batch(batches[0], bucket=bucket)
                        if trainer.watchdog is not None:
                            trainer.watchdog.beat(step=done + take, phase="train")
                        # the first 0-indexed step i of the dispatch with
                        # i % log_every == 0 is logged (its row of a chunk)
                        for i in range(done, done + take):
                            if i % log_every == 0:
                                _log(i, metrics, row=(i - done) if fused else None)
                                break
                        done += take
                        if shutdown.requested:
                            trainer._fault_incident("preempted", step=done,
                                                    reason=shutdown.reason or "signal")
                            trainer.save(kind="emergency")
                            raise Preempted(done, shutdown.reason or "signal")
                    trainer.skip_monitor.drain()
        except Preempted as p:
            print(f"{p} (exit {EXIT_PREEMPTED})", file=sys.stderr)
            return EXIT_PREEMPTED
        return 0
    try:
        with trace(args.profile):
            trainer.train(resume=args.resume, log_every=args.log_every)
    except Preempted as p:
        print(f"{p} (exit {EXIT_PREEMPTED})", file=sys.stderr)
        return EXIT_PREEMPTED
    except BaseException as e:
        if args.on_crash_checkpoint:
            # best-effort: persist what survived; the manifest says "crash"
            print(f"crash ({type(e).__name__}); attempting --on-crash-checkpoint save",
                  file=sys.stderr)
            trainer.save(kind="crash", required=False)
        raise
    trainer.save(kind="final")
    return 0


# ------------------------------------------------------------------- eval


def cmd_eval(args) -> int:
    """mAP of the newest (or the given) verified checkpoint over a split."""
    import numpy as np

    from replication_faster_rcnn_tpu_torch.config import COCO_CLASSES, VOC_CLASSES
    from replication_faster_rcnn_tpu_torch.data.loader import make_dataset
    from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator
    from replication_faster_rcnn_tpu_torch.train.trainer import load_eval_variables

    cfg = _build_config(args)
    device = _device(args)
    model = load_eval_variables(cfg, args.workdir, args.checkpoint_step, device=device)
    dataset = make_dataset(cfg.data, args.split)
    result = Evaluator(cfg, device=device).evaluate(
        model, dataset, batch_size=cfg.train.batch_size, max_images=args.max_images)
    if cfg.eval.metric == "coco":
        print(f"mAP@[.50:.95]: {result['mAP']:.4f} "
              f"(AP50 {result.get('AP50', float('nan')):.4f}, "
              f"AP75 {result.get('AP75', float('nan')):.4f})")
        if "AP_small" in result:
            print(f"  area: small {result['AP_small']:.4f}  "
                  f"medium {result['AP_medium']:.4f}  "
                  f"large {result['AP_large']:.4f}  (-1 = no gt in range)")
    else:
        print(f"mAP@{cfg.eval.iou_thresh}: {result['mAP']:.4f}")
    if args.per_class and "ap_per_class" in result:
        names = {len(VOC_CLASSES): VOC_CLASSES, len(COCO_CLASSES): COCO_CLASSES}.get(
            cfg.model.num_classes, [str(i) for i in range(cfg.model.num_classes)])
        aps = result["ap_per_class"]
        for c in range(1, cfg.model.num_classes):
            ap = aps[c]
            shown = "   n/a" if not np.isfinite(ap) else f"{ap:6.4f}"
            print(f"  {names[c]:>16s}  AP {shown}")
    return 0


# --------------------------------------------------------------- quantize


def cmd_quantize(args) -> int:
    """int8 calibration (+ the optional per-group sensitivity sweep) ->
    the CRC-manifested sidecar ``serve --params-dtype int8`` loads:
    per-channel weight scales and the cls/reg input's range from a small
    sweep through the inference forward; with ``--sweep`` a group whose
    response-reconstruction error (or mAP drop, ``--sweep-map-images``)
    crosses the ``quant.*`` budgets falls back to bf16 in the plan."""
    from replication_faster_rcnn_tpu_torch import quant
    from replication_faster_rcnn_tpu_torch.train.fault import config_hash
    from replication_faster_rcnn_tpu_torch.train.trainer import load_eval_variables

    cfg = _build_config(args)
    device = _device(args)
    q = cfg.quant
    if args.calib_batches is not None:
        q = dataclasses.replace(q, calib_batches=args.calib_batches)
    if args.calib_batch_size is not None:
        q = dataclasses.replace(q, calib_batch_size=args.calib_batch_size)
    cfg = cfg.replace(quant=q)
    model = load_eval_variables(cfg, args.workdir, args.checkpoint_step, device=device)
    variables = model.state_dict()

    if cfg.data.dataset == "synthetic" or args.synthetic_calib:
        batches = quant.synthetic_calibration_batches(
            cfg, cfg.quant.calib_batches, cfg.quant.calib_batch_size)
    else:
        from replication_faster_rcnn_tpu_torch.data.loader import make_dataset

        batches = quant.dataset_calibration_batches(
            make_dataset(cfg.data, args.split), cfg.quant.calib_batches,
            cfg.quant.calib_batch_size)
    artifact = quant.calibrate(model, variables, batches, cfg)

    if args.sweep:
        eval_fn = None
        if args.sweep_map_images:
            from replication_faster_rcnn_tpu_torch.data.loader import make_dataset
            from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator

            ev = Evaluator(cfg, device=device)
            eval_ds = make_dataset(cfg.data, args.eval_split)
            eval_fn = lambda v: ev.evaluate(  # noqa: E731
                v, eval_ds, batch_size=cfg.train.batch_size,
                max_images=args.sweep_map_images)["mAP"]
        artifact = quant.sweep(model, variables, artifact, batches, cfg, eval_fn)

    path = args.output or quant.default_artifact_path(cfg, args.workdir)
    quant.save_artifact(path, artifact, config_hash=config_hash(cfg))
    print(json.dumps({
        "artifact": path,
        "groups": sorted(artifact["groups"]),
        "plan": artifact["plan"],
        "sensitivity": dict(artifact.get("sensitivity", {})),
        "calib": artifact["calib"],
    }, indent=2))
    return 0


# ------------------------------------------------------------ bench, predict


def cmd_bench(args) -> int:
    """``benchmark.main``: the flagship's line, or the flags' configuration."""
    from replication_faster_rcnn_tpu_torch.benchmark import main as bench_main

    flagged = any(getattr(args, name) is not None for name in (
        "dataset", "data_root", "image_size", "backbone", "roi_op", "batch_size", "lr",
        "epochs", "seed", "mu_dtype", "loader_workers", "augment_scale",
        "steps_per_dispatch", "nonfinite_policy", "max_consecutive_skips",
        "prefetch_device", "augment_translate", "norm")) or any(getattr(args, name) for name in (
            "augment_hflip", "no_augment_hflip", "augment_scale_device", "augment_device",
            "cache_ram", "cache_device", "device_normalize", "async_checkpoint", "remat",
            "frozen_bn")) or (
        args.config != "voc_resnet18")
    bench_main(_build_config(args) if flagged else None, profile_dir=args.profile,
               device=_device(args))
    return 0


def cmd_predict(args) -> int:
    """Detections for ``--image`` paths (one micro-batched engine pass),
    printed as JSON."""
    from replication_faster_rcnn_tpu_torch.eval.predict import predict_images
    from replication_faster_rcnn_tpu_torch.quant import default_artifact_path
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
    from replication_faster_rcnn_tpu_torch.train.trainer import load_eval_variables

    cfg = _build_config(args)
    device = _device(args)
    model = load_eval_variables(cfg, args.workdir, args.checkpoint_step, device=device)
    artifact_path = None
    if cfg.serving.params_dtype == "int8":
        artifact_path = default_artifact_path(cfg, args.workdir)
    paths = list(args.image)
    with InferenceEngine(cfg, device=device, state_dict=model.state_dict(),
                         artifact_path=artifact_path) as engine:
        dets = predict_images(cfg, model, paths, args.score_thresh, engine=engine)
    if len(paths) == 1:
        print(json.dumps(dets[0], indent=2))
    else:
        print(json.dumps(dict(zip(paths, dets)), indent=2))
    return 0


# ------------------------------------------------------------------ serve


def _replica_trace_rank(replica_id: str) -> int:
    """Stable nonzero rank for a replica's trace file name: the digits of
    an r<K> id shifted by one, else a crc of the id."""
    m = re.search(r"(\d+)$", replica_id)
    if m:
        return int(m.group(1)) + 1
    return zlib.crc32(replica_id.encode()) % 9000 + 1000


def cmd_serve(args) -> int:
    """Serve HTTP requests through the graph-replaying engine: load the
    newest verified checkpoint in ``--workdir`` (the seeded init when there
    is none), capture every (bucket, batch size) graph, print the start-up
    JSON and serve until SIGTERM, which drains: ``/healthz`` advertises
    ``draining`` for ``fleet.drain_grace_s`` (with ``--replica-id``), then
    the listener closes and the engine finishes every admitted request."""
    from replication_faster_rcnn_tpu_torch.quant import default_artifact_path
    from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
    from replication_faster_rcnn_tpu_torch.serving.server import make_server
    from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
    from replication_faster_rcnn_tpu_torch.train.trainer import load_eval_variables

    device = _device(args)
    cfg = _build_config(args)
    _configure_chaos(args)
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


# -------------------------------------------------------------- telemetry


def cmd_telemetry(args) -> int:
    """Phase-time + train-health report of a ``--telemetry`` run directory
    (pure host-side parsing); ``--trace-id`` prints one request's hop
    timeline from the directory's traces merged (a replica's
    ``trace.rank<N>.json`` included). Exit 1 when there is nothing to
    report."""
    from replication_faster_rcnn_tpu_torch.telemetry.report import (
        TRACE_FILE,
        format_report,
        format_trace_timeline,
        load_trace_events,
        rank_variants,
        summarize_run,
        trace_timeline,
    )

    if args.trace_id:
        events = []
        for _rank, path in rank_variants(args.run_dir, TRACE_FILE):
            events.extend(load_trace_events(path))
        timeline = trace_timeline(events, args.trace_id)
        if timeline is None:
            print(f"no spans for trace id {args.trace_id!r} under {args.run_dir}",
                  file=sys.stderr)
            return 1
        if args.json:
            with open(args.json, "w") as f:
                json.dump(timeline, f, indent=2)
            print(f"timeline written to {args.json}")
        print(format_trace_timeline(timeline))
        return 0
    summary = summarize_run(args.run_dir)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"summary written to {args.json}")
    print(format_report(summary))
    return 0 if summary["artifacts"] else 1


# ---------------------------------------------------------- trace-summary


def cmd_trace_summary(args) -> int:
    """Device ms per kernel and per launching operator from a ``--profile``
    directory's capture (pure host-side parsing, no device needed); exit 1
    when the directory holds none."""
    from replication_faster_rcnn_tpu_torch.utils.profiling import (
        TRACE_SUFFIX,
        find_traces,
        format_table,
        op_tables,
    )

    if not find_traces(args.trace_dir):
        print(f"no *{TRACE_SUFFIX} under {args.trace_dir}", file=sys.stderr)
        return 1
    tables = op_tables(args.trace_dir, top=args.top)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"trace_dir": args.trace_dir, **tables}, f, indent=2)
        print(f"op table written to {args.json}")
    if tables["operators"]:
        print("kernels (device ms):")
        print(format_table(tables["ops"]))
        print("\nlaunching operators (device ms of the kernels each launched):")
        print(format_table(tables["operators"]))
    else:
        print("no device kernels in the capture: cpu_op rows (host ms, inclusive):")
        print(format_table(tables["ops"]))
    return 0


# ------------------------------------------------ fleet, chaos, rollout


def cmd_fleet(args) -> int:
    """Self-healing multi-replica serving front (serving/fleet/): a
    health-checked registry probes every ``serve`` replica's /healthz on a
    lease, and the router consistent-hashes requests over the live rotation
    with per-replica circuit breakers, failover re-dispatch, p99-hedged
    retries, a content-hash result cache, and canary/shadow traffic splits.
    Host-side routing only — no model; the replicas own the card."""
    from replication_faster_rcnn_tpu_torch.config import FleetConfig, TelemetryConfig
    from replication_faster_rcnn_tpu_torch.serving import fleet as fleet_mod
    from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans

    if not args.replica:
        print("fleet: need at least one --replica URL", file=sys.stderr)
        return 2
    overrides = {
        k: v
        for k, v in {
            "probe_interval_s": args.probe_interval_s,
            "lease_timeout_s": args.lease_timeout_s,
            "breaker_threshold": args.breaker_threshold,
            "max_attempts": args.max_attempts,
            "request_timeout_s": args.request_timeout_s,
            "cache_entries": args.cache_entries,
            "canary_fraction": args.canary_fraction,
        }.items()
        if v is not None
    }
    if args.no_hedge:
        overrides["hedge"] = False
    fleet_cfg = dataclasses.replace(FleetConfig(), **overrides)
    _configure_chaos(args)

    tracer = None
    if args.telemetry:
        os.makedirs(args.telemetry, exist_ok=True)
        tracer = tspans.SpanTracer(os.path.join(args.telemetry, "trace.json"),
                                   max_events=TelemetryConfig().trace_max_events)
        tspans.set_tracer(tracer)

    registry = fleet_mod.ReplicaRegistry(fleet_cfg)
    for url in args.replica:
        registry.add(url, fleet_mod.HTTPReplicaClient(url, url))
    for url in args.canary or []:
        registry.add(url, fleet_mod.HTTPReplicaClient(url, url), role="canary")
    for url in args.shadow or []:
        registry.add(url, fleet_mod.HTTPReplicaClient(url, url), role="shadow")
    router = fleet_mod.FleetRouter(registry, fleet_cfg)
    prober = fleet_mod.Prober(registry, fleet_cfg.probe_interval_s).start()
    server = fleet_mod.make_fleet_server(router, args.host, args.port)
    host, port = server.server_address[:2]
    print(json.dumps({
        "replicas": list(args.replica),
        "canaries": list(args.canary or []),
        "shadows": list(args.shadow or []),
        "hedge": fleet_cfg.hedge,
        "probe_interval_s": fleet_cfg.probe_interval_s,
        "lease_timeout_s": fleet_cfg.lease_timeout_s,
    }, indent=2))
    print(f"fleet router on http://{host}:{port}/ "
          "(POST /predict {\"paths\": [...]}, GET /healthz, GET /stats)", flush=True)

    # the replicas' drain discipline: /healthz says draining first, the
    # listener answers for the grace window, then the accept loop stops and
    # the prober and the hedge pool are joined
    def _drain(signum, frame):  # noqa: ARG001 - signal signature
        print(f"SIGTERM: draining fleet front (grace {fleet_cfg.drain_grace_s}s)...",
              file=sys.stderr)
        server.draining = True

        def _stop() -> None:
            if fleet_cfg.drain_grace_s > 0:
                time.sleep(fleet_cfg.drain_grace_s)
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
        prober.stop()
        router.close()
        if args.telemetry:
            path = os.path.join(args.telemetry, "fleet.jsonl")
            with open(path, "a") as fh:
                fh.write(json.dumps(router.snapshot()) + "\n")
            print(f"fleet telemetry appended to {path}", file=sys.stderr)
            if tracer is not None:
                tracer.flush()
    return 0


def cmd_chaos(args) -> int:
    """Chaos acceptance harness (faultlib/chaos.py): a tiny seeded fault
    schedule against the real loader, checkpoint store + manifest,
    micro-batcher, elastic agent, fleet router and rollout controller,
    asserting the recovery invariants and that two runs under the same seed
    log the identical fault sequence. Exit 0 = all invariants held."""
    if not args.smoke:
        print("chaos: pass --smoke (the only implemented mode)", file=sys.stderr)
        return 2
    import shutil
    import tempfile

    from replication_faster_rcnn_tpu_torch.faultlib import chaos

    workdir = args.workdir
    cleanup = workdir is None
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="frcnn-torch-chaos-")
    try:
        result = chaos.run_smoke(workdir, seed=args.seed)
    except chaos.ChaosSmokeError as e:
        print(f"chaos smoke FAILED: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(f"chaos smoke ok: seed={result['seed']} "
              f"injected_events={result['injected_events']} "
              f"elapsed_s={result['elapsed_s']}")
        for leg, detail in result["legs"].items():
            print(f"  {leg}: {detail}")
    if cleanup:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def cmd_rollout(args) -> int:
    """Rolling weight rollout (serving/rollout/): discover the checkpoint
    versions the trainer published to WORKDIR/manifests/ (feed.jsonl + a
    manifest scan), validate eligibility BEFORE any replica drains (manifest
    CRC fields, topology, config hash, int8 quant sidecar), then drive a
    rolling upgrade over --replica URLs: hold/drain one replica, POST /swap,
    rejoin-gate at the new version, canary-gate the first swapped replica on
    burn-rate and shadow-diff windows, promote the wave or roll it back."""
    from replication_faster_rcnn_tpu_torch.config import get_config
    from replication_faster_rcnn_tpu_torch.serving import fleet as fleet_mod
    from replication_faster_rcnn_tpu_torch.serving.rollout import (
        RolloutController,
        RolloutWatcher,
        VersionFeed,
    )

    cfg = get_config(args.config)
    if args.probe_interval_s is not None:
        cfg = cfg.replace(fleet=dataclasses.replace(
            cfg.fleet, probe_interval_s=args.probe_interval_s))
    if args.poll_interval_s is not None:
        cfg = cfg.replace(rollout=dataclasses.replace(
            cfg.rollout, poll_interval_s=args.poll_interval_s))
    _configure_chaos(args)
    feed = VersionFeed(args.workdir, config=None if args.no_config_checks else cfg)

    if args.validate_only:
        verdicts = [feed.validate(step) for step in feed.poll()]
        print(json.dumps({
            "workdir": feed.workdir,
            "versions": [
                {"step": v.step, "eligible": v.eligible, "reasons": v.reasons}
                for v in verdicts
            ],
        }, indent=2))
        return 0

    if not args.replica:
        print("rollout: need at least one --replica URL", file=sys.stderr)
        return 2
    registry = fleet_mod.ReplicaRegistry(cfg.fleet)
    for url in args.replica:
        registry.add(url, fleet_mod.HTTPReplicaClient(url, url))
    router = fleet_mod.FleetRouter(registry, cfg.fleet)
    prober = fleet_mod.Prober(registry, cfg.fleet.probe_interval_s).start()
    controller = RolloutController(registry, router, cfg, feed=feed)
    try:
        if args.watch:
            log_path = os.path.join(feed.workdir, "rollout.jsonl")
            watcher = RolloutWatcher(feed, controller, log_path=log_path)
            watcher.start()
            print(f"watching {feed.workdir} every {cfg.rollout.poll_interval_s}s for "
                  f"eligible versions (wave log: {log_path}); ctrl-c to stop", flush=True)
            try:
                while True:
                    time.sleep(60)
            except KeyboardInterrupt:
                pass
            finally:
                watcher.stop()
            return 0
        # one-shot wave (--once is the default mode)
        if args.step is not None:
            result = controller.rollout(str(args.step))
        else:
            verdict = feed.latest_eligible()
            if verdict is None:
                print("rollout: no eligible version published under "
                      f"{feed.workdir} (try --validate-only for reasons)", file=sys.stderr)
                return 1
            result = controller.rollout(verdict.version, verdict=verdict)
        print(json.dumps(result.to_dict(), indent=2))
        return 0 if result.outcome in ("promoted", "noop") else 1
    finally:
        prober.stop()
        router.close()


# ----------------------------------------------------------------- parser


def _add_common(p: argparse.ArgumentParser) -> None:
    """The JAX command line's common flags: those whose config fields the
    port has, and the others as errors naming where they come from."""
    from replication_faster_rcnn_tpu_torch.config import BACKBONES

    p.add_argument("--config", default="voc_resnet18",
                   help="preset name (replication_faster_rcnn_tpu_torch.config.CONFIGS)")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto = cuda (raises without a GPU); cpu runs the plain versions")
    p.add_argument("--chaos-spec", default=None, metavar="SPEC",
                   help="deterministic fault injection (faultlib): "
                        "'site:kind:prob:seed[:arg[:max_fires[:after]]]' comma list, or a "
                        "JSON schedule file; sites/kinds in faultlib.failpoints.SITES/KINDS")
    p.add_argument("--dataset", default=None, choices=[None, "voc", "coco", "synthetic"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--backbone", default=None, choices=[None, *BACKBONES])
    p.add_argument("--roi-op", default=None, choices=[None, "align", "pool"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--lr-scaling", default=None, choices=[None, "none", "linear"],
                   help="'linear' scales the peak LR by batch_size / base-batch-size")
    p.add_argument("--base-batch-size", type=int, default=None,
                   help="the batch size the preset LR was tuned at (default 8)")
    p.add_argument("--warmup-epochs", type=float, default=None,
                   help="linear LR warmup over this many epochs before the cosine decay")
    p.add_argument("--lars", action="store_true",
                   help="layer-wise trust ratio after Adam (arXiv:1708.03888)")
    p.add_argument("--optimizer", default=None, choices=[None, "adam", "lamb"],
                   help="'adam' (default) or 'lamb' (Adam + a per-layer trust ratio)")
    p.add_argument("--checkpoint-every-steps", type=int, default=None, metavar="N",
                   help="scheduled checkpoint every N optimizer steps (0 = off)")
    p.add_argument("--mu-dtype", default=None, choices=[None, "float32", "bfloat16"],
                   help="dtype of Adam's first moment")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="K train steps per dispatch (one replay of a K-step CUDA graph)")
    p.add_argument("--nonfinite-policy", default=None, choices=[None, "apply", "skip", "halt"],
                   help="a non-finite gradient: skip (default) withholds the update, halt "
                        "raises, apply applies it")
    p.add_argument("--max-consecutive-skips", type=int, default=None,
                   help="consecutive skipped steps before training raises")
    p.add_argument("--loader-workers", type=int, default=None,
                   help="host input-pipeline worker threads")
    p.add_argument("--loader-mode", default=None, choices=[None, "thread", "process"],
                   help="'thread' (GIL-releasing decode) or 'process' (forked workers)")
    p.add_argument("--device-normalize", action="store_true",
                   help="ship uint8 images and normalize on the card")
    p.add_argument("--cache-ram", action="store_true",
                   help="cache decoded samples in host RAM")
    p.add_argument("--cache-device", action="store_true",
                   help="the dataset resident on the card; each step ships indices")
    p.add_argument("--augment-hflip", action="store_true",
                   help="50%% horizontal flip (the VOC and COCO presets default it on)")
    p.add_argument("--no-augment-hflip", action="store_true", help="disable the flip")
    p.add_argument("--augment-scale", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                   help="random scale jitter on a fixed canvas, e.g. 0.75 1.25")
    p.add_argument("--augment-scale-device", action="store_true",
                   help="the jitter's image resample on the card")
    p.add_argument("--augment-device", action="store_true",
                   help="every augmentation on the card, inside the step")
    p.add_argument("--augment-translate", type=float, default=None, metavar="FRAC",
                   help="translation jitter up to FRAC of the canvas (with --augment-device)")
    p.add_argument("--train-resolutions", default=None, metavar="HxW,HxW",
                   help="multi-scale bucketed training, e.g. '300x300,600x600'")
    p.add_argument("--sampling-strategy", default=None, choices=[None, "random", "topk_iou"],
                   help="second-stage ROI sampling")
    p.add_argument("--prefetch-device", type=int, default=None, metavar="N",
                   help="batches staged on the card ahead of the step (0 = off)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="scheduled checkpoints written by a background writer")
    # the JAX flags whose machinery the port does not have yet
    for flag in ("--strict", "--threadsan"):
        p.add_argument(flag, action=_NotPorted, item=ITEM_7, help=f"not ported yet: {ITEM_7}")
    for flag in ("--shard-opt", "--spatial"):
        p.add_argument(flag, action=_NotPorted, item=ITEM_8, help=f"not ported yet: {ITEM_8}")
    for flag in ("--backend", "--num-processes", "--coordinator", "--process-id",
                 "--grad-allreduce-dtype", "--num-model", "--mesh-shape"):
        p.add_argument(flag, action=_NotPorted, item=ITEM_8, nargs=1,
                       help=f"not ported yet: {ITEM_8}")
    p.add_argument("--remat", action="store_true",
                   help="recompute each trunk block in the backward pass (less peak memory)")
    p.add_argument("--frozen-bn", action="store_true",
                   help="BatchNorm applies its running statistics in training too; its "
                        "affine stays trainable")
    p.add_argument("--norm", default=None, choices=[None, "batch", "group"],
                   help="backbone normalization: 'batch' or 'group' (GroupNorm(32), no "
                        "running statistics)")
    p.add_argument("--compile-cache", action=_NotPorted, item=NO_COMPILE_CACHE, nargs=1,
                   help=NO_COMPILE_CACHE)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="replication_faster_rcnn_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a detector")
    _add_common(p_train)
    p_train.add_argument("--workdir", default="checkpoints")
    p_train.add_argument("--steps", type=int, default=0,
                         help="run exactly N steps instead of the epoch loop")
    p_train.add_argument("--log-every", type=int, default=10)
    p_train.add_argument("--resume", action="store_true")
    p_train.add_argument("--eval-every", type=int, default=None,
                         help="run val mAP every N epochs (0 = never)")
    p_train.add_argument("--profile", default=None, metavar="DIR",
                         help="torch.profiler trace of the training loop")
    p_train.add_argument("--telemetry", default=None, metavar="DIR",
                         help="write run telemetry here: trace.json, metrics.jsonl, "
                              "watchdog.jsonl + progress.json; summarize with 'telemetry'")
    p_train.add_argument("--stall-timeout", type=float, default=300.0,
                         help="seconds without step progress before the watchdog records a "
                              "stall (needs --telemetry)")
    p_train.add_argument("--on-crash-checkpoint", action="store_true",
                         help="on an unhandled crash, best-effort save (manifest kind "
                              "'crash') before re-raising; SIGTERM/SIGINT always "
                              "emergency-saves and exits 75")
    p_train.add_argument("--pretrained-backbone", action=_NotPorted, item=ITEM_9, nargs=1,
                         help=f"not ported yet: {ITEM_9}")
    p_train.add_argument("--debug-nans", action=_NotPorted, item=ITEM_9,
                         help=f"not ported yet: {ITEM_9}")
    p_train.add_argument("--elastic", action=_NotPorted, item=ITEM_8,
                         help=f"not ported yet: {ITEM_8}")
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval", help="evaluate mAP")
    _add_common(p_eval)
    p_eval.add_argument("--workdir", default="checkpoints")
    p_eval.add_argument("--split", default="val")
    p_eval.add_argument("--checkpoint-step", type=int, default=None)
    p_eval.add_argument("--max-images", type=int, default=None)
    p_eval.add_argument("--per-class", action="store_true", help="print the per-class AP table")
    p_eval.add_argument("--iou-thresh", type=float, default=None,
                        help="matching IoU for VOC mAP (default 0.5)")
    p_eval.add_argument("--use-07-metric", action="store_true",
                        help="VOC2007 11-point AP instead of area-under-PR")
    p_eval.add_argument("--metric", default=None, choices=[None, "voc", "coco"],
                        help="voc: mAP@iou-thresh; coco: mAP@[.50:.95]")
    p_eval.add_argument("--tta-hflip", action="store_true",
                        help="flip test-time augmentation (a mirrored second forward, "
                             "candidates merged before NMS)")
    p_eval.set_defaults(fn=cmd_eval)

    p_bench = sub.add_parser("bench", help="train-step throughput")
    _add_common(p_bench)
    p_bench.add_argument("--profile", default=None, metavar="DIR",
                         help="write a torch.profiler trace of a few more steps")
    p_bench.set_defaults(fn=cmd_bench)

    p_pred = sub.add_parser("predict", help="detect objects in images")
    _add_common(p_pred)
    p_pred.add_argument("--image", required=True, nargs="+", metavar="PATH",
                        help="image path(s); several paths go through the serving engine as "
                             "one micro-batched wave")
    p_pred.add_argument("--workdir", default="checkpoints")
    p_pred.add_argument("--checkpoint-step", type=int, default=None)
    p_pred.add_argument("--score-thresh", type=float, default=0.5)
    p_pred.add_argument("--params-dtype", default=None,
                        choices=[None, "float32", "bfloat16", "int8"],
                        help="resident param dtype (serving.params_dtype); int8 needs the "
                             "calibration sidecar next to the checkpoint")
    p_pred.add_argument("--output", action=_NotPorted, item=ITEM_9, nargs=1, metavar="PATH",
                        help=f"drawing the boxes is not ported yet: {ITEM_9}")
    p_pred.set_defaults(fn=cmd_predict)

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

    p_quant = sub.add_parser(
        "quantize",
        help="int8 calibration: per-channel weight scales + the cls/reg input's range from a "
             "small sweep, an optional per-group sensitivity sweep (--sweep), written as the "
             "CRC-checked sidecar `serve --params-dtype int8` loads",
    )
    _add_common(p_quant)
    p_quant.add_argument("--workdir", default="checkpoints")
    p_quant.add_argument("--checkpoint-step", type=int, default=None)
    p_quant.add_argument("--output", default=None, metavar="PATH",
                         help="artifact path (default: quant.artifact if set, else "
                              "WORKDIR/quant_artifact.json)")
    p_quant.add_argument("--split", default="train",
                         help="dataset split the calibration batches come from (index order)")
    p_quant.add_argument("--eval-split", default="val",
                         help="split of the --sweep-map-images mini eval")
    p_quant.add_argument("--calib-batches", type=int, default=None,
                         help="calibration batches (quant.calib_batches)")
    p_quant.add_argument("--calib-batch-size", type=int, default=None,
                         help="images per calibration batch (quant.calib_batch_size)")
    p_quant.add_argument("--synthetic-calib", action="store_true",
                         help="synthetic calibration images even for a real dataset config")
    p_quant.add_argument("--sweep", action="store_true",
                         help="per-layer-group sensitivity sweep (arXiv:1806.00370): groups "
                              "crossing the quant.sensitivity_* budgets fall back to bf16")
    p_quant.add_argument("--sweep-map-images", type=int, default=None, metavar="N",
                         help="with --sweep: also measure each group's mAP drop on N images")
    p_quant.set_defaults(fn=cmd_quantize)

    p_fleet = sub.add_parser(
        "fleet",
        help="self-healing multi-replica serving front: health-checked replica registry "
             "(lease-staleness probes), consistent-hash routing with a content-hash result "
             "cache, per-replica circuit breakers, failover, p99-hedged retries, canary + "
             "shadow traffic (serving/fleet/)",
    )
    p_fleet.add_argument("--replica", action="append", metavar="URL",
                         help="serving replica base URL (repeatable), e.g. "
                              "http://127.0.0.1:8008 — start each with `serve --replica-id ...`")
    p_fleet.add_argument("--canary", action="append", metavar="URL",
                         help="canary replica URL: a deterministic fleet.canary_fraction "
                              "slice of the content-hash space tries it first")
    p_fleet.add_argument("--shadow", action="append", metavar="URL",
                         help="shadow replica URL: mirrored traffic, responses diffed "
                              "(never returned)")
    p_fleet.add_argument("--host", default="127.0.0.1")
    p_fleet.add_argument("--port", type=int, default=8010,
                         help="TCP port (0 = pick a free one)")
    p_fleet.add_argument("--probe-interval-s", type=float, default=None,
                         help="/healthz probe cadence per replica (fleet.probe_interval_s)")
    p_fleet.add_argument("--lease-timeout-s", type=float, default=None,
                         help="probe-staleness horizon before a replica is declared dead "
                              "(fleet.lease_timeout_s)")
    p_fleet.add_argument("--breaker-threshold", type=int, default=None,
                         help="consecutive dispatch failures that open a replica's circuit "
                              "breaker (fleet.breaker_threshold)")
    p_fleet.add_argument("--max-attempts", type=int, default=None,
                         help="primary + failover attempts per request (fleet.max_attempts)")
    p_fleet.add_argument("--request-timeout-s", type=float, default=None,
                         help="per-attempt replica call deadline (fleet.request_timeout_s)")
    p_fleet.add_argument("--cache-entries", type=int, default=None,
                         help="content-hash result cache size, 0 disables "
                              "(fleet.cache_entries)")
    p_fleet.add_argument("--canary-fraction", type=float, default=None,
                         help="fraction of the content-hash space routed to the canary first "
                              "(fleet.canary_fraction)")
    p_fleet.add_argument("--no-hedge", action="store_true",
                         help="disable hedged retries (fleet.hedge=False): dispatch becomes "
                              "strictly sequential failover")
    p_fleet.add_argument("--chaos-spec", default=None, metavar="SPEC",
                         help="arm failpoints (site:kind:prob:seed[:arg]) — the fleet sites "
                              "are router.dispatch and router.probe, plus http.handler on the "
                              "front itself")
    p_fleet.add_argument("--threadsan", action=_NotPorted, item=ITEM_7,
                         help=f"not ported yet: {ITEM_7}")
    p_fleet.add_argument("--telemetry", default=None, metavar="DIR",
                         help="append a final router/registry snapshot to DIR/fleet.jsonl on "
                              "shutdown and write the router's request/attempt spans to "
                              "DIR/trace.json — point the replicas' `serve --telemetry` at "
                              "the same DIR for the merged `telemetry --trace-id` timeline")
    p_fleet.set_defaults(fn=cmd_fleet)

    p_chaos = sub.add_parser(
        "chaos",
        help="deterministic fault-injection acceptance harness (faultlib): a seeded "
             "failpoint schedule against the real loader, checkpoint, micro-batcher, elastic "
             "agent, fleet router and rollout controller; asserts the fault-tolerance "
             "invariants hold and that the same seed reproduces the identical fault sequence",
    )
    p_chaos.add_argument("--smoke", action="store_true",
                         help="tiny seeded schedule on synthetic data (finishes in seconds); "
                              "currently the only mode, so required")
    p_chaos.add_argument("--seed", type=int, default=0,
                         help="schedule seed; the run is a pure function of it")
    p_chaos.add_argument("--workdir", default=None, metavar="DIR",
                         help="scratch dir for checkpoint legs (default: a fresh temp dir, "
                              "removed on success)")
    p_chaos.add_argument("--json", action="store_true",
                         help="print the full result record as JSON")
    p_chaos.set_defaults(fn=cmd_chaos)

    p_roll = sub.add_parser(
        "rollout",
        help="rolling weight rollout: validate checkpoint versions published to "
             "WORKDIR/manifests/ (pre-drain eligibility gate), then drive a rolling fleet "
             "upgrade over --replica URLs — drain → hot-swap (POST /swap) → rejoin-gate → "
             "gated canary promote, with first-class rollback (serving/rollout/)",
    )
    p_roll.add_argument("--workdir", required=True, metavar="DIR",
                        help="trainer workdir whose manifests/ feed is the version source "
                             "(the replicas must serve from the same workdir so POST /swap "
                             "can load the step)")
    p_roll.add_argument("--config", default="voc_resnet18",
                        help="preset the fleet serves (eligibility checks the manifest "
                             "config hash and, for int8, the quant sidecar against it)")
    p_roll.add_argument("--no-config-checks", action="store_true",
                        help="skip the config-hash and int8-sidecar eligibility checks "
                             "(manifest integrity + topology still judged)")
    p_roll.add_argument("--replica", action="append", metavar="URL",
                        help="serving replica base URL (repeatable); each must run `serve "
                             "--replica-id ... --workdir ...` so /swap is enabled")
    p_roll.add_argument("--validate-only", action="store_true",
                        help="print every published version's eligibility verdict as JSON "
                             "and exit — no replica is touched")
    p_roll.add_argument("--once", action="store_true",
                        help="run exactly one rollout wave to the newest eligible version "
                             "(or --step) and exit; this is the default mode")
    p_roll.add_argument("--step", type=int, default=None,
                        help="with --once: roll to this checkpoint step instead of the newest "
                             "eligible one (still validated first)")
    p_roll.add_argument("--watch", action="store_true",
                        help="poll the manifest feed forever (rollout.poll_interval_s) and "
                             "run a wave per newly eligible version; wave results append to "
                             "WORKDIR/rollout.jsonl")
    p_roll.add_argument("--probe-interval-s", type=float, default=None,
                        help="/healthz probe cadence (fleet.probe_interval_s)")
    p_roll.add_argument("--poll-interval-s", type=float, default=None,
                        help="manifest feed poll cadence for --watch "
                             "(rollout.poll_interval_s)")
    p_roll.add_argument("--chaos-spec", default=None, metavar="SPEC",
                        help="arm failpoints (site:kind:prob:seed[:arg]) — the rollout sites "
                             "are rollout.swap (before each per-replica swap RPC) and "
                             "rollout.promote (at the promote decision)")
    p_roll.set_defaults(fn=cmd_rollout)

    p_trace = sub.add_parser(
        "trace-summary",
        help="per-kernel and per-operator device time table from a --profile trace dir")
    p_trace.add_argument("trace_dir")
    p_trace.add_argument("--top", type=int, default=25)
    p_trace.add_argument("--plane", action=_NotPorted, item=NO_PLANE, nargs=1,
                         help=NO_PLANE)
    p_trace.add_argument("--json", default=None, metavar="PATH",
                         help="also write the tables as JSON")
    p_trace.set_defaults(fn=cmd_trace_summary)

    p_tel = sub.add_parser(
        "telemetry", help="phase-time + train-health report from a --telemetry run dir")
    p_tel.add_argument("run_dir")
    p_tel.add_argument("--json", default=None, metavar="PATH",
                       help="also write the summary as JSON")
    p_tel.add_argument("--trace-id", default=None, metavar="HEX32",
                       help="print one request's hop timeline from the merged traces instead "
                            "of the full report")
    p_tel.set_defaults(fn=cmd_telemetry)

    args = parser.parse_args(argv)
    return args.fn(args)
