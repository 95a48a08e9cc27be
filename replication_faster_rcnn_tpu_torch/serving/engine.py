"""Bucketed, micro-batched inference engine with one CUDA graph per flush
program (counterpart of the JAX package's ``serving/engine.py``).

* **Shape buckets.** Requests are routed to the smallest resolution bucket
  that contains them (``select_bucket``); each bucket has one inference
  function (``eval/evaluator.py::make_infer_fn``: forward, flip TTA under
  ``eval.tta_hflip``, decode) and a flush pads to the smallest of
  ``serving.batch_sizes`` that fits.
* **Serving graphs.** On the card each (model version, bucket, batch size)
  flush is a CUDA graph of that function (:class:`ServingGraph`), the
  counterpart of the JAX engine's AOT programs: ``warmup=True`` captures
  every graph at construction (``compile_seconds`` holds each capture's
  seconds under JAX's program names), otherwise a graph is captured at its
  first flush. A flush writes its padded batch into the graph's pinned
  staging buffer, copies it to the graph's static input without a sync,
  replays, and brings the four outputs back in one copy into pinned host
  memory with one event wait. All graphs capture into one memory pool: the
  batcher's one worker replays them one at a time. A capture that fails
  raises; nothing falls back to eager on the card. On the CPU, with
  ``capture=False`` and for ``reference=True`` the flush runs eagerly.
* **Resident params, versioned.** Each version's weights are cast once to
  ``serving.params_dtype`` and stay on the device; under ``"int8"`` the
  resident tree is the quantized one (``quant/apply.py``: int8 weights +
  per-channel scales, the rest bfloat16, driven by the CRC-checked
  calibration sidecar), and each replay rebuilds the compute-dtype weights
  with one launch of the grouped dequantize kernel inside the graph.
  ``swap_params`` validates, builds and captures a new version before it
  flips admission to it; flush keys are ``(version, bucket, reference)``,
  so no micro-batch mixes versions. The prior version stays resident as
  the rollback target; older versions with nothing pending are retired
  with their graphs.
* **Overload.** ``submit(..., timeout=0)`` is admission control (a full
  queue raises ``queue.Full``, counted as ``shed``);
  ``serving.request_timeout_s`` is each entry's time to live (dropped at
  flush time). Counters, gauges and histograms live in one
  ``MetricsRegistry``; a ``BurnRateTracker`` and the flush-failure streak
  drive ``degraded``; ``serving.adaptive_delay`` hands each bucket's
  deadline to a ``DeadlineController``.

Not ported: the strict-mode gate (``engine.strict``), the mesh serving
layout and the persistent compile cache (XLA only).
"""

from __future__ import annotations

import collections
import functools
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.eval.evaluator import (
    Evaluator,
    make_infer_fn,
    make_int8_infer_fn,
)
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
from replication_faster_rcnn_tpu_torch.quant import (
    default_artifact_path,
    load_artifact,
    quantize_variables,
    quantized_params_bytes,
)
from replication_faster_rcnn_tpu_torch.quant.apply import tree_to
from replication_faster_rcnn_tpu_torch.serving.batcher import MicroBatcher
from replication_faster_rcnn_tpu_torch.serving.slo import DeadlineController
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
from replication_faster_rcnn_tpu_torch.telemetry import tracecontext
from replication_faster_rcnn_tpu_torch.telemetry.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    MetricsRegistry,
)
from replication_faster_rcnn_tpu_torch.telemetry.slo_burn import BurnRateTracker

# consecutive flush failures before /healthz reports degraded; one
# successful flush resets the streak
DEGRADED_AFTER = 3

# below this many outcomes in the long window the burn-rate alarm stays
# quiet and only the flush-streak path can degrade
SLO_MIN_SAMPLES = 100

# the engine's serving counters, in /stats order; each is a registry
# counter named serve_<key>_total
_STAT_KEYS = (
    "requests",
    "flushes",
    "padded_slots",
    "shed",  # admission-control rejections (queue full)
    "deadline_expired",  # dropped at flush time, never computed
    "timeouts",  # handler-side waits that hit 504
    "flush_errors",  # failed micro-batch dispatches
)

# the four detection outputs, in the order one packed copy carries them
OUTPUT_KEYS = ("boxes", "scores", "classes", "valid")

__all__ = [
    "InferenceEngine",
    "OversizedImageError",
    "ServingGraph",
    "get_engine",
    "get_evaluator",
    "int8_program_name",
    "select_bucket",
    "serve_program_name",
]


class OversizedImageError(ValueError):
    """Request larger than every bucket under ``serving.oversize="reject"``."""


def serve_program_name(h: int, w: int, batch: int) -> str:
    """Name of one serving bucket program (the JAX package's
    ``train/warmup.py`` names)."""
    return f"serve_{h}x{w}_b{batch}"


def int8_program_name(base: str) -> str:
    """Name of the ``params_dtype="int8"`` twin of a serving program."""
    return base + "__int8"


def select_bucket(
    resolutions: Sequence[Tuple[int, int]],
    orig_h: int,
    orig_w: int,
    oversize: str = "downscale",
) -> Tuple[int, int]:
    """The smallest bucket that contains (orig_h, orig_w). Images bigger
    than every bucket follow the oversize policy: route to the largest
    bucket (lossy downscale) or refuse."""
    ordered = sorted(resolutions, key=lambda r: (r[0] * r[1], r))
    if not ordered:
        raise ValueError("no serving resolutions configured")
    for h, w in ordered:
        if orig_h <= h and orig_w <= w:
            return (h, w)
    if oversize == "reject":
        raise OversizedImageError(
            f"image {orig_h}x{orig_w} exceeds every serving bucket "
            f"{list(ordered)} and serving.oversize='reject'"
        )
    return ordered[-1]


def _pack(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The four outputs as one uint8 [N, bytes] tensor (per image: boxes,
    scores, classes, valid), so one copy brings a flush back."""
    n = out["valid"].shape[0]
    return torch.cat([out[k].contiguous().reshape(n, -1).view(torch.uint8) for k in OUTPUT_KEYS],
                     dim=1)


def _unpack(packed: np.ndarray, like: Dict[str, Tuple[Tuple[int, ...], np.dtype]]
            ) -> Dict[str, np.ndarray]:
    """:func:`_pack`'s inverse on the host: fresh arrays (the pinned buffer
    is overwritten by the next flush)."""
    out, at = {}, 0
    for k in OUTPUT_KEYS:
        shape, dtype = like[k]
        nbytes = int(np.prod(shape[1:])) * np.dtype(dtype).itemsize
        out[k] = packed[:, at:at + nbytes].copy().view(dtype).reshape(shape)
        at += nbytes
    return out


class ServingGraph:
    """One flush program, a version's inference function ``infer(images)``
    for one (bucket, batch size), as a CUDA graph.

    :meth:`capture` runs the function once eagerly on the engine's side
    stream (cuDNN's algorithm choice, the anchors, constants and the
    grouped dequantize's table are built there, never under capture), then
    captures it on that stream into the engine's shared pool. A call copies
    the padded batch from the pinned staging buffer into the static input
    (non-blocking), replays, and copies the packed outputs into a pinned
    host buffer, then waits on one event: no host sync comes between the
    input copy and the output copy.

    The kernel wrappers count a launch when Python calls them: the warm-up
    and the capture count once each, a replay counts nothing."""

    def __init__(self, infer: Callable, batch: int, bucket: Tuple[int, int],
                 device: torch.device, stream, pool, lock: threading.Lock):
        h, w = bucket
        self.infer, self.batch, self.bucket, self.device = infer, batch, bucket, device
        self.stream, self.pool, self.lock = stream, pool, lock
        self.staging = torch.zeros((batch, h, w, 3), dtype=torch.float32, pin_memory=True)
        self.static_in = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device)
        self.graph = None
        self.static_out: Optional[torch.Tensor] = None
        self.host_out: Optional[torch.Tensor] = None
        self.layout: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}
        self.done = torch.cuda.Event()

    def capture(self) -> float:
        """Warm up and capture; returns the seconds both took."""
        t0 = time.perf_counter()
        self._warm_up()
        with self.lock:
            self._capture()
        return time.perf_counter() - t0

    def _warm_up(self) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.infer(self.static_in)
            self.layout = {k: (tuple(out[k].shape), _numpy_dtype(out[k].dtype))
                           for k in OUTPUT_KEYS}
        current.wait_stream(self.stream)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: request threads and a hot-swap's staging may call
            # into CUDA meanwhile; only this thread's calls are checked
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.static_out = _pack(self.infer(self.static_in))
        except Exception as e:
            raise RuntimeError(
                f"capturing the serving program {self.bucket} b{self.batch} as a CUDA graph "
                f"failed: {type(e).__name__}: {e}") from e
        self.host_out = torch.empty(self.static_out.shape, dtype=torch.uint8, pin_memory=True)
        self.graph = graph

    def __call__(self, images: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
        """Detections of the padded batch whose first ``len(images)`` rows
        are ``images`` (float32 [h, w, 3] each); numpy arrays of [batch, ...]."""
        staging = self.staging.numpy()
        for i, image in enumerate(images):
            staging[i] = image
        staging[len(images):] = 0.0
        with self.lock:
            self.static_in.copy_(self.staging, non_blocking=True)
            self.graph.replay()
            self.host_out.copy_(self.static_out, non_blocking=True)
            self.done.record()
            self.done.synchronize()
            return _unpack(self.host_out.numpy(), self.layout)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype({torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}[dtype])


class _Version:
    """One device-resident model version: its module (bf16/f32; under int8
    the resident tree lives in the inference functions), its inference
    function per bucket, its resident bytes and its graphs."""

    def __init__(self, model: Optional[FasterRCNN], infer: Dict[Tuple[int, int], Callable],
                 params_bytes: int):
        self.model, self.infer, self.params_bytes = model, infer, params_bytes
        self.graphs: Dict[Tuple[Tuple[int, int], int], ServingGraph] = {}


class InferenceEngine:
    """Micro-batched detector serving for one config on one device (default
    ``cuda``, raising without a GPU), with the weights of ``state_dict``
    (e.g. bridged from the JAX package by ``models/convert.py``, or
    ``train/trainer.py::load_eval_variables(...).state_dict()``) or a
    seeded random init.

    ``params_dtype="int8"`` needs the calibration sidecar: ``artifact_path``,
    else ``quant.artifact``, else ``./quant_artifact.json``
    (``quant/artifact.py::default_artifact_path``); a missing or corrupt one
    raises :class:`QuantArtifactError` before anything is built.

    ``warmup=True`` captures every (bucket, batch size) graph now (the
    ``serve`` start-up contract); otherwise each is captured at its first
    flush. ``capture=False`` serves eagerly on the card (for comparisons)."""

    def __init__(
        self,
        config: FasterRCNNConfig,
        device: DeviceLike = None,
        state_dict: Optional[dict] = None,
        seed: int = 0,
        artifact_path: Optional[str] = None,
        warmup: bool = False,
        model_version: str = "0",
        capture: bool = True,
    ) -> None:
        self.config = config
        self.params_dtype = config.serving.params_dtype
        self.buckets = config.serving.bucket_resolutions(config.data.image_size)
        self.batch_sizes = tuple(sorted(set(config.serving.batch_sizes)))
        self.quant_artifact_path: Optional[str] = None
        if self.params_dtype == "int8":
            self.quant_artifact_path = artifact_path or default_artifact_path(config)
            load_artifact(self.quant_artifact_path)  # raises before anything is built
            self._serve_name = lambda h, w, n: int8_program_name(serve_program_name(h, w, n))
        else:
            self._serve_name = serve_program_name
        self.device = resolve_device(device)
        # the structure only (keys, shapes; the int8 forward's module tree)
        self._structure = FasterRCNN(config, device="meta")
        self._signature = {k: tuple(v.shape) for k, v in self._structure.state_dict().items()}
        if state_dict is None:  # the seeded init, drawn on the serving device
            state_dict = build_model(config, device=self.device, seed=seed).state_dict()
        self.capture = bool(capture) and self.device.type == "cuda"
        self._graph_lock = threading.Lock()  # one capture or replay on the card at a time
        self._capture_lock = threading.Lock()  # flush worker and hot-swap may race
        self._stream = torch.cuda.Stream(self.device) if self.capture else None
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.compile_seconds: Dict[str, float] = {}

        # versioned residency: `_resident` maps model_version -> the device
        # tree of that version; `model_version` names the version new
        # admissions bind to
        self.model_version = str(model_version)
        self._version_lock = threading.RLock()
        first = self._build_resident(state_dict)
        del state_dict
        self._resident: Dict[str, _Version] = {self.model_version: first}
        self.params_bytes = first.params_bytes

        self.metrics = MetricsRegistry()
        self._counters = {
            key: self.metrics.counter(f"serve_{key}_total", help=f"serving {key}")
            for key in _STAT_KEYS
        }
        buckets = config.telemetry.buckets_s() or DEFAULT_LATENCY_BUCKETS_S
        self._queue_wait_hist = self.metrics.histogram(
            "serve_queue_wait_seconds",
            help="micro-batch queue wait per request",
            buckets=buckets,
        )
        self._flush_hist = self.metrics.histogram(
            "serve_flush_seconds",
            help="micro-batch dispatch latency per flush",
            buckets=buckets,
        )
        self.metrics.register_collector(self._collect_gauges)
        self.slo = BurnRateTracker(
            availability_target=config.fleet.slo_availability_target,
            latency_target_s=config.fleet.slo_latency_target_ms / 1000.0,
            short_window_s=config.fleet.slo_short_window_s,
            long_window_s=config.fleet.slo_long_window_s,
        )
        self._stats_lock = threading.Lock()
        self._consecutive_flush_errors = 0
        self._last_flush_error: Optional[str] = None
        self._start_time = time.monotonic()
        # wall seconds of recent flushes (staging + transfer + replay or
        # forward + decode + copy back)
        self.flush_seconds: "collections.deque[float]" = collections.deque(maxlen=1024)
        if warmup:
            self._capture_all(self.model_version, first)
        self.deadline_controller: Optional[DeadlineController] = None
        if config.serving.adaptive_delay:
            self.deadline_controller = DeadlineController.from_config(
                config.serving, max_batch=lambda key: self.batch_sizes[-1]
            )
        # batcher keys are (model_version, bucket, reference): a micro-batch
        # holds one version only, and a request admitted before a swap is
        # answered entirely by the version it was admitted under
        self._batcher = MicroBatcher(
            self._process_bucket,
            max_batch=lambda key: self.batch_sizes[-1],
            max_delay_s=(
                (lambda key: self.deadline_controller.delay_s(key[1]))
                if self.deadline_controller is not None
                else config.serving.max_delay_ms / 1000.0
            ),
            depth=config.serving.queue_depth,
            name="serving-micro-batcher",
            on_expired=self._note_expired,
            on_flush_result=self._note_flush,
            on_flush_stats=self._note_flush_stats,
        )

    # ---------------------------------------------------- overload accounting

    def _note_expired(self, n: int) -> None:
        self._counters["deadline_expired"].inc(n)
        for _ in range(n):
            self.slo.record(False)

    def _note_flush(self, ok: bool) -> None:
        if not ok:
            self._counters["flush_errors"].inc()
        with self._stats_lock:
            if ok:
                self._consecutive_flush_errors = 0
            else:
                self._consecutive_flush_errors += 1

    def _note_flush_stats(self, key, waits_s) -> None:
        for w in waits_s:
            self._queue_wait_hist.observe(w)
        if self.deadline_controller is not None:
            # per bucket: a swap keeps the learned deadlines
            self.deadline_controller.on_flush(key[1], waits_s)

    def _collect_gauges(self) -> None:
        self.metrics.gauge(
            "serve_queue_depth", help="requests waiting in the batch queue"
        ).set(self.queue_depth())
        self.metrics.gauge(
            "serve_params_bytes",
            help="bytes of the device-resident model (weights + scales)",
            params_dtype=self.params_dtype,
        ).set(self.params_bytes)
        self.metrics.gauge(
            "serve_uptime_seconds", help="seconds since engine construction"
        ).set(self.uptime_s())
        with self._version_lock:
            versions = {v: int(v == self.model_version) for v in self._resident}
        for v, live in versions.items():
            self.metrics.gauge(
                "serve_model_version",
                help="device-resident model versions (1 = serving now)",
                model_version=v,
            ).set(live)
        for bucket, n in self.bucket_queue_depths().items():
            self.metrics.gauge(
                "serve_bucket_queue_depth",
                help="submitted-but-unflushed requests per bucket",
                bucket=bucket,
            ).set(n)

    @property
    def stats(self) -> Dict[str, int]:
        """The serving counters as a plain dict (``/stats``' ``stats``
        block), a registry snapshot."""
        out = {k: 0 for k in _STAT_KEYS}
        for name, v in self.metrics.counters_flat().items():
            if name.startswith("serve_") and name.endswith("_total") and "{" not in name:
                out[name[len("serve_"): -len("_total")]] = int(v)
        return out

    def incr_stat(self, key: str, n: int = 1) -> None:
        """Bump a serving counter (handler threads record their 504s here);
        a handler timeout burns error budget."""
        counter = self._counters.get(key)
        if counter is None:
            counter = self.metrics.counter(f"serve_{key}_total", help=f"serving {key}")
        counter.inc(n)
        if key == "timeouts":
            for _ in range(n):
                self.slo.record(False)

    def queue_depth(self) -> int:
        """Requests waiting in the micro-batch queue."""
        return self._batcher.queue_depth()

    def bucket_queue_depths(self) -> Dict[str, int]:
        """``"HxW" -> submitted-but-unflushed requests`` per bucket, summed
        over versions and the reference flag."""
        out: Dict[str, int] = {}
        for (_, (h, w), _), n in self._batcher.key_depths().items():
            k = f"{h}x{w}"
            out[k] = out.get(k, 0) + n
        return out

    def resident_versions(self) -> Dict[str, bool]:
        """``version -> is the version new admissions bind to``."""
        with self._version_lock:
            return {v: v == self.model_version for v in self._resident}

    def uptime_s(self) -> float:
        return time.monotonic() - self._start_time

    def _slo_alarm(self) -> bool:
        snap = self.slo.snapshot()
        return bool(snap["alarm"]) and snap["samples"]["long"] >= SLO_MIN_SAMPLES

    @property
    def degraded(self) -> bool:
        """True after :data:`DEGRADED_AFTER` consecutive flush failures (one
        success resets it) or while the SLO burn-rate alarm fires on at
        least :data:`SLO_MIN_SAMPLES` outcomes."""
        with self._stats_lock:
            if self._consecutive_flush_errors >= DEGRADED_AFTER:
                return True
        return self._slo_alarm()

    @property
    def degraded_reason(self) -> Optional[str]:
        """The cause while degraded, ``None`` when healthy."""
        with self._stats_lock:
            n = self._consecutive_flush_errors
            last = self._last_flush_error
        if n >= DEGRADED_AFTER:
            reason = f"{n} consecutive micro-batch flush failures"
            if last:
                reason += f" (last: {last})"
            return reason
        if self._slo_alarm():
            rates = self.slo.burn_rates()
            return (
                "SLO burn-rate alarm: burning error budget at "
                f"{rates['short']:.1f}x (5m) / {rates['long']:.1f}x (1h)"
            )
        return None

    # ------------------------------------------------------- versioned params

    def _validate(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The state's keys and shapes against the model's (the JAX engine
        checks the leaves against its compiled signature)."""
        if set(state_dict) != set(self._signature):
            raise ValueError(
                f"variables have {len(state_dict)} leaves; the serving program "
                f"expects {len(self._signature)} — wrong model/config for this "
                "checkpoint?"
            )
        for key, want in self._signature.items():
            got = tuple(state_dict[key].shape)
            if got != want:
                raise ValueError(
                    f"variables leaf {key!r} has shape {got}; the serving program "
                    f"expects {want} — wrong model/config for this checkpoint?"
                )

    def _build_resident(self, state_dict: Dict[str, torch.Tensor],
                        artifact_path: Optional[str] = None) -> _Version:
        """Validate, cast and upload one version's weights. int8 re-reads
        the CRC-checked sidecar (``artifact_path`` overrides the engine's),
        so a corrupt one fails here, before any serving state changes."""
        self._validate(state_dict)
        if self.params_dtype == "int8":
            artifact = load_artifact(artifact_path or self.quant_artifact_path)
            qvars = tree_to(quantize_variables(state_dict, artifact), self.device)
            infer = {
                b: functools.partial(make_int8_infer_fn(self._structure, self.config, b), qvars)
                for b in self.buckets
            }
            return _Version(None, infer, quantized_params_bytes(qvars))
        model = build_model(self.config, device=self.device, state_dict=state_dict)
        model = model.to(getattr(torch, self.params_dtype))
        nbytes = sum(t.numel() * t.element_size()
                     for t in list(model.parameters()) + list(model.buffers()))
        infer = {b: make_infer_fn(model, self.config, b) for b in self.buckets}
        return _Version(model, infer, int(nbytes))

    @property
    def model(self) -> FasterRCNN:
        """The current version's module (under int8 the structure on
        ``meta``; its weights are the resident tree's)."""
        with self._version_lock:
            current = self._resident[self.model_version]
        return current.model if current.model is not None else self._structure

    def swap_params(self, state_dict: Dict[str, torch.Tensor], version: str,
                    artifact_path: Optional[str] = None) -> str:
        """Hot-swap serving to ``version``; returns the prior version.

        Builds the new version's resident tree and, on the card, captures
        its graphs before any serving state changes (a bad checkpoint or
        sidecar raises here and the engine keeps serving the old version),
        then redirects admission under the version lock. Requests already
        admitted finish on the version in their flush key. The prior
        version stays resident (the rollback target); older versions with
        nothing pending are retired with their graphs."""
        version = str(version)
        staged = self._build_resident(state_dict, artifact_path=artifact_path)
        self._capture_all(version, staged)
        with self._version_lock:
            prior = self.model_version
            self._resident[version] = staged
            self.model_version = version
            if artifact_path is not None and self.params_dtype == "int8":
                self.quant_artifact_path = artifact_path
            self.params_bytes = staged.params_bytes
            pending = {k[0] for k in self._batcher.key_depths()}
            for v in [v for v in self._resident
                      if v not in (version, prior) and v not in pending]:
                del self._resident[v]
        return prior

    # -------------------------------------------------------------- graphs

    def _capture_all(self, version: str, resident: _Version) -> None:
        if not self.capture:
            return
        for h, w in self.buckets:
            for n in self.batch_sizes:
                self._graph(version, resident, (h, w), n)

    def _graph(self, version: str, resident: _Version, bucket: Tuple[int, int],
               n: int) -> ServingGraph:
        """The version's graph for (bucket, n), captured on first use."""
        graph = resident.graphs.get((bucket, n))
        if graph is not None:
            return graph
        with self._capture_lock:
            graph = resident.graphs.get((bucket, n))
            if graph is not None:
                return graph
            name = self._serve_name(bucket[0], bucket[1], n)
            with tspans.current_tracer().span(f"compile/{name}", cat="compile",
                                              model_version=version):
                graph = ServingGraph(resident.infer[bucket], n, bucket, self.device,
                                     self._stream, self._pool, self._graph_lock)
                seconds = graph.capture()
            self.compile_seconds[name] = round(seconds, 3)
            resident.graphs[(bucket, n)] = graph
            return graph

    def graphs(self, version: Optional[str] = None) -> Dict[Tuple[Tuple[int, int], int],
                                                            ServingGraph]:
        """The captured graphs of ``version`` (default: the current one)."""
        with self._version_lock:
            return dict(self._resident[version or self.model_version].graphs)

    # ------------------------------------------------------------- requests

    def _prepare(self, image: np.ndarray, orig_size: Optional[Tuple[int, int]]):
        """-> (bucket, (float32 image at bucket size, orig_h, orig_w, trace))."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] image, got {image.shape}")
        if image.dtype == np.uint8:
            orig_h, orig_w = image.shape[:2]
            bucket = select_bucket(self.buckets, orig_h, orig_w, self.config.serving.oversize)
            image = resize_normalize(
                image, bucket, self.config.data.pixel_mean, self.config.data.pixel_std
            )
        else:
            bucket = tuple(image.shape[:2])
            if bucket not in set(self.buckets):
                raise ValueError(
                    f"float image shape {image.shape[:2]} matches no serving "
                    f"bucket {list(self.buckets)}; pass uint8 for automatic routing"
                )
            orig_h, orig_w = orig_size if orig_size else bucket
        return bucket, (np.asarray(image, np.float32), int(orig_h), int(orig_w),
                        tracecontext.current_trace())

    def submit(
        self,
        image: np.ndarray,
        orig_size: Optional[Tuple[int, int]] = None,
        timeout: Optional[float] = None,
        reference: bool = False,
    ) -> Future:
        """Enqueue one image; the Future resolves to a detection dict
        (``boxes`` [D, 4] in ORIGINAL image coordinates, ``scores``,
        ``classes``, ``valid``). uint8 [H, W, 3] input of any size is
        bucket-routed and resized on the caller's thread; float32 input must
        match a bucket exactly (``orig_size`` is then its pre-resize size).
        ``timeout=0`` is admission control (a full queue raises
        ``queue.Full``). ``reference=True`` serves it eagerly through the
        kernels' plain versions."""
        bucket, item = self._prepare(image, orig_size)
        return self._submit(bucket, item, timeout, reference)

    def submit_path(self, path: str, timeout: Optional[float] = None) -> Future:
        """Load an image file, route it to its bucket, enqueue it."""
        from PIL import Image

        from replication_faster_rcnn_tpu_torch.data.voc import _load_image

        # the header gives the size without a decode, so the decode's resize
        # targets the bucket directly
        with Image.open(path) as im:
            orig_w, orig_h = im.size
        bucket = select_bucket(self.buckets, orig_h, orig_w, self.config.serving.oversize)
        image, orig_h, orig_w = _load_image(
            path, bucket, self.config.data.pixel_mean, self.config.data.pixel_std
        )
        return self._submit(
            bucket, (image, int(orig_h), int(orig_w), tracecontext.current_trace()), timeout
        )

    def _submit(self, bucket, entry, timeout: Optional[float], reference: bool = False
                ) -> Future:
        """Queue one request under the current version, with
        ``serving.request_timeout_s`` as its time to live; an admission
        rejection is counted as shed before it reaches the caller."""
        ttl = self.config.serving.request_timeout_s
        with self._version_lock:
            key = (self.model_version, bucket, bool(reference))
        try:
            return self._batcher.submit(
                key, entry, timeout=timeout, deadline_s=ttl if ttl > 0 else None
            )
        except queue_mod.Full:
            self._counters["shed"].inc()
            self.slo.record(False)
            raise

    def predict(self, images: Sequence[np.ndarray], reference: bool = False
                ) -> List[Dict[str, np.ndarray]]:
        """Resize every image first, then enqueue them back to back (so they
        coalesce into as few flushes as the batch sizes allow) and wait."""
        prepared = [self._prepare(img, None) for img in images]
        futures = [self._submit(bucket, item, None, reference) for bucket, item in prepared]
        return [f.result() for f in futures]

    def predict_paths(self, paths: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """Submit many paths (they coalesce into micro-batches) and wait."""
        futures = [self.submit_path(p) for p in paths]
        return [f.result() for f in futures]

    # ---------------------------------------------------------------- flush

    def _process_bucket(self, key, items):
        """One micro-batch against the version it was admitted under."""
        version, bucket, reference = key
        with self._version_lock:
            resident = self._resident.get(version)
        if resident is None:
            raise RuntimeError(
                f"model version {version!r} was retired with requests in "
                f"flight (resident: {sorted(self._resident)})"
            )
        try:
            out = self._process_bucket_inner(version, resident, bucket, reference, items)
            for _ in items:
                self.slo.record(True)
            return out
        except BaseException as e:  # noqa: BLE001 - recorded, then relayed
            with self._stats_lock:
                self._last_flush_error = f"{type(e).__name__}: {e}"
            for _ in items:
                self.slo.record(False)
            raise

    def _run_flush(self, version: str, resident: _Version, bucket, reference: bool,
                   items, bn: int) -> Dict[str, np.ndarray]:
        """The padded batch's detections as numpy [bn, ...] arrays."""
        h, w = bucket
        if self.capture and not reference:
            graph = self._graph(version, resident, bucket, bn)
            return graph([entry[0] for entry in items])
        batch = np.zeros((bn, h, w, 3), np.float32)
        for i, entry in enumerate(items):
            batch[i] = entry[0]
        out = resident.infer[bucket](torch.from_numpy(batch).to(self.device), reference)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _process_bucket_inner(self, version, resident, bucket, reference, items):
        h, w = bucket
        n = len(items)
        bn = next((b for b in self.batch_sizes if b >= n), self.batch_sizes[-1])
        name = self._serve_name(h, w, bn)
        tracer = tspans.current_tracer()
        t_dispatch = tracer.now_us()
        t_wall = time.perf_counter()
        with tracer.span("serve/flush", cat="serve", program=name, n=n, padded=bn - n,
                         model_version=version):
            out = self._run_flush(version, resident, bucket, reference, items, bn)
        flush_s = time.perf_counter() - t_wall
        self.flush_seconds.append(flush_s)
        self._flush_hist.observe(flush_s)
        self._counters["requests"].inc(n)
        self._counters["flushes"].inc()
        self._counters["padded_slots"].inc(bn - n)
        results = []
        for i, entry in enumerate(items):
            orig_h, orig_w = entry[1], entry[2]
            trace = entry[3] if len(entry) > 3 else None
            if trace is not None and tracer.enabled:
                # the per-request view of this flush, tagged with the
                # request's trace identity
                tracer.complete("serve/dispatch", t_dispatch, flush_s * 1e6, cat="serve",
                                program=name, **trace.span_args())
            back = np.asarray([orig_h / h, orig_w / w, orig_h / h, orig_w / w], np.float32)
            results.append(
                {
                    "boxes": out["boxes"][i] * back,
                    "scores": out["scores"][i].copy(),
                    "classes": out["classes"][i].copy(),
                    "valid": out["valid"][i].copy(),
                }
            )
        return results

    # ------------------------------------------------------------ lifecycle

    @property
    def flush_log(self) -> List[Tuple[Any, int]]:
        """((version, bucket, reference), n_requests) per flush, oldest first."""
        return self._batcher.flush_log

    def close(self) -> None:
        self._batcher.close()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# One-entry caches for repeated-call paths. The engine is keyed by (config,
# state dict identity, device): new weights get a fresh engine (and the
# displaced one's worker is shut down).
_cached_engine: Optional[InferenceEngine] = None
_cached_engine_key = None
_cached_evaluator: Optional[Evaluator] = None
_cached_evaluator_key = None
_cache_lock = threading.Lock()


def get_engine(config: FasterRCNNConfig, state_dict: Optional[dict] = None,
               warmup: bool = False, device: DeviceLike = None) -> InferenceEngine:
    """The cached engine for (config, state dict, device), built on first
    use. Config is value-hashable; the state dict keys by identity."""
    global _cached_engine, _cached_engine_key
    key = (config, id(state_dict), str(device))
    with _cache_lock:
        if _cached_engine is None or _cached_engine_key != key:
            if _cached_engine is not None:
                _cached_engine.close()
            _cached_engine = InferenceEngine(config, device=device, state_dict=state_dict,
                                             warmup=warmup)
            _cached_engine_key = key
        return _cached_engine


def get_evaluator(config: FasterRCNNConfig, model: Optional[FasterRCNN] = None,
                  device: DeviceLike = None) -> Evaluator:
    """The cached :class:`Evaluator` for (config, model, device), built on
    first use; the model keys by identity."""
    global _cached_evaluator, _cached_evaluator_key
    key = (config, id(model), str(device))
    with _cache_lock:
        if _cached_evaluator is None or _cached_evaluator_key != key:
            _cached_evaluator = Evaluator(config, model, device=device)
            _cached_evaluator_key = key
        return _cached_evaluator
