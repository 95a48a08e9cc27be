"""Training orchestration (counterpart of the JAX package's ``train/trainer.py``):
one process, one device, the loader's seeded per-epoch order, one
:func:`make_train_step` call per batch, and the fault-tolerance loop around
it: ``train.n_epoch`` epochs with log-boundary metric checks and
consecutive-skip escalation, scheduled saves every
``train.checkpoint_every_epochs`` epochs and every
``train.checkpoint_every_steps`` steps (on a background writer with
``train.async_checkpoint``), the val-split evaluation every
``train.eval_every_epochs`` epochs, a verified emergency save and
:class:`~replication_faster_rcnn_tpu_torch.train.fault.Preempted` on
SIGTERM/SIGINT, and an exact resume from the newest checkpoint that
verifies.

With a ``telemetry_dir`` the trainer also records what the JAX trainer
records there: a span tracer (``trace.json``, installed process-wide so the
loader's and evaluator's spans land in it too), the metric rows as JSONL
(``metrics.jsonl``) and a stall watchdog (``watchdog.jsonl`` with stall and
fault incidents, ``progress.json`` with the last heartbeat);
``telemetry/report.py`` summarises the directory. The spans carry the JAX
trainer's names: ``step/dispatch``, ``data/fetch``, ``data/device_put``,
``step/sync``, ``checkpoint/{save,snapshot,manifest,restore}``,
``state/host_fetch`` and ``eval/evaluate``. As in the JAX trainer, a step
returns device metrics and the host reads them only at a log boundary
(``step/sync``), at an epoch's end (``step/sync`` with ``boundary="epoch"``)
and where the skip monitor drains (``fault/skip_drain``). Telemetry reads
the clock and writes files; it never touches the state, so a run with it is
bitwise the run without.

On the card every step is a replay of a CUDA graph
(``train_step.CapturedSteps``), and with ``train.steps_per_dispatch`` = K
one replay trains K steps (:meth:`Trainer.train_chunk`); an epoch's tail of
fewer than K batches goes through the one-step graph.

The feed is the JAX trainer's. With ``data.cache_device`` the dataset is
uploaded to the card once (``data/device_cache.py::DeviceCache``) and a
``CachedSampler`` yields per-step selections (indices, flip bits, jitter
geometry), which the cached step materializes on the card; otherwise the
loader yields host batches, augmented on the host or tagged for the step's
on-card augmentation (``data.augment_*``). A batch is staged from a ring of
pinned host buffers with a non-blocking copy on the step's stream (no wait
for the card); with ``data.prefetch_device`` = D a producer thread
(``data/prefetch_device.py::DevicePrefetcher``) stages up to D batches (or
K-batch chunks) ahead on a copy stream of its own, and the step's stream
waits on each copy's event. With ``data.train_resolutions`` each dispatch
trains at the bucket its feed assigns (``bucket_of``), through that bucket's
graph.

A checkpoint holds the whole state a step reads: the parameters and
BatchNorm statistics (``model.state_dict()``), the optimizer's moments and
count (``optimizer.state_dict()``: ``mu``, ``nu``, ``count``; the count
is the schedule's position), the sampling generator's state and the step
count. A resumed run therefore repeats the uninterrupted run's steps bit
for bit. A checkpoint of the earlier ``torch.optim.Adam`` + ``LambdaLR``
layout is refused with a message that says so.

With ``data.loader_mode="process"`` the loader builds batches in forked
worker processes (``data/loader.py``); the loader's sample-fault
containment runs in both modes.

Not ported yet: the mesh and data parallelism, the checkpoint and prefetch
failpoints and the pretrained-backbone graft.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.data.loader import DataLoader, make_dataset
from replication_faster_rcnn_tpu_torch.data.prefetch_device import (
    STAGED,
    DevicePrefetcher,
    PinnedStager,
    consume,
)
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
from replication_faster_rcnn_tpu_torch.telemetry.watchdog import StallWatchdog
from replication_faster_rcnn_tpu_torch.train import fault
from replication_faster_rcnn_tpu_torch.train.async_checkpoint import AsyncCheckpointWriter
from replication_faster_rcnn_tpu_torch.train.train_step import (
    TrainState,
    create_train_state,
    host_schedule,
    make_cached_train_step,
    make_train_step,
    step_keys,
)
from replication_faster_rcnn_tpu_torch.utils.logging import MetricLogger

Tensor = torch.Tensor


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are host copies (never views: the
    optimizer updates the live tensors in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def load_eval_variables(
    config: FasterRCNNConfig,
    workdir: str,
    step: Optional[int] = None,
    device: DeviceLike = None,
) -> FasterRCNN:
    """The model for inference: the seeded init, then the newest (or the
    given) checkpoint in ``workdir`` that verifies, if there is one. Needs
    no train split and no optimizer; deletes nothing."""
    dev = resolve_device(device)
    model = build_model(config, device=dev, seed=config.train.seed)
    if os.path.isdir(workdir):
        store = fault.CheckpointStore(workdir, create=False, map_location=dev)
        if store.all_steps():
            with tspans.current_tracer().span("checkpoint/restore", cat="checkpoint"):
                result = fault.verified_restore(store, store.directory, step=step)
            if result.state is not None:
                model.load_state_dict(result.state["model"])
    return model.eval()


class Trainer:
    """``Trainer(config, dataset=None, device=None, seed=None,
    workdir="checkpoints", telemetry_dir=None, stall_timeout_s=300.0)``:
    ``dataset`` defaults to ``make_dataset(config.data, "train")``; the
    device defaults to ``cuda`` (raising without a GPU); ``seed`` (default
    ``config.train.seed``) seeds the weights, the sampling generator and the
    shuffle; checkpoints go to ``workdir``; ``telemetry_dir`` turns on the
    span trace, the JSONL metrics and the stall watchdog (which counts
    ``stall_timeout_s`` seconds without a heartbeat as a stall)."""

    def __init__(
        self,
        config: FasterRCNNConfig,
        dataset=None,
        device: DeviceLike = None,
        seed: Optional[int] = None,
        workdir: str = "checkpoints",
        telemetry_dir: Optional[str] = None,
        stall_timeout_s: float = 300.0,
    ):
        self.config = config
        self.workdir = workdir
        self.device = resolve_device(device)
        self.seed = config.train.seed if seed is None else int(seed)
        # The skip monitor and the watchdog hold the trainer weakly: a
        # reference cycle would keep a dropped trainer's device memory until
        # the garbage collector ran
        trainer = weakref.ref(self)

        # --- telemetry: span tracer + JSONL metrics + stall watchdog. With
        # no telemetry_dir everything collapses to no-ops (the NULL tracer's
        # spans, a stream-only logger, no watchdog thread)
        self.telemetry_dir = telemetry_dir
        self.watchdog: Optional[StallWatchdog] = None
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            self.tracer = tspans.SpanTracer(
                os.path.join(telemetry_dir, "trace.json"),
                max_events=config.telemetry.trace_max_events,
            )
            # installed process-wide, so the loader's and the evaluator's
            # span call sites (which take no tracer parameter) attach here
            tspans.set_tracer(self.tracer)
            self.logger = MetricLogger(jsonl_path=os.path.join(telemetry_dir, "metrics.jsonl"))
            self.watchdog = StallWatchdog(
                timeout_s=stall_timeout_s,
                snapshot_path=os.path.join(telemetry_dir, "watchdog.jsonl"),
                progress_path=os.path.join(telemetry_dir, "progress.json"),
                tracer=self.tracer,
                on_stall=lambda snap: trainer().logger.event(
                    "stall",
                    elapsed_s=snap.get("elapsed_since_progress_s"),
                    last_step=snap.get("last_step"),
                    last_phase=snap.get("last_phase"),
                ),
            )
        else:
            self.tracer = tspans.NULL_TRACER
            self.logger = MetricLogger()
        # consecutive-skip escalation for the guarded update's `skipped`
        # flags, and the dispatch-boundary shutdown flag train() installs
        self.skip_monitor = fault.SkipMonitor(
            policy=config.train.nonfinite_policy,
            max_consecutive=config.train.max_consecutive_skips,
            on_escalate=lambda kind, **fields: trainer()._fault_incident(kind, **fields),
        )
        self._shutdown: Optional[fault.GracefulShutdown] = None
        self.dataset = dataset if dataset is not None else make_dataset(config.data, "train")
        self.batch_size = config.train.batch_size
        if len(self.dataset) < self.batch_size:
            raise ValueError(
                f"the dataset holds {len(self.dataset)} samples, fewer than one batch of "
                f"{self.batch_size}"
            )
        data = config.data
        bucket_chunk = max(1, config.train.steps_per_dispatch)
        self.device_cache = None
        self.sampler = None
        self.loader = None
        if data.cache_device:
            # the dataset lives on the card; the host ships selections only
            from replication_faster_rcnn_tpu_torch.data.device_cache import (
                CachedSampler,
                DeviceCache,
            )

            self.device_cache = DeviceCache(self.dataset, device=self.device)
            self.sampler = CachedSampler(
                len(self.dataset), self.device_cache.image_hw, batch_size=self.batch_size,
                seed=self.seed, hflip=data.augment_hflip, scale_range=data.augment_scale,
                train_resolutions=data.train_resolutions, bucket_chunk=bucket_chunk,
            )
            self.feed = self.sampler
        else:
            self.loader = DataLoader(
                self.dataset,
                batch_size=self.batch_size,
                shuffle=True,
                seed=self.seed,
                prefetch=data.loader_prefetch,
                num_workers=data.loader_workers,
                worker_mode=data.loader_mode,
                augment_hflip=data.augment_hflip,
                augment_scale=data.augment_scale,
                augment_scale_device=data.augment_scale_device,
                augment_device=data.augment_device,
                augment_translate=data.augment_translate,
                cache_ram=data.loader_cache_ram,
                train_resolutions=data.train_resolutions,
                bucket_chunk=bucket_chunk,
            )
            self.feed = self.loader
        self.steps_per_epoch = len(self.feed)  # the tail is dropped
        self.state: TrainState = create_train_state(
            config, self.steps_per_epoch, self.device, self.seed)
        if self.device_cache is not None:
            self.step_fn = make_cached_train_step(config, self.device_cache.arrays)
        else:
            self.step_fn = make_train_step(config)
        self._bucket_resolutions = tuple(data.train_resolutions)
        # pinned staging: one stager for the trainer's thread, one for the
        # prefetch producer's
        self._stager = PinnedStager(self.device)
        self._prefetch_stager = PinnedStager(self.device)
        self.steps_per_dispatch = config.train.steps_per_dispatch
        self.host_schedule = host_schedule(config, self.steps_per_epoch)
        self._ckpt_mgr: Optional[fault.CheckpointStore] = None
        self._last_step_ckpt = 0
        self._evaluator = None
        self._val_dataset = None
        self._async_writer: Optional[AsyncCheckpointWriter] = None
        if config.train.async_checkpoint:
            self._async_writer = AsyncCheckpointWriter()

    @property
    def model(self) -> FasterRCNN:
        return self.state.model

    # ---------------------------------------------------------- checkpoints

    @property
    def checkpoint_manager(self) -> fault.CheckpointStore:
        if self._ckpt_mgr is None:
            self._ckpt_mgr = fault.CheckpointStore(
                self.workdir, max_to_keep=3, create=True, map_location=self.device)
        return self._ckpt_mgr

    def _host_state(self) -> Dict[str, Any]:
        """The whole state, copied to host memory: plain containers of
        tensors and Python scalars."""
        st = self.state
        with self.tracer.span("state/host_fetch", cat="sync"):
            return _to_host({
                "model": st.model.state_dict(),
                "optimizer": st.optimizer.state_dict(),
                "generator": st.generator.get_state(),
                "generator_device": st.generator.device.type,
                "step": st.step,
            })

    def _load_state(self, tree: Dict[str, Any]) -> None:
        """Put a restored tree into the live state (in place: the optimizer
        keeps its parameters)."""
        st = self.state
        saved_kind, kind = tree["generator_device"], st.generator.device.type
        if saved_kind != kind:
            raise ValueError(
                f"the checkpoint's sampling generator is a {saved_kind} generator and this "
                f"trainer's is a {kind} one: a generator's state restores only onto the "
                "device kind that saved it"
            )
        st.optimizer.load_state_dict(tree["optimizer"])  # refuses another layout first
        st.model.load_state_dict(tree["model"])
        st.generator.set_state(tree["generator"].cpu())
        st.step = int(tree["step"])

    def _fault_incident(self, kind: str, **fields) -> None:
        """Record a fault event in the metric stream and, with telemetry, in
        the watchdog's incident log."""
        self.logger.event(kind, **fields)
        if self.watchdog is not None:
            self.watchdog.incident(kind, **fields)

    def _handle_async_error(self, err) -> None:
        """Containment for a failed background scheduled save, surfaced at
        a drain point: a stderr warning and an incident; training goes on
        and the next interval retries. Never raises."""
        if err is None:
            return
        err_step, exc = err
        print(
            f"warning: async scheduled checkpoint at step {err_step} failed "
            f"({type(exc).__name__}: {exc}); training continues",
            file=sys.stderr,
        )
        self._fault_incident(
            "checkpoint_save_failed",
            step=err_step,
            ckpt_kind="scheduled",
            writer="async",
            error=f"{type(exc).__name__}: {exc}"[:300],
        )

    def _drain_async_saves(self) -> None:
        """Wait out an in-flight background save (handling its error).
        Called before every synchronous save, before restore and at
        train()'s exit, so the store is never touched from two threads."""
        if self._async_writer is not None:
            self._handle_async_error(self._async_writer.wait())

    def _save_async(self, step: int) -> bool:
        """Scheduled save through the background writer: the trainer thread
        pays only the host snapshot; ``torch.save``, the manifest and the
        prune run on the writer thread. Blocks only while the previous save
        is in flight."""
        writer = self._async_writer
        self._handle_async_error(writer.wait())
        try:
            # the writer is drained, so a save at `step` that succeeded is
            # the latest step; a failed one is not, and is retried here
            if self.checkpoint_manager.latest_step() == step:
                return True
            with self.tracer.span("checkpoint/snapshot", cat="checkpoint", step=step):
                snapshot = self._host_state()
        except Exception as e:
            print(
                f"warning: scheduled checkpoint at step {step} failed "
                f"({type(e).__name__}: {e}); training continues",
                file=sys.stderr,
            )
            self._fault_incident(
                "checkpoint_save_failed",
                step=step,
                ckpt_kind="scheduled",
                writer="async",
                error=f"{type(e).__name__}: {e}"[:300],
            )
            return False

        mgr, workdir, config = self.checkpoint_manager, self.workdir, self.config
        tracer = self.tracer

        def _write() -> None:
            mgr.save(step, snapshot)
            mgr.wait_until_finished()
            with tracer.span("checkpoint/manifest", cat="checkpoint"):
                fault.write_manifest(workdir, step, snapshot, config, kind="scheduled",
                                     writer="async")
            # the rollout feed announces the version once its manifest is durable
            fault.publish_manifest_event(workdir, step, kind="scheduled", writer="async")
            fault.prune_manifests(workdir, mgr.all_steps())

        self._handle_async_error(writer.submit(step, _write))
        return True

    def save(
        self,
        step: Optional[int] = None,
        kind: str = "scheduled",
        required: Optional[bool] = None,
    ) -> bool:
        """Checkpoint the whole state, with a sidecar manifest (step, config
        hash, per-leaf CRC32s, save ``kind``) that :meth:`restore` verifies.

        A ``scheduled`` save that fails is contained: an incident and a
        warning, training goes on and the next interval retries.
        ``emergency``/``final`` saves (or ``required=True``) raise: they are
        the last chance to persist anything. Returns True when a checkpoint
        for ``step`` is on disk (for an async scheduled save: submitted to
        the background writer).

        With ``train.async_checkpoint`` scheduled saves go through
        :meth:`_save_async`; the others stay synchronous and first drain
        the writer."""
        if required is None:
            required = kind in ("emergency", "final")
        step = self.state.step if step is None else step
        if self._async_writer is not None and kind == "scheduled" and not required:
            return self._save_async(step)
        self._drain_async_saves()  # the store must be quiet first
        try:
            mgr = self.checkpoint_manager
            if mgr.latest_step() == step:
                return True  # already checkpointed
            host_state = self._host_state()
            mgr.save(step, host_state)
            mgr.wait_until_finished()
            with self.tracer.span("checkpoint/manifest", cat="checkpoint"):
                fault.write_manifest(self.workdir, step, host_state, self.config, kind=kind)
            fault.publish_manifest_event(self.workdir, step, kind=kind, writer="sync")
            fault.prune_manifests(self.workdir, mgr.all_steps())
        except Exception as e:
            if required:
                raise
            print(
                f"warning: {kind} checkpoint at step {step} failed "
                f"({type(e).__name__}: {e}); training continues",
                file=sys.stderr,
            )
            self._fault_incident(
                "checkpoint_save_failed",
                step=step,
                ckpt_kind=kind,
                error=f"{type(e).__name__}: {e}"[:300],
            )
            return False
        return True

    def restore(self, step: Optional[int] = None, directory: Optional[str] = None) -> int:
        """Exact resume: parameters, BatchNorm statistics, Adam state,
        schedule, generator and step, manifest-verified, falling back to
        the newest step that verifies when the latest is torn
        (:func:`fault.verified_restore`). Discarded steps are logged,
        recorded as an incident and deleted from this trainer's own store.
        A step directory of another format (an orbax checkpoint) raises
        :class:`fault.ForeignCheckpointError` and is left alone. Returns
        the restored step (0 when there is no checkpoint).

        ``directory`` restores from another checkpoint directory without
        changing where this trainer saves (a warm start; read-only there)."""
        self._drain_async_saves()  # never read a store mid-write
        ephemeral = directory is not None
        if ephemeral:
            mgr = fault.CheckpointStore(directory, create=False, map_location=self.device)
        else:
            mgr = self.checkpoint_manager
        if not mgr.all_steps():
            return 0
        with self.tracer.span("checkpoint/restore", cat="checkpoint"):
            result = fault.verified_restore(mgr, mgr.directory, step=step)
        if result.discarded:
            if not ephemeral:
                for bad_step, _ in result.discarded:
                    try:
                        mgr.delete(bad_step)
                    except OSError:
                        pass  # a torn step may resist deletion too
            self._fault_incident(
                "checkpoint_fallback",
                restored_step=result.step,
                discarded={s: why for s, why in result.discarded},
            )
        if result.state is None:
            return 0
        self._load_state(result.state)
        return self.state.step

    # ---------------------------------------------------------------- train

    def _feed_name(self) -> str:
        return "device_cache" if self.device_cache is not None else "loader"

    def stage_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Tensor]:
        """Host batch (or cache selection) -> the step's device tensors: the
        keys the step reads, copied from a pinned buffer without waiting for
        the card (``data/device_put``)."""
        with self.tracer.span("data/device_put", cat="data", feed=self._feed_name()):
            staged, _ = self._stager.stage({k: batch[k] for k in step_keys(batch)})
            return staged

    def _stage_ahead(self, batches):
        """The prefetch producer's staging of one dispatch's batches (K
        stacked on a new leading axis when K > 1): the copy lands before
        this returns; the consumer calls ``prefetch_device.consume``."""
        keys = step_keys(batches[0])
        if len(batches) == 1:
            host, extra = {k: batches[0][k] for k in keys}, {}
        else:
            host, extra = {k: np.stack([b[k] for b in batches]) for k in keys}, {"steps": len(batches)}
        with self.tracer.span("data/device_put", cat="data", feed=self._feed_name(), **extra):
            return self._prefetch_stager.stage(host, wait=True)

    def _resolution(self, bucket: Optional[int]):
        if bucket is None or not self._bucket_resolutions:
            return None
        return self._bucket_resolutions[bucket]

    def train_one_batch(
        self,
        batch: Optional[Dict[str, np.ndarray]] = None,
        staged: Optional[Dict[str, Tensor]] = None,
        bucket: Optional[int] = None,
        **step_kw,
    ) -> Dict[str, Tensor]:
        """One optimizer step on a host ``batch`` (staged here) or an
        already staged device batch; ``bucket`` picks a
        ``data.train_resolutions`` bucket (None: the base canvas). Returns
        the metrics as device tensors (no host read) and hands the
        ``skipped`` flag to the skip monitor, which raises
        :class:`fault.NonFiniteEscalation` at once under
        ``nonfinite_policy='halt'``. ``step_kw`` passes through to the step
        (``draws``, ``record``, ``stage``)."""
        if staged is None:
            staged = self.stage_batch(batch)
        with self.tracer.span("step/dispatch", cat="step"):
            metrics = self.step_fn(self.state, staged, resolution=self._resolution(bucket),
                                   **step_kw)
        self.skip_monitor.observe(self.state.step, metrics)
        return metrics

    def train_chunk(self, batches=None, staged=None, bucket: Optional[int] = None
                    ) -> Dict[str, Tensor]:
        """``steps_per_dispatch`` steps in one dispatch (one CUDA graph
        replay on the card) on exactly that many host ``batches`` (or staged
        device batches: a list, or one dict stacked on a leading [K] axis).
        Returns stacked [K] device metrics."""
        k = self.steps_per_dispatch
        if staged is None:
            if len(batches) != k:
                raise ValueError(
                    f"train_chunk got {len(batches)} batches; a dispatch trains "
                    f"steps_per_dispatch={k}")
            staged = [self.stage_batch(b) for b in batches]
        elif isinstance(staged, dict):
            staged = [{key: v[i] for key, v in staged.items()} for i in range(k)]
        with self.tracer.span("step/dispatch", cat="step", steps=k):
            metrics = self.step_fn.chunk(self.state, staged, resolution=self._resolution(bucket))
        self.skip_monitor.observe(self.state.step - k + 1, metrics)  # stacked [K] flags
        return metrics

    def _host_metrics(self, metrics: Dict[str, Tensor]) -> Dict[str, np.ndarray]:
        """The metrics on the host: one copy of the stacked vector they view."""
        with self.tracer.span("step/sync", cat="sync"):
            stacked = torch.stack(list(metrics.values()), dim=-1).cpu().numpy()
        return {k: stacked[..., i] for i, k in enumerate(metrics)}

    def flush_telemetry(self) -> None:
        """Write the trace file and stop the watchdog. For callers driving
        :meth:`train_one_batch` directly without :meth:`telemetry_session`."""
        if self.watchdog is not None:
            self.watchdog.stop()
        self.tracer.flush()

    @contextlib.contextmanager
    def telemetry_session(self):
        """The watchdog running inside; on ANY exit the tracer flushed and
        the watchdog stopped, and a crash, an interrupt or a preemption
        first recorded as an ``abnormal_exit`` incident, so a post-mortem
        does not start from a silently truncated trace."""
        if self.watchdog is not None:
            self.watchdog.providers.setdefault("loader_queue_depth", self.feed.queue_depth)
            self.watchdog.start()
        try:
            yield self
        except BaseException as e:
            if self.watchdog is not None:
                self.watchdog.incident("abnormal_exit", error=f"{type(e).__name__}: {e}"[:500])
            raise
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
            self.tracer.flush()

    def _check_preemption(self, step: int) -> None:
        """Dispatch-boundary shutdown check: on a pending SIGTERM/SIGINT,
        save a verified emergency checkpoint, record the incident and leave
        through :class:`fault.Preempted` (exit code ``fault.EXIT_PREEMPTED``)."""
        sd = self._shutdown
        if sd is None or not sd.requested:
            return
        reason = sd.reason or "signal"
        self._fault_incident("preempted", step=step, reason=reason)
        self.save(kind="emergency")
        raise fault.Preempted(step, reason)

    def _maybe_step_checkpoint(self, step: int) -> None:
        """Scheduled save every ``train.checkpoint_every_steps`` optimizer
        steps (0 = epoch-boundary saves only)."""
        every = self.config.train.checkpoint_every_steps
        if not every or step - self._last_step_ckpt < every:
            return
        self._last_step_ckpt = step
        if self.watchdog is not None:
            self.watchdog.beat(phase="checkpoint")
        with self.tracer.span("checkpoint/save", cat="checkpoint", boundary="step"):
            self.save()

    def evaluate(self, max_images: Optional[int] = None) -> Dict[str, Any]:
        """mAP on the val split with the current training weights. The val
        dataset and the evaluator are built once."""
        if self._evaluator is None:
            from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator

            self._val_dataset = make_dataset(self.config.data, "val")
            self._evaluator = Evaluator(self.config, device=self.device)
        with self.tracer.span("eval/evaluate", cat="eval"):
            return self._evaluator.evaluate(
                self.model, self._val_dataset, batch_size=self.config.train.batch_size,
                max_images=max_images,
            )

    def _log_step(self, step: int, metrics: Dict[str, Tensor],
                  log_every: int) -> Optional[Dict[str, float]]:
        """At a log boundary: read the metrics on the host (``step/sync``),
        check them (fail fast on NaN/Inf unless the guarded update withheld
        the step), log them and drain the skip monitor. Returns the logged
        row, or None off the boundary."""
        if step % log_every != 0:
            return None
        row = fault.check_step_metrics(self._host_metrics(metrics), step)
        row["lr"] = self.host_schedule(step)
        self.logger.log(step, row)
        self.skip_monitor.drain()
        return row

    def _log_chunk(self, first: int, step: int, metrics: Dict[str, Tensor],
                   log_every: int) -> Optional[Dict[str, float]]:
        """Chunk-aware cadence: read the stacked [K] metrics only when a log
        boundary falls inside [``first``, ``step``], and log that boundary's
        own row. Returns the logged row, or None."""
        boundary = (step // log_every) * log_every
        if boundary < first:
            return None
        host = self._host_metrics(metrics)
        row = {k: v[boundary - first] for k, v in host.items()}
        row = fault.check_step_metrics(row, boundary)
        row["lr"] = self.host_schedule(boundary)
        self.logger.log(boundary, row)
        self.skip_monitor.drain()
        return row

    def _sync_epoch(self) -> None:
        """The epoch boundary's wait for the card, for an honest epoch rate."""
        with self.tracer.span("step/sync", cat="sync", boundary="epoch"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def train(self, log_every: int = 10, resume: bool = False) -> Dict[str, float]:
        """Run ``train.n_epoch`` epochs (the cosine schedule was built from
        it), from the newest verified checkpoint with ``resume``. Returns
        the last logged row merged with the last evaluation's scalars."""
        from replication_faster_rcnn_tpu_torch.eval.evaluator import summary_scalars

        cfg = self.config.train
        start_step = self.restore() if resume else 0
        steps_per_epoch = self.steps_per_epoch
        start_epoch = start_step // steps_per_epoch
        # a mid-epoch resume (emergency and step-interval checkpoints land
        # anywhere) starts the epoch's order at its first untrained batch
        replay = start_step - start_epoch * steps_per_epoch
        step = start_step
        self._last_step_ckpt = start_step
        last: Dict[str, float] = {}
        eval_result: Dict[str, float] = {}
        tracer = self.tracer
        k = self.steps_per_dispatch
        feed = self.feed
        prefetch = self.config.data.prefetch_device
        epoch = start_epoch

        def cur_bucket() -> Optional[int]:
            # the bucket of the next batch to train: a pure function of
            # (seed, epoch, position in the epoch), so a resume replays it;
            # the K batches of one dispatch share it (bucket_chunk = K)
            if not self._bucket_resolutions:
                return None
            return feed.bucket_of(step - epoch * steps_per_epoch)

        def images_of(batch) -> int:
            return batch["idx" if "idx" in batch else "image"].shape[0]

        def finish(row) -> None:
            """After a dispatch: beat, keep the logged row, check for
            preemption and step-interval saves."""
            nonlocal last
            if self.watchdog is not None:
                self.watchdog.beat(step=step, phase="train")
            if row is not None:
                last = row
            self._check_preemption(step)
            self._maybe_step_checkpoint(step)

        def dispatch(group) -> int:
            """Train one dispatch of host batches (K through the K-step
            graph, or one) and log at a boundary inside it. Returns the
            images trained."""
            nonlocal step
            if len(group) > 1:
                metrics = self.train_chunk(group, bucket=cur_bucket())
                first, step = step + 1, step + len(group)
                row = self._log_chunk(first, step, metrics, log_every)
            else:
                metrics = self.train_one_batch(group[0], bucket=cur_bucket())
                step += 1
                row = self._log_step(step, metrics, log_every)
            finish(row)
            return sum(images_of(b) for b in group)

        def dispatch_staged(item) -> int:
            """Train one staged prefetch item (one batch, or a stacked
            K-batch chunk)."""
            nonlocal step
            staged = consume(item[1])
            if item[2] > 1:
                metrics = self.train_chunk(staged=staged, bucket=cur_bucket())
                first, step = step + 1, step + item[2]
                row = self._log_chunk(first, step, metrics, log_every)
            else:
                metrics = self.train_one_batch(staged=staged, bucket=cur_bucket())
                step += 1
                row = self._log_step(step, metrics, log_every)
            finish(row)
            return item[3]

        self._shutdown = fault.GracefulShutdown()
        # Exits run inside out: the signal handlers are restored first, then
        # the background writer drains (a hung write still has the watchdog
        # over it, and its spans reach the trace), then the watchdog stops
        # and the trace is written
        with self.telemetry_session():
            try:
                with self._shutdown:
                    for epoch in range(start_epoch, cfg.n_epoch):
                        feed.set_epoch(epoch, start_batch=replay)
                        replay = 0
                        t_epoch = time.time()
                        n_images = 0
                        if prefetch > 0:
                            # a producer thread stages the next batches (or
                            # K-batch chunks) while this one trains; the
                            # epoch's tail of fewer than K comes back as host
                            # batches for the one-step graph
                            stager = DevicePrefetcher(iter(feed), self._stage_ahead,
                                                      depth=prefetch, chunk=k)
                            if self.watchdog is not None:
                                self.watchdog.providers["staged_queue_depth"] = (
                                    stager.queue_depth)
                            try:
                                for item in stager:
                                    if item[0] == STAGED:
                                        n_images += dispatch_staged(item)
                                    else:
                                        n_images += dispatch([item[1]])
                            finally:
                                # drops staged-but-untrained items; a resume
                                # regenerates them from the feed
                                stager.close()
                        else:
                            chunk = []  # pending batches of a partial dispatch
                            # closed on any exit: the loader's producer thread stops with it
                            with contextlib.closing(iter(feed)) as batches:
                                while True:
                                    # host-side batch production: the feed half
                                    # of feed-vs-compute
                                    with tracer.span("data/fetch", cat="data"):
                                        batch = next(batches, None)
                                    if batch is None:
                                        break
                                    chunk.append(batch)
                                    if len(chunk) == k:
                                        n_images += dispatch(chunk)
                                        chunk = []
                            # the epoch's tail of fewer than K batches: one step each
                            for batch in chunk:
                                n_images += dispatch([batch])
                        self._sync_epoch()
                        self.skip_monitor.drain()
                        dt = time.time() - t_epoch
                        self.logger.log_epoch(epoch, n_images / dt if dt > 0 else 0.0)
                        if cfg.eval_every_epochs and (epoch + 1) % cfg.eval_every_epochs == 0:
                            if self.watchdog is not None:
                                self.watchdog.beat(phase="eval")
                            # the flat scalar schema of the voc and coco metrics
                            eval_result = summary_scalars(
                                self.evaluate(), self.config.model.num_classes)
                            self.logger.log(step, eval_result)
                        if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                            if self.watchdog is not None:
                                self.watchdog.beat(phase="checkpoint")
                            with tracer.span("checkpoint/save", cat="checkpoint"):
                                self.save()  # scheduled: a failure is contained
                        self._check_preemption(step)
            finally:
                self._shutdown = None
                # the last scheduled save is on disk before train() returns
                self._drain_async_saves()
        last = {k: float(v) for k, v in last.items()}
        last.update(eval_result)  # merged last: step rows cannot wipe it
        return last
