"""Heartbeat watchdog for wedged devices (a copy of the JAX package's
``telemetry/watchdog.py``, on the port's spans).

A process that stops making progress leaves no record of where it was.
This watchdog turns that into a recorded root cause: the training loop
calls :meth:`StallWatchdog.beat` once per step, a daemon thread checks
elapsed-since-beat against a timeout, and on a stall it appends a
diagnostic snapshot — last beat's step/phase, the
tracer's last-entered span, and whatever live gauges (prefetch queue
depth, ...) the caller registered — to a JSONL incident file.

Semantics are fire-then-recover, not fire-and-kill: a stall fires once
per episode, the next beat records a ``recovered`` incident and re-arms.
Killing the process is the *caller's* policy (the bench has its own
``os._exit`` guard); the watchdog's job is evidence.

A monotonic progress file (atomic replace) mirrors the latest beat to
disk so an *external* supervisor can check liveness without attaching to
the process.
"""

from __future__ import annotations

import json
import os
import threading
import time
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Optional

from replication_faster_rcnn_tpu_torch.telemetry.spans import NULL_TRACER


class StallWatchdog:
    """Daemon-thread stall detector.

    Args:
        timeout_s: elapsed-since-last-beat that counts as a stall.
        snapshot_path: JSONL file appended with stall/recovered incidents.
        progress_path: JSON file atomically rewritten on each beat.
        tracer: span tracer whose ``last_span`` goes into snapshots.
        providers: name → zero-arg callable of live gauges to sample at
            snapshot time (errors are captured per-provider, never raised
            — a snapshot of a sick process must not die on a sick gauge).
        on_stall: optional callback invoked with the snapshot dict.
        poll_s: check interval; defaults to ``timeout_s / 4`` capped to 5s.
        rank: process_index of a multi-process run — stamped on every
            incident and progress payload so merged per-rank incident
            streams stay attributable (None on single-process runs).
    """

    def __init__(
        self,
        timeout_s: float = 300.0,
        snapshot_path: Optional[str] = None,
        progress_path: Optional[str] = None,
        tracer: Any = NULL_TRACER,
        providers: Optional[Dict[str, Callable[[], Any]]] = None,
        on_stall: Optional[Callable[[Dict[str, Any]], None]] = None,
        poll_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        rank: Optional[int] = None,
    ):
        self.timeout_s = timeout_s
        self.rank = rank
        self.snapshot_path = snapshot_path
        self.progress_path = progress_path
        self.tracer = tracer
        self.providers: Dict[str, Callable[[], Any]] = dict(providers or {})
        self.on_stall = on_stall
        self.poll_s = poll_s if poll_s is not None else min(timeout_s / 4.0, 5.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_beat = self._clock()
        self._last_step: Optional[int] = None
        self._last_phase: Optional[str] = None
        self._beats = 0
        self._in_stall = False
        self.fired_count = 0
        self.recovered_count = 0
        self.last_snapshot: Optional[Dict[str, Any]] = None

    # -- heartbeat ---------------------------------------------------------

    def beat(self, step: Optional[int] = None, phase: Optional[str] = None) -> None:
        """Record progress. Called from the training loop, once per step
        (or per long operation like eval/checkpoint via ``phase``)."""
        now = self._clock()
        with self._lock:
            self._last_beat = now
            self._beats += 1
            if step is not None:
                self._last_step = step
            if phase is not None:
                self._last_phase = phase
            recovered = self._in_stall
            self._in_stall = False
        if recovered:
            self.recovered_count += 1
            self._record_incident(self.snapshot(reason="recovered"))
        self._write_progress()

    def _write_progress(self) -> None:
        if self.progress_path is None:
            return
        payload = {
            "utc": datetime.now(timezone.utc).isoformat(),
            "step": self._last_step,
            "phase": self._last_phase,
            "beats": self._beats,
            "pid": os.getpid(),
        }
        if self.rank is not None:
            payload["process_index"] = self.rank
        tmp = f"{self.progress_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.progress_path)
        except OSError:
            pass  # a full/readonly disk must not take down training

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._last_beat = self._clock()  # arm from start, not construction
        self._thread = threading.Thread(
            target=self._run, name="telemetry-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.poll_s * 2))
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                elapsed = self._clock() - self._last_beat
                should_fire = elapsed > self.timeout_s and not self._in_stall
                if should_fire:
                    self._in_stall = True
            if should_fire:
                self.fired_count += 1
                snap = self.snapshot(reason="stall", elapsed_s=elapsed)
                stacks = self._thread_stacks()
                if stacks is not None:
                    snap["threads"] = stacks
                with self._lock:  # raced by incident() on the main thread
                    self.last_snapshot = snap
                self._record_incident(snap)
                if self.on_stall is not None:
                    try:
                        self.on_stall(snap)
                    except Exception:
                        pass

    # -- diagnostics -------------------------------------------------------

    def incident(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Record a non-stall incident (nonfinite-skip escalation,
        preemption, checkpoint-save failure, abnormal exit, ...) in the
        same JSONL stream as stall snapshots: one file answers "what went
        wrong and where was the process when it did". ``fields`` are
        merged over the snapshot; the snapshot's standard keys win only
        for ``kind``."""
        snap = self.snapshot(reason=kind)
        for key, value in fields.items():
            if key != "kind":
                snap[key] = value
        with self._lock:  # raced by the watchdog thread's stall path
            self.last_snapshot = snap
        self._record_incident(snap)
        return snap

    def snapshot(self, reason: str = "manual", elapsed_s: Optional[float] = None) -> Dict[str, Any]:
        """Diagnostic snapshot: what was the process doing, and for how
        long has it not moved."""
        with self._lock:
            elapsed = elapsed_s if elapsed_s is not None else self._clock() - self._last_beat
            snap: Dict[str, Any] = {
                "kind": reason,
                "utc": datetime.now(timezone.utc).isoformat(),
                "elapsed_since_progress_s": round(elapsed, 3),
                "timeout_s": self.timeout_s,
                "last_step": self._last_step,
                "last_phase": self._last_phase,
                "beats": self._beats,
                "pid": os.getpid(),
            }
            if self.rank is not None:
                snap["process_index"] = self.rank
        try:
            snap["last_span"] = self.tracer.last_span
        except Exception as e:  # pragma: no cover - defensive
            snap["last_span"] = f"error: {e!r}"
        gauges: Dict[str, Any] = {}
        for name, fn in self.providers.items():
            try:
                gauges[name] = fn()
            except Exception as e:
                gauges[name] = f"error: {e!r}"
        if gauges:
            snap["gauges"] = gauges
        return snap

    @staticmethod
    def _thread_stacks() -> Optional[list]:
        """All-thread tracebacks as a list of lines, so a hung prefetch or
        serving thread is diagnosable from the incident file post-mortem.
        Uses faulthandler (C-level frame walk, no per-thread cooperation
        needed) through a spooled temp file — it only writes to fds."""
        try:
            import faulthandler
            import tempfile

            with tempfile.TemporaryFile(mode="w+") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
                f.seek(0)
                return f.read().rstrip("\n").split("\n")
        except Exception:  # pragma: no cover - diagnostics must not raise
            return None

    def _record_incident(self, snap: Dict[str, Any]) -> None:
        if self.snapshot_path is None:
            return
        try:
            with open(self.snapshot_path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        except OSError:
            pass
