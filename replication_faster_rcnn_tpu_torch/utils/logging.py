"""Structured scalar logging (a copy of the JAX package's ``utils/logging.py``).

Plain-text structured lines on a stream, and an optional JSONL sink
(``jsonl_path``) for machine consumption: ``log`` writes step rows,
``event`` out-of-band run events (``checkpoint_save_failed``,
``checkpoint_fallback``, ``preempted``, ``nonfinite_escalation``),
``log_epoch`` an epoch's throughput.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO


def _fmt(v: Any) -> str:
    try:
        return f"{float(v):.4g}"
    except (TypeError, ValueError):
        return str(v)


def _jsonable(v: Any) -> Any:
    """json.dumps ``default``: numpy and torch scalars → Python numbers, anything
    else → repr, so one odd metric value cannot kill the logging path."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class MetricLogger:
    def __init__(
        self,
        stream: Optional[TextIO] = None,
        jsonl_path: Optional[str] = None,
    ):
        # None = resolve sys.stdout at write time: a default bound at import
        # time pins whatever stdout was then (stale under redirection)
        self._stream = stream
        self.jsonl_path = jsonl_path
        self._t0 = time.time()

    @property
    def stream(self) -> TextIO:
        return self._stream if self._stream is not None else sys.stdout

    def _write_jsonl(self, record: Dict) -> None:
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record, default=_jsonable) + "\n")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        parts = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(metrics.items()))
        self.stream.write(f"[step {step:>6}] {parts}\n")
        self.stream.flush()
        self._write_jsonl({"step": step, "t": time.time() - self._t0, **metrics})

    def event(self, kind: str, **fields) -> None:
        """Out-of-band run event (stall, recovery, ...) — one stream line
        plus a ``{"event": kind, ...}`` JSONL row, distinguishable from
        step rows by the absence of a ``step`` key."""
        parts = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(fields.items()))
        self.stream.write(f"[event {kind}] {parts}\n")
        self.stream.flush()
        self._write_jsonl({"event": kind, "t": time.time() - self._t0, **fields})

    def log_epoch(self, epoch: int, images_per_sec: float) -> None:
        self.stream.write(
            f"[epoch {epoch:>3}] throughput={images_per_sec:.2f} images/sec\n"
        )
        self.stream.flush()
        self._write_jsonl({"epoch": epoch, "images_per_sec": images_per_sec})
