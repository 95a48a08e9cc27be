"""Overload-hardening primitives for the serving tier (a copy of the JAX
package's ``serving/overload.py``).

The HTTP front-end turns these into its response contract:

* **Admission control** — the engine submits with ``timeout=0`` against
  the bounded micro-batch queue; ``queue.Full`` becomes **503** with a
  ``Retry-After`` hint instead of a blocked handler thread. Under 2x
  capacity the tier sheds load; it never queues unboundedly or hangs.
* **Per-request deadlines** (``serving.request_timeout_s``) — a request
  carries an absolute deadline from submit time. The handler's future
  wait times out to **504**; entries whose deadline passed while they
  waited in the queue are dropped AT FLUSH TIME with
  :class:`DeadlineExceeded`, so abandoned work is never dispatched to
  the accelerator.
* **Jittered backoff** — the loadgen client's retry schedule for shed
  submissions (decorrelated exponential backoff), seeded so benchmark
  runs are reproducible.
"""

from __future__ import annotations

import math
import random
from typing import Iterator

from replication_faster_rcnn_tpu_torch.serving.batcher import DeadlineExceeded

__all__ = ["DeadlineExceeded", "backoff_delays", "retry_after_s"]


def retry_after_s(max_delay_ms: float) -> int:
    """The ``Retry-After`` header value for a shed request: at least a
    second, at least one micro-batch deadline window — by then the queue
    has had a full flush cycle to drain."""
    return max(1, int(math.ceil(max_delay_ms / 1000.0)))


def backoff_delays(
    base_s: float = 0.005,
    max_s: float = 0.25,
    retries: int = 8,
    seed: int = 0,
) -> Iterator[float]:
    """Jittered exponential backoff delays for submit retries:
    ``U(0.5, 1.5) * base * 2^attempt`` capped at ``max_s``. Seeded so a
    loadgen run's retry schedule is reproducible."""
    rng = random.Random(seed)
    for attempt in range(retries):
        yield min(max_s, base_s * (2.0**attempt) * (0.5 + rng.random()))
