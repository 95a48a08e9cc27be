"""SLO-driven micro-batch deadlines — adapt per-bucket ``max_delay_ms``
from observed queue waits (a copy of the JAX package's ``serving/slo.py``).

The static ``serving.max_delay_ms`` knob is one global answer to a
per-bucket question: how long may a request sit in the micro-batch queue
before we flush a partial batch?  Under load a bucket fills its batch
before the deadline and the knob is irrelevant; idle buckets pay the
full deadline on every request.  The :class:`DeadlineController` closes
the loop: it watches the per-flush queue-wait samples the MicroBatcher
already emits (``on_flush_stats``) and nudges each bucket's deadline
with ONE bounded multiplicative step per adaptation window —

- wait p99 above ``SHRINK_AT`` x ``adaptive_slo_ms``: divide the
  deadline by ``adaptive_delay_step`` (stop holding requests we are
  about to miss the SLO on);
- wait p99 below ``GROW_BELOW`` x the SLO *and* flushes are going out
  partially filled: multiply by the step (there is SLO headroom to
  amortize dispatches better);
- always clamped to ``[delay_floor_ms, delay_ceiling_ms]``.

Multiplicative-with-clamp makes the controller self-limiting: it cannot
run away, and a misbehaving p99 estimate costs at most one step per
window.  The controller is pure bookkeeping — no thread of its own; the
MicroBatcher worker drives it via the ``on_flush_stats`` hook and reads
the result back through the ``key -> seconds`` callable seam
(``delay_s``), so adaptation is as deterministic as the flush sequence.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["DeadlineController"]

# Hysteresis band around the SLO target, in fractions of adaptive_slo_ms.
# Shrink when the observed wait p99 crosses 0.8x the SLO (we are close to
# missing it); grow only when p99 is under 0.4x (comfortable headroom).
# The dead zone between them keeps the deadline stable under steady load.
SHRINK_AT = 0.8
GROW_BELOW = 0.4


def _p99(samples: List[float]) -> float:
    """p99 by nearest-rank on a sorted copy (small fixed windows — exact
    beats clever here)."""
    s = sorted(samples)
    idx = min(len(s) - 1, int(0.99 * (len(s) - 1) + 0.5))
    return s[idx]


class DeadlineController:
    """Per-key adaptive flush deadline with bounded multiplicative steps.

    ``delay_s`` is the callable handed to :class:`MicroBatcher` as
    ``max_delay_s``; ``on_flush`` is wired to ``on_flush_stats``.  Both
    run on the batcher worker thread; ``delays_ms`` snapshots from HTTP
    handler threads, hence the lock.  ``max_batch`` (optional,
    ``key -> int``) lets the grow rule require partially-filled flushes:
    if every flush already fills the batch, a longer deadline buys
    nothing and only adds latency.
    """

    def __init__(
        self,
        slo_ms: float,
        floor_ms: float,
        ceiling_ms: float,
        step: float,
        initial_ms: float,
        max_batch: Optional[Callable[[Any], int]] = None,
        window: int = 16,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not 0 < floor_ms <= ceiling_ms:
            raise ValueError(
                f"need 0 < floor_ms <= ceiling_ms, got {floor_ms}/{ceiling_ms}"
            )
        if step <= 1.0:
            raise ValueError(f"step must be > 1.0, got {step}")
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._slo_ms = slo_ms
        self._floor_ms = floor_ms
        self._ceiling_ms = ceiling_ms
        self._step = step
        self._initial_ms = min(max(initial_ms, floor_ms), ceiling_ms)
        self._max_batch = max_batch
        self._window = window
        self._clock = clock  # reserved seam: time-based cadence in tests
        self._lock = threading.Lock()
        self._delay_ms: Dict[Any, float] = {}
        # per-key accumulation since the last adaptation:
        # (wait samples, n_flushes, n_partial_flushes)
        self._acc: Dict[Any, Tuple[List[float], int, int]] = {}
        self._adaptations = 0  # total steps taken (introspection/tests)

    @classmethod
    def from_config(cls, serving, max_batch=None, **kw) -> "DeadlineController":
        """Build from a ``ServingConfig`` (`adaptive_*`/`delay_*` knobs)."""
        return cls(
            slo_ms=serving.adaptive_slo_ms,
            floor_ms=serving.delay_floor_ms,
            ceiling_ms=serving.delay_ceiling_ms,
            step=serving.adaptive_delay_step,
            initial_ms=serving.max_delay_ms,
            max_batch=max_batch,
            **kw,
        )

    # ---------------------------------------------------------------- reads

    def delay_s(self, key: Any) -> float:
        """Current flush deadline for ``key``, in seconds (the MicroBatcher
        ``max_delay_s`` callable)."""
        with self._lock:
            return self._delay_ms.get(key, self._initial_ms) / 1000.0

    def delays_ms(self) -> Dict[str, float]:
        """``str(key) -> current delay_ms`` for every adapted key (the
        /stats gauge; keys still at the initial value are omitted)."""
        with self._lock:
            return {str(k): v for k, v in self._delay_ms.items()}

    @property
    def adaptations(self) -> int:
        with self._lock:
            return self._adaptations

    # ---------------------------------------------------------------- hook

    def on_flush(self, key: Any, waits_s: List[float]) -> None:
        """Record one flush's queue waits; adapt once per ``window``
        accumulated samples.  Wired to ``MicroBatcher(on_flush_stats=...)``
        (worker thread; must stay cheap and non-raising)."""
        if not waits_s:
            return
        partial = 0
        if self._max_batch is not None:
            partial = int(len(waits_s) < self._max_batch(key))
        with self._lock:
            samples, flushes, partials = self._acc.get(key, ([], 0, 0))
            samples = samples + [w * 1000.0 for w in waits_s]
            flushes += 1
            partials += partial
            if len(samples) < self._window:
                self._acc[key] = (samples, flushes, partials)
                return
            # adaptation point: one bounded multiplicative step
            self._acc.pop(key, None)  # absent when one flush fills the window
            cur = self._delay_ms.get(key, self._initial_ms)
            p99_ms = _p99(samples)
            new = cur
            if p99_ms > SHRINK_AT * self._slo_ms:
                new = cur / self._step
            elif p99_ms < GROW_BELOW * self._slo_ms and (
                self._max_batch is None or partials > 0
            ):
                new = cur * self._step
            new = min(max(new, self._floor_ms), self._ceiling_ms)
            if new != cur or key not in self._delay_ms:
                self._delay_ms[key] = new
            if new != cur:
                self._adaptations += 1
