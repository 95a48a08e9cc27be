"""Per-replica circuit breaker (a copy of the JAX package's
``serving/fleet/breaker.py``) — fail fast at the router instead of
queueing requests behind a sick replica.

The classic three-state machine:

* **CLOSED** — requests flow; ``threshold`` consecutive failures open
  the breaker (a single success resets the streak, mirroring the
  engine's degraded 3-strike discipline).
* **OPEN** — every request is refused locally for ``cooldown_s``; the
  replica gets zero traffic while it restarts/recovers, and the
  router's failover path never waits on it.
* **HALF_OPEN** — after the cooldown, exactly ONE trial request is let
  through; success closes the breaker, failure re-opens it for another
  cooldown. One probe, not a thundering herd.

``allow()`` is the admission question and CLAIMS the half-open trial
slot (first caller after cooldown gets True, concurrent callers get
False) — callers must report the outcome via ``record_success`` /
``record_failure`` or the trial slot stays spent until the next
cooldown lapses.  All transitions are under one lock with an injectable
clock, so tests and the chaos leg drive the timeline deterministically.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probe recovery."""

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self._threshold = threshold
        self._cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0  # consecutive, while CLOSED
        self._opened_at = 0.0
        self._trial_inflight = False  # HALF_OPEN probe slot claimed
        self._opens = 0  # lifetime CLOSED/HALF_OPEN -> OPEN transitions

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        # lock held. OPEN lazily decays to HALF_OPEN once the cooldown
        # elapses — no timer thread, the next caller observes it.
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self._cooldown_s
        ):
            self._state = HALF_OPEN
            self._trial_inflight = False
        return self._state

    def allow(self) -> bool:
        """May a request go to this replica right now?  In HALF_OPEN this
        hands out the single trial slot."""
        with self._lock:
            state = self._peek_state()
            if state == CLOSED:
                return True
            if state == HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._peek_state()
            self._state = CLOSED
            self._failures = 0
            self._trial_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            state = self._peek_state()
            if state == HALF_OPEN:
                # failed trial: straight back to OPEN, cooldown restarts
                self._state = OPEN
                self._opened_at = self._clock()
                self._trial_inflight = False
                self._opens += 1
                return
            if state == OPEN:
                return  # refused traffic can't deepen the outage
            self._failures += 1
            if self._failures >= self._threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                self._opens += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self._peek_state(),
                "consecutive_failures": self._failures,
                "opens": self._opens,
            }
