"""Multi-window error-budget burn-rate accounting (a copy of the JAX
package's ``telemetry/slo_burn.py``).

The SRE formulation: an SLO target (say 99.9% availability) leaves an
error *budget* of ``1 - target`` (0.1%).  The burn rate over a window
is ``observed error rate / budget`` — burn 1.0 spends the budget
exactly at the rate it refills, burn 14 exhausts a 30-day budget in
about 2 days.  A single window either pages too slowly (long window)
or flaps on every blip (short window); the standard fix is the
multi-window AND rule: alarm only while BOTH the short (default 5 m)
and long (default 1 h) windows burn above threshold.  The long window
makes the alarm meaningful, the short window lets it CLEAR as soon as
the incident actually stops — which is exactly what the fleet needs to
re-admit a rejoined replica or a demoted canary.

:class:`BurnRateTracker` is the dependency-free core: outcomes are
folded into fixed-width interval buckets (memory is O(window /
resolution), never O(events)), the clock is injectable so tests and
the simulated fleet benchmark drive it deterministically, and an
outcome counts against the budget if it failed OR (when a latency
target is set) succeeded too slowly — the latency SLO and the
availability SLO share one budget, per the user's experience of "my
request did not come back in time".
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = ["BurnRateTracker"]


class BurnRateTracker:
    """Rolling multi-window burn-rate over request/attempt outcomes."""

    def __init__(
        self,
        availability_target: float = 0.999,
        latency_target_s: float = 0.0,
        short_window_s: float = 300.0,
        long_window_s: float = 3600.0,
        alarm_burn: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        resolution_s: Optional[float] = None,
    ):
        if not 0.0 < availability_target < 1.0:
            raise ValueError(
                f"availability_target must be in (0, 1), got {availability_target}"
            )
        if latency_target_s < 0:
            raise ValueError(f"latency_target_s must be >= 0, got {latency_target_s}")
        if not 0 < short_window_s < long_window_s:
            raise ValueError(
                "need 0 < short_window_s < long_window_s, got "
                f"{short_window_s} / {long_window_s}"
            )
        if alarm_burn <= 0:
            raise ValueError(f"alarm_burn must be > 0, got {alarm_burn}")
        self.availability_target = availability_target
        self.latency_target_s = latency_target_s
        self.short_window_s = short_window_s
        self.long_window_s = long_window_s
        self.alarm_burn = alarm_burn
        self.budget = 1.0 - availability_target
        self._clock = clock
        # bucket width: fine enough that the short window has ~20 slots
        self._res = (
            float(resolution_s) if resolution_s else max(short_window_s / 20.0, 1e-6)
        )
        self._lock = threading.Lock()
        # (bucket_start_time, ok_count, err_count); append-right, expire-left
        self._buckets: Deque[Tuple[float, int, int]] = deque()
        self._total_ok = 0
        self._total_err = 0

    def _bucket_start(self, now: float) -> float:
        return now - (now % self._res)

    def record(self, ok: bool, latency_s: Optional[float] = None) -> None:
        """Fold one outcome in. ``ok=True`` with a latency above the
        target still burns budget — a too-slow success is an SLO miss."""
        err = (not ok) or (
            self.latency_target_s > 0
            and latency_s is not None
            and latency_s > self.latency_target_s
        )
        now = self._clock()
        start = self._bucket_start(now)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == start:
                t, o, e = self._buckets[-1]
                self._buckets[-1] = (t, o + (0 if err else 1), e + (1 if err else 0))
            else:
                self._buckets.append(
                    (start, 0 if err else 1, 1 if err else 0)
                )
            if err:
                self._total_err += 1
            else:
                self._total_ok += 1
            self._expire_locked(now)

    def _expire_locked(self, now: float) -> None:
        horizon = now - self.long_window_s - self._res
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def _window_rate(self, window_s: float, now: float) -> Tuple[float, int]:
        """(error rate, sample count) over the trailing ``window_s``;
        caller holds no lock (we take it)."""
        cutoff = now - window_s
        ok = err = 0
        with self._lock:
            buckets: List[Tuple[float, int, int]] = list(self._buckets)
        for start, o, e in reversed(buckets):
            # a bucket belongs to the window if any of it overlaps
            if start + self._res <= cutoff:
                break
            ok += o
            err += e
        n = ok + err
        return (err / n if n else 0.0), n

    def burn_rates(self) -> Dict[str, float]:
        """Current ``{"short": burn, "long": burn}``."""
        now = self._clock()
        short_rate, _ = self._window_rate(self.short_window_s, now)
        long_rate, _ = self._window_rate(self.long_window_s, now)
        return {
            "short": short_rate / self.budget,
            "long": long_rate / self.budget,
        }

    def alarm(self) -> bool:
        """Multi-window AND rule: burning above threshold on BOTH
        windows right now."""
        rates = self.burn_rates()
        return (
            rates["short"] > self.alarm_burn and rates["long"] > self.alarm_burn
        )

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock()
        short_rate, short_n = self._window_rate(self.short_window_s, now)
        long_rate, long_n = self._window_rate(self.long_window_s, now)
        with self._lock:
            total_ok, total_err = self._total_ok, self._total_err
        burn_short = short_rate / self.budget
        burn_long = long_rate / self.budget
        return {
            "availability_target": self.availability_target,
            "latency_target_s": self.latency_target_s,
            "budget": self.budget,
            "windows_s": {
                "short": self.short_window_s,
                "long": self.long_window_s,
            },
            "samples": {"short": short_n, "long": long_n},
            "error_rates": {"short": short_rate, "long": long_rate},
            "burn_rates": {"short": burn_short, "long": burn_long},
            "alarm": burn_short > self.alarm_burn and burn_long > self.alarm_burn,
            "total_ok": total_ok,
            "total_err": total_err,
        }
