"""Elastic fleet training's heartbeat side (a port of the JAX package's
``parallel/elastic.py``): the in-child :class:`ElasticAgent` and the JSON
file protocol its survivors re-form through.

A fixed-world data-parallel fleet dies with its weakest member: when one
rank is lost (spot reclaim, OOM kill, hardware fault), every surviving
rank's next collective never completes. Recovery therefore cannot live on
the main thread: :class:`ElasticAgent` is a daemon thread that doubles as
heartbeat writer and collective watchdog. Every ``heartbeat_interval_s`` it
(a) consults the ``heartbeat.beat`` failpoint — a seeded ``drop`` whose
``arg`` equals this rank's index kills the rank mid-lease, the
deterministic stand-in for a real rank loss — then (b) renews this rank's
lease file and (c) checks every peer's lease age. A peer whose lease is
older than ``lease_timeout_s`` is declared lost: the agent records the
incident, writes a durable *shrink intent* file, and after a short grace
hard-exits with ``train.fault.EXIT_FLEET_SHRINK`` (76).

The survivors re-form through claim and plan files: each writes a claim
for the next generation, the lowest claimant arbitrates the plan
(survivor list, new world size), and every planned-in host respawns at
its new contiguous rank.

All fleet state is plain JSON files under one ``fleet_dir`` (atomic
tmp + ``os.replace`` writes). Same-seed runs reproduce the identical
incident sequence: the heartbeat drop is decided by the failpoint
registry's pure hash. ``faultlib/chaos.py``'s fleet leg drives the whole
protocol in one process with a fake clock.

Not ported here (ROADMAP Queue A item 8, with ``train --elastic`` and the
port's multi-process training): the per-host supervisor ``run_supervisor``,
``child_argv`` and the supervisor/child environment contract
(``fleet_env``, ``child_env``).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from replication_faster_rcnn_tpu_torch.faultlib import failpoints

# ------------------------------------------------------------ fleet files
#
# One flat directory of small JSON files; every write is atomic
# (tmp + os.replace) so a reader never sees a torn record. Names encode
# generation + rank so successive generations never collide.


def lease_path(fleet_dir: str, generation: int, rank: int) -> str:
    return os.path.join(fleet_dir, f"hb_gen{generation}_rank{rank}.json")


def intent_path(fleet_dir: str, generation: int) -> str:
    return os.path.join(fleet_dir, f"shrink_gen{generation}.json")


def claim_path(fleet_dir: str, generation: int, rank: int) -> str:
    return os.path.join(fleet_dir, f"claim_gen{generation}_rank{rank}.json")


def plan_path(fleet_dir: str, generation: int) -> str:
    return os.path.join(fleet_dir, f"plan_gen{generation}.json")


def _write_json_atomic(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_intent(fleet_dir: str, generation: int) -> Optional[Dict[str, Any]]:
    """The shrink-intent record for ``generation``, if any survivor of
    that generation declared one (None otherwise)."""
    return _read_json(intent_path(fleet_dir, generation))


def read_plan(fleet_dir: str, generation: int) -> Optional[Dict[str, Any]]:
    return _read_json(plan_path(fleet_dir, generation))


# --------------------------------------------------------- in-child agent


class ElasticAgent:
    """Heartbeat writer + peer-lease watchdog for one training rank.

    One daemon thread per rank does three things every
    ``heartbeat_interval_s``:

      1. consults the ``heartbeat.beat`` failpoint (a ``drop`` whose
         ``arg`` equals this rank kills the process via ``on_drop`` —
         default ``os._exit(1)``, the sudden-death a real reclaim looks
         like; drops naming other ranks are ignored here and land on
         their target's own registry, which replays the same seeded
         decision stream),
      2. renews this rank's lease file, and
      3. checks every peer lease's age.

    A peer lease older than ``lease_timeout_s`` declares that rank lost:
    ``on_lost`` fires once (the trainer logs the ``fleet_rank_lost``
    incident there), the durable shrink intent is written, and the lost
    set becomes visible to the main thread via :meth:`check`. If
    ``exit_on_shrink`` is set (the production wiring), the thread then
    waits ``exit_grace_s`` for the main thread to exit cleanly and
    hard-exits with ``EXIT_FLEET_SHRINK`` — the main thread is usually
    blocked inside the doomed collective and will never run again, so
    the watchdog cannot wait politely.

    A peer with *no* lease file yet is considered alive: leases start
    lazily at the first dispatch boundary, and compile skew between
    ranks must not read as death.

    ``clock`` and manual :meth:`beat` calls make the whole protocol
    drivable single-threaded (never :meth:`start` it) — the chaos
    harness's fleet leg replays rank loss in-process with a fake clock
    and asserts the same seed yields the identical event log.
    """

    def __init__(
        self,
        fleet_dir: str,
        generation: int,
        rank: int,
        world: int,
        *,
        heartbeat_interval_s: float = 0.5,
        lease_timeout_s: float = 5.0,
        exit_grace_s: float = 2.0,
        clock: Callable[[], float] = time.time,
        on_drop: Optional[Callable[[], None]] = None,
        on_lost: Optional[Callable[[List[int], List[int]], None]] = None,
        exit_on_shrink: bool = True,
    ) -> None:
        self.fleet_dir = fleet_dir
        self.generation = int(generation)
        self.rank = int(rank)
        self.world = int(world)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.lease_timeout_s = float(lease_timeout_s)
        self.exit_grace_s = float(exit_grace_s)
        self.clock = clock
        self.on_drop = on_drop
        self.on_lost = on_lost
        self.exit_on_shrink = exit_on_shrink
        self._beats = 0
        self._lost: List[int] = []
        self._lost_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(fleet_dir, exist_ok=True)

    # -- heartbeat side

    def beat(self) -> None:
        """One lease renewal: consult the failpoint, then write the lease."""
        n = self._beats
        self._beats = n + 1
        inj = failpoints.fire(
            "heartbeat.beat",
            rank=self.rank,
            generation=self.generation,
            beat=n,
        )
        if inj is not None and inj.kind == "drop" and int(inj.arg) == self.rank:
            if self.on_drop is not None:
                self.on_drop()
                return  # dead ranks do not renew their lease
            # sudden death: no cleanup, no atexit — what a reclaimed
            # host actually looks like from the peers' side
            os._exit(1)
        _write_json_atomic(
            lease_path(self.fleet_dir, self.generation, self.rank),
            {
                "rank": self.rank,
                "generation": self.generation,
                "beat": n,
                "t": self.clock(),
            },
        )

    # -- watchdog side

    def lost_ranks(self, now: Optional[float] = None) -> List[int]:
        """Peers whose lease age exceeds the timeout (missing = alive)."""
        if now is None:
            now = self.clock()
        lost = []
        for r in range(self.world):
            if r == self.rank:
                continue
            lease = _read_json(lease_path(self.fleet_dir, self.generation, r))
            if lease is None:
                continue
            if now - float(lease.get("t", now)) > self.lease_timeout_s:
                lost.append(r)
        return lost

    def survivors(self, lost: Sequence[int]) -> List[int]:
        return [r for r in range(self.world) if r not in set(lost)]

    def declare_shrink(self, lost: Sequence[int], step: int = -1) -> List[int]:
        """Write the durable shrink intent (idempotent: last write wins,
        every survivor writes the same survivor set). Returns survivors."""
        survivors = self.survivors(lost)
        _write_json_atomic(
            intent_path(self.fleet_dir, self.generation),
            {
                "generation": self.generation,
                "lost": sorted(int(r) for r in lost),
                "survivors": survivors,
                "step": int(step),
                "detected_by": self.rank,
            },
        )
        return survivors

    def check(self) -> List[int]:
        """Main-thread view of the watchdog: ranks declared lost so far
        (empty while the fleet is healthy). Non-blocking."""
        with self._lost_lock:
            return list(self._lost)

    # -- thread lifecycle

    def start(self) -> None:
        """Start the heartbeat/watchdog thread (idempotent)."""
        if self._thread is not None or self._stop.is_set():
            return
        self._thread = threading.Thread(
            target=self._run, name="elastic-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.beat()
            lost = self.lost_ranks()
            if lost:
                self._on_peer_lost(lost)
                return
            self._stop.wait(self.heartbeat_interval_s)

    def _on_peer_lost(self, lost: List[int]) -> None:
        survivors = self.survivors(lost)
        if self.on_lost is not None:
            try:
                self.on_lost(sorted(lost), survivors)
            except Exception:  # noqa: BLE001 - observer must not block recovery
                pass
        self.declare_shrink(lost)
        with self._lost_lock:
            self._lost = sorted(lost)
        if not self.exit_on_shrink:
            return
        # grace window: if the main thread is between dispatches it will
        # see check() != [] and leave cleanly with exit 76. If it is
        # blocked inside the dead fleet's collective it never returns, so
        # exit from here.
        self._stop.wait(self.exit_grace_s)
        if self._stop.is_set():
            return  # stop() won the race (tests); let the caller decide
        sys.stderr.write(
            f"elastic: rank(s) {sorted(lost)} lost lease "
            f"(gen {self.generation}); exiting for re-formation\n"
        )
        sys.stderr.flush()
        from replication_faster_rcnn_tpu_torch.train.fault import EXIT_FLEET_SHRINK

        os._exit(EXIT_FLEET_SHRINK)


# ------------------------------------------------------ re-form protocol


def write_claim(fleet_dir: str, generation: int, rank: int) -> None:
    """Claim membership in ``generation`` (rank = the claimant's rank in
    the PREVIOUS generation; the plan maps these to new contiguous ranks)."""
    _write_json_atomic(
        claim_path(fleet_dir, generation, rank),
        {"rank": int(rank), "pid": os.getpid()},
    )


def read_claims(fleet_dir: str, generation: int, world: int) -> List[int]:
    """Sorted previous-generation ranks that claimed ``generation``."""
    return sorted(
        r for r in range(world)
        if os.path.exists(claim_path(fleet_dir, generation, r))
    )


def write_plan(fleet_dir: str, generation: int, survivors: Sequence[int]) -> None:
    survivors = sorted(int(r) for r in survivors)
    _write_json_atomic(
        plan_path(fleet_dir, generation),
        {
            "generation": int(generation),
            "survivors": survivors,
            "world": len(survivors),
        },
    )


def wait_plan(
    fleet_dir: str,
    generation: int,
    timeout_s: float,
    poll_s: float = 0.05,
) -> Optional[Dict[str, Any]]:
    """Poll for the generation's plan file (None on timeout)."""
    deadline = time.monotonic() + timeout_s
    while True:
        plan = read_plan(fleet_dir, generation)
        if plan is not None:
            return plan
        if time.monotonic() >= deadline:
            return None
        time.sleep(poll_s)


def clear_fleet_dir(fleet_dir: str) -> None:
    """Drop stale lease/claim/plan/intent files from a previous run (the
    coordinator-rank supervisor calls this before generation 0 so a
    reused workdir cannot replay an old fleet's shrink protocol).

    Safe against concurrent supervisors without locking: the clear runs
    before rank 0 spawns its generation-0 child, no peer child can exit
    before that child joins the collective bring-up (or bring-up itself
    fails, which is a fleet-leaving exit, not a shrink), and supervisors
    only write fleet files while re-forming after a child exit — so no
    live fleet file can be mid-write while this runs."""
    if not os.path.isdir(fleet_dir):
        return
    for name in os.listdir(fleet_dir):
        if name.startswith(("hb_gen", "shrink_gen", "claim_gen", "plan_gen")):
            try:
                os.remove(os.path.join(fleet_dir, name))
            except OSError:
                pass
