"""Deterministic, seeded failpoint registry (a copy of the JAX package's
``faultlib/failpoints.py``, with the three sites the port fires:
``loader.fetch``, ``batcher.flush`` and ``http.handler``).

Every fault-tolerance path in this repo (retry-then-substitute loading,
scheduled-save containment, verified-restore walk-back, per-flush error
relay, load shedding) exists because some real failure motivates it —
but until now each was exercised only by hand-written test plumbing
(monkeypatched ``save``, datasets whose ``__getitem__`` raises, files
garbled with ``write_bytes``). Failpoints make those faults first-class:
NAMED injection sites in production code, off by default, armed by a
seeded schedule, so the same chaos run is reproducible bit-for-bit.

Design constraints, in order:

* **Zero overhead off.** ``fire(site)`` is a module-global boolean test
  on the disarmed path — no registry lookup, no lock, no allocation.
  Production code can consult a site unconditionally.
* **Determinism independent of thread interleaving.** A naive per-site
  ``random.Random`` stream would make the k-th *draw* depend on which
  thread got the lock first — fine — but any shared stream across sites
  would not be. Here the decision for the k-th hit of a site is a PURE
  function of ``(rule.seed, site, kind, k)`` via SHA-256: the per-site
  hit counter is the only mutable state (one locked increment), so two
  runs with the same seed inject the exact same fault at the exact same
  per-site hit index no matter how threads interleave across sites.
* **Faults ride existing containment.** ``ioerror`` raises a real
  ``OSError`` subclass from inside the site, so the retry/substitute/
  containment code that handles a real disk or decode failure handles
  the injected one identically. Data faults (``torn_write``,
  ``crc_corrupt``, ``nan``, ``drop``) are returned to the call site,
  which applies them where only it can (the saved file, the batch).

Sites (see the README failpoint table):
  loader.fetch         data/loader.py::fetch_sample (every dataset access)
  batcher.flush        serving/batcher.py::MicroBatcher._flush
  http.handler         serving/server.py POST handler

Kinds:
  ioerror      raise ChaosError (an OSError) at the site
  torn_write   caller truncates the target file(s) after ``arg`` bytes
  crc_corrupt  caller flips one byte per target file (same length)
  nan          caller poisons the sample/batch images with NaN
  delay        sleep ``arg`` milliseconds at the site
  drop         caller discards the unit of work (request/connection)

Activation: ``configure("site:kind:prob:seed[:arg[:max_fires[:after]]],...")``
or a JSON schedule file (``configure("/path/sched.json")`` — a list of
rule objects, or ``{"rules": [...]}``). ``--chaos-spec`` on the CLI and
``debug.chaos_spec`` in the config route here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from replication_faster_rcnn_tpu_torch.telemetry import tracecontext

__all__ = [
    "SITES",
    "KINDS",
    "ChaosError",
    "Fault",
    "Rule",
    "armed",
    "configure",
    "disarm",
    "event_log",
    "fire",
    "parse_spec",
    "poison_batch",
    "set_sink",
]

# the sites the port fires; the JAX package's others (checkpoint, prefetch,
# collective, heartbeat, router, rollout) come with the code that fires them,
# and ``configure`` rejects them until then
SITES = (
    "loader.fetch",
    "batcher.flush",
    "http.handler",
)

KINDS = ("ioerror", "torn_write", "crc_corrupt", "nan", "delay", "drop")


class ChaosError(OSError):
    """Injected I/O failure (failpoint kind ``ioerror``).

    An ``OSError`` so every containment path written for real disk /
    network trouble (retry, substitute, contain-and-continue) treats the
    injection exactly like the fault it stands in for.
    """


@dataclasses.dataclass(frozen=True)
class Rule:
    """One activation: inject ``kind`` at ``site`` with probability
    ``prob`` per hit, decided by ``seed``. ``arg`` parameterizes the
    kind (delay ms, torn-write byte offset); ``max_fires`` caps total
    injections (0 = unlimited); hits before ``after`` never fire — so
    ``prob=1.0, after=k, max_fires=1`` means "exactly the k-th hit",
    the deterministic scheduling idiom the chaos suites lean on."""

    site: str
    kind: str
    prob: float
    seed: int
    arg: float = 0.0
    max_fires: int = 0
    after: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown failpoint site {self.site!r} (sites: {', '.join(SITES)})"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (kinds: {', '.join(KINDS)})"
            )
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.max_fires < 0:
            raise ValueError(f"max_fires must be >= 0, got {self.max_fires}")
        if self.after < 0:
            raise ValueError(f"after must be >= 0, got {self.after}")


@dataclasses.dataclass(frozen=True)
class Fault:
    """An injected fault: which site fired, what kind, at which per-site
    hit index (``seq``), with the rule's parameter."""

    site: str
    kind: str
    seq: int
    arg: float


def _decision(rule: Rule, n: int) -> float:
    """Uniform in [0, 1) for the n-th hit — a pure function of the rule
    and the hit index, so thread interleaving cannot change it."""
    h = hashlib.sha256(
        f"{rule.seed}:{rule.site}:{rule.kind}:{n}".encode()
    ).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


class Registry:
    """Rules grouped by site + per-site hit counters + the event log.

    All mutable state (counters, fire tallies, events) lives behind one
    lock; the injection decision itself needs none of it beyond the hit
    index, which is why determinism survives threading.
    """

    def __init__(self, rules: Sequence[Rule]) -> None:
        self._rules: Dict[str, List[Rule]] = {}
        for r in rules:
            self._rules.setdefault(r.site, []).append(r)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {s: 0 for s in self._rules}
        self._fired: Dict[tuple, int] = {}
        self._events: List[Dict[str, Any]] = []

    def consult(self, site: str) -> Optional[Fault]:
        rules = self._rules.get(site)
        if not rules:
            return None
        with self._lock:
            n = self._hits[site]
            self._hits[site] = n + 1
            for i, rule in enumerate(rules):
                if n < rule.after:
                    continue
                if rule.max_fires and self._fired.get((site, i), 0) >= rule.max_fires:
                    continue
                if _decision(rule, n) < rule.prob:
                    self._fired[(site, i)] = self._fired.get((site, i), 0) + 1
                    self._events.append(
                        {"site": site, "seq": n, "kind": rule.kind, "arg": rule.arg}
                    )
                    return Fault(site, rule.kind, n, rule.arg)
        return None

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def hits(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)


# Module state: `_armed` is the disarmed-path fast check (a plain bool
# read — benign race by design: arming happens before the workload under
# test starts). The registry/sink swap under `_state_lock`.
_state_lock = threading.Lock()
_armed = False
_registry: Optional[Registry] = None
_sink: Optional[Callable[[Dict[str, Any]], None]] = None


def parse_spec(spec: str) -> List[Rule]:
    """Rules from a ``site:kind:prob:seed[:arg[:max_fires[:after]]],...``
    string or a JSON schedule file (a path ending ``.json`` or prefixed
    ``@``)."""
    spec = spec.strip()
    if not spec:
        return []
    if spec.startswith("@") or spec.endswith(".json"):
        return load_schedule(spec.lstrip("@"))
    rules = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if len(fields) < 4 or len(fields) > 7:
            raise ValueError(
                f"bad failpoint spec {part!r}: want "
                "site:kind:prob:seed[:arg[:max_fires[:after]]]"
            )
        site, kind, prob, seed = fields[:4]
        arg = float(fields[4]) if len(fields) > 4 else 0.0
        max_fires = int(fields[5]) if len(fields) > 5 else 0
        after = int(fields[6]) if len(fields) > 6 else 0
        rules.append(
            Rule(site, kind, float(prob), int(seed), arg=arg,
                 max_fires=max_fires, after=after)
        )
    return rules


def load_schedule(path: str) -> List[Rule]:
    """Rules from a JSON schedule: ``[{"site": ..., "kind": ...,
    "prob": ..., "seed": ..., "arg": ..., "max_fires": ...}, ...]`` or
    the same list under a ``"rules"`` key."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("rules", [])
    rules = []
    for i, d in enumerate(data):
        try:
            rules.append(
                Rule(
                    site=d["site"],
                    kind=d["kind"],
                    prob=float(d["prob"]),
                    seed=int(d["seed"]),
                    arg=float(d.get("arg", 0.0)),
                    max_fires=int(d.get("max_fires", 0)),
                    after=int(d.get("after", 0)),
                )
            )
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad schedule entry {i} in {path}: {e}") from e
    return rules


def configure(
    spec: Any = "", sink: Optional[Callable[[Dict[str, Any]], None]] = None
) -> List[Rule]:
    """Arm the registry from a spec string / schedule path / Rule list.
    An empty spec disarms. Returns the parsed rules."""
    global _armed, _registry, _sink
    if isinstance(spec, str):
        rules = parse_spec(spec)
    else:
        rules = [r if isinstance(r, Rule) else Rule(**r) for r in spec]
    with _state_lock:
        if not rules:
            _armed = False
            _registry = None
            _sink = None
            return []
        _registry = Registry(rules)
        if sink is not None:
            _sink = sink
        _armed = True
    return rules


def disarm() -> None:
    """Disarm and drop the registry + sink (test/teardown hook)."""
    configure("")


def armed() -> bool:
    return _armed


def set_sink(fn: Optional[Callable[[Dict[str, Any]], None]]) -> None:
    """Per-injection observer: called with the event dict (site, seq,
    kind, arg + call-site context) for every injected fault. The trainer
    wires this to its watchdog incident log so a chaos run's post-mortem
    shows exactly which faults landed."""
    global _sink
    with _state_lock:
        _sink = fn


def event_log() -> List[Dict[str, Any]]:
    """Injected events so far, in registry order (the determinism tests
    compare these across two runs of the same schedule)."""
    reg = _registry
    return reg.events() if reg is not None else []


def site_hits() -> Dict[str, int]:
    """Per-site consult counts (armed sites only)."""
    reg = _registry
    return reg.hits() if reg is not None else {}


def fire(site: str, **ctx: Any) -> Optional[Fault]:
    """Consult a failpoint. Disarmed: a single boolean test, returns
    None. Armed: decide deterministically for this site hit; ``ioerror``
    raises :class:`ChaosError` and ``delay`` sleeps here (fully applied),
    every injected kind is returned so call sites can apply the data
    faults they own (``nan``/``torn_write``/``crc_corrupt``/``drop``) —
    a site simply ignores kinds it has no behavior for."""
    if not _armed:
        return None
    reg = _registry
    if reg is None:  # pragma: no cover - disarm raced a fire
        return None
    fault = reg.consult(site)
    if fault is None:
        return None
    sink = _sink
    if sink is not None:
        try:
            event = {
                "site": fault.site,
                "seq": fault.seq,
                "kind": fault.kind,
                "arg": fault.arg,
                **ctx,
            }
            # a request-scoped fault carries its trace id, so the
            # chaos_injected incident joins the merged request timeline
            trace = tracecontext.current_trace()
            if trace is not None:
                event.setdefault("trace_id", trace.trace_id)
            sink(event)
        except Exception:  # noqa: BLE001 - observer must not alter the fault
            pass
    if fault.kind == "delay":
        time.sleep(fault.arg / 1000.0)
    elif fault.kind == "ioerror":
        raise ChaosError(
            f"injected IOError at failpoint {site!r} (hit {fault.seq})"
        )
    return fault


def poison_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The ``nan`` fault: a copy of a sample/batch dict whose float
    ``image`` is all-NaN (the exact poison the guarded-update tests
    inject by hand) — non-float images pass through untouched."""
    out = dict(batch)
    img = out.get("image")
    if img is None:
        return out
    img = np.array(img, copy=True)
    if img.dtype.kind == "f":
        img.fill(np.nan)
        out["image"] = img
    return out
