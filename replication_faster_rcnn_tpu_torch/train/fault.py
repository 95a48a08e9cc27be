"""Fault tolerance (counterpart of the JAX package's ``train/fault.py``):
the guarded update, consecutive-skip escalation, preemption-safe shutdown,
and verified checkpoints with a latest-good fallback.

* **Poisoned gradients** — :func:`guarded_update` withholds the update of a
  step whose gradient holds a NaN/Inf, and :class:`SkipMonitor` turns the
  per-step ``skipped`` flags into consecutive-skip escalation.
* **Preemption** — :class:`GracefulShutdown` turns SIGTERM/SIGINT into a
  flag the trainer checks at each dispatch boundary; the trainer then saves
  an emergency checkpoint and leaves through :class:`Preempted`
  (exit code :data:`EXIT_PREEMPTED`).
* **Torn checkpoints** — every save writes a sidecar manifest (step, config
  hash, leaf count, per-leaf CRC32) to ``<workdir>/manifests/<step>.json``;
  :func:`verified_restore` checks the restored tree against it and walks
  back to the newest step that verifies.

The store (:class:`CheckpointStore`) plays the part of the orbax
``CheckpointManager`` the JAX package uses: one directory per step,
``<workdir>/<step>/state.pt``, a ``torch.save`` of plain containers written
into ``<step>.tmp-<pid>/`` and renamed into place. A step directory without
``state.pt`` (an orbax checkpoint of the JAX package, say) is not this
format: reading it raises :class:`ForeignCheckpointError`, which the
fallback walk does not treat as torn, so nothing of it is deleted.

Policies of the guarded update (``train.nonfinite_policy``):

* ``skip`` — a gradient with any NaN/Inf withholds the whole update: the
  parameters, the optimizer's moments and count (the schedule's position)
  and the BatchNorm running statistics stay bit-identical, and the metrics
  carry ``skipped = 1`` (a device scalar: the gate never reads the host);
* ``halt`` — gates the same way; the skip monitor then raises
  :class:`NonFiniteEscalation`;
* ``apply`` — applies every update.

The step counter advances either way (it counts dispatched batches).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import signal
import threading
import zlib
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans
from replication_faster_rcnn_tpu_torch.telemetry.health import (
    flat,
    global_norm,
    nonfinite_count,
)

Tensor = torch.Tensor

# "preempted with a verified emergency checkpoint; restart me with resume":
# EX_TEMPFAIL in sysexits.h, so a supervisor can requeue instead of paging
EXIT_PREEMPTED = 75

NONFINITE_POLICIES = ("apply", "skip", "halt")

MANIFEST_DIRNAME = "manifests"
MANIFEST_SCHEMA = "ckpt_manifest/v1"
STATE_FILENAME = "state.pt"

# (BatchNorm module, (new running mean, new running var))
PendingStats = List[Tuple[torch.nn.Module, Tuple[Tensor, Tensor]]]


class Preempted(RuntimeError):
    """Raised by the trainer after a graceful-shutdown request has been
    honoured: the emergency checkpoint is on disk and verified."""

    def __init__(self, step: int, reason: str = "signal"):
        super().__init__(
            f"training preempted ({reason}) at step {step}; emergency "
            "checkpoint saved — restart with resume=True"
        )
        self.step = int(step)
        self.reason = reason


class NonFiniteEscalation(FloatingPointError):
    """Raised when non-finite-gradient skips exceed the configured budget
    (or at once under ``nonfinite_policy='halt'``)."""


class ForeignCheckpointError(ValueError):
    """A step directory that is not this store's format."""


def guarded_update(
    optimizer,
    params: Sequence[torch.nn.Parameter],
    new_stats: PendingStats,
    policy: str = "skip",
) -> Dict[str, Tensor]:
    """One step of ``optimizer`` (``train_step.ChainOptimizer``) from the
    gradients of ``params``, and the new BatchNorm statistics, gated on the
    gradients' finiteness. Returns the health scalars plus ``skipped``.

    Under ``skip``/``halt`` the gate is a device predicate, ``ok =
    nonfinite_count == 0``, feeding selects: the parameters, the optimizer's
    moments and count and the BatchNorm running statistics each take the new
    value where ``ok`` and keep the old one bitwise otherwise, and
    ``skipped = 1 - ok``. With no new statistics (a GroupNorm model, or
    ``frozen_bn``) nothing of the kind is committed. Nothing is read on the
    host, so the step can be captured in a CUDA graph. A withheld step reports ``update_norm`` and
    ``update_ratio`` as NaN (the JAX package's Adam update of a non-finite
    gradient). Under ``apply`` every update is committed."""
    if policy not in NONFINITE_POLICIES:
        raise ValueError(f"nonfinite_policy must be one of {NONFINITE_POLICIES}, got {policy!r}")
    with torch.no_grad():
        # one flat float32 copy each: a few launches for any parameter count
        grads = flat([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
        old = flat([p.detach() for p in params])
        bad = nonfinite_count([grads])
        ok = None if policy == "apply" else bad == 0
        param_norm = global_norm([old])  # before the update writes the parameters
        delta = optimizer.update(grads, old, ok)
        if new_stats:
            live = [buf for m, _ in new_stats for buf in (m.running_mean, m.running_var)]
            new = [t for _, pair in new_stats for t in pair]
            if ok is not None:
                kept = torch.where(ok, flat(new), flat(live))
                new = [v.view(b.shape) for v, b in zip(kept.split([b.numel() for b in live]),
                                                       live)]
            torch._foreach_copy_(live, new)
        update_norm = global_norm([delta])
        update_ratio = update_norm / (param_norm + 1e-12)
        if ok is None:
            skipped = torch.zeros((), device=old.device)
        else:
            update_norm = torch.where(ok, update_norm, float("nan"))
            update_ratio = torch.where(ok, update_ratio, float("nan"))
            skipped = 1.0 - ok.float()
        health = {
            "grad_norm": global_norm([grads]),
            "param_norm": param_norm,
            "update_norm": update_norm,
            "update_ratio": update_ratio,
            "nonfinite_count": bad,
            "skipped": skipped,
        }
    for module, _ in new_stats:
        module.pending_stats = None
    return health


def finite_or_raise(metrics: Mapping[str, Any], step: int) -> Dict[str, float]:
    """The metrics as floats; raises on any NaN/Inf."""
    vals = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(
            f"non-finite metrics at step {step}: {bad} (all: {vals})"
        )
    return vals


def check_step_metrics(metrics: Dict[str, Any], step: int) -> Dict[str, float]:
    """Log-boundary validation, guard-aware: a row whose update was withheld
    (``skipped > 0``) may carry non-finite diagnostics (the poisoned batch's
    NaN loss is the evidence); any other row fails fast like
    :func:`finite_or_raise`."""
    vals = {k: float(v) for k, v in metrics.items()}
    if vals.get("skipped", 0.0) > 0.0:
        return vals
    return finite_or_raise(vals, step)


# ------------------------------------------------------- host-side monitor


class SkipMonitor:
    """Consecutive-skip escalation from the per-step ``skipped`` flags.

    The trainer feeds every dispatch's flag to :meth:`observe` (a device
    scalar, or a stacked ``[K]`` tensor from a chunk) without a host read;
    :meth:`drain` fetches the pending flags, and the trainer calls it where
    it already syncs (log boundaries, epoch ends). Under ``policy='halt'``
    observe drains at once: promptness over pipelining is that policy's
    point.

    Escalation (``consecutive >= max_consecutive``, or any skip under
    ``halt``) calls ``on_escalate(kind, **fields)`` (the trainer records
    the incident), then raises :class:`NonFiniteEscalation`.
    """

    # pending flags this many deep are drained by observe itself: bounds
    # memory for direct train_one_batch loops that never reach a log boundary
    _AUTO_DRAIN = 512

    def __init__(
        self,
        policy: str = "skip",
        max_consecutive: int = 10,
        on_escalate: Optional[Callable[..., None]] = None,
    ):
        if policy not in NONFINITE_POLICIES:
            raise ValueError(
                f"nonfinite_policy must be one of {NONFINITE_POLICIES}, "
                f"got {policy!r}"
            )
        self.policy = policy
        self.max_consecutive = int(max_consecutive)
        self.on_escalate = on_escalate
        self.consecutive = 0
        self.total_skipped = 0
        self.last_skipped_step: Optional[int] = None
        self._pending: List[Tuple[int, Any]] = []

    def observe(self, first_step: int, metrics: Dict[str, Any]) -> None:
        """Record one dispatch's ``skipped`` flag(s) (a scalar or a [K]
        array); ``first_step`` is the 1-indexed step of the first."""
        if self.policy == "apply" or "skipped" not in metrics:
            return
        self._pending.append((int(first_step), metrics["skipped"]))
        if self.policy == "halt" or len(self._pending) >= self._AUTO_DRAIN:
            self.drain()

    def drain(self) -> None:
        """Check the pending flags and update the consecutive count; raises
        :class:`NonFiniteEscalation` past the budget."""
        pending, self._pending = self._pending, []
        for first, flags in pending:
            with tspans.current_tracer().span("fault/skip_drain", cat="sync"):
                if isinstance(flags, torch.Tensor):
                    flags = flags.detach().cpu()
                arr = np.atleast_1d(np.asarray(flags, np.float64))
            for off, flag in enumerate(arr):
                if flag > 0:
                    self.consecutive += 1
                    self.total_skipped += 1
                    self.last_skipped_step = first + off
                    if self.policy == "halt":
                        self._escalate(
                            "nonfinite_gradient halted training "
                            f"(nonfinite_policy='halt') at step {first + off}: "
                            "the update was withheld and params are clean; "
                            "inspect the batch, or train with "
                            "nonfinite_policy='skip' to ride through "
                            "transients"
                        )
                    if self.consecutive >= self.max_consecutive:
                        self._escalate(
                            f"{self.consecutive} consecutive nonfinite-"
                            "gradient skips (>= train.max_consecutive_skips="
                            f"{self.max_consecutive}, last at step "
                            f"{first + off}, {self.total_skipped} skipped "
                            "total): gradients are persistently non-finite, "
                            "not a transient — lower the lr or check the data"
                        )
                else:
                    self.consecutive = 0

    def _escalate(self, message: str) -> None:
        if self.on_escalate is not None:
            try:
                self.on_escalate(
                    "nonfinite_escalation",
                    policy=self.policy,
                    consecutive=self.consecutive,
                    total_skipped=self.total_skipped,
                    last_skipped_step=self.last_skipped_step,
                )
            except Exception:  # recording the incident must not mask the error
                pass
        raise NonFiniteEscalation(message)


# ----------------------------------------------------------- shutdown flag


class GracefulShutdown:
    """SIGTERM/SIGINT as a flag checked at dispatch boundaries.

    Context manager: on enter it installs handlers that set
    :attr:`requested` at the first signal; the training loop then saves an
    emergency checkpoint and raises :class:`Preempted`. A second delivery
    of the same signal restores the previous handler and re-raises, so a
    stuck save can still be killed. On exit the previous handlers return.

    Off the main thread (where ``signal.signal`` raises) no handler is
    bound; :meth:`request` still sets the flag.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._prev: Dict[int, Any] = {}
        self._requested = threading.Event()
        self.reason: Optional[str] = None

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def request(self, reason: str = "manual") -> None:
        if not self._requested.is_set():
            self.reason = reason
            self._requested.set()

    def _handle(self, signum, frame) -> None:
        if self._requested.is_set():
            # second signal: fall back to the previous disposition, re-deliver
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            os.kill(os.getpid(), signum)
            return
        try:
            name = signal.Signals(signum).name
        except ValueError:  # an unknown signal number
            name = f"signal {signum}"
        self.request(name)

    def __enter__(self) -> "GracefulShutdown":
        for sig in self.signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # not the main thread
                pass
        return self

    def __exit__(self, *exc: Any) -> bool:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        return False


# ------------------------------------------------------ checkpoint manifest


def config_hash(config) -> str:
    """Stable short hash of a (dataclass) config: manifest provenance."""
    payload = json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a tree of dicts, lists and tuples, paths spelt as
    ``jax.tree_util.keystr`` spells them (``['model']['fc.weight']``,
    ``[0]``); None is an empty subtree, as in a JAX pytree."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves_with_path(value, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf's host bytes as a numpy array, and its dtype's name. numpy has
    no bfloat16, so a bfloat16 tensor goes through a uint8 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_records(tree: Any) -> Dict[str, Dict[str, Any]]:
    leaves: Dict[str, Dict[str, Any]] = {}
    for path, leaf in _leaves_with_path(tree):
        arr, dtype = _host_array(leaf)
        leaves[path] = {
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            "shape": list(leaf.shape) if isinstance(leaf, torch.Tensor) else list(arr.shape),
            "dtype": dtype,
        }
    return leaves


def manifest_path(workdir: str, step: int) -> str:
    return os.path.join(os.path.abspath(workdir), MANIFEST_DIRNAME, f"{int(step)}.json")


def run_topology() -> Dict[str, Any]:
    """The topology a checkpoint was saved under: provenance. The port
    trains in one process on one device."""
    return {"process_count": 1, "device_count": 1}


def write_manifest(
    workdir: str,
    step: int,
    state: Any,
    config=None,
    kind: str = "scheduled",
    writer: str = "sync",
    topology: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Sidecar manifest for the checkpoint at ``step``: leaf count and
    per-leaf CRC32/shape/dtype of the saved tree, the config hash, the save
    ``kind`` (scheduled | emergency | final), whether the trainer thread
    (``sync``) or the background writer (``async``) wrote it, and the
    topology. Written to a tmp file and renamed into place, next to (not
    inside) the step directory."""
    leaves = _leaf_records(state)
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "step": int(step),
        "kind": kind,
        "writer": writer,
        "saved_utc": datetime.now(timezone.utc).isoformat(),
        "config_hash": config_hash(config) if config is not None else None,
        "topology": topology if topology is not None else run_topology(),
        "leaf_count": len(leaves),
        "leaves": leaves,
    }
    path = manifest_path(workdir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)
    return manifest


def load_manifest(workdir: str, step: int) -> Optional[Dict[str, Any]]:
    path = manifest_path(workdir, step)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if manifest.get("schema") != MANIFEST_SCHEMA:
        return None
    return manifest


FEED_BASENAME = "feed.jsonl"


def feed_path(workdir: str) -> str:
    return os.path.join(os.path.abspath(workdir), MANIFEST_DIRNAME, FEED_BASENAME)


def publish_manifest_event(
    workdir: str, step: int, kind: str = "scheduled", writer: str = "sync"
) -> None:
    """Append one line to ``manifests/feed.jsonl``, the rollout feed: the
    order in which verified versions were published, for a serving-side
    watcher to tail. Best-effort: a failed append never fails the save."""
    event = {
        "step": int(step),
        "kind": kind,
        "writer": writer,
        "published_utc": datetime.now(timezone.utc).isoformat(),
    }
    try:
        path = feed_path(workdir)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(event, sort_keys=True) + "\n")
    except OSError:
        pass


def prune_manifests(workdir: str, live_steps) -> None:
    """Drop manifests whose checkpoints the store has deleted."""
    d = os.path.join(os.path.abspath(workdir), MANIFEST_DIRNAME)
    if not os.path.isdir(d):
        return
    keep = {f"{int(s)}.json" for s in live_steps}
    for name in os.listdir(d):
        if name.endswith(".json") and name not in keep:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


def verify_state(manifest: Dict[str, Any], state: Any) -> List[str]:
    """Integrity problems (an empty list means verified). A config hash
    that drifted is not one: warm-starting under an edited config is
    legitimate; restoring torn bytes is not."""
    problems: List[str] = []
    got = _leaf_records(state)
    want = manifest.get("leaves", {})
    if len(got) != manifest.get("leaf_count"):
        problems.append(f"leaf count {len(got)} != manifest {manifest.get('leaf_count')}")
    for key, rec in want.items():
        if key not in got:
            problems.append(f"missing leaf {key}")
        elif got[key]["crc32"] != rec["crc32"]:
            problems.append(
                f"checksum mismatch at {key} (crc32 {got[key]['crc32']} != {rec['crc32']})"
            )
    for key in got:
        if key not in want:
            problems.append(f"unexpected leaf {key}")
    return problems


# ------------------------------------------------------------ the store


class CheckpointStore:
    """One directory per step under ``directory``: ``<step>/state.pt``, a
    ``torch.save`` of a tree of plain containers and tensors. The calls are
    those of the orbax ``CheckpointManager`` the JAX package uses. A save
    writes into ``<step>.tmp-<pid>/`` and renames it into place, then
    deletes the oldest steps past ``max_to_keep``. ``map_location`` is
    where :meth:`restore` puts the tensors."""

    def __init__(self, directory: str, max_to_keep: int = 3, create: bool = True,
                 map_location: Any = "cpu"):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.map_location = map_location
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Every step directory, this format or not (see :meth:`restore`)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isdir(os.path.join(self.directory, name))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        final = self._step_dir(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already exists in {self.directory}")
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)  # left by a crash of a process of this pid
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_FILENAME)
        with open(path, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else ():
            self.delete(old)

    def restore(self, step: int) -> Any:
        """The tree saved at ``step``. A step directory without
        ``state.pt`` raises :class:`ForeignCheckpointError`; any other
        failure to read it is a torn checkpoint."""
        path = os.path.join(self._step_dir(step), STATE_FILENAME)
        if not os.path.exists(path):
            raise ForeignCheckpointError(
                f"checkpoint step {step} in {self.directory} is not this port's format "
                f"(no {STATE_FILENAME}; an orbax checkpoint of the JAX package?): "
                "convert it with models/convert.py::train_state_from_flax"
            )
        return torch.load(path, map_location=self.map_location, weights_only=True)

    def delete(self, step: int) -> None:
        path = self._step_dir(step)
        if not os.path.exists(os.path.join(path, STATE_FILENAME)):
            raise ForeignCheckpointError(
                f"refusing to delete step {step} in {self.directory}: not this port's format")
        shutil.rmtree(path)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for."""


@dataclasses.dataclass
class RestoreResult:
    step: Optional[int]
    state: Any
    manifest: Optional[Dict[str, Any]]
    discarded: List[Tuple[int, str]]


def verified_restore(
    mgr: CheckpointStore,
    workdir: str,
    step: Optional[int] = None,
    log: Callable[[str], None] = print,
) -> RestoreResult:
    """Restore the newest checkpoint that loads AND matches its manifest.

    With an explicit ``step`` there is no walking: a corrupt requested step
    raises (handing back older weights than asked for would be worse than
    failing). With ``step=None`` the steps are tried newest to oldest; each
    discard (load failure or checksum mismatch) is logged and returned, so
    the caller can delete the torn directories. A checkpoint with no
    manifest restores unverified, with a log line saying so. A step that is
    not the store's format raises :class:`ForeignCheckpointError` at once.
    """
    steps = sorted(int(s) for s in mgr.all_steps())
    if step is not None:
        steps = [s for s in steps if s == int(step)]
        if not steps:
            raise ValueError(
                f"checkpoint step {step} not found in {workdir} "
                f"(available: {sorted(mgr.all_steps())})"
            )
    discarded: List[Tuple[int, str]] = []
    for s in reversed(steps):
        try:
            restored = mgr.restore(s)
        except ForeignCheckpointError:
            raise
        except Exception as e:  # a torn or truncated step
            why = f"restore failed: {type(e).__name__}: {str(e)[:200]}"
            if step is not None:
                raise RuntimeError(
                    f"checkpoint step {s} in {workdir} is unrecoverable ({why}); "
                    "pass step=None to fall back to the newest verifiable step"
                ) from e
            discarded.append((s, why))
            log(f"fault: discarding checkpoint step {s} — {why}")
            continue
        manifest = load_manifest(workdir, s)
        if manifest is None:
            log(f"fault: checkpoint step {s} has no manifest — restoring unverified")
            return RestoreResult(s, restored, None, discarded)
        problems = verify_state(manifest, restored)
        if problems:
            why = "; ".join(problems[:3]) + (
                f" (+{len(problems) - 3} more)" if len(problems) > 3 else ""
            )
            if step is not None:
                raise RuntimeError(
                    f"checkpoint step {s} in {workdir} failed manifest verification: {why}"
                )
            discarded.append((s, why))
            log(f"fault: discarding checkpoint step {s} — {why}")
            continue
        if discarded:
            log(f"fault: fell back to verified step {s} after discarding "
                f"{[d[0] for d in discarded]}")
        return RestoreResult(s, restored, manifest, discarded)
    return RestoreResult(None, None, None, discarded)
