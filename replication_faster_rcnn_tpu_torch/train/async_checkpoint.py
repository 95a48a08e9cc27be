"""Background scheduled checkpointing (counterpart of the JAX package's
``train/async_checkpoint.py``): the write off the critical path.

* **Trainer thread (blocking, cheap):** copy every leaf of the state to
  host memory once (the optimizer updates the parameters in place, so the
  copy must land before the next step is dispatched) and hand the
  snapshot to the writer. If the PREVIOUS save is still in flight, block
  until it lands first: at most one save is in flight, so a slow disk
  applies backpressure instead of piling snapshots up in RAM.
* **Writer thread (slow, off-path):** ``torch.save`` and fsync, the CRC
  manifest and its rename (``fault.write_manifest``, as on the sync path),
  then manifest pruning. Host work only: the writer makes no CUDA call.

Only ``scheduled`` saves ride the writer. Emergency (preemption) and final
saves stay synchronous on the trainer thread: they are the last chance to
persist anything. The trainer drains the writer before any synchronous
save and before restore, so the store is never touched from two threads.

A writer failure is recorded and surfaced at the next drain point, with
the scheduled-save containment (incident + stderr warning, training
continues, the next interval retries). The failed step's manifest was
never renamed into place, so ``verified_restore``'s fallback walk handles
what it left.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple


class AsyncCheckpointWriter:
    """Single background writer with an in-flight bound of one save.

    Checkpoints must land in submission order and two writers on one store
    would race, so the "queue" is the single in-flight slot: :meth:`submit`
    first waits for the previous save (the only case where the trainer
    blocks on checkpoint I/O at all).

    All methods are meant for ONE controlling thread (the trainer); the
    background thread only runs the submitted work item.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        # _error crosses the writer->trainer boundary: written by the
        # writer on failure, read-and-cleared by the trainer at drain.
        self._lock = threading.Lock()
        self._error: Optional[Tuple[int, BaseException]] = None

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def wait(self) -> Optional[Tuple[int, BaseException]]:
        """Block until no save is in flight. Returns (step, exception) of
        a failed background save (once, then the error slot is cleared)
        or None. Never raises: the caller owns the containment policy."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        return err

    def submit(
        self, step: int, work: Callable[[], None]
    ) -> Optional[Tuple[int, BaseException]]:
        """Run ``work`` (the serialize + manifest closure for ``step``) on
        the background writer. Blocks only while a previous save is in
        flight; returns that save's deferred error, if any, as
        :meth:`wait` does."""
        err = self.wait()

        def _run() -> None:
            try:
                work()
            except BaseException as e:  # noqa: BLE001 — surfaced at drain
                with self._lock:
                    self._error = (int(step), e)

        # Non-daemon: a checkpoint caught mid-fsync by interpreter exit
        # must finish, not be killed; the thread ends once work() returns.
        t = threading.Thread(target=_run, name="ckpt-writer", daemon=False)
        self._thread = t
        t.start()
        return err
