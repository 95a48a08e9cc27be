"""A reduced trainer (counterpart of the JAX package's ``train/trainer.py``):
one process, one device, batches collated in the loop from a seeded
per-epoch shuffle of the dataset, one :func:`make_train_step` call per batch.

Not ported yet: the mesh and data parallelism, checkpointing and restore,
telemetry, the threaded loader and device prefetch, augmentation, K-step
fusion and evaluation.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.data.loader import collate
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.train.fault import NonFiniteEscalation
from replication_faster_rcnn_tpu_torch.train.train_step import (
    create_train_state,
    host_schedule,
    make_train_step,
)

Tensor = torch.Tensor


class Trainer:
    """``Trainer(config, dataset, device=None, seed=None)``: the device
    defaults to ``cuda`` (raising without a GPU); ``seed`` (default
    ``config.train.seed``) seeds the weights, the sampling generator and
    the shuffle."""

    def __init__(
        self,
        config: FasterRCNNConfig,
        dataset,
        device: DeviceLike = None,
        seed: Optional[int] = None,
    ):
        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device)
        self.seed = config.train.seed if seed is None else int(seed)
        self.batch_size = config.train.batch_size
        if len(dataset) < self.batch_size:
            raise ValueError(
                f"the dataset holds {len(dataset)} samples, fewer than one batch of "
                f"{self.batch_size}"
            )
        self.steps_per_epoch = len(dataset) // self.batch_size  # the tail is dropped
        self.state = create_train_state(config, self.steps_per_epoch, self.device, self.seed)
        self.step_fn = make_train_step(config)
        self.host_schedule = host_schedule(config, self.steps_per_epoch)

    @property
    def model(self):
        return self.state.model

    def batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's host batches: a ``RandomState(seed + epoch)``
        permutation cut into full batches."""
        order = np.random.RandomState(self.seed + epoch).permutation(len(self.dataset))
        for i in range(self.steps_per_epoch):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield collate([self.dataset[int(j)] for j in idx])

    def stage_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Tensor]:
        """Host batch -> the step's device tensors."""
        return {
            k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device)
            for k in ("image", "boxes", "labels", "mask")
        }

    def train_one_batch(self, batch: Dict[str, np.ndarray], **step_kw) -> Dict[str, float]:
        """One optimizer step on a host batch; returns the metrics as floats
        (one synchronisation). Raises :class:`NonFiniteEscalation` when the
        update was withheld under ``nonfinite_policy='halt'``. ``step_kw``
        passes through to the step (``draws``, ``record``, ``stage``)."""
        lr = self.host_schedule(self.state.scheduler.last_epoch)
        metrics = self.step_fn(self.state, self.stage_batch(batch), **step_kw)
        out = {k: float(v) for k, v in metrics.items()}
        out["lr"] = lr
        if out["skipped"] > 0 and self.config.train.nonfinite_policy == "halt":
            raise NonFiniteEscalation(
                f"non-finite gradient at step {self.state.step} "
                f"({int(out['nonfinite_count'])} entries); update withheld"
            )
        return out

    def train(self, steps: int) -> List[Dict[str, float]]:
        """``steps`` optimizer steps, continuing from the current step;
        returns each step's metrics."""
        history: List[Dict[str, float]] = []
        while len(history) < steps:
            epoch, offset = divmod(self.state.step, self.steps_per_epoch)
            for i, batch in enumerate(self.batches(epoch)):
                if i < offset:
                    continue
                history.append(self.train_one_batch(batch))
                if len(history) == steps:
                    break
        return history
