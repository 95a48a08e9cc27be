"""The training step: trunk -> RPN -> anchor targets -> proposals -> proposal
targets -> head -> 4 losses -> backward -> guarded Adam update (counterpart
of the JAX package's ``train/train_step.py``).

The losses follow the JAX package: rpn_cls (2-way CE, ignore -1), rpn_reg
(smooth-L1 on anchor positives), head_cls (21-way CE, ignore -1) and
head_reg (smooth-L1 on sampled positives, class-specific deltas), summed
with ``train.loss_weights``.

Random draws. The JAX step keys its sampling with threefry, which PyTorch
cannot reproduce; here every uniform the targets consume is drawn from the
state's device ``torch.Generator``, in a fixed order (:data:`DRAW_NAMES`),
unless the caller injects them. The parity tests inject the JAX step's own
draws; ``chip_smoke.py`` replays one step's draws under
``ops.reference_scope()``.

The optimizer is ``torch.optim.Adam`` with ``weight_decay`` (L2 added to
the gradient, as optax's ``add_decayed_weights`` before ``scale_by_adam``)
and a ``LambdaLR`` per-epoch cosine schedule, stepped only on applied
updates (the optax schedule's count lives in its state, which a withheld
step keeps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig, TrainConfig
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
from replication_faster_rcnn_tpu_torch.models.head import select_class_deltas
from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
from replication_faster_rcnn_tpu_torch.targets import (
    batched_anchor_targets,
    batched_proposal_targets,
    draw_uniform,
)
from replication_faster_rcnn_tpu_torch.train import fault, losses

Tensor = torch.Tensor

# the targets' uniform draws, in the order they are taken from the generator:
# anchor positives/negatives [N, A], roi positives/negatives/pack [N, R + G]
DRAW_NAMES = ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_pack")

# stage(name) -> context manager around one stage (timing hooks); the
# default does nothing
StageFn = Callable[[str], contextlib.AbstractContextManager]


def _no_stage(name: str) -> contextlib.AbstractContextManager:
    return contextlib.nullcontext()


@dataclasses.dataclass
class TrainState:
    """What a step carries: the model (parameters + BatchNorm statistics),
    the optimizer and schedule, the sampling generator and the step count."""

    model: FasterRCNN
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator
    step: int = 0


def _cosine_factor(tc: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    def factor(step: int) -> float:
        epoch = min(int(step) // max(steps_per_epoch, 1), tc.n_epoch)
        return 0.5 * (1.0 + math.cos(math.pi * epoch / tc.n_epoch))

    return factor


def make_optimizer(
    config: FasterRCNNConfig, params, steps_per_epoch: int
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam(lr, weight_decay) with a per-epoch cosine schedule: the lr at
    applied step k is ``lr * 0.5 * (1 + cos(pi * epoch / n_epoch))``,
    epoch = min(k // steps_per_epoch, n_epoch)."""
    tc = config.train
    optimizer = torch.optim.Adam(params, lr=tc.lr, weight_decay=tc.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, _cosine_factor(tc, steps_per_epoch))
    return optimizer, scheduler


def host_schedule(config: FasterRCNNConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The schedule's lr at a step, in plain Python (for log rows)."""
    factor = _cosine_factor(config.train, steps_per_epoch)
    return lambda step: float(config.train.lr * factor(step))


def create_train_state(
    config: FasterRCNNConfig,
    steps_per_epoch: int,
    device: DeviceLike = None,
    seed: int = 0,
) -> TrainState:
    """A seeded model in training mode with its optimizer, schedule and a
    device generator seeded from ``seed``."""
    dev = resolve_device(device)
    model = build_model(config, device=dev, seed=seed).train()
    optimizer, scheduler = make_optimizer(config, model.parameters(), steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model, optimizer, scheduler, generator)


def pending_batch_stats(model: torch.nn.Module) -> fault.PendingStats:
    """The new BatchNorm running statistics the last training forward left."""
    return [
        (m, m.pending_stats)
        for m in model.modules()
        if isinstance(m, BatchNorm) and m.pending_stats is not None
    ]


def compute_losses(
    model: FasterRCNN,
    config: FasterRCNNConfig,
    batch: Dict[str, Tensor],
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, Tensor]] = None,
    record: Optional[dict] = None,
    stage: StageFn = _no_stage,
) -> Tuple[Tensor, Tuple[Dict[str, Tensor], fault.PendingStats]]:
    """Forward + 4 losses on a device batch (``image`` [N, H, W, 3],
    ``boxes`` [N, G, 4], ``labels`` [N, G], ``mask`` [N, G]). Returns
    (total, (metrics, new BatchNorm statistics)).

    ``draws`` injects the uniforms by name (:data:`DRAW_NAMES`); missing
    ones come from ``generator``. ``record``, when given, receives the
    draws used and the targets (``rpn_reg``, ``rpn_labels``,
    ``sample_rois``, ``roi_reg``, ``roi_labels``)."""
    images = batch["image"]
    gt_boxes, gt_labels, gt_mask = batch["boxes"], batch["labels"], batch["mask"]
    img_h, img_w = float(images.shape[1]), float(images.shape[2])
    sigma = config.train.smooth_l1_sigma
    used = dict(draws or {})

    def draw(name: str, shape) -> Tensor:
        if name not in used:
            if generator is None:
                raise ValueError(f"draw {name!r} was not injected and no generator was given")
            used[name] = draw_uniform(generator, shape, images.device)
        return used[name]

    with stage("trunk"):
        feat = model.extract_features(images)
    with stage("rpn"):
        logits, deltas, anchors = model.rpn_forward(feat)
    n, a = logits.shape[:2]
    with stage("anchor_targets"):
        reg_t, lab_t = batched_anchor_targets(
            gt_boxes, gt_mask, anchors, config.rpn_targets,
            draw("rpn_pos", (n, a)), draw("rpn_neg", (n, a)),
        )
    with stage("losses"):
        rpn_reg_loss = losses.loc_loss(deltas, reg_t, lab_t, sigma)
        rpn_cls_loss = losses.ignore_cross_entropy(logits, lab_t)
    with stage("proposals"):
        rois, roi_valid = model.propose(logits, deltas, anchors, img_h, img_w, train=True)
    n_cand = (n, rois.shape[1] + gt_boxes.shape[1])
    with stage("proposal_targets"):
        sample_rois, reg_t2, lab_t2 = batched_proposal_targets(
            rois, roi_valid, gt_boxes, gt_labels, gt_mask, config.roi_targets,
            draw("roi_pos", n_cand), draw("roi_neg", n_cand), draw("roi_pack", n_cand),
            strategy=config.train.sampling_strategy,
        )
    with stage("head"):
        cls_out, reg_out = model.head_forward(feat, sample_rois, img_h, img_w,
                                              generator=generator)
    with stage("losses"):
        reg_sel = select_class_deltas(reg_out, lab_t2)
        head_reg_loss = losses.loc_loss(reg_sel, reg_t2, lab_t2, sigma)
        head_cls_loss = losses.ignore_cross_entropy(cls_out, lab_t2)
        w1, w2, w3, w4 = config.train.loss_weights
        total = w1 * rpn_cls_loss + w2 * rpn_reg_loss + w3 * head_cls_loss + w4 * head_reg_loss
    if record is not None:
        record["draws"] = used
        record["targets"] = {
            "rpn_reg": reg_t, "rpn_labels": lab_t, "sample_rois": sample_rois,
            "roi_reg": reg_t2, "roi_labels": lab_t2,
        }
    metrics = {
        "loss": total.detach(),
        "rpn_cls_loss": rpn_cls_loss.detach(),
        "rpn_reg_loss": rpn_reg_loss.detach(),
        "head_cls_loss": head_cls_loss.detach(),
        "head_reg_loss": head_reg_loss.detach(),
        "n_pos_rpn": (lab_t == 1).sum().float(),
        "n_pos_head": (lab_t2 > 0).sum().float(),
    }
    return total, (metrics, pending_batch_stats(model))


def make_train_step(config: FasterRCNNConfig):
    """(state, batch, draws=None, record=None, stage=...) -> metrics: one
    optimizer step, gated by ``train.nonfinite_policy``."""

    def train_step(
        state: TrainState,
        batch: Dict[str, Tensor],
        draws: Optional[Dict[str, Tensor]] = None,
        record: Optional[dict] = None,
        stage: StageFn = _no_stage,
    ) -> Dict[str, Tensor]:
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, (metrics, new_stats) = compute_losses(
            model, config, batch, state.generator, draws, record, stage
        )
        with stage("backward"):
            total.backward()
        with stage("optimizer"):
            health = fault.guarded_update(
                state.optimizer, state.scheduler, list(model.parameters()), new_stats,
                config.train.nonfinite_policy,
            )
        state.step += 1
        metrics.update(health)
        return metrics

    return train_step
