"""RPN (first-stage) target assignment, fixed shape, on the device
(counterpart of the JAX package's ``targets/anchor_targets.py``).

* label -1 = ignore, 0 = negative (max IoU < neg_thresh), 1 = positive
  (max IoU >= pos_thresh);
* each valid gt's best anchor is forced positive and its regression target
  points at that gt (when two gts share a best anchor, the later gt wins,
  as the JAX package's scatter resolves it);
* subsampling: at most ``pos_ratio * n_sample`` positives, negatives fill
  the rest of ``n_sample``, drawn with the given uniforms;
* regression targets encode(anchor, matched gt) for all anchors; zeros and
  no positives for an image without gt.

The IoU matching is the CUDA kernel for CUDA tensors
(``ops/iou_match.py::match_boxes_auto``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from replication_faster_rcnn_tpu_torch.config import RPNTargetConfig
from replication_faster_rcnn_tpu_torch.ops import boxes as box_ops
from replication_faster_rcnn_tpu_torch.ops.iou_match import match_boxes_auto
from replication_faster_rcnn_tpu_torch.targets.sampling import random_subset_mask

Tensor = torch.Tensor


def batched_anchor_targets(
    gt_boxes: Tensor,
    gt_mask: Tensor,
    anchors: Tensor,
    cfg: RPNTargetConfig,
    u_pos: Tensor,
    u_neg: Tensor,
) -> Tuple[Tensor, Tensor]:
    """gt_boxes [N, G, 4], gt_mask [N, G] bool, anchors [A, 4], uniform
    draws u_pos/u_neg [N, A] -> (reg [N, A, 4] f32, labels [N, A] int64)."""
    n, g = gt_mask.shape
    a = anchors.shape[0]
    gt_boxes = gt_boxes.float()
    has_gt = gt_mask.any(dim=1)[:, None]  # [N, 1]
    argmax, max_iou, best_anchor = match_boxes_auto(anchors, gt_boxes, gt_mask, want_col=True)

    # force-match each valid gt's best anchor; the last gt naming an anchor wins
    target_row = torch.where(gt_mask, best_anchor, a)  # [N, G], a = no anchor
    rows = torch.arange(a, device=anchors.device)
    hits = rows[None, :, None] == target_row[:, None, :]  # [N, A, G]
    last = (hits * torch.arange(1, g + 1, device=anchors.device)).amax(dim=2)  # 0 = none
    forced = last > 0
    argmax = torch.where(forced, last - 1, argmax)

    labels = torch.full((n, a), -1, dtype=torch.int64, device=anchors.device)
    labels = torch.where(max_iou < cfg.neg_iou_thresh, 0, labels)
    labels = torch.where(max_iou >= cfg.pos_iou_thresh, 1, labels)
    labels = torch.where(forced & has_gt, 1, labels)

    n_pos = int(cfg.pos_ratio * cfg.n_sample)
    pos_keep = random_subset_mask(u_pos, labels == 1, n_pos, k_max=n_pos)
    labels = torch.where((labels == 1) & ~pos_keep, -1, labels)
    n_neg = cfg.n_sample - (labels == 1).sum(dim=1)
    neg_keep = random_subset_mask(u_neg, labels == 0, n_neg, k_max=cfg.n_sample)
    labels = torch.where((labels == 0) & ~neg_keep, -1, labels)

    matched = torch.gather(gt_boxes, 1, argmax[..., None].expand(n, a, 4))
    reg = box_ops.encode(anchors[None], matched)
    reg = torch.where(has_gt[..., None], reg, 0.0)
    labels = torch.where(has_gt, labels, torch.where(labels == 1, -1, labels))
    return reg.float(), labels


def anchor_targets(
    gt_boxes: Tensor,
    gt_mask: Tensor,
    anchors: Tensor,
    cfg: RPNTargetConfig,
    u_pos: Tensor,
    u_neg: Tensor,
) -> Tuple[Tensor, Tensor]:
    """One image: gt_boxes [G, 4], gt_mask [G], draws [A] ->
    (reg [A, 4], labels [A])."""
    reg, labels = batched_anchor_targets(
        gt_boxes[None], gt_mask[None], anchors, cfg, u_pos[None], u_neg[None]
    )
    return reg[0], labels[0]
