"""Second-stage (head) target assignment, fixed shape, on the device
(counterpart of the JAX package's ``targets/proposal_targets.py``).

* gt boxes join the candidate pool (rois + gt);
* positives: IoU >= pos_iou_thresh, at most ``n_pos_max``; negatives:
  neg_low <= IoU < neg_high, filling to ``n_sample`` (uniform draws, or the
  highest IoUs under ``strategy="topk_iou"``);
* the output is always exactly ``n_sample`` slots per image: positives
  first, then negatives, then filler (label -1, zero roi), in a random
  order inside each group;
* regression targets encode(sample roi, matched gt), normalised by
  (reg_mean, reg_std), zero off the positives; labels are the gt class for
  positives and 0 for negatives.

The IoU matching is the CUDA kernel for CUDA tensors (without the column
argmax, which this site does not need).
"""

from __future__ import annotations

from typing import Tuple

import torch

from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.config import ROITargetConfig
from replication_faster_rcnn_tpu_torch.ops import boxes as box_ops
from replication_faster_rcnn_tpu_torch.ops.iou_match import match_boxes_auto
from replication_faster_rcnn_tpu_torch.targets.sampling import (
    pack_by_priority,
    random_subset_mask,
    topk_subset_mask,
)

Tensor = torch.Tensor


def batched_proposal_targets(
    rois: Tensor,
    roi_valid: Tensor,
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_mask: Tensor,
    cfg: ROITargetConfig,
    u_pos: Tensor,
    u_neg: Tensor,
    u_pack: Tensor,
    strategy: str = "random",
) -> Tuple[Tensor, Tensor, Tensor]:
    """rois [N, R, 4], roi_valid [N, R], gt [N, G, 4] / labels [N, G] /
    mask [N, G], uniform draws [N, R + G] each ->
    (sample_rois [N, S, 4], reg [N, S, 4], labels [N, S] int64), S = n_sample."""
    n_sample = cfg.n_sample
    gt_boxes = gt_boxes.float()
    cand = torch.cat([rois.float(), gt_boxes], dim=1)  # [N, R+G, 4]
    cand_valid = torch.cat([roi_valid, gt_mask], dim=1)
    assignment, max_iou, _ = match_boxes_auto(cand, gt_boxes, gt_mask, want_col=False)
    max_iou = torch.where(cand_valid, max_iou, -1.0)  # padded rois match nothing

    is_pos = cand_valid & (max_iou >= cfg.pos_iou_thresh)
    is_neg = cand_valid & (max_iou < cfg.neg_iou_thresh_high) & (max_iou >= cfg.neg_iou_thresh_low)
    if strategy == "topk_iou":
        pos_keep = topk_subset_mask(is_pos, max_iou, cfg.n_pos_max, k_max=cfg.n_pos_max)
        neg_keep = topk_subset_mask(
            is_neg, max_iou, n_sample - pos_keep.sum(dim=1), k_max=n_sample
        )
    elif strategy == "random":
        pos_keep = random_subset_mask(u_pos, is_pos, cfg.n_pos_max, k_max=cfg.n_pos_max)
        neg_keep = random_subset_mask(
            u_neg, is_neg, n_sample - pos_keep.sum(dim=1), k_max=n_sample
        )
    else:
        raise ValueError(f"unknown sampling strategy {strategy!r}")

    priority = torch.where(pos_keep, 0, torch.where(neg_keep, 1, 2))
    idx = pack_by_priority(u_pack, priority, n_sample)  # [N, S]
    slot_pos = torch.gather(pos_keep, 1, idx)
    slot_neg = torch.gather(neg_keep, 1, idx)
    sample_rois = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 4))
    sample_rois = sample_rois * (slot_pos | slot_neg)[..., None]

    assign = torch.gather(assignment, 1, idx)
    matched_gt = torch.gather(gt_boxes, 1, assign[..., None].expand(-1, -1, 4))
    reg = box_ops.encode(sample_rois, matched_gt)
    mean = ops.constant(cfg.reg_mean, torch.float32, reg.device)
    std = ops.constant(cfg.reg_std, torch.float32, reg.device)
    reg = torch.where(slot_pos[..., None], (reg - mean) / std, 0.0)

    gt_cls = torch.gather(gt_labels.long(), 1, assign)
    labels = torch.where(slot_pos, gt_cls, torch.where(slot_neg, 0, -1))
    return sample_rois.float(), reg.float(), labels


def proposal_targets(
    rois: Tensor,
    roi_valid: Tensor,
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_mask: Tensor,
    cfg: ROITargetConfig,
    u_pos: Tensor,
    u_neg: Tensor,
    u_pack: Tensor,
    strategy: str = "random",
) -> Tuple[Tensor, Tensor, Tensor]:
    """One image: rois [R, 4], gt [G, 4], draws [R + G] ->
    (sample_rois [S, 4], reg [S, 4], labels [S])."""
    out = batched_proposal_targets(
        rois[None], roi_valid[None], gt_boxes[None], gt_labels[None], gt_mask[None],
        cfg, u_pos[None], u_neg[None], u_pack[None], strategy,
    )
    return tuple(x[0] for x in out)
