"""Inference decode: proposals + head outputs -> final detections
(counterpart of the JAX package's ``eval/detect.py``).

* reg outputs are de-normalised with ``roi_targets.reg_std`` / ``reg_mean``
  before decoding; class c uses deltas [4c:4c+4];
* scores are the softmax over classes; class 0 (background) is dropped;
* (roi, class) pairs are flattened roi-major, class-minor, thresholded at
  ``score_thresh``, and go through one class-offset NMS per image that
  keeps ``max_detections``;
* flip test-time augmentation (:func:`batched_decode_tta`) decodes a second
  pass run on the mirrored image, reflects its boxes back and sends the
  union of both passes' candidates through that one NMS, so duplicates
  across the passes suppress each other.

The batched functions take rois [N, R, 4] -> detections [N, D, ...];
:func:`decode_detections` and :func:`decode_detections_tta` are their
one-image forms.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.config import EvalConfig, ROITargetConfig
from replication_faster_rcnn_tpu_torch.ops import boxes as box_ops
from replication_faster_rcnn_tpu_torch.ops import nms as nms_ops

Tensor = torch.Tensor


def _class_boxes_scores(
    rois: Tensor,
    cls_logits: Tensor,
    reg_out: Tensor,
    img_h: float,
    img_w: float,
    roi_cfg: ROITargetConfig,
) -> Tuple[Tensor, Tensor]:
    """Pre-NMS stage: (probs [N, R, C], clipped class boxes [N, R, C, 4])."""
    n, r, c = cls_logits.shape
    dev = cls_logits.device
    probs = torch.softmax(cls_logits, dim=-1)
    # cached device constants: no host copy per call, so a CUDA graph may
    # capture the decode
    mean = ops.constant(roi_cfg.reg_mean, torch.float32, dev)
    std = ops.constant(roi_cfg.reg_std, torch.float32, dev)
    deltas = reg_out.reshape(n, r, c, 4) * std + mean
    boxes = box_ops.decode(rois[:, :, None, :], deltas)
    return probs, box_ops.clip(boxes, img_h, img_w)


def _nms_tail(
    boxes: Tensor,
    probs: Tensor,
    roi_valid: Tensor,
    eval_cfg: EvalConfig,
) -> Dict[str, Tensor]:
    """Flatten the (roi, class > 0) pairs, threshold the scores, one
    class-offset NMS per image, D = ``eval_cfg.max_detections`` outputs."""
    n, r, c = probs.shape
    dev = probs.device
    flat_boxes = boxes.reshape(n, r * c, 4)
    flat_scores = probs.reshape(n, r * c)
    class_ids = torch.arange(c, dtype=torch.int64, device=dev).repeat(r)  # [R*C]
    fg = (class_ids > 0) & torch.repeat_interleave(roi_valid, c, dim=1)
    fg &= flat_scores >= eval_cfg.score_thresh

    idx, valid = nms_ops.batched_nms_fixed(
        flat_boxes, flat_scores, class_ids, eval_cfg.nms_thresh,
        eval_cfg.max_detections, mask=fg,
    )
    picked = torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4))
    zero = flat_scores.new_zeros(())
    return {
        "boxes": picked * valid[..., None],
        "scores": torch.where(valid, torch.gather(flat_scores, 1, idx), zero),
        "classes": torch.where(valid, class_ids[idx], torch.zeros_like(idx)).to(torch.int32),
        "valid": valid,
    }


def batched_decode(
    rois: Tensor,
    roi_valid: Tensor,
    cls_logits: Tensor,
    reg_out: Tensor,
    img_h: float,
    img_w: float,
    eval_cfg: EvalConfig,
    roi_cfg: ROITargetConfig,
) -> Dict[str, Tensor]:
    """rois [N, R, 4], roi_valid [N, R], cls_logits [N, R, C], reg_out
    [N, R, C*4] -> dict of 'boxes' [N, D, 4], 'scores' [N, D], 'classes'
    [N, D] int32, 'valid' [N, D] bool, D = eval_cfg.max_detections."""
    probs, boxes = _class_boxes_scores(rois, cls_logits, reg_out, img_h, img_w, roi_cfg)
    return _nms_tail(boxes, probs, roi_valid, eval_cfg)


def batched_decode_tta(
    plain: Tuple[Tensor, Tensor, Tensor, Tensor],
    mirrored: Tuple[Tensor, Tensor, Tensor, Tensor],
    img_h: float,
    img_w: float,
    eval_cfg: EvalConfig,
    roi_cfg: ROITargetConfig,
) -> Dict[str, Tensor]:
    """Flip test-time augmentation: ``plain`` and ``mirrored`` are each
    (rois, roi_valid, cls_logits, reg_out) as :func:`batched_decode` takes
    them, ``mirrored`` from the pass on the horizontally flipped images and
    still in the mirrored frame. Its class boxes are reflected back
    (x -> img_w - x on columns 1 and 3 of ``[y1, x1, y2, x2]``) and the 2R
    rois' candidates go through one NMS per image."""
    probs_a, boxes_a = _class_boxes_scores(plain[0], plain[2], plain[3], img_h, img_w, roi_cfg)
    probs_b, boxes_b = _class_boxes_scores(
        mirrored[0], mirrored[2], mirrored[3], img_h, img_w, roi_cfg)
    boxes_b = torch.stack(
        [boxes_b[..., 0], img_w - boxes_b[..., 3], boxes_b[..., 2], img_w - boxes_b[..., 1]],
        dim=-1,
    )
    probs = torch.cat([probs_a, probs_b], dim=1)  # [N, 2R, C]
    boxes = torch.cat([boxes_a, boxes_b], dim=1)  # [N, 2R, C, 4]
    valid = torch.cat([plain[1], mirrored[1]], dim=1)
    return _nms_tail(boxes, probs, valid, eval_cfg)


def _one_image(out: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v[0] for k, v in out.items()}


def decode_detections(
    rois: Tensor,
    roi_valid: Tensor,
    cls_logits: Tensor,
    reg_out: Tensor,
    img_h: float,
    img_w: float,
    eval_cfg: EvalConfig,
    roi_cfg: ROITargetConfig,
) -> Dict[str, Tensor]:
    """One image: rois [R, 4], roi_valid [R], cls_logits [R, C], reg_out
    [R, C*4] -> dict of [D, ...] (see :func:`batched_decode`)."""
    return _one_image(batched_decode(
        rois[None], roi_valid[None], cls_logits[None], reg_out[None],
        img_h, img_w, eval_cfg, roi_cfg,
    ))


def decode_detections_tta(
    rois: Tensor,
    roi_valid: Tensor,
    cls_logits: Tensor,
    reg_out: Tensor,
    rois_f: Tensor,
    roi_valid_f: Tensor,
    cls_logits_f: Tensor,
    reg_out_f: Tensor,
    img_h: float,
    img_w: float,
    eval_cfg: EvalConfig,
    roi_cfg: ROITargetConfig,
) -> Dict[str, Tensor]:
    """One image's flip test-time augmentation: the plain pass's rois
    [R, 4], roi_valid [R], cls_logits [R, C], reg_out [R, C*4] and the
    mirrored pass's (``*_f``, still in the mirrored frame) -> dict of
    [D, ...] (see :func:`batched_decode_tta`)."""
    return _one_image(batched_decode_tta(
        (rois[None], roi_valid[None], cls_logits[None], reg_out[None]),
        (rois_f[None], roi_valid_f[None], cls_logits_f[None], reg_out_f[None]),
        img_h, img_w, eval_cfg, roi_cfg,
    ))
