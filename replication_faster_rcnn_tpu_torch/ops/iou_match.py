"""IoU matching of boxes against padded ground truth — the plain PyTorch
version of the IoU-matching kernel (``csrc/iou_match_kernel.cu``).

Counterpart of the jnp matching in the JAX package's
``targets/anchor_targets.py`` / ``targets/proposal_targets.py`` (and of its
Pallas kernel ``ops/pallas/iou_kernel.py``), with the batch written out:

* boxes [M, 4] or [B or 1, M, 4] (a leading 1 shares the boxes — the
  anchors — across the batch), gt [B, G, 4], gt_mask [B, G] bool;
* IoU [B, M, G] with padded gt columns set to -1 (they never match);
* row argmax [B, M] int64 (first occurrence on ties) and row
  ``max(max(iou, 0))`` [B, M] float32;
* optionally the column argmax [B, G] int64 (each gt's best box, first
  occurrence on ties), which the anchor targets use to force-match.

Every IoU is ``ops/boxes.py::iou``, strict IEEE float32, so the kernel and
this version agree bit for bit. :func:`match_boxes_auto` is the dispatch
point: the kernel for CUDA tensors, this version for CPU tensors or inside
:class:`ops.reference_scope`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.ops import boxes as box_ops

Tensor = torch.Tensor


def _batched(boxes: Tensor, gt: Tensor) -> Tensor:
    if gt.dim() != 3 or gt.shape[-1] != 4:
        raise ValueError(f"gt must be [B, G, 4], got {tuple(gt.shape)}")
    if boxes.dim() == 2:
        boxes = boxes[None]
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.shape[0] not in (1, gt.shape[0]):
        raise ValueError(
            f"boxes must be [M, 4] or [1 or {gt.shape[0]}, M, 4], got {tuple(boxes.shape)}"
        )
    return boxes


def iou_matrix(boxes: Tensor, gt: Tensor, gt_mask: Tensor) -> Tensor:
    """[B, M, G] IoU, -1 on padded gt columns."""
    boxes = _batched(boxes, gt)
    ious = box_ops.iou(boxes.float(), gt.float())
    return torch.where(gt_mask[:, None, :], ious, ious.new_full((), -1.0))


def match_boxes(
    boxes: Tensor, gt: Tensor, gt_mask: Tensor, want_col: bool = True
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """(ious [B, M, G], argmax [B, M], max_iou [B, M], col_argmax [B, G] or
    None) — the matching of ``targets/anchor_targets.py`` and, without the
    column argmax, of ``targets/proposal_targets.py``."""
    ious = iou_matrix(boxes, gt, gt_mask)
    argmax = torch.argmax(ious, dim=2)  # first maximum
    max_iou = torch.amax(torch.clamp(ious, min=0.0), dim=2)
    col = torch.argmax(ious, dim=1) if want_col else None
    return ious, argmax, max_iou, col


def match_boxes_auto(
    boxes: Tensor, gt: Tensor, gt_mask: Tensor, want_col: bool = True
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(argmax, max_iou, col_argmax or None) for the targets: the CUDA
    kernel for a CUDA tensor (it never writes the IoU matrix, which no
    caller reads past the reductions), the plain version for a CPU tensor
    or inside :class:`ops.reference_scope`."""
    if ops.reference_requested():
        _, argmax, max_iou, col = match_boxes(boxes, gt, gt_mask, want_col)
        return argmax, max_iou, col
    # imported here: the kernel wrapper imports this module
    from replication_faster_rcnn_tpu_torch.ops.cuda.iou_kernel import match_boxes_cuda

    _, argmax, max_iou, col = match_boxes_cuda(boxes, gt, gt_mask, want_col, want_iou=False)
    return argmax, max_iou, col
