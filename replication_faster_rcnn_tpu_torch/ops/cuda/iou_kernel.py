"""Wrapper of the CUDA IoU-matching kernel (``csrc/iou_match_kernel.cu``).

Counterpart of the JAX package's ``ops/pallas/iou_kernel.py``
(``match_boxes_pallas`` / ``iou_matrix_pallas``) with the batch written
out. A CPU tensor runs the plain version ``ops/iou_match.py::match_boxes``,
which the kernel matches bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build
from replication_faster_rcnn_tpu_torch.ops.iou_match import _batched, match_boxes

Tensor = torch.Tensor

# kernel launches since the last reset (the caller resets it to 0)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.library("iou_match_kernel")
        fn = lib.iou_match_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.iou_match_error_string.argtypes = [ctypes.c_int]
        lib.iou_match_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.iou_match_error_string)
    return _fn


def match_boxes_cuda(
    boxes: Tensor,
    gt: Tensor,
    gt_mask: Tensor,
    want_col: bool = True,
    want_iou: bool = True,
) -> Tuple[Optional[Tensor], Tensor, Tensor, Optional[Tensor]]:
    """Same contract as :func:`match_boxes` (bit-identical outputs):
    boxes [M, 4] or [B or 1, M, 4], gt [B, G, 4], gt_mask [B, G] bool ->
    (ious [B, M, G] or None unless ``want_iou``, argmax [B, M] int64,
    max_iou [B, M] f32, col_argmax [B, G] int64 or None unless
    ``want_col``). One launch for the whole batch."""
    if not gt.is_cuda:
        ious, argmax, max_iou, col = match_boxes(boxes, gt, gt_mask, want_col)
        return (ious if want_iou else None), argmax, max_iou, col
    boxes = _batched(boxes, gt)
    bsz, g = gt.shape[:2]
    m = boxes.shape[1]
    if g < 1:
        raise ValueError("gt must hold at least one (possibly padded) box")
    if gt_mask.shape != (bsz, g) or gt_mask.dtype != torch.bool:
        raise ValueError(f"gt_mask must be bool {(bsz, g)}, got {gt_mask.dtype} {tuple(gt_mask.shape)}")
    if not (boxes.is_cuda and gt_mask.is_cuda) or not (boxes.device == gt.device == gt_mask.device):
        raise ValueError("boxes, gt and gt_mask must be on the same CUDA device")
    dev = gt.device
    boxes = boxes.float().contiguous()
    gt = gt.float().contiguous()
    gt_mask = gt_mask.contiguous()
    ious = torch.empty(bsz, m, g, dtype=torch.float32, device=dev) if want_iou else None
    argmax = torch.empty(bsz, m, dtype=torch.int64, device=dev)
    max_iou = torch.empty(bsz, m, dtype=torch.float32, device=dev)
    col = torch.empty(bsz, g, dtype=torch.int64, device=dev) if want_col else None
    fn, err = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            boxes.data_ptr(), m if boxes.shape[0] == bsz and bsz > 1 else 0,
            gt.data_ptr(), gt_mask.data_ptr(), bsz, m, g,
            ious.data_ptr() if ious is not None else None,
            argmax.data_ptr(), max_iou.data_ptr(),
            col.data_ptr() if col is not None else None,
            stream,
        )
    build.check(rc, err, "iou_match_kernel")
    global launches
    launches += 1
    return ious, argmax, max_iou, col
