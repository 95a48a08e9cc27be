"""Wrapper of the CUDA greedy-NMS kernels (``csrc/nms_kernel.cu``).

Counterpart of the JAX package's ``ops/pallas/nms_kernel.py::nms_fixed_pallas``.
As there, score clean-up and the stable descending sort run outside the
kernels (``nms_tiled.prepare_candidates``). One call computes the
suppression bitmasks of the sorted candidates across the card and walks them
greedily, one block per image, in chunks of candidates (a mask and a walk
kernel per chunk; the chunks after the walk reaches ``max_out`` exit at
once). A CPU tensor runs the plain version ``nms_fixed_tiled``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build
from replication_faster_rcnn_tpu_torch.ops.nms_tiled import (
    nms_fixed_tiled,
    prepare_candidates,
)

Tensor = torch.Tensor

# kernel launches since the last reset (the caller resets it to 0)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.library("nms_kernel")
        fn = lib.nms_greedy_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.nms_error_string.argtypes = [ctypes.c_int]
        lib.nms_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.nms_error_string)
    return _fn


def scratch_words(bsz: int, n: int) -> int:
    """uint64 words of the kernels' scratch, per image: each candidate's mask
    row within its chunk (32 words), the chunk's removed set (32 words) and
    2 int32 of state."""
    return bsz * (n * 32 + 32 + 1)


def nms_fixed_cuda(
    boxes: Tensor,
    scores: Tensor,
    iou_thresh: float,
    max_out: int,
    mask: Optional[Tensor] = None,
    assume_sorted: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Same contract as :func:`nms_fixed_tiled` (bit-identical selections):
    boxes [N, 4] or [B, N, 4] -> (idx int64, valid bool) of [max_out] /
    [B, max_out]. The kernels' scratch, :func:`scratch_words` uint64, is
    24.6 MB at 8 x 12000."""
    if not boxes.is_cuda:
        return nms_fixed_tiled(
            boxes, scores, iou_thresh, max_out, mask=mask, assume_sorted=assume_sorted
        )
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores = boxes[None], scores[None]
        mask = None if mask is None else mask[None]
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    bsz, n = boxes.shape[:2]
    if scores.shape != (bsz, n):
        raise ValueError(f"scores {tuple(scores.shape)} do not match boxes {tuple(boxes.shape)}")
    if mask is not None and (mask.shape != (bsz, n) or mask.dtype != torch.bool):
        raise ValueError(f"mask must be bool {(bsz, n)}, got {mask.dtype} {tuple(mask.shape)}")
    if not scores.is_cuda or scores.device != boxes.device:
        raise ValueError("boxes and scores must be on the same CUDA device")
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    dev = boxes.device
    if bsz == 0 or n == 0:
        idx = torch.zeros(bsz, max_out, dtype=torch.int64, device=dev)
        valid = torch.zeros(bsz, max_out, dtype=torch.bool, device=dev)
    else:
        b_sorted, s_sorted, order = prepare_candidates(boxes, scores, mask, assume_sorted)
        b_sorted = b_sorted.contiguous()
        s_sorted = s_sorted.contiguous()
        order = order.contiguous()
        idx = torch.empty(bsz, max_out, dtype=torch.int64, device=dev)
        valid = torch.empty(bsz, max_out, dtype=torch.bool, device=dev)
        scratch = torch.empty(scratch_words(bsz, n), dtype=torch.int64, device=dev)
        fn, err = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(
                b_sorted.data_ptr(), s_sorted.data_ptr(), order.data_ptr(),
                bsz, n, float(iou_thresh), int(max_out), scratch.data_ptr(),
                idx.data_ptr(), valid.data_ptr(), stream,
            )
        build.check(rc, err, "nms kernels")
        global launches
        launches += 1
    if unbatched:
        return idx[0], valid[0]
    return idx, valid
