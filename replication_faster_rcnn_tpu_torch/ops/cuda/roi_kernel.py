"""Wrappers of the CUDA ROIAlign kernels (``csrc/roi_align_kernel.cu``).

The forward is the counterpart of the JAX package's
``ops/pallas/roi_kernel.py::roi_align_pallas`` with the batch written out. A
CPU tensor runs the plain version, ``roi_ops.roi_align(method="gather")``,
which the kernel matches bit for bit. The output is float32 by default (for
float32 and bfloat16 features, as the JAX package's default einsum path
returns) or ``out_dtype``: the kernel then stores each finished float32
value rounded once, which equals ``.to(out_dtype)`` of the float32 output.

:func:`roi_align_cuda` is differentiable with respect to the features
through a ``torch.autograd.Function`` whose backward is the backward kernel
(plain version ``roi_ops.roi_align_backward`` on the CPU). The backward
kernel reads float32 or bfloat16 gradients as they come, writes the
feature's dtype, and sums in a fixed order: it is bitwise reproducible from
run to run. The rois get no gradient: the Function raises if they require
one, so a gradient is never dropped silently.
"""

from __future__ import annotations

import ctypes

import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build
from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align, roi_align_backward

Tensor = torch.Tensor

# kernel launches since the last reset (the caller resets them to 0)
launches = 0
backward_launches = 0

# the most samples (out_size * sampling_ratio) along one axis the kernels take
MAX_SAMPLES = 224
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype flags

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = build.library("roi_align_kernel")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.roi_align_fwd.argtypes = [p, i, p, i, i, i, i, i, i, i, p, i, i, p]
        lib.roi_align_bwd.argtypes = [p, i, p, i, i, i, i, i, i, i, p, i, p]
        lib.roi_align_fwd.restype = ctypes.c_int
        lib.roi_align_bwd.restype = ctypes.c_int
        lib.roi_align_error_string.argtypes = [ctypes.c_int]
        lib.roi_align_error_string.restype = ctypes.c_char_p
        _fns = (lib.roi_align_fwd, lib.roi_align_bwd, lib.roi_align_error_string)
    return _fns


def _dtype_flag(dtype: torch.dtype, what: str) -> int:
    flag = _DTYPES.get(dtype)
    if flag is None:
        raise TypeError(f"the ROIAlign kernels take float32 or bfloat16 {what}, got {dtype}")
    return flag


def _check_args(feat: Tensor, rois: Tensor, out_size: int, sampling_ratio: int) -> None:
    if feat.dim() != 4:
        raise ValueError(f"feat must be [N, H, W, C], got {tuple(feat.shape)}")
    n = feat.shape[0]
    if rois.dim() != 3 or rois.shape[0] != n or rois.shape[-1] != 4:
        raise ValueError(f"rois must be [{n}, R, 4], got {tuple(rois.shape)}")
    if rois.device != feat.device:
        raise ValueError("feat and rois must be on the same device")
    if out_size < 1 or sampling_ratio < 1:
        raise ValueError(f"out_size and sampling_ratio must be >= 1, got {out_size}, {sampling_ratio}")
    if feat.is_cuda and out_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"the kernels take out_size * sampling_ratio <= {MAX_SAMPLES}, got "
                         f"{out_size} * {sampling_ratio}")


def _forward_cuda(feat: Tensor, rois: Tensor, out_size: int, s: int,
                  out_dtype: torch.dtype, splits: int = 0) -> Tensor:
    """The forward kernel on rois already in feature coordinates. ``splits``
    > 0 fixes the number of blocks per roi (0: the kernel picks)."""
    fwd, _, err = _kernels()
    feat_flag = _dtype_flag(feat.dtype, "features")
    out_flag = _dtype_flag(out_dtype, "outputs")
    n, h, w, c = feat.shape
    feat = feat.contiguous()
    r = rois.shape[1]
    out = torch.empty(n, r, out_size, out_size, c, dtype=out_dtype, device=feat.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fwd(feat.data_ptr(), feat_flag, rois.data_ptr(), n, h, w, c, r, out_size, s,
                 out.data_ptr(), out_flag, splits, stream)
    build.check(rc, err, "roi_align_kernel")
    global launches
    launches += 1
    return out


def roi_align_backward_cuda(
    grad_out: Tensor, rois: Tensor, feat_shape, feat_dtype: torch.dtype, out_size: int, s: int
) -> Tensor:
    """The backward kernel: grad_out [N, R, out, out, C] (float32 or
    bfloat16), rois [N, R, 4] in feature coordinates -> grad_feat
    [N, H, W, C] in ``feat_dtype``, the same bits in every run. A CPU tensor
    runs ``roi_ops.roi_align_backward``."""
    if not grad_out.is_cuda:
        return roi_align_backward(grad_out, rois, feat_shape, feat_dtype, out_size, s)
    n, h, w, c = feat_shape
    r = rois.shape[1]
    if tuple(grad_out.shape) != (n, r, out_size, out_size, c):
        raise ValueError(
            f"grad_out must be {(n, r, out_size, out_size, c)}, got {tuple(grad_out.shape)}"
        )
    if not rois.is_cuda or rois.device != grad_out.device:
        raise ValueError("grad_out and rois must be on the same CUDA device")
    if out_size * s > MAX_SAMPLES:
        raise ValueError(f"the kernels take out_size * sampling_ratio <= {MAX_SAMPLES}")
    _, bwd, err = _kernels()
    grad_flag = _dtype_flag(grad_out.dtype, "gradients")
    feat_flag = _dtype_flag(feat_dtype, "features")
    grad_out = grad_out.contiguous()
    rois = rois.float().contiguous()
    grad = torch.empty(n, h, w, c, dtype=feat_dtype, device=grad_out.device)
    if grad.numel() == 0:
        return grad
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream(grad_out.device).cuda_stream
        rc = bwd(grad_out.data_ptr(), grad_flag, rois.data_ptr(), n, h, w, c, r, out_size, s,
                 grad.data_ptr(), feat_flag, stream)
    build.check(rc, err, "roi_align_bwd_kernel")
    global backward_launches
    backward_launches += 1
    return grad


class _RoIAlign(torch.autograd.Function):
    """ROIAlign with the kernels on CUDA tensors and the plain versions on
    CPU tensors, in both directions. Rois arrive in feature coordinates."""

    @staticmethod
    def forward(ctx, feat: Tensor, rois: Tensor, out_size: int, s: int,
                out_dtype: torch.dtype) -> Tensor:
        ctx.save_for_backward(rois)
        ctx.feat_meta = (tuple(feat.shape), feat.dtype, out_size, s)
        if feat.is_cuda:
            return _forward_cuda(feat, rois, out_size, s, out_dtype)
        return roi_align(feat, rois, out_size, s, method="gather").to(out_dtype)

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        (rois,) = ctx.saved_tensors
        shape, dtype, out_size, s = ctx.feat_meta
        grad = None
        if ctx.needs_input_grad[0]:
            grad = roi_align_backward_cuda(grad_out, rois, shape, dtype, out_size, s)
        return grad, None, None, None, None


def roi_align_cuda(
    feat: Tensor,
    rois: Tensor,
    out_size: int = 7,
    sampling_ratio: int = 2,
    spatial_scale: float = 1.0,
    out_dtype: torch.dtype = torch.float32,
) -> Tensor:
    """feat [N, H, W, C] (f32 or bf16), rois [N, R, 4] -> [N, R, out, out, C]
    in ``out_dtype`` (float32 or bfloat16), differentiable with respect to
    ``feat``."""
    _check_args(feat, rois, out_size, sampling_ratio)
    if rois.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "roi_align_cuda gives no gradient to the rois; detach them (the "
            "training path's proposals and gt boxes carry none)"
        )
    rois = (rois.float() * spatial_scale).contiguous()
    return _RoIAlign.apply(feat, rois, out_size, sampling_ratio, out_dtype)
