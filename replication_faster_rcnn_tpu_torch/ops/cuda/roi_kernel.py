"""Wrappers of the CUDA ROI kernels: ROIAlign and the FPN's multi-level
ROIAlign (``csrc/roi_align_kernel.cu``) and ROIPool
(``csrc/roi_pool_kernel.cu``).

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

:func:`roi_pool_cuda` is the ROIPool forward kernel, bitwise equal to the
plain ``roi_ops.roi_pool`` (which a CPU tensor runs), differentiable with
respect to the features through ``_RoIPool``, whose backward is the
two-pass backward kernel (plain version ``roi_ops.roi_pool_backward``): it
splits a tied maximum's gradient as the plain VJP does, sums in float32 in
a fixed order and writes the feature's dtype. A shape the backward refuses
(a map too wide for its shared-memory row, or of more than 255 rows for its
uint8 tie counts) raises ValueError with the kernel's message.

:func:`multilevel_roi_align_cuda` is the FPN's ROIAlign over P2..P5: the
forward kernel is bitwise ``models/fpn.py::multilevel_roi_align_plain`` (the
JAX ``method="flat"``), the backward kernel (``_MultilevelRoIAlign``)
writes the four levels' gradients deterministically. Both read the levels
that ``models/fpn.py::roi_levels`` computes on the card.
"""

from __future__ import annotations

import ctypes

import torch

from replication_faster_rcnn_tpu_torch.ops.cuda import build
from replication_faster_rcnn_tpu_torch.ops.roi_ops import (
    roi_align,
    roi_align_backward,
    roi_pool,
    roi_pool_backward,
)

Tensor = torch.Tensor

# kernel launches since the last reset (the caller resets them to 0); a
# ROIPool backward call (two kernels) counts once
launches = 0
backward_launches = 0
pool_launches = 0
pool_backward_launches = 0
multilevel_launches = 0
multilevel_backward_launches = 0

# the most samples (out_size * sampling_ratio, ROIPool: out_size) along one
# axis the kernels take
MAX_SAMPLES = 224
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype flags

_fns = None
_pool_fns = None


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
        f = ctypes.c_float
        lib.multilevel_roi_align_fwd.argtypes = [p, p, p, i, p, p, i, i, i, f, f, i, i, p, i, p]
        lib.multilevel_roi_align_bwd.argtypes = [p, i, p, p, i, p, p, i, i, f, f, i, i, p, i, p,
                                                 p]
        lib.multilevel_roi_align_fwd.restype = ctypes.c_int
        lib.multilevel_roi_align_bwd.restype = ctypes.c_int
        lib.multilevel_roi_align_bwd_scratch.argtypes = [i, p, p, i]
        lib.multilevel_roi_align_bwd_scratch.restype = ctypes.c_longlong
        _fns = (lib.roi_align_fwd, lib.roi_align_bwd, lib.roi_align_error_string,
                lib.multilevel_roi_align_fwd, lib.multilevel_roi_align_bwd,
                lib.multilevel_roi_align_bwd_scratch)
    return _fns


def _pool_kernels():
    global _pool_fns
    if _pool_fns is None:
        lib = build.library("roi_pool_kernel")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.roi_pool_fwd.argtypes = [p, i, p, i, i, i, i, i, i, p, p]
        lib.roi_pool_bwd.argtypes = [p, i, p, i, p, i, i, i, i, i, i, p, p, p, p]
        lib.roi_pool_fwd.restype = ctypes.c_int
        lib.roi_pool_bwd.restype = ctypes.c_int
        lib.roi_pool_error_string.argtypes = [ctypes.c_int]
        lib.roi_pool_error_string.restype = ctypes.c_char_p
        _pool_fns = (lib.roi_pool_fwd, lib.roi_pool_bwd, lib.roi_pool_error_string)
    return _pool_fns


def _dtype_flag(dtype: torch.dtype, what: str) -> int:
    flag = _DTYPES.get(dtype)
    if flag is None:
        raise TypeError(f"the ROI kernels take float32 or bfloat16 {what}, got {dtype}")
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
    fwd, _, err, _, _, _ = _kernels()
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
    _, bwd, err, _, _, _ = _kernels()
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


def _check_pool(rc: int, err, what: str, feat: Tensor) -> None:
    """A negative return code is a shape the ROIPool kernels refuse
    (ValueError with the kernel's message); a positive one a CUDA error."""
    if rc < 0:
        raise ValueError(f"{err(rc).decode()}: feat {tuple(feat.shape)}")
    build.check(rc, err, what)


def _pool_forward_cuda(feat: Tensor, rois: Tensor, out_size: int) -> Tensor:
    """The ROIPool forward kernel on rois already in feature coordinates."""
    fwd, _, err = _pool_kernels()
    flag = _dtype_flag(feat.dtype, "features")
    n, h, w, c = feat.shape
    feat = feat.contiguous()
    r = rois.shape[1]
    out = torch.empty(n, r, out_size, out_size, c, dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fwd(feat.data_ptr(), flag, rois.data_ptr(), n, h, w, c, r, out_size, out.data_ptr(),
                 stream)
    _check_pool(rc, err, "roi_pool_kernel", feat)
    global pool_launches
    pool_launches += 1
    return out


def roi_pool_backward_cuda(grad_out: Tensor, feat: Tensor, rois: Tensor, out_size: int) -> Tensor:
    """The backward kernels: grad_out [N, R, out, out, C] (float32 or
    bfloat16), the forward's features and rois (feature coordinates) ->
    grad_feat [N, H, W, C] in the feature's dtype, the same bits in every
    run. Two launches (the bins pass, then the gather), counted once. Their
    scratch, freed on return, is two arrays of grad_out's shape: each bin's
    maximum in the feature's dtype and its tied-row count in uint8. A CPU
    tensor runs ``roi_ops.roi_pool_backward``."""
    if not grad_out.is_cuda:
        return roi_pool_backward(grad_out, feat, rois, out_size)
    n, h, w, c = feat.shape
    r = rois.shape[1]
    if tuple(grad_out.shape) != (n, r, out_size, out_size, c):
        raise ValueError(
            f"grad_out must be {(n, r, out_size, out_size, c)}, got {tuple(grad_out.shape)}"
        )
    if not (feat.is_cuda and rois.is_cuda) or len({grad_out.device, feat.device, rois.device}) > 1:
        raise ValueError("grad_out, feat and rois must be on the same CUDA device")
    _, bwd, err = _pool_kernels()
    feat_flag = _dtype_flag(feat.dtype, "features")
    grad_flag = _dtype_flag(grad_out.dtype, "gradients")
    grad_out, feat = grad_out.contiguous(), feat.contiguous()
    rois = rois.float().contiguous()
    grad = torch.empty(n, h, w, c, dtype=feat.dtype, device=feat.device)
    if grad.numel() == 0:
        return grad
    bin_max = torch.empty(grad_out.shape, dtype=feat.dtype, device=feat.device)
    tie_rows = torch.empty(grad_out.shape, dtype=torch.uint8, device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = bwd(feat.data_ptr(), feat_flag, grad_out.data_ptr(), grad_flag, rois.data_ptr(), n, h,
                 w, c, r, out_size, bin_max.data_ptr(), tie_rows.data_ptr(), grad.data_ptr(),
                 stream)
    _check_pool(rc, err, "roi_pool_bwd_kernel", feat)
    global pool_backward_launches
    pool_backward_launches += 1
    return grad


class _RoIPool(torch.autograd.Function):
    """ROIPool with the kernels in both directions (CUDA tensors only). Rois
    arrive in feature coordinates; the forward keeps references to its
    inputs for the backward, no copies."""

    @staticmethod
    def forward(ctx, feat: Tensor, rois: Tensor, out_size: int) -> Tensor:
        ctx.save_for_backward(feat, rois)
        ctx.out_size = out_size
        return _pool_forward_cuda(feat, rois, out_size)

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        feat, rois = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = roi_pool_backward_cuda(grad_out, feat, rois, ctx.out_size)
        return grad, None, None


def roi_pool_cuda(
    feat: Tensor,
    rois: Tensor,
    out_size: int = 7,
    spatial_scale: float = 1.0,
) -> Tensor:
    """feat [N, H, W, C] (f32 or bf16), rois [N, R, 4] -> [N, R, out, out, C]
    in the feature's dtype, differentiable with respect to ``feat``. A CPU
    tensor runs the plain ``roi_ops.roi_pool``."""
    _check_args(feat, rois, out_size, 1)
    if not feat.is_cuda:
        return roi_pool(feat, rois, out_size, spatial_scale)
    if rois.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "roi_pool_cuda gives no gradient to the rois; detach them (the "
            "training path's proposals and gt boxes carry none)"
        )
    rois = (rois.float() * spatial_scale).contiguous()
    return _RoIPool.apply(feat, rois, out_size)


def _levels_arrays(shapes):
    """Host int arrays of the four levels' heights and widths."""
    four = ctypes.c_int * 4
    return four(*(int(sh[1]) for sh in shapes)), four(*(int(sh[2]) for sh in shapes))


def _pointers(tensors):
    return (ctypes.c_void_p * 4)(*(t.data_ptr() for t in tensors))


def _multilevel_forward_cuda(feats, rois: Tensor, levels: Tensor, img_h: float, img_w: float,
                             out_size: int, s: int, out_dtype: torch.dtype) -> Tensor:
    """The multi-level forward kernel: P2..P5 (contiguous, one dtype), rois
    [N, R, 4] float32 image coordinates, levels [N, R] int32."""
    _, _, err, fwd, _, _ = _kernels()
    feat_flag = _dtype_flag(feats[0].dtype, "features")
    out_flag = _dtype_flag(out_dtype, "outputs")
    n, c = feats[0].shape[0], feats[0].shape[-1]
    r = rois.shape[1]
    out = torch.empty(n, r, out_size, out_size, c, dtype=out_dtype, device=rois.device)
    if out.numel() == 0:
        return out
    hs, ws = _levels_arrays([f.shape for f in feats])
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        rc = fwd(_pointers(feats), hs, ws, feat_flag, rois.data_ptr(), levels.data_ptr(), n, c, r,
                 img_h, img_w, out_size, s, out.data_ptr(), out_flag, stream)
    build.check(rc, err, "multilevel_roi_align_kernel")
    global multilevel_launches
    multilevel_launches += 1
    return out


def multilevel_roi_align_backward_cuda(grad_out: Tensor, rois: Tensor, levels: Tensor, shapes,
                                       feat_dtype: torch.dtype, img_h: float, img_w: float,
                                       out_size: int, s: int):
    """The multi-level backward kernel: grad_out [N, R, out, out, C]
    (float32 or bfloat16), the forward's rois (image coordinates) and
    levels -> the gradients of P2..P5 (``shapes``) in ``feat_dtype``, the
    same bits in every run."""
    n, c = shapes[0][0], shapes[0][-1]
    r = rois.shape[1]
    if tuple(grad_out.shape) != (n, r, out_size, out_size, c):
        raise ValueError(
            f"grad_out must be {(n, r, out_size, out_size, c)}, got {tuple(grad_out.shape)}")
    if not (grad_out.is_cuda and rois.device == grad_out.device == levels.device):
        raise ValueError("grad_out, rois and levels must be on the same CUDA device")
    _, _, err, _, bwd, scratch_bytes = _kernels()
    grad_flag = _dtype_flag(grad_out.dtype, "gradients")
    feat_flag = _dtype_flag(feat_dtype, "features")
    grad_out = grad_out.contiguous()
    grads = [torch.empty(sh, dtype=feat_dtype, device=grad_out.device) for sh in shapes]
    if grad_out.numel() == 0:
        return [g.zero_() for g in grads]
    hs, ws = _levels_arrays(shapes)
    nbytes = scratch_bytes(n, hs, ws, r)
    if nbytes < 0:
        raise ValueError(f"the multi-level backward takes level sides up to 65535, got {shapes}")
    # the rois' geometry on their levels and the tiles' roi masks
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=grad_out.device)
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream(grad_out.device).cuda_stream
        rc = bwd(grad_out.data_ptr(), grad_flag, rois.data_ptr(), levels.data_ptr(), n, hs, ws,
                 c, r, img_h, img_w, out_size, s, _pointers(grads), feat_flag,
                 scratch.data_ptr(), stream)
    build.check(rc, err, "multilevel_roi_align_bwd_kernel")
    global multilevel_backward_launches
    multilevel_backward_launches += 1
    return grads


class _MultilevelRoIAlign(torch.autograd.Function):
    """Multi-level ROIAlign with the kernels in both directions (CUDA
    tensors only); the gradient goes to the four levels."""

    @staticmethod
    def forward(ctx, rois: Tensor, levels: Tensor, img_h: float, img_w: float, out_size: int,
                s: int, out_dtype: torch.dtype, *feats: Tensor) -> Tensor:
        ctx.save_for_backward(rois, levels)
        ctx.meta = ([tuple(f.shape) for f in feats], feats[0].dtype, img_h, img_w, out_size, s)
        return _multilevel_forward_cuda(feats, rois, levels, img_h, img_w, out_size, s,
                                        out_dtype)

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        rois, levels = ctx.saved_tensors
        shapes, dtype, img_h, img_w, out_size, s = ctx.meta
        grads = [None] * 4
        if any(ctx.needs_input_grad[7:]):
            grads = multilevel_roi_align_backward_cuda(grad_out, rois, levels, shapes, dtype,
                                                       img_h, img_w, out_size, s)
        return (None,) * 7 + tuple(grads)


def multilevel_roi_align_cuda(
    feats,
    rois: Tensor,
    img_h: float,
    img_w: float,
    out_size: int = 7,
    sampling_ratio: int = 2,
    out_dtype: torch.dtype = torch.float32,
) -> Tensor:
    """FPN ROIAlign: ``feats`` P2..P5 NHWC (a fifth level, P6, is ignored;
    f32 or bf16, one dtype), rois [N, R, 4] image coordinates -> [N, R, out,
    out, C] in ``out_dtype``, differentiable with respect to the four
    levels. Each roi's level is ``models/fpn.py::roi_levels``, computed here
    with the plain tensor operations and passed to both kernels. A CPU
    tensor runs ``models/fpn.py::multilevel_roi_align_plain`` (and its
    autograd)."""
    from replication_faster_rcnn_tpu_torch.models.fpn import (
        multilevel_roi_align_plain,
        roi_levels,
    )

    feats = list(feats[:4])
    if len(feats) != 4:
        raise ValueError(f"expected the levels P2..P5, got {len(feats)}")
    n = rois.shape[0]
    for f in feats:
        if f.dim() != 4 or f.shape[0] != n or f.shape[-1] != feats[0].shape[-1]:
            raise ValueError(f"levels must be [{n}, H, W, C] with one C, got "
                             f"{[tuple(x.shape) for x in feats]}")
        if f.device != rois.device or f.dtype != feats[0].dtype:
            raise ValueError("the levels and rois must be on one device, the levels of one dtype")
    if rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"rois must be [{n}, R, 4], got {tuple(rois.shape)}")
    if not rois.is_cuda:
        return multilevel_roi_align_plain(feats, rois, img_h, img_w, out_size,
                                          sampling_ratio).to(out_dtype)
    if out_size * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"the kernels take out_size * sampling_ratio <= {MAX_SAMPLES}")
    if rois.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "multilevel_roi_align_cuda gives no gradient to the rois; detach them (the "
            "training path's proposals and gt boxes carry none)"
        )
    rois = rois.float().contiguous()
    levels = roi_levels(rois).contiguous()
    feats = [f.contiguous() for f in feats]
    return _MultilevelRoIAlign.apply(rois, levels, float(img_h), float(img_w), out_size,
                                     sampling_ratio, out_dtype, *feats)
