"""ROI feature extraction: ROIAlign (plain versions of the CUDA kernel) and
ROIPool (counterpart of the JAX package's ``ops/roi_ops.py``).

Features are NHWC with the batch written out: feat [N, H, W, C], rois
[N, R, 4] in feature coordinates after ``spatial_scale``; outputs are
[N, R, out, out, C].

* :func:`roi_align` — bilinear sampling on an ``s x s`` grid per output bin,
  averaged (torchvision aligned=False). Two plain versions:
    - ``method="gather"``: the four-tap gather, with the same products and
      sums in the same order as ``csrc/roi_align_kernel.cu`` — the kernel's
      bit-exact twin, and what a CPU tensor runs on the serving path;
    - ``method="einsum"``: the separable tent-weight contraction the JAX
      package runs by default, kept to hold both against it.
  Both return float32 (bf16 features are promoted, as in the JAX default).
* :func:`roi_align_backward` — the gradient with respect to the features:
  the plain version of the backward kernel (the same taps and weights,
  scattered with ``index_add_``).
* :func:`roi_pool` — quantized max pooling (Caffe/torchvision ROIPool).
"""

from __future__ import annotations

from typing import Optional

import torch

from replication_faster_rcnn_tpu_torch import ops

Tensor = torch.Tensor


def _true_div(x: Tensor, d: float) -> Tensor:
    """``x / d`` as an IEEE division on every device (on CUDA, PyTorch
    turns division by a Python scalar into a multiply by its reciprocal)."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


def _reciprocal(n: int) -> Tensor:
    """float32 1/n, correctly rounded (a CPU scalar: multiplies any device)."""
    return torch.tensor(1.0, dtype=torch.float32) / n


def _sample_coords(rois: Tensor, out_size: int, s: int):
    """Sample coordinates per roi: (rr [N, R, out*s], cc [N, R, out*s]).

    The bin size multiplies the 1-pixel-minimum extent by the float32
    reciprocal of ``out_size``, as the JAX package's compiled program does
    (XLA folds the division by a constant); the CUDA kernel repeats it."""
    r1, c1, r2, c2 = rois.unbind(-1)
    inv_out = _reciprocal(out_size)
    bin_h = torch.clamp(r2 - r1, min=1.0) * inv_out
    bin_w = torch.clamp(c2 - c1, min=1.0) * inv_out
    pts = _true_div(torch.arange(out_size * s, dtype=torch.float32, device=rois.device) + 0.5, s)
    rr = r1[..., None] + pts * bin_h[..., None]
    cc = c1[..., None] + pts * bin_w[..., None]
    return rr, cc


def _axis_taps(coords: Tensor, extent: int):
    """Clamped tap pair, weights and in-range flag along one axis. The clamp
    is fmax/fmin, as in the kernel: a NaN coordinate (a diverged step's
    proposal) becomes 0 and is out of range, so it reads pixel 0 with no
    weight instead of indexing out of bounds."""
    in_range = (coords >= -1.0) & (coords <= extent)
    x = torch.fmin(torch.fmax(coords, coords.new_zeros(())), coords.new_full((), extent - 1.0))
    x0 = torch.floor(x)
    frac = x - x0
    i0 = x0.long()
    i1 = torch.clamp(i0 + 1, max=extent - 1)
    return i0, i1, 1.0 - frac, frac, in_range


def _tent_weights(coords: Tensor, extent: int) -> Tensor:
    """[..., P] -> [..., P, extent]: max(0, 1 - |x - i|) after clamping,
    zero for points outside [-1, extent]."""
    in_range = (coords >= -1.0) & (coords <= extent)
    x = torch.clamp(coords, 0.0, extent - 1.0)
    grid = torch.arange(extent, dtype=coords.dtype, device=coords.device)
    w = torch.clamp(1.0 - torch.abs(x[..., None] - grid), min=0.0)
    return w * in_range[..., None]


def roi_align(
    feat: Tensor,
    rois: Tensor,
    out_size: int = 7,
    sampling_ratio: int = 2,
    spatial_scale: float = 1.0,
    method: str = "einsum",
) -> Tensor:
    """ROIAlign: feat [N, H, W, C], rois [N, R, 4] -> [N, R, out, out, C] f32."""
    n, h, w, c = feat.shape
    s = sampling_ratio
    rois = rois.float() * spatial_scale
    rr, cc = _sample_coords(rois, out_size, s)
    f = feat.float()
    if method == "einsum":
        wr = _tent_weights(rr, h)  # [N, R, P, H]
        wc = _tent_weights(cc, w)  # [N, R, Q, W]
        rows = torch.einsum("nrph,nhwc->nrpwc", wr, f)
        sampled = torch.einsum("nrpwc,nrqw->nrpqc", rows, wc)
        r = sampled.shape[1]
        return sampled.reshape(n, r, out_size, s, out_size, s, c).mean(dim=(3, 5))
    if method != "gather":
        raise ValueError(f"unknown roi_align method {method!r}")
    y0, y1, wy0, wy1, in_r = _axis_taps(rr, h)  # [N, R, P]
    x0, x1, wx0, wx1, in_c = _axis_taps(cc, w)  # [N, R, Q]
    b = torch.arange(n, device=feat.device)[:, None, None, None]

    def tap(yi, xi):
        return f[b, yi[..., :, None], xi[..., None, :]]  # [N, R, P, Q, C]

    def outer(u, v):
        return (u[..., :, None] * v[..., None, :])[..., None]

    v = tap(y0, x0) * outer(wy0, wx0)
    v = v + tap(y0, x1) * outer(wy0, wx1)
    v = v + tap(y1, x0) * outer(wy1, wx0)
    v = v + tap(y1, x1) * outer(wy1, wx1)
    inside = (in_r[..., :, None] & in_c[..., None, :])[..., None]
    v = torch.where(inside, v, v.new_zeros(()))
    r = v.shape[1]
    v = v.reshape(n, r, out_size, s, out_size, s, c)
    acc = torch.zeros(n, r, out_size, out_size, c, dtype=torch.float32, device=feat.device)
    for iy in range(s):  # the kernel's summation order
        for ix in range(s):
            acc = acc + v[:, :, :, iy, :, ix]
    return _true_div(acc, s * s)


def roi_align_backward(
    grad_out: Tensor,
    rois: Tensor,
    feat_shape,
    feat_dtype: torch.dtype,
    out_size: int = 7,
    sampling_ratio: int = 2,
    spatial_scale: float = 1.0,
) -> Tensor:
    """Gradient of :func:`roi_align` with respect to ``feat``:
    grad_out [N, R, out, out, C] -> [N, H, W, C] in ``feat_dtype``.

    Each in-range sample scatters ``(grad / (s*s)) * (wy * wx)`` onto its
    four taps (a border sample's two taps may be one pixel, which then
    receives both); sums are float32, cast to ``feat_dtype`` at the end. The
    rois get no gradient (proposals are detached and gt boxes are data)."""
    n, h, w, c = feat_shape
    s = sampling_ratio
    rois = rois.float() * spatial_scale
    r = rois.shape[1]
    p = out_size * s
    rr, cc = _sample_coords(rois, out_size, s)
    y0, y1, wy0, wy1, in_r = _axis_taps(rr, h)  # [N, R, P]
    x0, x1, wx0, wx1, in_c = _axis_taps(cc, w)  # [N, R, Q]
    g = _true_div(grad_out.float(), s * s)  # [N, R, out, out, C]
    g = g[:, :, :, None, :, None, :].expand(n, r, out_size, s, out_size, s, c)
    g = g.reshape(n, r, p, p, c)
    inside = in_r[..., :, None] & in_c[..., None, :]  # [N, R, P, Q]
    base = (torch.arange(n, device=grad_out.device) * (h * w))[:, None, None, None]
    grad = torch.zeros(n * h * w, c, dtype=torch.float32, device=grad_out.device)
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            weight = torch.where(inside, wy[..., :, None] * wx[..., None, :], 0.0)
            flat = base + yi[..., :, None] * w + xi[..., None, :]  # [N, R, P, Q]
            grad.index_add_(0, flat.reshape(-1), (g * weight[..., None]).reshape(-1, c))
    return grad.view(n, h, w, c).to(feat_dtype)


def roi_pool(
    feat: Tensor,
    rois: Tensor,
    out_size: int = 7,
    spatial_scale: float = 1.0,
) -> Tensor:
    """ROIPool: feat [N, H, W, C], rois [N, R, 4] -> [N, R, out, out, C].

    Scaled coordinates are rounded; extents get +1; bin edges are floor/ceil
    of the fractional bin size; bins clamp to the map; empty bins are 0.
    """
    n, h, w, c = feat.shape
    dt = torch.float32  # bin geometry; the pooled values keep feat's dtype
    rois = rois.float()
    r1 = torch.round(rois[..., 0] * spatial_scale)
    c1 = torch.round(rois[..., 1] * spatial_scale)
    r2 = torch.round(rois[..., 2] * spatial_scale)
    c2 = torch.round(rois[..., 3] * spatial_scale)
    # the JAX package's compiled program multiplies by the float32
    # reciprocal of the bin count (XLA folds the division by a constant);
    # the bin edges below round that product, so the port does the same
    inv_out = _reciprocal(out_size)
    bin_h = torch.clamp(r2 - r1 + 1.0, min=1.0) * inv_out  # [N, R]
    bin_w = torch.clamp(c2 - c1 + 1.0, min=1.0) * inv_out

    p = torch.arange(out_size, dtype=dt, device=feat.device)

    def edges(start, size, extent):
        lo = torch.clamp(torch.floor(p * size[..., None]) + start[..., None], 0, extent)
        hi = torch.clamp(torch.ceil((p + 1) * size[..., None]) + start[..., None], 0, extent)
        return lo, hi  # [N, R, out]

    hstart, hend = edges(r1, bin_h, h)
    wstart, wend = edges(c1, bin_w, w)
    rows = torch.arange(h, dtype=dt, device=feat.device)
    cols = torch.arange(w, dtype=dt, device=feat.device)
    row_mask = (rows >= hstart[..., None]) & (rows < hend[..., None])  # [N, R, out, H]
    col_mask = (cols >= wstart[..., None]) & (cols < wend[..., None])  # [N, R, out, W]

    neg = feat.new_full((), float("-inf"))
    f = feat[:, None]  # [N, 1, H, W, C]
    col_pooled = torch.stack(
        [
            torch.amax(torch.where(col_mask[:, :, j, None, :, None], f, neg), dim=3)
            for j in range(out_size)
        ],
        dim=3,
    )  # [N, R, H, out, C]
    pooled = torch.stack(
        [
            torch.amax(torch.where(row_mask[:, :, i, :, None, None], col_pooled, neg), dim=2)
            for i in range(out_size)
        ],
        dim=2,
    )  # [N, R, out, out, C]
    return torch.where(torch.isfinite(pooled), pooled, pooled.new_zeros(()))


def extract_roi_features(
    feat: Tensor,
    rois: Tensor,
    op: str = "align",
    out_size: int = 7,
    sampling_ratio: int = 2,
    spatial_scale: float = 1.0,
    out_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """ROIAlign or ROIPool by config string. ROIAlign launches the CUDA
    kernel for a CUDA tensor and runs its plain gather version on the CPU or
    inside :class:`ops.reference_scope`. ``out_dtype`` is the output's dtype
    (default: float32 for ROIAlign, the feature's dtype for ROIPool); the
    kernel stores it directly, the plain versions cast to it."""
    if op == "align":
        out_dtype = out_dtype or torch.float32
        if ops.reference_requested():
            return roi_align(
                feat, rois, out_size, sampling_ratio, spatial_scale, method="gather"
            ).to(out_dtype)
        # imported here: the kernel wrapper imports this module's plain version
        from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_cuda

        return roi_align_cuda(feat, rois, out_size, sampling_ratio, spatial_scale, out_dtype)
    if op == "pool":
        pooled = roi_pool(feat, rois, out_size, spatial_scale)
        return pooled if out_dtype is None else pooled.to(out_dtype)
    raise ValueError(f"unknown roi op {op!r}")
