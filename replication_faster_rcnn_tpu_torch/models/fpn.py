"""Feature Pyramid Network (counterpart of the JAX package's ``models/fpn.py``).

* :class:`FPNNeck`: 1x1 lateral convs over C2..C5, the nearest-neighbour
  top-down sum (2x repeat, cropped to the finer level's possibly odd shape:
  75 -> 38 -> 19 at 600x600), 3x3 smoothing convs -> P2..P5, and P6 the
  stride-2 subsample of P5 (an RPN-only level). The convs carry no bias and
  run in the input's dtype, as the flax ones.
* :func:`roi_levels`: the FPN paper's level assignment
  ``k = floor(4 + log2(sqrt(area) / 224))`` clipped to P2..P5.
* :func:`multilevel_roi_align_plain`: the JAX ``method="flat"`` ROIAlign over
  P2..P5, operation by operation: each roi scaled into its level, the
  4-corner bilinear gather at level-offset indices of the flattened pyramid,
  the border rule of ``roi_ops``, and the mean over each bin's s x s samples
  (summed in row-major sample order). Its gradient is autograd's.
* :func:`multilevel_roi_align`: the dispatch seam. A CUDA tensor launches the
  hand-written kernel (``ops/cuda/roi_kernel.py::multilevel_roi_align_cuda``,
  forward bitwise this plain version, deterministic backward); a CPU tensor,
  or ``ops.reference_scope()``, runs the plain version.

Modules take NCHW (channels-last) tensors, as the ResNet ones; the model
hands the levels out as NHWC, ordered fine -> coarse.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.models.resnet import Conv2d
from replication_faster_rcnn_tpu_torch.ops.roi_ops import _true_div

Tensor = torch.Tensor

FPN_STRIDES: Tuple[int, ...] = (4, 8, 16, 32, 64)  # P2..P6


def _upsample_nearest(x: Tensor, target_hw: Tuple[int, int]) -> Tensor:
    """2x nearest upsample of NCHW ``x`` cropped to the (possibly odd) finer
    shape."""
    return F.interpolate(x, scale_factor=2, mode="nearest")[:, :, : target_hw[0], : target_hw[1]]


class FPNNeck(nn.Module):
    """[C2..C5] (NCHW) -> [P2..P6], all ``channels`` wide."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256, device=None):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(c, channels, 1, 1, 0, bias=False, device=device))
        for i in range(len(in_channels)):
            self.add_module(f"smooth{i}", Conv2d(channels, channels, 3, 1, 1, bias=False,
                                                 device=device))

    def forward(self, feats: Sequence[Tensor]) -> List[Tensor]:
        laterals = [getattr(self, f"lateral{i}")(c) for i, c in enumerate(feats)]
        tds = [laterals[3]]
        for i in (2, 1, 0):  # top-down pathway
            finer = laterals[i]
            tds.insert(0, finer + _upsample_nearest(tds[0], finer.shape[2:]))
        outs = [getattr(self, f"smooth{i}")(t) for i, t in enumerate(tds)]
        # P6: stride-2 subsample of P5 (max pool k=1 s=2, the Detectron convention)
        return outs + [outs[3][:, :, ::2, ::2]]


def roi_levels(rois: Tensor, k0: int = 4, canonical: float = 224.0) -> Tensor:
    """[..., 4] image-coordinate rois -> int32 level index 0..3 (P2..P5).
    The division is an IEEE division on every device. A NaN roi goes to
    level 0 (the clip is fmax/fmin), where the ROIAlign border rule gives
    it zero weight."""
    h = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-6)
    w = torch.clamp(rois[..., 3] - rois[..., 1], min=1e-6)
    k = torch.floor(k0 + torch.log2(_true_div(torch.sqrt(h * w), canonical)))
    k = torch.fmin(torch.fmax(k, k.new_full((), 2.0)), k.new_full((), 5.0))
    return k.to(torch.int32) - 2


def multilevel_roi_align_plain(
    feats: Sequence[Tensor],
    rois: Tensor,
    img_h: float,
    img_w: float,
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> Tensor:
    """The JAX ``multilevel_roi_align(method="flat")``: ``feats`` NHWC
    [N, Hl, Wl, C] (P2..P5; a fifth level is ignored), rois [N, R, 4] image
    coordinates -> [N, R, out, out, C] float32 (bfloat16 features are
    widened, as JAX promotes them against the float32 weights)."""
    feats = list(feats[:4])
    n, r = rois.shape[0], rois.shape[1]
    c = feats[0].shape[-1]
    dev = rois.device
    hs = [int(f.shape[1]) for f in feats]
    ws = [int(f.shape[2]) for f in feats]
    offs = [0]
    for h, w in zip(hs[:-1], ws[:-1]):
        offs.append(offs[-1] + h * w)
    flat = torch.cat([f.reshape(n, -1, c) for f in feats], dim=1)  # [N, sum Hl*Wl, C]

    rois = rois.float()
    lv = roi_levels(rois).long()
    h_l = ops.constant(hs, torch.float32, dev)[lv]  # [N, R] assigned-level extents
    w_l = ops.constant(ws, torch.float32, dev)[lv]
    w_li = w_l.long()
    off_l = ops.constant(offs, torch.int64, dev)[lv]

    # roi coordinates in assigned-level units
    sr = _true_div(h_l, img_h)
    sc = _true_div(w_l, img_w)
    r1, c1 = rois[..., 0] * sr, rois[..., 1] * sc
    r2, c2 = rois[..., 2] * sr, rois[..., 3] * sc

    # sample grid: 1-pixel minimum extent, centres at (p + .5)/s bin units
    s = sampling_ratio
    bin_h = _true_div(torch.clamp(r2 - r1, min=1.0), out_size)
    bin_w = _true_div(torch.clamp(c2 - c1, min=1.0), out_size)
    pts = _true_div(torch.arange(out_size * s, dtype=torch.float32, device=dev) + 0.5, s)
    rr = r1[..., None] + pts * bin_h[..., None]  # [N, R, S]
    cc = c1[..., None] + pts * bin_w[..., None]

    def axis(coord: Tensor, extent: Tensor):
        """Border rule along one axis: outside [-1, extent] is out of range;
        in range clamps to [0, extent - 1] (fmax/fmin: NaN -> 0)."""
        ext = extent[..., None]
        in_range = (coord >= -1.0) & (coord <= ext)
        x = torch.fmin(torch.fmax(coord, coord.new_zeros(())), ext - 1.0)
        x0 = torch.floor(x)
        i0 = x0.long()
        i1 = torch.minimum(i0 + 1, ext.long() - 1)
        return i0, i1, x - x0, in_range

    r0i, r1i, ar, in_r = axis(rr, h_l)
    c0i, c1i, ac, in_c = axis(cc, w_l)
    # the [N, R, S, S] grid: rows on axis -2, columns on axis -1
    ar, ac = ar[..., :, None], ac[..., None, :]
    base = off_l[..., None, None]
    wrow = w_li[..., None, None]
    batch = torch.arange(n, device=dev)[:, None]

    def corner(ri: Tensor, ci: Tensor) -> Tensor:
        idx = (base + ri[..., :, None] * wrow + ci[..., None, :]).reshape(n, -1)
        return flat[batch, idx].float()  # [N, R*S*S, C]

    def w3(wt: Tensor) -> Tensor:
        return wt.reshape(n, -1, 1)

    sampled = (
        corner(r0i, c0i) * w3((1 - ar) * (1 - ac))
        + corner(r0i, c1i) * w3((1 - ar) * ac)
        + corner(r1i, c0i) * w3(ar * (1 - ac))
        + corner(r1i, c1i) * w3(ar * ac)
    )
    inside = in_r[..., :, None] & in_c[..., None, :]
    sampled = sampled * w3(inside.float())
    sampled = sampled.reshape(n, r, out_size, s, out_size, s, c)
    acc = torch.zeros(n, r, out_size, out_size, c, dtype=torch.float32, device=dev)
    for iy in range(s):  # the kernel's summation order
        for ix in range(s):
            acc = acc + sampled[:, :, :, iy, :, ix]
    return _true_div(acc, s * s)


def multilevel_roi_align(
    feats: Sequence[Tensor],
    rois: Tensor,
    img_h: float,
    img_w: float,
    out_size: int = 7,
    sampling_ratio: int = 2,
    out_dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Level-assigned ROIAlign over P2..P5 -> [N, R, out, out, C] in
    ``out_dtype``, differentiable with respect to the levels: the CUDA
    kernels for a CUDA tensor, the plain version on the CPU or inside
    ``ops.reference_scope()``."""
    if ops.reference_requested():
        return multilevel_roi_align_plain(
            feats, rois, img_h, img_w, out_size, sampling_ratio).to(out_dtype)
    # imported here: the kernel wrapper imports this module's plain version
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import multilevel_roi_align_cuda

    return multilevel_roi_align_cuda(feats, rois, img_h, img_w, out_size, sampling_ratio,
                                     out_dtype)
