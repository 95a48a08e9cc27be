"""Second-stage detection head: ROI features + ResNet tail + cls/reg Linear
(counterpart of the JAX package's ``models/head.py::DetectionHead``), and
:func:`select_class_deltas` for the head's regression loss.

In training mode the tail's BatchNorm uses the batch statistics of the
N * R crops, and the ROIAlign kernel passes the gradient back to the
features (``ops/cuda/roi_kernel.py``). In int8 serving the cls/reg layers
run as true int8 GEMMs (:func:`_head_dense`)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from replication_faster_rcnn_tpu_torch.models.resnet import ResNetTail, tail_channels
from replication_faster_rcnn_tpu_torch.ops import quant_ops, roi_ops

Tensor = torch.Tensor


def _head_dense(layer: nn.Linear, x: Tensor, qinfo: Optional[Dict[str, Any]]) -> Tensor:
    """cls/reg projection of the float32 embedding: the float Linear, or,
    when the caller passes quantization info for this layer, its int8 twin
    (the JAX package's ``QuantDense``): the same parameters with ``weight``
    int8 ``[out, in]``, computed by ``ops/quant_ops.py::quant_dense`` with
    the calibrated activation scale."""
    if qinfo is not None:
        return quant_ops.quant_dense(x, layer.weight.t(), qinfo["w_scale"], qinfo["x_scale"],
                                     layer.bias)
    return F.linear(x, layer.weight.float(), layer.bias.float())


class DetectionHead(nn.Module):
    """forward(feat NHWC [N, H, W, C], rois [N, R, 4] image coords, img_h, img_w,
    quant=None) -> (cls [N, R, num_classes], reg [N, R, num_classes * 4])
    float32.

    The tail runs in the feature's dtype; cls/reg run in float32 on the
    embedding cast to float32, as int8 GEMMs for the layers named in
    ``quant`` (``{"cls": {"w_scale", "x_scale"}, ...}``)."""

    def __init__(self, arch: str = "resnet18", num_classes: int = 21,
                 roi_size: int = 7, roi_op: str = "align", sampling_ratio: int = 2,
                 device=None):
        super().__init__()
        self.roi_size = roi_size
        self.roi_op = roi_op
        self.sampling_ratio = sampling_ratio
        self.tail = ResNetTail(arch, device=device)
        ch = tail_channels(arch)
        self.cls = nn.Linear(ch, num_classes, device=device)
        self.reg = nn.Linear(ch, num_classes * 4, device=device)

    def forward(self, feat: Tensor, rois: Tensor, img_h: float, img_w: float,
                quant: Optional[Dict[str, Any]] = None) -> Tuple[Tensor, Tensor]:
        n, r = rois.shape[0], rois.shape[1]
        fh, fw = feat.shape[1], feat.shape[2]
        # image -> feature coordinates; the ratios are Python floats
        scale = torch.tensor(
            [fh / img_h, fw / img_w, fh / img_h, fw / img_w],
            dtype=rois.dtype, device=rois.device,
        )
        crops = roi_ops.extract_roi_features(
            feat, rois * scale, op=self.roi_op, out_size=self.roi_size,
            sampling_ratio=self.sampling_ratio, out_dtype=feat.dtype,
        )  # [N, R, s, s, C] in the feature's dtype (the kernel stores it directly)
        crops = crops.reshape((n * r,) + crops.shape[2:]).to(feat.dtype)
        embed = self.tail(crops.permute(0, 3, 1, 2)).float()  # [N*R, C_tail]
        quant = quant or {}
        cls = _head_dense(self.cls, embed, quant.get("cls"))
        reg = _head_dense(self.reg, embed, quant.get("reg"))
        return cls.reshape(n, r, -1), reg.reshape(n, r, -1)


def select_class_deltas(reg: Tensor, labels: Tensor) -> Tensor:
    """Each roi's box deltas for its class: reg [..., R, C * 4], labels
    [..., R] int -> [..., R, 4]. Labels are clamped into [0, C - 1] (the
    filler label -1 picks class 0; the loss masks it out)."""
    per_class = reg.reshape(reg.shape[:-1] + (-1, 4))  # [..., R, C, 4]
    idx = torch.clamp(labels.long(), 0, per_class.shape[-2] - 1)
    idx = idx[..., None, None].expand(labels.shape + (1, 4))
    return torch.gather(per_class, -2, idx)[..., 0, :]
