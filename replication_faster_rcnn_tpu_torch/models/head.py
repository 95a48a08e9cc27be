"""Second-stage detection head: ROI features + backbone tail (ResNet layer4,
or VGG16's fc6/fc7) + cls/reg Linear (counterpart of the JAX package's
``models/head.py::DetectionHead``), the FPN head (multi-level ROIAlign + two
fc layers, :class:`FPNDetectionHead`), and :func:`select_class_deltas` for
the head's regression loss.

In training mode the ResNet tail's BatchNorm uses the batch statistics of
the N * R crops, and the ROI kernels (ROIAlign or ROIPool) pass the
gradient back to the features (``ops/cuda/roi_kernel.py``). In int8
serving the cls/reg layers of both heads run as true int8 GEMMs
(:func:`_head_dense`), and every other weight arrives dequantized in the
compute dtype."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from replication_faster_rcnn_tpu_torch.models.fpn import multilevel_roi_align
from replication_faster_rcnn_tpu_torch.models.resnet import ResNetTail, tail_channels
from replication_faster_rcnn_tpu_torch.models.vgg import VGG16_TAIL_CHANNELS, VGG16Tail
from replication_faster_rcnn_tpu_torch import ops
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
    quant=None, generator=None, masks=None) -> (cls [N, R, num_classes], reg
    [N, R, num_classes * 4]) float32.

    The tail runs in the feature's dtype; cls/reg run in float32 on the
    embedding cast to float32, as int8 GEMMs for the layers named in
    ``quant`` (``{"cls": {"w_scale", "x_scale"}, ...}``). In training mode
    the VGG16 tail's dropout takes its keep masks from ``masks`` or draws
    them from ``generator`` into it (``models/vgg.py::VGG16Tail``); the
    ResNet tail ignores both. ``norm`` and ``frozen_bn`` reach the ResNet
    tail (``models/resnet.py``)."""

    def __init__(self, arch: str = "resnet18", num_classes: int = 21,
                 roi_size: int = 7, roi_op: str = "align", sampling_ratio: int = 2,
                 device=None, norm: str = "batch", frozen_bn: bool = False):
        super().__init__()
        self.roi_size = roi_size
        self.roi_op = roi_op
        self.sampling_ratio = sampling_ratio
        if arch == "vgg16":
            self.tail = VGG16Tail(roi_size, device=device)
            ch = VGG16_TAIL_CHANNELS
        else:
            self.tail = ResNetTail(arch, device=device, norm=norm, frozen_bn=frozen_bn)
            ch = tail_channels(arch)
        self.cls = nn.Linear(ch, num_classes, device=device)
        self.reg = nn.Linear(ch, num_classes * 4, device=device)

    def forward(self, feat: Tensor, rois: Tensor, img_h: float, img_w: float,
                quant: Optional[Dict[str, Any]] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Dict[str, Tensor]] = None) -> Tuple[Tensor, Tensor]:
        n, r = rois.shape[0], rois.shape[1]
        fh, fw = feat.shape[1], feat.shape[2]
        # image -> feature coordinates; the ratios are Python floats
        scale = ops.constant([fh / img_h, fw / img_w, fh / img_h, fw / img_w],
                             rois.dtype, rois.device)
        crops = roi_ops.extract_roi_features(
            feat, rois * scale, op=self.roi_op, out_size=self.roi_size,
            sampling_ratio=self.sampling_ratio, out_dtype=feat.dtype,
        )  # [N, R, s, s, C] in the feature's dtype (the kernel stores it directly)
        crops = crops.reshape((n * r,) + crops.shape[2:]).to(feat.dtype)
        embed = self.tail(crops, generator, masks).float()  # [N*R, C_tail]
        quant = quant or {}
        cls = _head_dense(self.cls, embed, quant.get("cls"))
        reg = _head_dense(self.reg, embed, quant.get("reg"))
        return cls.reshape(n, r, -1), reg.reshape(n, r, -1)


class FPNDetectionHead(nn.Module):
    """The FPN head (the JAX package's ``FPNDetectionHead``): multi-level
    ROIAlign over P2..P5, then the paper's two-fc box head, ``fc6`` and
    ``fc7`` (``mlp_dim``, ReLU) in the features' dtype, then cls/reg in
    float32 through :func:`_head_dense`.

    forward(feats [P2..P6 NHWC], rois [N, R, 4] image coords, img_h, img_w,
    quant=None, generator=None, masks=None) -> (cls [N, R, num_classes], reg
    [N, R, num_classes * 4]). The crops are flattened in (row, column,
    channel) order, the order of flax's ``fc6`` kernel rows. ``quant`` is
    the single-scale head's: cls/reg named there run as int8 GEMMs on
    fc7's ReLU output cast to float32. ``generator`` and ``masks`` keep the
    single-scale head's call; this head draws nothing.

    ``fc7_out`` (an identity) sees fc7's output before its ReLU, in the
    features' dtype: the int8 calibration hooks it there, as the JAX
    package captures ``fc7`` and folds the ReLU into the range."""

    def __init__(self, in_channels: int = 256, num_classes: int = 21, roi_size: int = 7,
                 sampling_ratio: int = 2, mlp_dim: int = 1024, device=None):
        super().__init__()
        self.roi_size = roi_size
        self.sampling_ratio = sampling_ratio
        self.fc6 = nn.Linear(roi_size * roi_size * in_channels, mlp_dim, device=device)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim, device=device)
        self.fc7_out = nn.Identity()
        self.cls = nn.Linear(mlp_dim, num_classes, device=device)
        self.reg = nn.Linear(mlp_dim, num_classes * 4, device=device)

    def forward(self, feats, rois: Tensor, img_h: float, img_w: float,
                quant: Optional[Dict[str, Any]] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Dict[str, Tensor]] = None) -> Tuple[Tensor, Tensor]:
        n, r = rois.shape[0], rois.shape[1]
        dtype = feats[0].dtype
        crops = multilevel_roi_align(feats, rois, img_h, img_w, self.roi_size,
                                     self.sampling_ratio, out_dtype=dtype)  # [N, R, s, s, C]
        x = crops.reshape(n * r, -1)
        x = F.relu(F.linear(x, self.fc6.weight.to(dtype), self.fc6.bias.to(dtype)))
        x = F.linear(x, self.fc7.weight.to(dtype), self.fc7.bias.to(dtype))
        x = F.relu(self.fc7_out(x)).float()  # cls/reg logits in float32
        quant = quant or {}
        cls = _head_dense(self.cls, x, quant.get("cls"))
        reg = _head_dense(self.reg, x, quant.get("reg"))
        return cls.reshape(n, r, -1), reg.reshape(n, r, -1)


def select_class_deltas(reg: Tensor, labels: Tensor) -> Tensor:
    """Each roi's box deltas for its class: reg [..., R, C * 4], labels
    [..., R] int -> [..., R, 4]. Labels are clamped into [0, C - 1] (the
    filler label -1 picks class 0; the loss masks it out)."""
    per_class = reg.reshape(reg.shape[:-1] + (-1, 4))  # [..., R, C, 4]
    idx = torch.clamp(labels.long(), 0, per_class.shape[-2] - 1)
    idx = idx[..., None, None].expand(labels.shape + (1, 4))
    return torch.gather(per_class, -2, idx)[..., 0, :]
