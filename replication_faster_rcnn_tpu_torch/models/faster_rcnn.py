"""Faster R-CNN assembly: trunk + RPN + detection head
(counterpart of the JAX package's ``models/faster_rcnn.py``).

The stages are methods — ``extract_features`` / ``rpn_forward`` / ``propose``
/ ``head_forward`` — and ``forward`` composes them into the inference pass
with the JAX model's seven outputs. Images and features are NHWC at every
method boundary. With ``model.fpn`` the trunk is :class:`ResNetFeatures`, the
``neck`` an :class:`FPNNeck`, the features the list ``[P2..P6]``, the RPN one
head shared by every level and the head :class:`FPNDetectionHead`.
``nn.Module.training`` switches every BatchNorm between its running and its
batch statistics (the JAX methods' ``train`` argument; a ``model.frozen_bn``
BatchNorm keeps its running ones); ``model.norm`` picks BatchNorm or
GroupNorm at the backbone's norm sites and ``model.remat`` recomputes the
trunk's blocks in the backward pass (``models/resnet.py``). The training step
(``train/train_step.py``) calls the stages one by one with
``propose(train=True)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.models.fpn import FPN_STRIDES, FPNNeck
from replication_faster_rcnn_tpu_torch.models.head import DetectionHead, FPNDetectionHead
from replication_faster_rcnn_tpu_torch.models.resnet import (
    BatchNorm,
    GroupNorm,
    ResNetFeatures,
    ResNetTrunk,
    stage_channels,
    trunk_channels,
)
from replication_faster_rcnn_tpu_torch.models.rpn import RPNHead, batched_proposals
from replication_faster_rcnn_tpu_torch.models.vgg import VGG16_TRUNK_CHANNELS, VGG16Trunk
from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.ops import anchors as anchor_ops

Tensor = torch.Tensor
# a single-scale feature map, or the FPN levels [P2..P6]
Features = Union[Tensor, List[Tensor]]

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class FasterRCNN(nn.Module):
    """The two-stage detector. Submodules ``trunk`` / ``rpn`` / ``head`` and
    their parameter names follow the flax tree (see ``models/convert.py``)."""

    def __init__(self, config: FasterRCNNConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)
        m = cfg.model
        knobs = dict(norm=m.norm, frozen_bn=m.frozen_bn)
        if m.fpn:
            self.trunk = ResNetFeatures(m.backbone, device=dev, remat=m.remat, **knobs)
            self.neck = FPNNeck(stage_channels(m.backbone), m.fpn_channels, device=dev)
            self.rpn = RPNHead(m.fpn_channels, cfg.anchors.num_base_anchors, m.fpn_channels,
                               device=dev)
            self.head = FPNDetectionHead(m.fpn_channels, m.num_classes, m.roi_size,
                                         m.roi_sampling_ratio, device=dev)
        else:
            if m.backbone == "vgg16":
                self.trunk = VGG16Trunk(device=dev, remat=m.remat)
                feat_channels = VGG16_TRUNK_CHANNELS
            else:
                self.trunk = ResNetTrunk(m.backbone, device=dev, remat=m.remat, **knobs)
                feat_channels = trunk_channels(m.backbone)
            self.rpn = RPNHead(feat_channels, cfg.anchors.num_base_anchors, m.rpn_mid_channels,
                               device=dev)
            self.head = DetectionHead(m.backbone, m.num_classes, m.roi_size, m.roi_op,
                                      m.roi_sampling_ratio, device=dev, **knobs)
        self._anchors: Dict[Tuple, Tensor] = {}
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def preprocess(self, images: Tensor) -> Tensor:
        """uint8 NHWC -> normalized float32; float input passes through."""
        if images.dtype == torch.uint8:
            mean = ops.constant(self.config.data.pixel_mean, torch.float32, images.device)
            std = ops.constant(self.config.data.pixel_std, torch.float32, images.device)
            images = (images.float() / 255.0 - mean) / std
        return images

    def extract_features(self, images: Tensor) -> Features:
        """images NHWC [N, H, W, 3] -> features NHWC [N, H/16, W/16, C], or
        with FPN the list [P2..P6] NHWC (strides 4..64)."""
        x = self.preprocess(images).to(self.compute_dtype)
        feat = self.trunk(x.permute(0, 3, 1, 2))  # channels-last NCHW view
        if self.config.model.fpn:
            return [p.permute(0, 2, 3, 1).contiguous() for p in self.neck(feat)]
        return feat.permute(0, 2, 3, 1).contiguous()

    def anchors(self, shapes: Tuple[Tuple[int, int], ...]) -> Tensor:
        """[A, 4] float32 anchors on the model's device for the feature maps
        of ``shapes`` (one map, or with FPN the levels fine -> coarse, one
        stride each, concatenated), built once per (shapes, device): a
        captured graph reads no new host copy."""
        key = (shapes, self.device)
        a = self._anchors.get(key)
        if a is None:
            acfg = self.config.anchors
            if self.config.model.fpn:
                a = np.concatenate([
                    anchor_ops.grid_anchors(
                        anchor_ops.anchor_base(stride, acfg.ratios, acfg.scales), stride, h, w)
                    for (h, w), stride in zip(shapes, FPN_STRIDES)])
            else:
                a = anchor_ops.make_anchors(acfg, shapes[0])
            a = self._anchors[key] = torch.from_numpy(a).to(self.device)
        return a

    def rpn_forward(self, feat: Features) -> Tuple[Tensor, Tensor, Tensor]:
        """features -> (logits [N, A, 2], deltas [N, A, 4], anchors [A, 4]).
        With FPN the one RPN head runs on every level and the levels'
        outputs and anchors concatenate fine -> coarse."""
        if self.config.model.fpn:
            outs = [self.rpn(level) for level in feat]
            shapes = tuple((level.shape[1], level.shape[2]) for level in feat)
            return (torch.cat([lg for lg, _ in outs], dim=1),
                    torch.cat([dl for _, dl in outs], dim=1),
                    self.anchors(shapes))
        logits, deltas = self.rpn(feat)
        return logits, deltas, self.anchors(((feat.shape[1], feat.shape[2]),))

    def propose(self, logits: Tensor, deltas: Tensor, anchors: Tensor,
                img_h: float, img_w: float, train: bool = False
                ) -> Tuple[Tensor, Tensor]:
        """(rois [N, post_nms, 4], valid [N, post_nms])."""
        return batched_proposals(
            anchors, logits, deltas, img_h, img_w, self.config.proposals, train
        )

    def head_forward(self, feat: Features, rois: Tensor, img_h: float, img_w: float,
                     quant: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     masks: Optional[dict] = None) -> Tuple[Tensor, Tensor]:
        """(cls [N, R, num_classes], reg [N, R, num_classes * 4]); ``quant``:
        the int8 serving path's ``{"head": {"cls"|"reg": ...}}``;
        ``generator`` / ``masks``: the VGG16 tail's dropout keep masks in
        training mode, drawn from the generator into ``masks`` unless
        ``masks`` holds them (``models/vgg.py::VGG16Tail``)."""
        return self.head(feat, rois, img_h, img_w, (quant or {}).get("head"), generator,
                         masks)

    def forward(self, images: Tensor, quant: Optional[dict] = None):
        """Inference pass -> (rpn_logits, rpn_deltas, rois, roi_valid, cls,
        reg, anchors)."""
        img_h, img_w = float(images.shape[1]), float(images.shape[2])
        feat = self.extract_features(images)
        logits, deltas, anchors = self.rpn_forward(feat)
        rois, valid = self.propose(logits, deltas, anchors, img_h, img_w)
        cls, reg = self.head_forward(feat, rois, img_h, img_w, quant)
        return logits, deltas, rois, valid, cls, reg, anchors


def functional_forward(model: FasterRCNN, params: Dict[str, Tensor], images: Tensor,
                       quant: Optional[dict] = None):
    """``model(images, quant)`` in inference mode with every parameter and
    buffer taken from ``params`` (a full state dict; the module's own
    tensors are not read, so it may live on the ``meta`` device)."""
    with torch.inference_mode():
        return torch.func.functional_call(
            model, params, (images,), {"quant": quant}, strict=True
        )


def init_parameters(model: FasterRCNN, seed: int = 0) -> FasterRCNN:
    """Random init from a seeded ``torch.Generator`` with the flax model's
    schemes: trunk/tail and FPN neck convs and the FPN head's fc6/fc7
    lecun-normal (truncated, fan-in), RPN convs N(0, 0.01), head cls
    N(0, 0.01) and reg N(0, 0.001), zero biases,
    BatchNorm identity (weight 1, bias 0, mean 0, var 1), GroupNorm weight 1
    and bias 0 (flax's ones and zeros)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)

    def lecun(w: Tensor) -> None:
        std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (BatchNorm, GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                if name.startswith("rpn."):
                    mod.weight.normal_(0.0, 0.01, generator=gen)
                elif name == "head.cls":
                    mod.weight.normal_(0.0, 0.01, generator=gen)
                elif name == "head.reg":
                    mod.weight.normal_(0.0, 0.001, generator=gen)
                else:
                    lecun(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def build_model(config: FasterRCNNConfig, device: DeviceLike = None,
                seed: int = 0, state_dict: Optional[dict] = None) -> FasterRCNN:
    """A ready inference model on ``device`` (default ``cuda``): the given
    state dict, else a seeded random init."""
    model = FasterRCNN(config, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_parameters(model, seed)
    return model
