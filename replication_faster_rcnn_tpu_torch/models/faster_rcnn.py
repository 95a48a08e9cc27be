"""Faster R-CNN assembly: trunk + RPN + detection head
(counterpart of the JAX package's ``models/faster_rcnn.py``).

The stages are methods — ``extract_features`` / ``rpn_forward`` / ``propose``
/ ``head_forward`` — and ``forward`` composes them into the inference pass
with the JAX model's seven outputs. Images and features are NHWC at every
method boundary.
``nn.Module.training`` switches every BatchNorm between its running and its
batch statistics (the JAX methods' ``train`` argument); the training step
(``train/train_step.py``) calls the stages one by one with
``propose(train=True)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.models.head import DetectionHead
from replication_faster_rcnn_tpu_torch.models.resnet import (
    BatchNorm,
    ResNetTrunk,
    trunk_channels,
)
from replication_faster_rcnn_tpu_torch.models.rpn import RPNHead, batched_proposals
from replication_faster_rcnn_tpu_torch.ops import anchors as anchor_ops

Tensor = torch.Tensor

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
        self.trunk = ResNetTrunk(cfg.model.backbone, device=dev)
        self.rpn = RPNHead(
            trunk_channels(cfg.model.backbone), cfg.anchors.num_base_anchors,
            cfg.model.rpn_mid_channels, device=dev,
        )
        self.head = DetectionHead(
            cfg.model.backbone, cfg.model.num_classes, cfg.model.roi_size,
            cfg.model.roi_op, cfg.model.roi_sampling_ratio, device=dev,
        )
        self._anchors: Dict[Tuple[int, int, torch.device], Tensor] = {}
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.trunk.conv1.weight.device

    def preprocess(self, images: Tensor) -> Tensor:
        """uint8 NHWC -> normalized float32; float input passes through."""
        if images.dtype == torch.uint8:
            mean = torch.tensor(self.config.data.pixel_mean, dtype=torch.float32,
                                device=images.device)
            std = torch.tensor(self.config.data.pixel_std, dtype=torch.float32,
                               device=images.device)
            images = (images.float() / 255.0 - mean) / std
        return images

    def extract_features(self, images: Tensor) -> Tensor:
        """images NHWC [N, H, W, 3] -> features NHWC [N, H/16, W/16, C]."""
        x = self.preprocess(images).to(self.compute_dtype)
        feat = self.trunk(x.permute(0, 3, 1, 2))  # channels-last NCHW view
        return feat.permute(0, 2, 3, 1).contiguous()

    def anchors(self, feat_h: int, feat_w: int) -> Tensor:
        """[feat_h * feat_w * K, 4] float32 anchors on the model's device."""
        key = (feat_h, feat_w, self.device)
        a = self._anchors.get(key)
        if a is None:
            a = torch.from_numpy(
                anchor_ops.make_anchors(self.config.anchors, (feat_h, feat_w))
            ).to(self.device)
            self._anchors[key] = a
        return a

    def rpn_forward(self, feat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """features -> (logits [N, A, 2], deltas [N, A, 4], anchors [A, 4])."""
        logits, deltas = self.rpn(feat)
        return logits, deltas, self.anchors(feat.shape[1], feat.shape[2])

    def propose(self, logits: Tensor, deltas: Tensor, anchors: Tensor,
                img_h: float, img_w: float, train: bool = False
                ) -> Tuple[Tensor, Tensor]:
        """(rois [N, post_nms, 4], valid [N, post_nms])."""
        return batched_proposals(
            anchors, logits, deltas, img_h, img_w, self.config.proposals, train
        )

    def head_forward(self, feat: Tensor, rois: Tensor, img_h: float, img_w: float
                     ) -> Tuple[Tensor, Tensor]:
        """(cls [N, R, num_classes], reg [N, R, num_classes * 4])."""
        return self.head(feat, rois, img_h, img_w)

    def forward(self, images: Tensor):
        """Inference pass -> (rpn_logits, rpn_deltas, rois, roi_valid, cls,
        reg, anchors)."""
        img_h, img_w = float(images.shape[1]), float(images.shape[2])
        feat = self.extract_features(images)
        logits, deltas, anchors = self.rpn_forward(feat)
        rois, valid = self.propose(logits, deltas, anchors, img_h, img_w)
        cls, reg = self.head_forward(feat, rois, img_h, img_w)
        return logits, deltas, rois, valid, cls, reg, anchors


def init_parameters(model: FasterRCNN, seed: int = 0) -> FasterRCNN:
    """Random init from a seeded ``torch.Generator`` with the flax model's
    schemes: trunk/tail convs lecun-normal (truncated, fan-in), RPN convs
    N(0, 0.01), head cls N(0, 0.01) and reg N(0, 0.001), zero biases,
    BatchNorm identity (weight 1, bias 0, mean 0, var 1)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)

    def lecun(w: Tensor) -> None:
        std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
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
