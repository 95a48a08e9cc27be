"""VGG16 trunk and tail (counterpart of the JAX package's ``models/vgg.py``):
the py-faster-rcnn backbone of the ``coco_vgg16`` preset.

* :class:`VGG16Trunk`: conv1_1..conv5_3 (3x3, padding 1, ReLU) with 2x2/s2
  max pools after blocks 1-4 only (no pool5) -> a stride-16, 512-channel
  map. The pools round up (Caffe's rounding, flax's -inf padding of an odd
  extent), so 600 -> 38 as in the ResNet trunks.
* :class:`VGG16Tail`: the pooled ROI crop, flattened in H, W, C order (the
  NHWC layout the JAX tail flattens, so fc6's bridged weights line up) ->
  fc6 -> ReLU -> dropout -> fc7 -> ReLU -> dropout -> 4096 features.

Convolutions and the fc layers run in the input's dtype with weights cast
per call, as the flax modules compute in ``dtype`` with float32 parameters.
Module names are the flax tree's (``conv1_1`` ... ``conv5_3``, ``fc6``,
``fc7``), so ``models/convert.py`` maps them by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from replication_faster_rcnn_tpu_torch.models.resnet import Conv2d

Tensor = torch.Tensor

# (block, convs in the block, channels): VGG configuration "D" (16 layers)
VGG16_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))
VGG16_TRUNK_CHANNELS = 512
VGG16_TAIL_CHANNELS = 4096
DROPOUT_RATE = 0.5


class VGG16Trunk(nn.Module):
    """NCHW [N, 3, H, W] -> [N, 512, ceil(H/16), ceil(W/16)]."""

    def __init__(self, device=None):
        super().__init__()
        in_ch = 3
        for block, n_convs, ch in VGG16_BLOCKS:
            for i in range(1, n_convs + 1):
                self.add_module(f"conv{block}_{i}", Conv2d(in_ch, ch, 3, 1, 1, device=device))
                in_ch = ch

    def forward(self, x: Tensor) -> Tensor:
        for block, n_convs, _ in VGG16_BLOCKS:
            if block > 1:
                x = F.max_pool2d(x, kernel_size=2, stride=2, ceil_mode=True)
            for i in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"conv{block}_{i}")(x))
        return x


class VGG16Tail(nn.Module):
    """Pooled ROI crops NHWC [R, s, s, 512] -> [R, 4096] in the crops' dtype.

    In training mode each dropout keeps a value with probability 0.5 and
    doubles it, the keep mask drawn from ``generator`` (flax's
    ``nn.Dropout``; the draws differ from JAX's, which PyTorch cannot
    reproduce). In inference mode dropout is the identity.

    ``dense_out`` (an identity) sees fc6's and then fc7's output before its
    ReLU: the int8 calibration hooks it there, as the JAX package's capture
    of the tail's ``fc6`` / ``fc7`` intermediates does
    (``quant/calibrate.py::activation_ranges``)."""

    def __init__(self, roi_size: int = 7, device=None):
        super().__init__()
        self.fc6 = nn.Linear(roi_size * roi_size * VGG16_TRUNK_CHANNELS, VGG16_TAIL_CHANNELS,
                             device=device)
        self.fc7 = nn.Linear(VGG16_TAIL_CHANNELS, VGG16_TAIL_CHANNELS, device=device)
        self.dense_out = nn.Identity()

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        if self.training and generator is None:
            raise ValueError("VGG16Tail draws its dropout from an explicit torch.Generator in "
                             "training mode; pass generator=")
        x = x.reshape(x.shape[0], -1)
        keep = 1.0 - DROPOUT_RATE
        for fc in (self.fc6, self.fc7):
            x = F.relu(self.dense_out(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))))
            if self.training:
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, x.new_zeros(()))
        return x
