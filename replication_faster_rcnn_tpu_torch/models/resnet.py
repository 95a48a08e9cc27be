"""ResNet trunk and tail (counterpart of the JAX package's ``models/resnet.py``).

The Faster R-CNN split: a stride-16 **trunk** (conv1..layer3) gives the
shared feature map; the **tail** (layer4 + global average pool) embeds the
pooled ROI crops in the detection head.

Modules take NCHW tensors; the model hands them channels-last views of its
NHWC inputs, so cuDNN runs NHWC underneath without copies. Convolutions
run in the input's dtype (the model's compute dtype) with weights cast per
call, as the flax modules do. BatchNorm computes in float32 (eps 1e-5):
in inference mode (``nn.Module.training`` False) with the running
statistics, in training mode with the batch's (see :class:`BatchNorm`).
Module and parameter names
follow the flax tree (``conv1``, ``bn1``, ``layer1.0.downsample_conv``, ...)
so ``models/convert.py`` is a pure name and layout mapping.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

_WIDTHS = (64, 128, 256, 512)
_DEPTHS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
_BOTTLENECK = {"resnet50", "resnet101", "resnet152"}


class Conv2d(nn.Conv2d):
    """Conv whose weight (and bias) follow the input's dtype."""

    def forward(self, x: Tensor) -> Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int, padding: int, device) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False, device=device)


class BatchNorm(nn.Module):
    """BatchNorm as flax computes it: ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in float32, cast back to the input's dtype.

    Inference mode uses the running statistics. Training mode uses the
    batch's: ``mean = E[x]`` and the biased ``var = max(E[x^2] - E[x]^2, 0)``
    over (N, H, W) in float32, differentiated through. The running update
    ``running = 0.9 * running + 0.1 * batch`` (with the biased variance, as
    flax keeps it) is not applied here: it is left in ``pending_stats`` for
    the optimizer step to commit (``train/fault.py::guarded_update``), so a
    withheld step leaves the buffers bit-identical."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.pending_stats: Optional[Tuple[Tensor, Tensor]] = None

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            return self._train_forward(x)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float().view(shape)) * mul.view(shape)
        return (y + self.bias.float().view(shape)).to(x.dtype)

    def _train_forward(self, x: Tensor) -> Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp(torch.square(xf).mean(dim=(0, 2, 3)) - torch.square(mean), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.pending_stats = (
                m * self.running_mean + (1 - m) * mean.detach(),
                m * self.running_var + (1 - m) * var.detach(),
            )
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.float().view(shape)).to(x.dtype)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = _conv(in_ch, features, 3, stride, 1, device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = _conv(features, features, 3, 1, 1, device)
        self.bn2 = BatchNorm(features, device=device)
        self.downsample_conv: Optional[Conv2d] = None
        if stride != 1 or in_ch != features:
            self.downsample_conv = _conv(in_ch, features, 1, stride, 0, device)
            self.downsample_bn = BatchNorm(features, device=device)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4) bottleneck."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None):
        super().__init__()
        out_ch = features * self.expansion
        self.conv1 = _conv(in_ch, features, 1, 1, 0, device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = _conv(features, features, 3, stride, 1, device)
        self.bn2 = BatchNorm(features, device=device)
        self.conv3 = _conv(features, out_ch, 1, 1, 0, device)
        self.bn3 = BatchNorm(out_ch, device=device)
        self.downsample_conv: Optional[Conv2d] = None
        if stride != 1 or in_ch != out_ch:
            self.downsample_conv = _conv(in_ch, out_ch, 1, stride, 0, device)
            self.downsample_bn = BatchNorm(out_ch, device=device)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


def _block(arch: str):
    if arch not in _DEPTHS:
        raise ValueError(f"unknown resnet arch {arch!r}; choices: {sorted(_DEPTHS)}")
    return Bottleneck if arch in _BOTTLENECK else BasicBlock


def _stage(arch: str, in_ch: int, stage: int, stride: int, device) -> nn.ModuleList:
    block = _block(arch)
    blocks = []
    for i in range(_DEPTHS[arch][stage]):
        blocks.append(block(in_ch, _WIDTHS[stage], stride if i == 0 else 1, device))
        in_ch = _WIDTHS[stage] * block.expansion
    return nn.ModuleList(blocks)


def trunk_channels(arch: str) -> int:
    return _WIDTHS[2] * _block(arch).expansion


def tail_channels(arch: str) -> int:
    return _WIDTHS[3] * _block(arch).expansion


class ResNetTrunk(nn.Module):
    """conv1..layer3: NCHW [N, 3, H, W] -> [N, C, ceil(H/16), ceil(W/16)]."""

    def __init__(self, arch: str = "resnet18", device=None):
        super().__init__()
        expansion = _block(arch).expansion
        self.conv1 = _conv(3, 64, 7, 2, 3, device)
        self.bn1 = BatchNorm(64, device=device)
        self.layer1 = _stage(arch, 64, 0, 1, device)
        self.layer2 = _stage(arch, _WIDTHS[0] * expansion, 1, 2, device)
        self.layer3 = _stage(arch, _WIDTHS[1] * expansion, 2, 2, device)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x)
        return x


class ResNetTail(nn.Module):
    """layer4 + global average pool: NCHW [R, C, h, w] -> [R, C_out]."""

    def __init__(self, arch: str = "resnet18", device=None):
        super().__init__()
        self.layer4 = _stage(arch, _WIDTHS[2] * _block(arch).expansion, 3, 2, device)

    def forward(self, x: Tensor) -> Tensor:
        for block in self.layer4:
            x = block(x)
        # mean accumulated in float32, rounded to the compute dtype
        return x.float().mean(dim=(2, 3)).to(x.dtype)
