"""ResNet trunk and tail (counterpart of the JAX package's ``models/resnet.py``).

The Faster R-CNN split: a stride-16 **trunk** (conv1..layer3) gives the
shared feature map; the **tail** (layer4 + global average pool) embeds the
pooled ROI crops in the detection head. With FPN, :class:`ResNetFeatures`
is the whole network (conv1..layer4) and returns every stage's output.
Every arch of the JAX package's ``_SPECS`` table builds: the plain ResNets,
ResNeXt (a grouped 3x3 in each Bottleneck, cuDNN's ``groups=``) and the
wide ResNets (a wider Bottleneck inside, the same output).

Modules take NCHW tensors; the model hands them channels-last views of its
NHWC inputs, so cuDNN runs NHWC underneath without copies. Convolutions
run in the input's dtype (the model's compute dtype) with weights cast per
call, as the flax modules do. BatchNorm computes in float32 (eps 1e-5):
in inference mode (``nn.Module.training`` False) with the running
statistics, in training mode with the batch's (see :class:`BatchNorm`),
or with the running ones again when it is frozen (``model.frozen_bn``).
``model.norm="group"`` puts :class:`GroupNorm` at the same sites.
``model.remat`` recomputes each residual block of the trunk in the
backward pass (:func:`run_blocks`). Module and parameter names follow the
flax tree (``conv1``, ``bn1``, ``layer1.0.downsample_conv``, ...) so
``models/convert.py`` is a pure name and layout mapping.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor

_WIDTHS = (64, 128, 256, 512)
GN_GROUPS = 32  # flax nn.GroupNorm's default, the JAX package's GroupNorm(32)


class Conv2d(nn.Conv2d):
    """Conv whose weight (and bias) follow the input's dtype."""

    def forward(self, x: Tensor) -> Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding, 1,
                        self.groups)


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int, padding: int, device,
          groups: int = 1) -> Conv2d:
    """A bias-free conv; ``groups`` > 1 is the JAX package's ``GroupedConv``
    (its einsum over each group's taps), here cuDNN's grouped convolution:
    output channels in contiguous blocks of ``out_ch / groups``, each block
    reading its own ``in_ch / groups`` inputs."""
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False, groups=groups,
                  device=device)


class BatchNorm(nn.Module):
    """BatchNorm as flax computes it: ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in float32, cast back to the input's dtype.

    Inference mode uses the running statistics. Training mode uses the
    batch's: ``mean = E[x]`` and the biased ``var = max(E[x^2] - E[x]^2, 0)``
    over (N, H, W) in float32, differentiated through. The running update
    ``running = 0.9 * running + 0.1 * batch`` (with the biased variance, as
    flax keeps it) is not applied here: it is left in ``pending_stats`` for
    the optimizer step to commit (``train/fault.py::guarded_update``), so a
    withheld step leaves the buffers bit-identical.

    A ``frozen`` BatchNorm (``model.frozen_bn``) applies the running
    statistics in training mode too: its affine still trains, and it
    leaves no ``pending_stats``. The module's ``training`` flag is not
    touched, so the rest of the model trains as before."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5, device=None, frozen: bool = False):
        super().__init__()
        self.eps = eps
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.pending_stats: Optional[Tuple[Tensor, Tensor]] = None

    def forward(self, x: Tensor) -> Tensor:
        if self.training and not self.frozen:
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


class GroupNorm(nn.Module):
    """GroupNorm as flax's ``nn.GroupNorm(32, epsilon=1e-5)`` computes it:
    per sample and group of ``C / 32`` channels, ``mean = E[x]`` and flax's
    fast variance ``max(E[x^2] - E[x]^2, 0)`` over (H, W, the group's
    channels) in float32, then ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias`` in float32, cast back to the input's dtype. The same in training
    and inference: no running statistics. Parameters ``weight`` / ``bias``
    sit at the BatchNorm sites' names (flax's ``scale`` / ``bias``)."""

    eps = 1e-5

    def __init__(self, channels: int, device=None):
        super().__init__()
        if channels % GN_GROUPS:
            raise ValueError(f"GroupNorm: {GN_GROUPS} groups do not divide {channels} channels")
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: Tensor) -> Tensor:
        n, c = x.shape[:2]
        xf = x.float()
        # per-channel means first (a channels-last map reduces in place),
        # then the group's: each channel counts H * W values, so the mean of
        # the means is the group's mean
        size = c // GN_GROUPS
        mean = xf.mean(dim=(2, 3)).view(n, GN_GROUPS, size).mean(dim=2)
        mean_sq = torch.square(xf).mean(dim=(2, 3)).view(n, GN_GROUPS, size).mean(dim=2)
        var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
        mean = mean.repeat_interleave(size, dim=1).view(n, c, 1, 1)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(size, dim=1) * self.weight.float()
        y = (xf - mean) * mul.view(n, c, 1, 1)
        return (y + self.bias.float().view(1, -1, 1, 1)).to(x.dtype)


def _norm(channels: int, norm: str, frozen: bool, device) -> nn.Module:
    """The norm layer at a BatchNorm site (the JAX package's ``_norm``)."""
    if norm == "group":
        return GroupNorm(channels, device=device)
    return BatchNorm(channels, device=device, frozen=frozen)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None,
                 norm: str = "batch", frozen: bool = False):
        super().__init__()
        self.conv1 = _conv(in_ch, features, 3, stride, 1, device)
        self.bn1 = _norm(features, norm, frozen, device)
        self.conv2 = _conv(features, features, 3, 1, 1, device)
        self.bn2 = _norm(features, norm, frozen, device)
        self.downsample_conv: Optional[Conv2d] = None
        if stride != 1 or in_ch != features:
            self.downsample_conv = _conv(in_ch, features, 1, stride, 0, device)
            self.downsample_bn = _norm(features, norm, frozen, device)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4) bottleneck. ``groups`` and
    ``base_width`` give the ResNeXt and wide variants: the inner width is
    ``int(features * base_width / 64) * groups`` and the 3x3 is grouped;
    the output stays ``features * 4``."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None,
                 norm: str = "batch", frozen: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        out_ch = features * self.expansion
        width = int(features * (base_width / 64.0)) * groups
        self.conv1 = _conv(in_ch, width, 1, 1, 0, device)
        self.bn1 = _norm(width, norm, frozen, device)
        self.conv2 = _conv(width, width, 3, stride, 1, device, groups)
        self.bn2 = _norm(width, norm, frozen, device)
        self.conv3 = _conv(width, out_ch, 1, 1, 0, device)
        self.bn3 = _norm(out_ch, norm, frozen, device)
        self.downsample_conv: Optional[Conv2d] = None
        if stride != 1 or in_ch != out_ch:
            self.downsample_conv = _conv(in_ch, out_ch, 1, stride, 0, device)
            self.downsample_bn = _norm(out_ch, norm, frozen, device)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


# arch -> (block, blocks per stage, groups, width per group): the JAX
# package's ``_SPECS`` (torchvision's constructor table)
_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}


def _spec(arch: str):
    if arch not in _SPECS:
        raise ValueError(f"unknown resnet arch {arch!r}; choices: {sorted(_SPECS)}")
    return _SPECS[arch]


def _stage(arch: str, in_ch: int, stage: int, stride: int, device, norm: str = "batch",
           frozen: bool = False) -> nn.ModuleList:
    block, depths, groups, base_width = _spec(arch)
    kw = {"groups": groups, "base_width": base_width} if block is Bottleneck else {}
    blocks = []
    for i in range(depths[stage]):
        blocks.append(block(in_ch, _WIDTHS[stage], stride if i == 0 else 1, device, norm, frozen,
                            **kw))
        in_ch = _WIDTHS[stage] * block.expansion
    return nn.ModuleList(blocks)


def run_blocks(blocks, x: Tensor, remat: bool = False) -> Tensor:
    """``x`` through each block in turn. With ``remat`` (and autograd
    recording) each block runs under ``torch.utils.checkpoint``: the
    backward recomputes its activations (the JAX package's per-block
    ``nn.remat``). The blocks draw nothing, so no RNG state is saved, which
    would also read the generator's state inside a graph capture."""
    for block in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x)
    return x


def trunk_channels(arch: str) -> int:
    return _WIDTHS[2] * _spec(arch)[0].expansion


def tail_channels(arch: str) -> int:
    return _WIDTHS[3] * _spec(arch)[0].expansion


class ResNetTrunk(nn.Module):
    """conv1..layer3: NCHW [N, 3, H, W] -> [N, C, ceil(H/16), ceil(W/16)].
    ``norm`` / ``frozen_bn`` / ``remat``: the model's knobs (module
    docstring)."""

    def __init__(self, arch: str = "resnet18", device=None, norm: str = "batch",
                 frozen_bn: bool = False, remat: bool = False):
        super().__init__()
        expansion = _spec(arch)[0].expansion
        self.remat = remat
        self.conv1 = _conv(3, 64, 7, 2, 3, device)
        self.bn1 = _norm(64, norm, frozen_bn, device)
        self.layer1 = _stage(arch, 64, 0, 1, device, norm, frozen_bn)
        self.layer2 = _stage(arch, _WIDTHS[0] * expansion, 1, 2, device, norm, frozen_bn)
        self.layer3 = _stage(arch, _WIDTHS[1] * expansion, 2, 2, device, norm, frozen_bn)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3):
            x = run_blocks(layer, x, self.remat)
        return x


class ResNetFeatures(ResNetTrunk):
    """conv1..layer4 returning ``[C2, C3, C4, C5]`` (strides 4/8/16/32) for
    the FPN neck (the JAX package's ``models/fpn.py::ResNetFeatures``).
    ``layer4`` lives here, not in the head, as in the flax tree; the knobs
    apply to all four stages."""

    def __init__(self, arch: str = "resnet50", device=None, norm: str = "batch",
                 frozen_bn: bool = False, remat: bool = False):
        super().__init__(arch, device, norm, frozen_bn, remat)
        self.layer4 = _stage(arch, trunk_channels(arch), 3, 2, device, norm, frozen_bn)

    def forward(self, x: Tensor) -> List[Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = run_blocks(layer, x, self.remat)
            feats.append(x)
        return feats


def stage_channels(arch: str) -> Tuple[int, ...]:
    """Channels of C2..C5."""
    return tuple(w * _spec(arch)[0].expansion for w in _WIDTHS)


class ResNetTail(nn.Module):
    """layer4 + global average pool: pooled ROI crops NHWC [R, h, w, C] ->
    [R, C_out]. ``generator`` and ``masks`` are unused (the tail draws
    nothing); they keep the head's one call for every tail. ``norm`` and
    ``frozen_bn`` as the trunk's; the tail has no remat, as in JAX."""

    def __init__(self, arch: str = "resnet18", device=None, norm: str = "batch",
                 frozen_bn: bool = False):
        super().__init__()
        self.layer4 = _stage(arch, trunk_channels(arch), 3, 2, device, norm, frozen_bn)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None,
                masks: Optional[dict] = None) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        for block in self.layer4:
            x = block(x)
        # mean accumulated in float32, rounded to the compute dtype
        return x.float().mean(dim=(2, 3)).to(x.dtype)
