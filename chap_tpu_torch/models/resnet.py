"""ResNet / ResNeXt backbone family in 2D and 3D (port of
chap_tpu/models/resnet.py; the reference's resnet.py:144-415 /
resnet3d.py:213-265 and the 2D ResNet2d :242-357). No factory key builds
it; ``CONSTRUCTORS`` names every constructor.

chap_tpu's semantics, which it keeps from the reference: base width 16 *
width; a 7x7 stride-1 stem (the reference's maxpool is defined but unused
in its forward), so the stem feature is at full resolution and every stage
strides by 2, but the last with ``layer4_dilation`` 2 (stride 1, dilation
2: the ``_16s`` variant); Bottleneck width planes * (width_per_group / 64)
* groups, expansion 4; a downsample of a 1x1 strided conv and BN, or with
``avg_down`` an average pool, a 1x1 conv and BN; the ``_d`` deep stem of
three 3x3 convs (32 at stride 2, 32, 64) whose stem norm takes the 64
channels it gets (chap_tpu's repair of the reference's 16-channel bn1).
forward -> the pyramid [c1, c2, c3, c4, c5].

``ndim`` (2 or 3) picks the convolutions (NCHW or NCDHW). Names follow
torchvision's ResNet, as the reference's: ``conv1``, ``bn1``,
``layer{s}.{b}.conv1`` ... ``downsample.{0,1}`` (``.{1,2}`` behind the
average pool), and the deep stem's Sequential ``conv1.{0,1,3,4,6}``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, BatchNorm3d, Conv2d,
                                          Conv3d, FlaxBatchNorm, Stats,
                                          set_stats_keys)


def _layers(ndim: int):
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    return (Conv2d, BatchNorm2d) if ndim == 2 else (Conv3d, BatchNorm3d)


def _run(seq: nn.Module, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
    """A Sequential's layers in order, its BatchNorms given ``stats``."""
    for layer in seq:
        x = layer(x, stats) if isinstance(layer, FlaxBatchNorm) else layer(x)
    return x


def _downsample(ndim: int, in_ch: int, out_ch: int, stride: int,
                avg_down: bool) -> Optional[nn.Sequential]:
    """None where the shape stays (the identity skip); else a 1x1 strided
    conv and BN, or with ``avg_down`` (and a stride) an average pool of
    the stride, a 1x1 conv and BN (chap_tpu resnet.py:93-109)."""
    if stride == 1 and in_ch == out_ch:
        return None
    conv, bn = _layers(ndim)
    if avg_down and stride != 1:
        pool = nn.AvgPool2d(stride) if ndim == 2 else nn.AvgPool3d(stride)
        return nn.Sequential(pool, conv(in_ch, out_ch, 1, bias=False), bn(out_ch))
    return nn.Sequential(conv(in_ch, out_ch, 1, stride, bias=False), bn(out_ch))


class BasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN plus the skip, then ReLU (chap_tpu
    resnet.py:36-57; the dilation is not applied, as there)."""
    expansion = 1

    def __init__(self, ndim: int, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, avg_down: bool = False):
        super().__init__()
        conv, bn = _layers(ndim)
        self.conv1 = conv(in_ch, planes, 3, stride, padding=1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, padding=1, bias=False)
        self.bn2 = bn(planes)
        self.downsample = _downsample(ndim, in_ch, planes, stride, avg_down)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), stats))
        h = self.bn2(self.conv2(h), stats)
        skip = x if self.downsample is None else _run(self.downsample, x, stats)
        return F.relu(h + skip)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, groups, dilation) -> 1x1 to planes * 4, BN after
    each, plus the skip, then ReLU (chap_tpu resnet.py:60-90)."""
    expansion = 4

    def __init__(self, ndim: int, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, avg_down: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        conv, bn = _layers(ndim)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(in_ch, width, 1, bias=False)
        self.bn1 = bn(width)
        self.conv2 = conv(width, width, 3, stride, padding=dilation,
                          dilation=dilation, groups=groups, bias=False)
        self.bn2 = bn(width)
        self.conv3 = conv(width, planes * 4, 1, bias=False)
        self.bn3 = bn(planes * 4)
        self.downsample = _downsample(ndim, in_ch, planes * 4, stride, avg_down)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), stats))
        h = F.relu(self.bn2(self.conv2(h), stats))
        h = self.bn3(self.conv3(h), stats)
        skip = x if self.downsample is None else _run(self.downsample, x, stats)
        return F.relu(h + skip)


class ResNetBackbone(nn.Module):
    """The ResNet / ResNet2d body (chap_tpu resnet.py:112-175):
    forward(x [B, in_chns, *spatial]) -> [c1, c2, c3, c4, c5]."""

    def __init__(self, in_chns: int = 1, ndim: int = 2, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2), width: int = 1,
                 groups: int = 1, width_per_group: int = 64,
                 avg_down: bool = False, deep_stem: bool = False,
                 layer4_dilation: int = 1):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown block {block!r}")
        if layer4_dilation not in (1, 2):
            raise NotImplementedError("layer4_dilation must be 1 or 2")
        conv, bn = _layers(ndim)
        base = 16 * width
        if deep_stem:
            self.conv1 = nn.Sequential(
                conv(in_chns, 32, 3, 2, padding=1, bias=False), bn(32), nn.ReLU(),
                conv(32, 32, 3, padding=1, bias=False), bn(32), nn.ReLU(),
                conv(32, 64, 3, padding=1, bias=False))
            ch = 64
        else:
            self.conv1 = conv(in_chns, base, 7, padding=3, bias=False)
            ch = base
        self.bn1 = bn(ch)
        self.stages = len(layers)
        for stage, blocks in enumerate(layers):
            planes = base * 2 ** (stage + 1)
            last = stage == len(layers) - 1
            stride = 1 if (last and layer4_dilation == 2) else 2
            dilation = layer4_dilation if last else 1
            mods = []
            for b in range(blocks):
                kw = dict(stride=stride if b == 0 else 1, dilation=dilation,
                          avg_down=avg_down)
                if block == "bottleneck":
                    mods.append(Bottleneck(ndim, ch, planes, groups=groups,
                                           base_width=width_per_group, **kw))
                    ch = planes * 4
                else:
                    mods.append(BasicBlock(ndim, ch, planes, **kw))
                    ch = planes
            setattr(self, f"layer{stage + 1}", nn.ModuleList(mods))
        set_stats_keys(self)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> List[torch.Tensor]:
        stem = self.conv1
        h = _run(stem, x, stats) if isinstance(stem, nn.Sequential) else stem(x)
        h = F.relu(self.bn1(h, stats))
        feats = [h]
        for stage in range(self.stages):
            for block in getattr(self, f"layer{stage + 1}"):
                h = block(h, stats)
            feats.append(h)
        return feats


def _make(block: str, layers: Sequence[int], **kw) -> ResNetBackbone:
    return ResNetBackbone(block=block, layers=tuple(layers), **kw)


# the constructor family (resnet.py:359-415 == resnet3d.py:213-265); pass
# in_chns and ndim as keywords
def resnet18(**kw):
    return _make("basic", (2, 2, 2, 2), **kw)


def resnet18_d(**kw):
    return _make("basic", (2, 2, 2, 2), deep_stem=True, avg_down=True, **kw)


def resnet34(**kw):
    return _make("basic", (3, 4, 6, 3), **kw)


def resnet34_d(**kw):
    return _make("basic", (3, 4, 6, 3), deep_stem=True, avg_down=True, **kw)


def resnet50(**kw):
    return _make("bottleneck", (3, 4, 6, 3), **kw)


def resnet50_w2x(**kw):
    return _make("bottleneck", (3, 4, 6, 3), width=2, **kw)


def resnet50_16s(**kw):
    return _make("bottleneck", (3, 4, 6, 3), layer4_dilation=2, **kw)


def resnet50_d(**kw):
    return _make("bottleneck", (3, 4, 6, 3), deep_stem=True, avg_down=True, **kw)


def resnet101(**kw):
    return _make("bottleneck", (3, 4, 23, 3), **kw)


def resnet101_d(**kw):
    return _make("bottleneck", (3, 4, 23, 3), deep_stem=True, avg_down=True, **kw)


def resnext101_32x8d(**kw):
    return _make("bottleneck", (3, 4, 23, 3), groups=32, width_per_group=8, **kw)


def resnet152(**kw):
    return _make("bottleneck", (3, 8, 36, 3), **kw)


def resnet152_d(**kw):
    return _make("bottleneck", (3, 8, 36, 3), deep_stem=True, avg_down=True, **kw)


def resnext152_32x8d(**kw):
    return _make("bottleneck", (3, 8, 36, 3), groups=32, width_per_group=8, **kw)


CONSTRUCTORS = {
    "resnet18": resnet18, "resnet18_d": resnet18_d,
    "resnet34": resnet34, "resnet34_d": resnet34_d,
    "resnet50": resnet50, "resnet50_d": resnet50_d,
    "resnet50_w2x": resnet50_w2x, "resnet50_16s": resnet50_16s,
    "resnet101": resnet101, "resnet101_d": resnet101_d,
    "resnet152": resnet152, "resnet152_d": resnet152_d,
    "resnext101_32x8d": resnext101_32x8d, "resnext152_32x8d": resnext152_32x8d,
}
