"""ResUNet 2D, key ``resunet`` (port of chap_tpu/models/resunet2d.py; the
reference's ResNet2d.py:210-270): a narrow ResNet-34 encoder (7x7 stride-1
stem of 16 channels, stages of [3, 4, 6, 3] BasicBlocks, each stride 2)
under the UNet decoder, pyramid [16, 32, 64, 128, 256]. No dropout.

chap_tpu's projection and prediction heads (resunet2d.py:71-86) are Flax
setup modules no forward calls, so they hold no parameters there and are
not built here. Module names follow the reference's ResNet
(``encoder.layer1.0.conv1`` ...); chap_tpu has no converter rules for it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, Stats,
                                          set_stats_keys)
from chap_tpu_torch.models.unet2d import Decoder

RESUNET_CHNS = (16, 32, 64, 128, 256)


class BasicBlock2d(nn.Module):
    """conv3x3(stride)-BN-ReLU-conv3x3-BN plus the skip (a 1x1 strided conv
    and BN where the stride or width changes), then ReLU (chap_tpu
    resunet2d.py:17-39)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None):
        h = F.relu(self.bn1(self.conv1(x), stats))
        h = self.bn2(self.conv2(h), stats)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x), stats)
        return F.relu(h + residual)


class ResNetEncoder2d(nn.Module):
    """resnet34_2d: the stem and four stages -> [c1 .. c5] (chap_tpu
    resunet2d.py:42-64)."""

    def __init__(self, in_chns: int, layers: Sequence[int] = (3, 4, 6, 3),
                 base: int = 16):
        super().__init__()
        self.conv1 = Conv2d(in_chns, base, 7, padding=3, bias=False)
        self.bn1 = BatchNorm2d(base)
        planes = base
        for stage, blocks in enumerate(layers):
            setattr(self, f"layer{stage + 1}", nn.ModuleList(
                [BasicBlock2d(planes, 2 * planes, 2)]
                + [BasicBlock2d(2 * planes, 2 * planes) for _ in range(blocks - 1)]))
            planes *= 2
        self.num_stages = len(layers)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x), stats))
        feats = [h]
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                h = block(h, stats)
            feats.append(h)
        return feats


class ResUNet2d(nn.Module):
    """forward(x [B, Cin, H, W]) -> logits [B, C, H, W]; H and W divisible
    by 16."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4):
        super().__init__()
        self.encoder = ResNetEncoder2d(in_chns)
        self.decoder = Decoder(num_classes, RESUNET_CHNS, True)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> list:
        return []

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        return self.decoder(self.encoder(x, stats), stats)
