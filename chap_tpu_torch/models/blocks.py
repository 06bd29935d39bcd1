"""Shared auxiliary blocks (port of chap_tpu/models/blocks.py; the
reference's networks/utils.py SqEx :280-302, attention.py SCSEModule
:51-64 / Conv2dReLU :9-48, VoxResNet.py SEBlock :9-23). No factory key
builds them; they are the library's parts.

NC... layouts. Names: SqEx's ``linear1`` / ``linear2``, SCSEModule's
``cSE`` / ``sSE`` Sequentials and Conv2dReLU's ``block`` Sequential as in
the reference lineage (segmentation_models_pytorch for the last two);
SEBlock3d's ``conv1`` / ``conv2`` for chap_tpu's Conv_0 / Conv_1.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, Conv3d, Linear,
                                          Stats, set_stats_keys)


class SqEx(nn.Module):
    """Squeeze-and-excitation over any spatial rank: the spatial mean, a
    ReLU bottleneck of ``n_features // reduction`` and a sigmoid gate
    (chap_tpu blocks.py:15-26)."""

    def __init__(self, n_features: int, reduction: int = 16):
        super().__init__()
        self.linear1 = Linear(n_features, n_features // reduction)
        self.linear2 = Linear(n_features // reduction, n_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=tuple(range(2, x.dim())))
        s = torch.sigmoid(self.linear2(F.relu(self.linear1(s))))
        return x * s.reshape(s.shape + (1,) * (x.dim() - 2))


class SEBlock3d(nn.Module):
    """Residual SE with a 1x1x1 conv squeeze, ReLU after both convs:
    s * x + x (chap_tpu blocks.py:29-40)."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.conv1 = Conv3d(channels, channels // reduction, 1)
        self.conv2 = Conv3d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = F.relu(self.conv2(F.relu(self.conv1(s))))
        return s * x + x


class SCSEModule(nn.Module):
    """Concurrent spatial and channel SE: x * cSE(x) + x * sSE(x)
    (chap_tpu blocks.py:43-55)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.cSE = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 Conv2d(channels, channels // reduction, 1),
                                 nn.ReLU(), Conv2d(channels // reduction, channels, 1),
                                 nn.Sigmoid())
        self.sSE = nn.Sequential(Conv2d(channels, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.cSE(x) + x * self.sSE(x)


class Conv2dReLU(nn.Module):
    """Bias-free conv (padding kernel // 2) - BatchNorm - ReLU (chap_tpu
    blocks.py:58-72); ``stats`` takes the train pass's batch statistics
    (models/layers.py)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.block = nn.Sequential(
            Conv2d(in_channels, out_channels, kernel, stride, padding=kernel // 2,
                   bias=False),
            BatchNorm2d(out_channels))
        set_stats_keys(self)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        return F.relu(self.block[1](self.block[0](x), stats))
