"""PNet 2D, key ``pnet`` (port of chap_tpu/models/pnet.py; the reference's
pnet.py:17-122): five blocks of two dilated 3x3 conv-BN-LeakyReLU at rates
1-5, their outputs concatenated and fused by 1x1 convs, with two dropouts
of 0.3 whose uniforms come in as ``drop_u`` (``dropout_shapes``).
chap_tpu has no converter rules for it; the names here are the port's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, Stats,
                                          dropout_from_uniform, set_stats_keys,
                                          split_drop_u)

DROPOUT_P = 0.3


class PNetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dilation: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=dilation,
                            dilation=dilation)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=dilation,
                            dilation=dilation)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None):
        x = F.leaky_relu(self.bn1(self.conv1(x), stats), 0.01)
        return F.leaky_relu(self.bn2(self.conv2(x), stats), 0.01)


class PNet2D(nn.Module):
    """forward(x [B, Cin, H, W]) -> logits [B, C, H, W]."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 num_filters: int = 64, ratios: Sequence[int] = (1, 2, 3, 4, 5)):
        super().__init__()
        nf = num_filters
        self.num_filters = nf
        self.blocks = nn.ModuleList(
            PNetBlock(in_chns if i == 0 else nf, nf, rate)
            for i, rate in enumerate(ratios))
        self.fuse1 = Conv2d(nf * len(ratios), nf * 5, 1)
        self.fuse2 = Conv2d(nf * 5, nf * 2, 1)
        self.fuse3 = Conv2d(nf * 2, nf, 1)
        self.out_conv = Conv2d(nf, num_classes, 1)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> list:
        """[after fuse2 [rows, 2 nf, H, W], after fuse3 [rows, nf, H, W]]."""
        h, w = (int(s) for s in spatial)
        return [(rows, 2 * self.num_filters, h, w), (rows, self.num_filters, h, w)]

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        u1, u2 = split_drop_u(drop_u, 2)
        feats = []
        for block in self.blocks:
            x = block(x, stats)
            feats.append(x)
        h = F.leaky_relu(self.fuse1(torch.cat(feats, dim=1)), 0.01)
        h = F.leaky_relu(self.fuse2(h), 0.01)
        if self.training:
            h = dropout_from_uniform(h, DROPOUT_P, u1)
        h = F.leaky_relu(self.fuse3(h), 0.01)
        if self.training:
            h = dropout_from_uniform(h, DROPOUT_P, u2)
        return self.out_conv(h)
