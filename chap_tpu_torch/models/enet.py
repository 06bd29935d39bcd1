"""ENet, key ``enet`` (port of chap_tpu/models/enet.py; the reference's
enet.py:5-614): an initial conv + max-pool block, bottleneck stages with
regular, dilated and asymmetric (5x1, 1x5) convolutions and PReLU, two
downsampling bottlenecks whose max-pool indices the two upsampling
bottlenecks unpool with, and a 3x3 stride-2 transposed conv head.

chap_tpu unpools through the VJP of its max pool (enet.py:20-23), which
routes each value to its window's first maximum; ``F.max_pool2d(...,
return_indices=True)`` and ``F.max_unpool2d`` pick the same position.
Every bottleneck ends in a spatial dropout, one keep bit per (sample,
channel) kept where u < 1 - p; its uniforms [B, C, 1, 1] come in as
``drop_u`` in call order (``dropout_shapes``), 27 of them.

The head is Flax's ConvTranspose((3, 3), strides 2, padding "SAME"), whose
dilated input is padded 2 before and 1 after each axis; PyTorch's
transposed conv pads alike on both sides, so the head runs at padding 0
(2 and 2) and drops the last row and column. Flax's PReLU has one slope,
and keeps its input's dtype (models/layers.py). In bf16 the initial
block concatenates the bf16 conv output with the max pool of the input in
the input's dtype, so a float32 input makes the concatenation float32, as
jnp.concatenate promotes (its BatchNorm casts back).
chap_tpu has no converter rules for ENet; the names here are the port's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                          PReLU, Stats, set_stats_keys,
                                          split_drop_u)


def spatial_dropout(h: torch.Tensor, p: float, u: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """chap_tpu's bottleneck dropout: h * keep / (1 - p), keep = u < 1 - p
    for u [B, C, 1, 1] (None: drawn on h's device)."""
    if u is None:
        u = torch.rand(h.shape[:2] + (1, 1), device=h.device)
    return h * (u < 1 - p).to(h.dtype) / (1 - p)


class InitialBlock(nn.Module):
    """3x3 stride-2 conv to out - in channels, concatenated with the 2x2 max
    pool of the input, BN, PReLU (enet.py:5-68)."""

    def __init__(self, in_channels: int, out_channels: int = 16):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels - in_channels, 3, 2,
                           padding=1, bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None):
        out = torch.cat([self.conv(x), F.max_pool2d(x, 2)], dim=1)
        return self.prelu(self.bn(out, stats))


class _Bottleneck(nn.Module):
    """The expansion branch's tail shared by the three bottlenecks: its last
    BN, the spatial dropout, and the PReLU of main + branch."""

    dropout_p: float

    def _finish(self, main, h, stats, u):
        h = self.bn3(h, stats)
        if self.training and self.dropout_p > 0:
            h = spatial_dropout(h, self.dropout_p, u)
        return self.prelu_out(main + h)


class RegularBottleneck(_Bottleneck):
    """1x1 reduce -> (3x3 dilated | 5x1 + 1x5) -> 1x1 expand, residual
    (enet.py:71-207)."""

    def __init__(self, channels: int, internal_ratio: int = 4,
                 dilation: int = 1, asymmetric: bool = False,
                 dropout_p: float = 0.1):
        super().__init__()
        inter = channels // internal_ratio
        self.dropout_p = dropout_p
        self.asymmetric = asymmetric
        self.conv1 = Conv2d(channels, inter, 1, bias=False)
        self.bn1 = BatchNorm2d(inter)
        self.prelu1 = PReLU()
        if asymmetric:
            self.conv2 = Conv2d(inter, inter, (5, 1), padding=(2, 0), bias=False)
            self.conv2b = Conv2d(inter, inter, (1, 5), padding=(0, 2), bias=False)
        else:
            self.conv2 = Conv2d(inter, inter, 3, padding=dilation,
                                dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(inter)
        self.prelu2 = PReLU()
        self.conv3 = Conv2d(inter, channels, 1, bias=False)
        self.bn3 = BatchNorm2d(channels)
        self.prelu_out = PReLU()

    def forward(self, x, stats=None, u=None):
        h = self.prelu1(self.bn1(self.conv1(x), stats))
        h = self.conv2(h)
        if self.asymmetric:
            h = self.conv2b(h)
        h = self.prelu2(self.bn2(h, stats))
        return self._finish(x, self.conv3(h), stats, u)


class DownsamplingBottleneck(_Bottleneck):
    """Main branch: 2x2 max pool (its indices kept) with the channels
    zero-padded; branch: 2x2 stride-2 conv, 3x3, 1x1 (enet.py:209-320).
    Returns (out, pool indices)."""

    def __init__(self, in_channels: int, out_channels: int,
                 internal_ratio: int = 4, dropout_p: float = 0.1):
        super().__init__()
        inter = out_channels // internal_ratio
        self.dropout_p = dropout_p
        self.pad = out_channels - in_channels
        self.conv1 = Conv2d(in_channels, inter, 2, 2, bias=False)
        self.bn1 = BatchNorm2d(inter)
        self.prelu1 = PReLU()
        self.conv2 = Conv2d(inter, inter, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(inter)
        self.prelu2 = PReLU()
        self.conv3 = Conv2d(inter, out_channels, 1, bias=False)
        self.bn3 = BatchNorm2d(out_channels)
        self.prelu_out = PReLU()

    def forward(self, x, stats=None, u=None) -> Tuple[torch.Tensor, torch.Tensor]:
        main, indices = F.max_pool2d(x, 2, return_indices=True)
        main = F.pad(main, (0, 0, 0, 0, 0, self.pad))
        h = self.prelu1(self.bn1(self.conv1(x), stats))
        h = self.prelu2(self.bn2(self.conv2(h), stats))
        return self._finish(main, self.conv3(h), stats, u), indices


class UpsamplingBottleneck(_Bottleneck):
    """Main branch: 1x1 conv, BN, max-unpool with the matching
    downsampling bottleneck's indices; branch: 1x1, 2x2 stride-2
    transposed conv, 1x1 (enet.py:322-451)."""

    def __init__(self, in_channels: int, out_channels: int,
                 internal_ratio: int = 4, dropout_p: float = 0.1):
        super().__init__()
        inter = out_channels // internal_ratio
        self.dropout_p = dropout_p
        self.main_conv = Conv2d(in_channels, out_channels, 1, bias=False)
        self.main_bn = BatchNorm2d(out_channels)
        self.conv1 = Conv2d(in_channels, inter, 1, bias=False)
        self.bn1 = BatchNorm2d(inter)
        self.prelu1 = PReLU()
        self.deconv = ConvTranspose2d(inter, inter, 2, 2, bias=False)
        self.bn2 = BatchNorm2d(inter)
        self.prelu2 = PReLU()
        self.conv3 = Conv2d(inter, out_channels, 1, bias=False)
        self.bn3 = BatchNorm2d(out_channels)
        self.prelu_out = PReLU()

    def forward(self, x, indices, stats=None, u=None):
        main = self.main_bn(self.main_conv(x), stats)
        main = F.max_unpool2d(main, indices, 2,
                              output_size=(2 * x.shape[2], 2 * x.shape[3]))
        h = self.prelu1(self.bn1(self.conv1(x), stats))
        h = self.prelu2(self.bn2(self.deconv(h), stats))
        return self._finish(main, self.conv3(h), stats, u)


def _stage23(stage: int) -> List[Tuple[str, nn.Module]]:
    """Stages 2 and 3: eight 128-channel bottlenecks each."""
    return [(f"reg{stage}_1", RegularBottleneck(128)),
            (f"dil{stage}_2", RegularBottleneck(128, dilation=2)),
            (f"asym{stage}_3", RegularBottleneck(128, asymmetric=True)),
            (f"dil{stage}_4", RegularBottleneck(128, dilation=4)),
            (f"reg{stage}_5", RegularBottleneck(128)),
            (f"dil{stage}_6", RegularBottleneck(128, dilation=8)),
            (f"asym{stage}_7", RegularBottleneck(128, asymmetric=True)),
            (f"dil{stage}_8", RegularBottleneck(128, dilation=16))]


class ENet(nn.Module):
    """forward(x [B, Cin, H, W]) -> logits [B, C, H, W]; H and W divisible
    by 8. The bottlenecks carry chap_tpu's names (enet.py:159-181)."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4):
        super().__init__()
        self.initial = InitialBlock(in_chns, 16)
        self.down1_0 = DownsamplingBottleneck(16, 64, dropout_p=0.01)
        self.stage1 = nn.ModuleDict(
            (f"reg1_{i + 1}", RegularBottleneck(64, dropout_p=0.01))
            for i in range(4))
        self.down2_0 = DownsamplingBottleneck(64, 128, dropout_p=0.1)
        self.stage23 = nn.ModuleDict(_stage23(2) + _stage23(3))
        self.up4_0 = UpsamplingBottleneck(128, 64)
        self.reg4_1 = RegularBottleneck(64)
        self.reg4_2 = RegularBottleneck(64)
        self.up5_0 = UpsamplingBottleneck(64, 16)
        self.reg5_1 = RegularBottleneck(16)
        self.fullconv = ConvTranspose2d(16, num_classes, 3, 2, padding=0)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> list:
        """One [rows, C, 1, 1] a bottleneck, in call order."""
        chans = [64] * 5 + [128] * 17 + [64] * 3 + [16] * 2
        return [(rows, c, 1, 1) for c in chans]

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        u = iter(split_drop_u(drop_u, 27))
        h = self.initial(x, stats)
        h, idx1 = self.down1_0(h, stats, next(u))
        for block in self.stage1.values():
            h = block(h, stats, next(u))
        h, idx2 = self.down2_0(h, stats, next(u))
        for block in self.stage23.values():
            h = block(h, stats, next(u))
        h = self.up4_0(h, idx2, stats, next(u))
        h = self.reg4_1(h, stats, next(u))
        h = self.reg4_2(h, stats, next(u))
        h = self.up5_0(h, idx1, stats, next(u))
        h = self.reg5_1(h, stats, next(u))
        n, m = 2 * h.shape[2], 2 * h.shape[3]
        return self.fullconv(h)[:, :, :n, :m]
