"""Efficient-UNet, key ``efficient_unet`` (port of
chap_tpu/models/efficientunet.py; the reference's efficientunet.py:27-215
over efficient_encoder.py:70-109): an EfficientNet-B0 encoder (stem of 32
channels, MBConv stages with squeeze-excite of ratio 0.25, swish) giving
the pyramid [32, 24, 40, 112, 320] at strides 2-32, under a UNet decoder of
nearest 2x up-sampling, skip concat and two conv-BN-ReLU a block.

The encoder keeps the EfficientNet lineage's semantics that chap_tpu keeps
(efficientunet.py:42-54): TF-SAME padding, which pads a stride-2 conv
asymmetrically (more at the end, ``tf_same_pad``), where PyTorch's
``padding=`` pads both sides alike, and BatchNorm epsilon 1e-3. Its
modules carry lukemelas efficientnet_pytorch's names (``_conv_stem``,
``_blocks.{k}._depthwise_conv`` ...), which chap_tpu's
``efficientnet_b0_rules`` spell out (convert/torch_import.py:269-299).
No dropout. ``encoder_name`` takes b0 only, the factory's encoder.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, Stats,
                                          set_stats_keys)

EFFNET_BN_EPS = 1e-3
# (out_channels, blocks, stride, kernel, expand) per B0 stage
B0_STAGES = ((16, 1, 1, 3, 1), (24, 2, 2, 3, 6), (40, 2, 2, 5, 6),
             (80, 3, 2, 3, 6), (112, 3, 1, 5, 6), (192, 4, 2, 5, 6),
             (320, 1, 1, 3, 6))
PYRAMID_STAGES = (1, 2, 4, 6)      # stages that end at a resolution drop


def tf_same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Flax / TF "SAME" padding of both spatial axes: (out - 1) * stride +
    kernel - n in all, half of it (rounded down) before."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv2d(Conv2d):
    """A bias-free conv of TF-SAME padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride,
                         groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(tf_same_pad(x, self.kernel_size[0], self.stride[0]))


class MBConv(nn.Module):
    """[1x1 expand-BN-swish] -> depthwise kxk (stride)-BN-swish ->
    squeeze-excite -> 1x1 project-BN, residual where the shape stays
    (chap_tpu efficientunet.py:31-67)."""

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: int,
                 stride: int, kernel: int, se_ratio: float = 0.25):
        super().__init__()
        mid = in_channels * expand_ratio
        self.residual = stride == 1 and in_channels == out_channels
        if expand_ratio != 1:
            self._expand_conv = Conv2d(in_channels, mid, 1, bias=False)
            self._bn0 = BatchNorm2d(mid, EFFNET_BN_EPS)
        self._depthwise_conv = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self._bn1 = BatchNorm2d(mid, EFFNET_BN_EPS)
        reduced = max(1, int(in_channels * se_ratio))
        self._se_reduce = Conv2d(mid, reduced, 1)
        self._se_expand = Conv2d(reduced, mid, 1)
        self._project_conv = Conv2d(mid, out_channels, 1, bias=False)
        self._bn2 = BatchNorm2d(out_channels, EFFNET_BN_EPS)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None):
        h = x
        if hasattr(self, "_expand_conv"):
            h = F.silu(self._bn0(self._expand_conv(h), stats))
        h = F.silu(self._bn1(self._depthwise_conv(h), stats))
        s = F.silu(self._se_reduce(h.mean(dim=(2, 3), keepdim=True)))
        h = h * torch.sigmoid(self._se_expand(s))
        h = self._bn2(self._project_conv(h), stats)
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    """EfficientNet-B0 -> [stem, after stages 1, 2, 4, 6]."""

    def __init__(self, in_chns: int = 1):
        super().__init__()
        self._conv_stem = SameConv2d(in_chns, 32, 3, 2)
        self._bn0 = BatchNorm2d(32, EFFNET_BN_EPS)
        blocks, self.stage_ends = [], []
        ch = 32
        for out, n, stride, kernel, expand in B0_STAGES:
            for b in range(n):
                blocks.append(MBConv(ch, out, expand, stride if b == 0 else 1,
                                     kernel))
                ch = out
            self.stage_ends.append(len(blocks))
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> List[torch.Tensor]:
        h = F.silu(self._bn0(self._conv_stem(x), stats))
        feats = [h]
        ends = {self.stage_ends[s] for s in PYRAMID_STAGES}
        for k, block in enumerate(self._blocks):
            h = block(h, stats)
            if k + 1 in ends:
                feats.append(h)
        return feats


class DecoderBlock(nn.Module):
    """Nearest 2x up-sampling, skip concat, 2 x (conv3x3-BN-ReLU)
    (efficientunet.py:27-62)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(in_channels + skip_channels, out_channels, 3, padding=1,
                   bias=False), BatchNorm2d(out_channels))
        self.conv2 = nn.Sequential(
            Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor],
                stats: Optional[Stats] = None) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        for conv in (self.conv1, self.conv2):
            x = F.relu(conv[1](conv[0](x), stats))
        return x


class EffiUNet(nn.Module):
    """forward(x [B, Cin, H, W]) -> logits [B, C, H, W]; H and W divisible
    by 32."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 encoder_name: str = "efficientnet-b0"):
        super().__init__()
        if encoder_name != "efficientnet-b0":
            raise ValueError(f"encoder {encoder_name!r}: the port builds "
                             f"efficientnet-b0, the factory's encoder")
        self.encoder = EfficientNetEncoder(in_chns)
        pyramid = [32] + [B0_STAGES[s][0] for s in PYRAMID_STAGES]
        skips = pyramid[:-1][::-1] + [0]
        ins = [pyramid[-1]] + list(decoder_channels[:-1])
        self.decoder = nn.Module()
        self.decoder.blocks = nn.ModuleList(
            DecoderBlock(i, s, o) for i, s, o in zip(ins, skips, decoder_channels))
        self.segmentation_head = Conv2d(decoder_channels[-1], num_classes, 3,
                                        padding=1)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> list:
        return []

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        feats = self.encoder(x, stats)
        skips = feats[:-1][::-1] + [None]
        h = feats[-1]
        for block, skip in zip(self.decoder.blocks, skips):
            h = block(h, skip, stats)
        return self.segmentation_head(h)
