"""Efficient-UNet, key ``efficient_unet`` (port of
chap_tpu/models/efficientunet.py; the reference's efficientunet.py:27-215
over efficient_encoder.py:70-215): an EfficientNet encoder (MBConv stages
with squeeze-excite of ratio 0.25, swish) giving a 5-level pyramid at
strides 2-32, under a UNet decoder of nearest 2x up-sampling, skip concat
and two conv-BN-ReLU a block.

Any of b0-b7 by compound scaling (``get_encoder``, ``EffiUNet(encoder_name=
...)``): the stage widths by ``round_filters`` and the repeats by
``round_repeats`` of chap_tpu's (width, depth) table (efficientunet.py:
83-136); b0's pyramid is [32, 24, 40, 112, 320], b2's [32, 24, 48, 120,
352], b3's [40, 32, 48, 136, 384]. The factory's ``efficient_unet`` is b0.

The encoder keeps the EfficientNet lineage's semantics that chap_tpu keeps
(efficientunet.py:42-54): TF-SAME padding, which pads a stride-2 conv
asymmetrically (more at the end, ``tf_same_pad``), where PyTorch's
``padding=`` pads both sides alike, and BatchNorm epsilon 1e-3. Its
modules carry lukemelas efficientnet_pytorch's names (``_conv_stem``,
``_blocks.{k}._depthwise_conv`` ...), which chap_tpu's
``efficientnet_b0_rules`` spell out (convert/torch_import.py:269-299).
No dropout.
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
# compound-scaling (width, depth) coefficients of b0-b7
# (efficient_encoder.py:124-201)
SCALING = {
    "efficientnet-b0": (1.0, 1.0), "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2), "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8), "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6), "efficientnet-b7": (2.0, 3.1),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """EfficientNet's channel rounding (efficientnet_pytorch.utils)."""
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def stage_repeats(depth: float) -> List[int]:
    """The MBConv blocks of each of the 7 stages at ``depth``."""
    return [round_repeats(n, depth) for _, n, _, _, _ in B0_STAGES]


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
    """EfficientNet at (width, depth) -> [stem, after stages 1, 2, 4, 6];
    ``out_channels`` lists the five levels' channels."""

    def __init__(self, in_chns: int = 1, width: float = 1.0, depth: float = 1.0):
        super().__init__()
        stem = round_filters(32, width)
        self._conv_stem = SameConv2d(in_chns, stem, 3, 2)
        self._bn0 = BatchNorm2d(stem, EFFNET_BN_EPS)
        blocks, self.stage_ends = [], []
        ch = stem
        for (out, _, stride, kernel, expand), n in zip(B0_STAGES, stage_repeats(depth)):
            out = round_filters(out, width)
            for b in range(n):
                blocks.append(MBConv(ch, out, expand, stride if b == 0 else 1,
                                     kernel))
                ch = out
            self.stage_ends.append(len(blocks))
        self._blocks = nn.ModuleList(blocks)
        self.out_channels = [stem] + [round_filters(B0_STAGES[s][0], width)
                                      for s in PYRAMID_STAGES]
        set_stats_keys(self)

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


def get_encoder(name: str = "efficientnet-b0", in_chns: int = 3
                ) -> EfficientNetEncoder:
    """The encoder by name (efficient_encoder.py:203-216; chap_tpu's
    get_encoder). ImageNet weights load through
    convert/from_pth.py ``convert_efficientnet_pretrained``."""
    if name not in SCALING:
        raise KeyError(f"unknown encoder {name!r}; have {sorted(SCALING)}")
    return EfficientNetEncoder(in_chns, *SCALING[name])


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
        self.encoder = get_encoder(encoder_name, in_chns)
        pyramid = self.encoder.out_channels
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
