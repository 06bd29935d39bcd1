"""ResVNet (port of chap_tpu/models/resvnet.py; reference ResVNet.py:92-196
over resnet3d.py:99-221): a narrow 3D ResNet-34 encoder with affine-free
instance norm (epsilon 1e-5, chap_tpu's voxresnet._instance_norm) and the
VNet deconv decoder, whose norm is ``normalization`` (default instancenorm:
Flax's affine-free GroupNorm, epsilon 1e-6). forward returns
``[logits, x6]``, the segmentation and the first decoder stage's features.

With ``has_dropout``, a train-mode forward (unless ``turnoff_drop``) drops
the last decoder features with probability 0.5 from ``drop_u = [u]``
(``dropout_shapes``), kept where u < 0.5 as chap_tpu's bernoulli(0.5).

NCDHW, the encoder named as a torchvision-style ResNet (``resencoder.conv1``,
``resencoder.layer1.0.conv1`` ... ``.downsample.0``), the decoder as VNet's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (Conv3d, dropout_from_uniform,
                                          instance_norm, set_stats_keys,
                                          split_drop_u)
from chap_tpu_torch.models.vnet3d import ConvBlock3d, UpBlock3d

DROPOUT_P = 0.5
STAGE_BLOCKS = (3, 4, 6, 3)


class BasicBlock3d(nn.Module):
    """conv3 (stride) - IN - ReLU - conv3 - IN, plus the identity or a
    strided 1x1x1 conv + IN, then ReLU (chap_tpu resvnet.py:18-37)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3d(in_planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.conv2 = Conv3d(planes, planes, 3, padding=1, bias=False)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv3d(in_planes, planes, 1, stride=stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = instance_norm(self.conv2(F.relu(instance_norm(self.conv1(x)))))
        residual = x if self.downsample is None else instance_norm(self.downsample(x))
        return F.relu(h + residual)


class ResNetEncoder3d(nn.Module):
    """7^3 stride-1 stem (``base`` channels, IN, ReLU) and four stages of
    (3, 4, 6, 3) BasicBlocks, each opening with stride 2 and doubling the
    width: the pyramid [base, 2, 4, 8, 16 x base] at 1, 1/2 ... 1/16."""

    def __init__(self, in_chns: int = 1, base: int = 16):
        super().__init__()
        self.conv1 = Conv3d(in_chns, base, 7, padding=3, bias=False)
        planes = base
        for stage, blocks in enumerate(STAGE_BLOCKS):
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock3d(planes if b == 0 else 2 * planes,
                                          2 * planes, 2 if b == 0 else 1))
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(instance_norm(self.conv1(x)))
        feats = [h]
        for stage in range(len(STAGE_BLOCKS)):
            h = getattr(self, f"layer{stage + 1}")(h)
            feats.append(h)
        return feats


class ResVNet(nn.Module):
    """forward(x [B, Cin, X, Y, Z]) -> [logits [B, C, X, Y, Z], x6 [B, 8 nf,
    X/8, Y/8, Z/8]]; X, Y and Z divisible by 16."""

    num_decoders = 1

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 n_filters: int = 16, normalization: str = "instancenorm",
                 has_dropout: bool = False):
        super().__init__()
        nf = n_filters
        self.n_filters, self.has_dropout = nf, has_dropout
        self.resencoder = ResNetEncoder3d(in_chns, nf)
        self.block_five_up = UpBlock3d(16 * nf, 8 * nf, normalization, 0)
        self.block_six = ConvBlock3d(3, 8 * nf, 8 * nf, normalization)
        self.block_six_up = UpBlock3d(8 * nf, 4 * nf, normalization, 0)
        self.block_seven = ConvBlock3d(3, 4 * nf, 4 * nf, normalization)
        self.block_seven_up = UpBlock3d(4 * nf, 2 * nf, normalization, 0)
        self.block_eight = ConvBlock3d(2, 2 * nf, 2 * nf, normalization)
        self.block_eight_up = UpBlock3d(2 * nf, nf, normalization, 0)
        self.branch_conv = ConvBlock3d(1, nf, nf, normalization)
        self.branch_out = Conv3d(nf, num_classes, 1)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]
                       ) -> List[Tuple[int, ...]]:
        if not self.has_dropout:
            return []
        return [(rows, self.n_filters) + tuple(int(s) for s in spatial)]

    def forward(self, x: torch.Tensor, *, drop_u=None, turnoff_drop: bool = False,
                stats=None) -> List[torch.Tensor]:
        x1, x2, x3, x4, x5 = self.resencoder(x)
        x6 = self.block_six(self.block_five_up(x5, stats) + x4, stats)
        h = self.block_seven(self.block_six_up(x6, stats) + x3, stats)
        h = self.block_eight(self.block_seven_up(h, stats) + x2, stats)
        h = self.branch_conv(self.block_eight_up(h, stats) + x1, stats)
        (u,) = split_drop_u(drop_u, 1) if self.has_dropout else (None,)
        if self.has_dropout and self.training and not turnoff_drop:
            h = dropout_from_uniform(h, DROPOUT_P, u)
        return [self.branch_out(h), x6]
