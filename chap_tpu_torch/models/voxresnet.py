"""VoxResNet (port of chap_tpu/models/voxresnet.py; reference
VoxResNet.py:26-116): pre-activation residual blocks with affine-free
instance norm (epsilon 1e-5) and bias-free convs at one width, two max-pool
downsamples after the stem, and a skip-concat up path with align_corners
trilinear 2x upsampling. No norm statistics and no dropout.

NCDHW, with the reference torch names (``res1.block.2``, ``up1_conv
.conv_block.5`` ...)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (Conv3d, InstanceNorm,
                                          upsample2x_trilinear)


def _preact_double_conv(in_channels: int, out_channels: int) -> nn.Sequential:
    """IN-ReLU-conv-IN-ReLU-conv, the convs at Sequential indices 2 and 5."""
    return nn.Sequential(
        InstanceNorm(), nn.ReLU(),
        Conv3d(in_channels, out_channels, 3, padding=1, bias=False),
        InstanceNorm(), nn.ReLU(),
        Conv3d(out_channels, out_channels, 3, padding=1, bias=False))


class VoxRex(nn.Module):
    """The pre-activation double conv plus the identity (VoxResNet.py:26-41)."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = _preact_double_conv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


class VoxConvBlock(nn.Module):
    """The pre-activation double conv (VoxResNet.py:44-61)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_block = _preact_double_conv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(x)


class VoxResNet(nn.Module):
    """forward(x [B, Cin, X, Y, Z]) -> logits [B, C, X, Y, Z]; X, Y and Z
    divisible by 8."""

    num_decoders = 1

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_chns: int = 64):
        super().__init__()
        nf = feature_chns
        self.conv1 = Conv3d(in_chns, nf, 3, padding=1)
        for i in range(1, 7):
            setattr(self, f"res{i}", VoxRex(nf))
        self.up1_conv = VoxConvBlock(2 * nf, nf)
        self.up2_conv = VoxConvBlock(2 * nf, nf)
        self.out = Conv3d(nf, num_classes, 1)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]
                       ) -> List[Tuple[int, ...]]:
        return []

    def forward(self, x: torch.Tensor, *, drop_u=None, stats=None
                ) -> torch.Tensor:
        x = F.max_pool3d(self.conv1(x), 2)
        x2_pool = F.max_pool3d(self.res2(self.res1(x)), 2)
        x4 = F.max_pool3d(self.res4(self.res3(x2_pool)), 2)
        x6 = self.res6(self.res5(x4))
        up1 = self.up1_conv(torch.cat([x2_pool, upsample2x_trilinear(x6)], dim=1))
        up2 = self.up2_conv(torch.cat([x, upsample2x_trilinear(up1)], dim=1))
        return self.out(upsample2x_trilinear(up2))
