"""Classic 3D U-Net, the BraTS model (port of chap_tpu/models/unet3d.py;
reference unet_3D.py:20-100 with UnetConv3 and UnetUp3_CT from
networks/utils.py).

Filters (64, 128, 256, 512, 1024) / feature_scale (4 gives 16 ... 256).
``is_batchnorm`` selects an affine-free instance norm (biased variance,
epsilon 1e-5), as the reference's UnetConv3 does despite the flag's name;
there are no running stats. Upsampling is half-pixel trilinear at 2x
(jax.image.resize 'linear'). Two dropouts of 0.3, after ``center`` and after
``up_concat1``, take their uniforms from ``drop_u = [u_center, u_up1]``
(``dropout_shapes``), kept where u < 0.7 as Flax's nn.Dropout keeps
bernoulli(0.7).

NCDHW ``[B, C, X, Y, Z]``, with the reference torch module names that
chap_tpu's converter rules spell out (convert/torch_import.py:182-197).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (Conv3d, InstanceNorm,
                                          dropout_from_uniform, resize_linear,
                                          split_drop_u)

DROPOUT_P = 0.3
UNET_FILTERS = (64, 128, 256, 512, 1024)
IN_EPS = 1e-5


def unet_filters(feature_scale: int) -> List[int]:
    return [f // feature_scale for f in UNET_FILTERS]


def _conv_norm_relu(in_channels: int, out_channels: int,
                    is_batchnorm: bool) -> nn.Sequential:
    ops: List[nn.Module] = [Conv3d(in_channels, out_channels, 3, padding=1)]
    if is_batchnorm:
        ops.append(InstanceNorm(IN_EPS))
    ops.append(nn.ReLU())
    return nn.Sequential(*ops)


class UnetConv3(nn.Module):
    """2 x (conv3x3x3 -> [instance norm] -> ReLU) (chap_tpu unet3d.py:14-35)."""

    def __init__(self, in_channels: int, out_channels: int,
                 is_batchnorm: bool = True):
        super().__init__()
        self.conv1 = _conv_norm_relu(in_channels, out_channels, is_batchnorm)
        self.conv2 = _conv_norm_relu(out_channels, out_channels, is_batchnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UnetUp3CT(nn.Module):
    """Half-pixel trilinear 2x upsample of ``x``, concat after ``skip``,
    UnetConv3 (chap_tpu unet3d.py:38-50)."""

    def __init__(self, in_channels: int, out_channels: int,
                 is_batchnorm: bool = True):
        super().__init__()
        self.conv = UnetConv3(in_channels + out_channels, out_channels,
                              is_batchnorm)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        up = resize_linear(x, [2 * s for s in x.shape[2:]])
        return self.conv(torch.cat([skip, up], dim=1))


class UNet3DEncoder(nn.Module):
    """conv1 .. conv4 with 2x max pools between, then center: the shared
    front of UNet3D, UNet3DDvSemi and AttentionUNet3D."""

    def __init__(self, in_chns: int, filters: Sequence[int], is_batchnorm: bool):
        super().__init__()
        self.conv1 = UnetConv3(in_chns, filters[0], is_batchnorm)
        self.conv2 = UnetConv3(filters[0], filters[1], is_batchnorm)
        self.conv3 = UnetConv3(filters[1], filters[2], is_batchnorm)
        self.conv4 = UnetConv3(filters[2], filters[3], is_batchnorm)
        self.center = UnetConv3(filters[3], filters[4], is_batchnorm)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        conv1 = self.conv1(x)
        conv2 = self.conv2(F.max_pool3d(conv1, 2))
        conv3 = self.conv3(F.max_pool3d(conv2, 2))
        conv4 = self.conv4(F.max_pool3d(conv3, 2))
        return [conv1, conv2, conv3, conv4, self.center(F.max_pool3d(conv4, 2))]


def _dropout(module: nn.Module, x: torch.Tensor,
             u: Optional[torch.Tensor]) -> torch.Tensor:
    return dropout_from_uniform(x, DROPOUT_P, u) if module.training else x


class UNet3D(UNet3DEncoder):
    """unet_3D: forward(x [B, Cin, X, Y, Z]) -> logits [B, C, X, Y, Z]; X, Y
    and Z divisible by 16."""

    num_decoders = 1

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_scale: int = 4, is_batchnorm: bool = True):
        filters = unet_filters(feature_scale)
        super().__init__(in_chns, filters, is_batchnorm)
        self.filters = filters
        self.up_concat4 = UnetUp3CT(filters[4], filters[3], is_batchnorm)
        self.up_concat3 = UnetUp3CT(filters[3], filters[2], is_batchnorm)
        self.up_concat2 = UnetUp3CT(filters[2], filters[1], is_batchnorm)
        self.up_concat1 = UnetUp3CT(filters[1], filters[0], is_batchnorm)
        self.final = Conv3d(filters[0], num_classes, 1)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]
                       ) -> List[Tuple[int, ...]]:
        """[center [rows, f4, X/16, Y/16, Z/16], up1 [rows, f0, X, Y, Z]]."""
        x, y, z = (int(s) for s in spatial)
        return [(rows, self.filters[4], x >> 4, y >> 4, z >> 4),
                (rows, self.filters[0], x, y, z)]

    def decode(self, feats: Sequence[torch.Tensor], drop_u
               ) -> List[torch.Tensor]:
        """[up4, up3, up2, up1] with the two dropouts applied."""
        conv1, conv2, conv3, conv4, center = feats
        u_center, u_up1 = split_drop_u(drop_u, 2)
        center = _dropout(self, center, u_center)
        up4 = self.up_concat4(conv4, center)
        up3 = self.up_concat3(conv3, up4)
        up2 = self.up_concat2(conv2, up3)
        up1 = _dropout(self, self.up_concat1(conv1, up2), u_up1)
        return [up4, up3, up2, up1]

    def forward(self, x: torch.Tensor, *, drop_u=None, stats=None
                ) -> torch.Tensor:
        return self.final(self.decode(self.encode(x), drop_u)[3])

