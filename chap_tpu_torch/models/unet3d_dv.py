"""Deep-supervised semi-supervised 3D U-Net (port of
chap_tpu/models/unet3d_dv.py; reference unet_3D_dv_semi.py:13-106): the
UNet3D backbone with its two dropouts, returning four deep-supervision
outputs, all at the input's resolution."""
from __future__ import annotations

from typing import Tuple

import torch

from chap_tpu_torch.models.attention3d import UnetDsv3
from chap_tpu_torch.models.layers import Conv3d
from chap_tpu_torch.models.unet3d import UNet3D


class UNet3DDvSemi(UNet3D):
    """unet_3D_dv_semi: forward(x) -> (dsv1, dsv2, dsv3, dsv4), each
    [B, C, X, Y, Z]; dsv1 from up_concat1 (after its dropout), dsv2-4 from
    up_concat2-4 resized 2x, 4x and 8x. ``drop_u`` as UNet3D's."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_scale: int = 4, is_batchnorm: bool = True):
        super().__init__(in_chns, num_classes, feature_scale, is_batchnorm)
        f = self.filters
        del self.final
        self.dsv4 = UnetDsv3(f[3], num_classes, 8)
        self.dsv3 = UnetDsv3(f[2], num_classes, 4)
        self.dsv2 = UnetDsv3(f[1], num_classes, 2)
        self.dsv1 = Conv3d(f[0], num_classes, 1)

    def forward(self, x: torch.Tensor, *, drop_u=None, stats=None
                ) -> Tuple[torch.Tensor, ...]:
        up4, up3, up2, up1 = self.decode(self.encode(x), drop_u)
        return self.dsv1(up1), self.dsv2(up2), self.dsv3(up3), self.dsv4(up4)
