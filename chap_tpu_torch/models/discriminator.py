"""Adversarial discriminators (port of chap_tpu/models/discriminator.py;
the reference's discriminator.py:6-104). NCDHW / NCHW, chap_tpu's names
(``conv0`` ... ``classifier``).

FC3DDiscriminator: (probability map, image) -> [B, 2] logits, two strided
4^3 conv streams summed, three more, a global average pool and a linear
head. FCDiscriminator: a fully convolutional 2D map discriminator, four
strided 4x4 convs and a one-channel strided head. LeakyReLU 0.2.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import Conv2d, Conv3d, Linear


class FC3DDiscriminator(nn.Module):
    """forward(seg_map [B, num_classes, X, Y, Z], image [B, n_channel, X,
    Y, Z]) -> [B, 2] (chap_tpu discriminator.py:13-31)."""

    def __init__(self, num_classes: int, ndf: int = 64, n_channel: int = 1):
        super().__init__()
        self.conv0 = Conv3d(num_classes, ndf, 4, 2, padding=1)
        self.conv1 = Conv3d(n_channel, ndf, 4, 2, padding=1)
        self.conv2 = Conv3d(ndf, ndf * 2, 4, 2, padding=1)
        self.conv3 = Conv3d(ndf * 2, ndf * 4, 4, 2, padding=1)
        self.conv4 = Conv3d(ndf * 4, ndf * 8, 4, 2, padding=1)
        self.classifier = Linear(ndf * 8, 2)

    def forward(self, seg_map: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(seg_map) + self.conv1(image), 0.2)
        for conv in (self.conv2, self.conv3, self.conv4):
            h = F.leaky_relu(conv(h), 0.2)
        return self.classifier(h.mean(dim=(2, 3, 4)))


class FCDiscriminator(nn.Module):
    """forward(x [B, num_classes, H, W]) -> [B, 1, H / 32, W / 32]
    (chap_tpu discriminator.py:34-47)."""

    def __init__(self, num_classes: int, ndf: int = 64):
        super().__init__()
        chans = (num_classes, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            setattr(self, f"conv{i + 1}", Conv2d(chans[i], chans[i + 1], 4, 2,
                                                 padding=1))
        self.classifier = Conv2d(ndf * 8, 1, 4, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"conv{i + 1}")(x), 0.2)
        return self.classifier(x)
