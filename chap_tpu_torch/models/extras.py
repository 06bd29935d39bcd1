"""Long-tail model variants of the reference's ResNet2d.py (port of
chap_tpu/models/extras.py). No factory key builds them.

UNet2dBCP (:382-398) is the plain UNet; UNetTsne (:401-454) returns the
logits and the last decoder feature map, with two contrastive MLP heads
over channel-last feature vectors; NetD (:358-379) is the flattened tanh
MLP discriminator (the gradient reversal is models/grl.py); TinyUNet3D
(:457-532) is a 3-scale 3D UNet that adds softmax maps of two coarser
scales in train mode.

In bf16 (models/layers.py) UNetTsne's two heads stay float32: chap_tpu
builds them as nn.Dense(32) without a dtype (extras.py:31-32), which
computes in float32 over its float32 kernel, so they are
``Linear(promote=True)`` here and a bf16 feature comes out float32.
TinyUNet3D's softmax maps are bf16, rounded step by step as JAX's.

Names: the UNet's (``encoder`` / ``decoder1``, under ``backbone`` in
UNetTsne), the heads' Sequential indices, NetD's ``fc1``-``fc3``
(chap_tpu's Dense_0-2), and chap_tpu's TinyUNet3D names (``enc1_conv``
... ``ms2``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm3d, Conv3d, Linear, Stats,
                                          set_stats_keys, softmax,
                                          upsample2x_trilinear)
from chap_tpu_torch.models.unet2d import DEFAULT_CHNS, UNet


class UNet2dBCP(UNet):
    """UNet_2dBCP: the plain UNet's topology and names."""


def _mlp_head(in_features: int) -> nn.Sequential:
    """nn.Dense(32), ReLU, nn.Dense(32), without a dtype: float32."""
    return nn.Sequential(Linear(in_features, 32, promote=True), nn.ReLU(),
                         Linear(32, 32, promote=True))


class UNetTsne(nn.Module):
    """UNet_tsne: forward -> (logits, the last decoder feature map);
    ``forward_projection_head`` / ``forward_prediction_head`` map [..., C]
    feature vectors (channels last, as chap_tpu's Dense) to 32."""

    def __init__(self, in_chns: int, num_classes: int,
                 feature_chns: Sequence[int] = DEFAULT_CHNS):
        super().__init__()
        self.backbone = UNet(in_chns, num_classes, feature_chns)
        self.projection_head = _mlp_head(feature_chns[0])
        self.prediction_head = _mlp_head(32)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]):
        return self.backbone.dropout_shapes(rows, spatial)

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None):
        return self.backbone(x, drop_u=drop_u, stats=stats, with_feats=True)

    def forward_projection_head(self, features: torch.Tensor) -> torch.Tensor:
        return self.projection_head(features)

    def forward_prediction_head(self, features: torch.Tensor) -> torch.Tensor:
        return self.prediction_head(features)


class NetD(nn.Module):
    """net_D: the whole input flattened to one row -> Linear / 2 -> tanh ->
    Linear / 4 -> tanh -> Linear(1) -> sigmoid: [1, 1]."""

    def __init__(self, total_dim: int):
        super().__init__()
        self.fc1 = Linear(total_dim, total_dim // 2)
        self.fc2 = Linear(total_dim // 2, total_dim // 4)
        self.fc3 = Linear(total_dim // 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.fc1(x.reshape(1, -1)))
        h = torch.tanh(self.fc2(h))
        return torch.sigmoid(self.fc3(h))


class TinyUNet3D(nn.Module):
    """Conv-BN-ReLU blocks of 16, 32, 64 channels over two max pools, two
    trilinear-up decoder blocks and a 1x1x1 head; train mode returns (out,
    (softmax of ms2 over the 32-channel decoder map, of ms3 over the
    64-channel bottleneck)) (chap_tpu extras.py:58-89)."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2):
        super().__init__()
        for name, cin, cout in (("enc1", in_chns, 16), ("enc2", 16, 32),
                                ("enc3", 32, 64), ("dec2", 96, 32),
                                ("dec1", 48, 16)):
            setattr(self, f"{name}_conv", Conv3d(cin, cout, 3, padding=1))
            setattr(self, f"{name}_bn", BatchNorm3d(cout))
        self.out = Conv3d(16, num_classes, 1)
        self.ms3 = Conv3d(64, num_classes, 1)
        self.ms2 = Conv3d(32, num_classes, 1)
        set_stats_keys(self)

    def _block(self, name: str, h: torch.Tensor, stats: Optional[Stats]):
        h = getattr(self, f"{name}_conv")(h)
        return F.relu(getattr(self, f"{name}_bn")(h, stats))

    def forward(self, x: torch.Tensor, *, stats: Optional[Stats] = None):
        e1 = self._block("enc1", x, stats)
        e2 = self._block("enc2", F.max_pool3d(e1, 2), stats)
        e3 = self._block("enc3", F.max_pool3d(e2, 2), stats)
        d2 = self._block("dec2", torch.cat([upsample2x_trilinear(e3), e2], 1), stats)
        d1 = self._block("dec1", torch.cat([upsample2x_trilinear(d2), e1], 1), stats)
        out = self.out(d1)
        if self.training:
            return out, (softmax(self.ms2(d2), 1), softmax(self.ms3(e3), 1))
        return out
