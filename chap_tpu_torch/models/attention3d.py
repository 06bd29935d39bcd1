"""Attention-gated 3D U-Net (port of chap_tpu/models/attention3d.py;
reference attention_unet.py:9-136, grid_attention_layer.py:7-381 and the
UnetDsv3 / UnetGridGatingSignal3 heads of networks/utils.py).

Every resize is jax.image.resize 'linear' (layers.resize_linear): half-pixel
centred, edge weights renormalised, antialiased where it shrinks. The gate
BatchNorms are the port's Flax-semantics BatchNorm (momentum 0.9 in Flax's
convention, running stats folded by the train step). The gating signal is
conv 1x1x1 + affine-free instance norm (epsilon 1e-5) + ReLU.

NCDHW, with the reference torch module names (``attentionblock4.gate_block_1
.W.0``, ``gating.conv1.0``, ``dsv4.dsv.0`` ...); chap_tpu has no converter
rules for this model, so ``convert/from_jax.py`` spells the mapping out.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, BatchNorm3d, Conv2d,
                                          Conv3d, Stats, instance_norm,
                                          resize_linear, set_stats_keys,
                                          softmax)
from chap_tpu_torch.models.unet3d import (UNet3DEncoder, UnetUp3CT,
                                          unet_filters)

GRID_MODES = ("concatenation", "concatenation_debug", "concatenation_residual")
TORR_MODES = ("concatenation_softmax", "concatenation_sigmoid",
              "concatenation_mean", "concatenation_mean_flow",
              "concatenation_range_normalise")


def _softmax_over_space(psi: torch.Tensor) -> torch.Tensor:
    b = psi.shape[0]
    return softmax(psi.reshape(b, -1), 1).reshape(psi.shape)


class GridAttentionBlock3D(nn.Module):
    """Grid attention (grid_attention_layer.py:84-159): theta(x) strided onto
    the attention grid, phi(g) resized onto it, additive fusion, psi -> gate
    resized back onto x, then W = 1x1x1 conv + BatchNorm. Modes:
      concatenation           ReLU fusion, sigmoid gate
      concatenation_debug     softplus fusion, sigmoid gate
      concatenation_residual  ReLU fusion, softmax over the flattened space.
    forward(x, g) -> (W(x * gate), gate [B, 1, *x spatial])."""

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, sub_sample_factor=(2, 2, 2),
                 mode: str = "concatenation"):
        super().__init__()
        if mode not in GRID_MODES:
            raise ValueError(f"unknown grid-attention mode {mode!r}")
        self.mode = mode
        ssf = tuple(sub_sample_factor)
        self.theta = Conv3d(in_channels, inter_channels, ssf, stride=ssf,
                               bias=False)
        self.phi = Conv3d(gating_channels, inter_channels, 1)
        self.psi = Conv3d(inter_channels, 1, 1)
        self.W = nn.Sequential(Conv3d(in_channels, in_channels, 1),
                               BatchNorm3d(in_channels))

    def forward(self, x: torch.Tensor, g: torch.Tensor,
                stats: Optional[Stats] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        theta_x = self.theta(x)
        phi_g = resize_linear(self.phi(g), theta_x.shape[2:])
        fuse = F.softplus if self.mode == "concatenation_debug" else F.relu
        psi = self.psi(fuse(theta_x + phi_g))
        if self.mode == "concatenation_residual":
            gate = _softmax_over_space(psi)
        else:
            gate = torch.sigmoid(psi)
        gate = resize_linear(gate, x.shape[2:])
        return self.W[1](self.W[0](x * gate), stats), gate


class GridAttentionBlockTORR(nn.Module):
    """The _TORR grid-attention family (grid_attention_layer.py:183-381;
    chap_tpu attention3d.py:70-157), 2D or 3D by ``dims``: phi strided like
    theta, unpadded convs, any of W / theta / phi / psi switchable to the
    identity, psi's bias initialised to 3.0 (sigmoid) or 10.0 (softmax), and
    five gate normalisations over the flattened space. The plain
    'concatenation' mode is refused, as in the reference."""

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, dims: int = 3,
                 mode: str = "concatenation_softmax",
                 sub_sample_factor: Sequence[int] = (1, 1, 1),
                 bn_layer: bool = True, use_W: bool = True,
                 use_phi: bool = True, use_theta: bool = True,
                 use_psi: bool = True, nonlinearity1: str = "relu"):
        super().__init__()
        if mode not in TORR_MODES:
            raise ValueError(f"unsupported TORR mode {mode!r} (reference "
                             f"supports only {TORR_MODES})")
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        conv = Conv3d if dims == 3 else Conv2d
        bn = BatchNorm3d if dims == 3 else BatchNorm2d
        ssf = tuple(sub_sample_factor)[:dims] or (1,) * dims
        self.mode, self.nonlinearity1 = mode, nonlinearity1
        self.theta = conv(in_channels, inter_channels, ssf, stride=ssf,
                          bias=False) if use_theta else None
        self.phi = conv(gating_channels, inter_channels, ssf, stride=ssf,
                        bias=False) if use_phi else None
        self.psi = conv(inter_channels, 1, 1) if use_psi else None
        if self.psi is not None:
            nn.init.constant_(self.psi.bias, {"concatenation_sigmoid": 3.0,
                                              "concatenation_softmax": 10.0
                                              }.get(mode, 0.0))
        self.W = None
        if use_W:
            self.W = (nn.Sequential(conv(in_channels, in_channels, 1),
                                    bn(in_channels)) if bn_layer
                      else conv(in_channels, in_channels, 1))
        set_stats_keys(self)

    def forward(self, x: torch.Tensor, g: torch.Tensor,
                stats: Optional[Stats] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        theta_x = x if self.theta is None else self.theta(x)
        phi_g = g if self.phi is None else self.phi(g)
        phi_g = resize_linear(phi_g, theta_x.shape[2:])
        f = theta_x + phi_g
        if self.nonlinearity1 == "relu":
            f = F.relu(f)
        psi_f = f if self.psi is None else self.psi(f)
        b = psi_f.shape[0]
        flat = psi_f.reshape(b, -1)
        if self.mode == "concatenation_softmax":
            gate = softmax(flat, 1)
        elif self.mode == "concatenation_mean":
            gate = flat / flat.sum(dim=1, keepdim=True)
        elif self.mode == "concatenation_mean_flow":
            shifted = flat - flat.min(dim=1, keepdim=True).values
            gate = shifted / shifted.sum(dim=1, keepdim=True)
        elif self.mode == "concatenation_range_normalise":
            lo = flat.min(dim=1, keepdim=True).values
            hi = flat.max(dim=1, keepdim=True).values
            gate = (flat - lo) / (hi - lo)
        else:   # concatenation_sigmoid
            gate = torch.sigmoid(flat)
        gate = resize_linear(gate.reshape((b, 1) + tuple(psi_f.shape[2:])),
                             x.shape[2:])
        y = x * gate
        if self.W is None:
            return y, gate
        if isinstance(self.W, nn.Sequential):
            return self.W[1](self.W[0](y), stats), gate
        return self.W(y), gate


class MultiAttentionBlock(nn.Module):
    """Two parallel gates, their outputs concatenated and combined by a
    1x1x1 conv + BatchNorm + ReLU (attention_unet.py:113-136)."""

    def __init__(self, in_size: int, gate_size: int, inter_size: int):
        super().__init__()
        self.gate_block_1 = GridAttentionBlock3D(in_size, gate_size, inter_size)
        self.gate_block_2 = GridAttentionBlock3D(in_size, gate_size, inter_size)
        self.combine_gates = nn.Sequential(Conv3d(2 * in_size, in_size, 1),
                                           BatchNorm3d(in_size), nn.ReLU())

    def forward(self, x: torch.Tensor, g: torch.Tensor,
                stats: Optional[Stats] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        g1, a1 = self.gate_block_1(x, g, stats)
        g2, a2 = self.gate_block_2(x, g, stats)
        c = self.combine_gates
        h = c[1](c[0](torch.cat([g1, g2], dim=1)), stats)
        return F.relu(h), torch.cat([a1, a2], dim=1)


class UnetDsv3(nn.Module):
    """Deep-supervision head: 1x1x1 conv, then a half-pixel trilinear
    resize to ``scale_factor`` times the size."""

    def __init__(self, in_size: int, out_size: int, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor
        self.dsv = nn.Sequential(Conv3d(in_size, out_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_linear(self.dsv(x),
                             [s * self.scale_factor for s in x.shape[2:]])


class UnetGridGatingSignal3(nn.Module):
    """conv 1x1x1 + instance norm (epsilon 1e-5, no affine) + ReLU
    (utils.py:192-204; its is_batchnorm flag selects the instance norm)."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv1 = nn.Sequential(Conv3d(in_size, out_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(instance_norm(self.conv1(x)))


class AttentionUNet3D(UNet3DEncoder):
    """Attention_UNet: the UNet3D encoder, a gating signal from the
    bottleneck, MultiAttentionBlock gates on the skips of levels 2-4, and
    four deep-supervision heads fused by a 1x1x1 conv. No dropout.
    forward(x [B, Cin, X, Y, Z]) -> logits [B, C, X, Y, Z]."""

    num_decoders = 1

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_scale: int = 4, is_batchnorm: bool = True):
        f = unet_filters(feature_scale)
        super().__init__(in_chns, f, is_batchnorm)
        self.gating = UnetGridGatingSignal3(f[4], f[4])
        self.attentionblock2 = MultiAttentionBlock(f[1], f[2], f[1])
        self.attentionblock3 = MultiAttentionBlock(f[2], f[3], f[2])
        self.attentionblock4 = MultiAttentionBlock(f[3], f[4], f[3])
        self.up_concat4 = UnetUp3CT(f[4], f[3], is_batchnorm)
        self.up_concat3 = UnetUp3CT(f[3], f[2], is_batchnorm)
        self.up_concat2 = UnetUp3CT(f[2], f[1], is_batchnorm)
        self.up_concat1 = UnetUp3CT(f[1], f[0], is_batchnorm)
        self.dsv4 = UnetDsv3(f[3], num_classes, 8)
        self.dsv3 = UnetDsv3(f[2], num_classes, 4)
        self.dsv2 = UnetDsv3(f[1], num_classes, 2)
        self.dsv1 = Conv3d(f[0], num_classes, 1)
        self.final = Conv3d(4 * num_classes, num_classes, 1)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]
                       ) -> List[Tuple[int, ...]]:
        return []

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        conv1, conv2, conv3, conv4, center = self.encode(x)
        gating = self.gating(center)
        g4, _ = self.attentionblock4(conv4, gating, stats)
        up4 = self.up_concat4(g4, center)
        g3, _ = self.attentionblock3(conv3, up4, stats)
        up3 = self.up_concat3(g3, up4)
        g2, _ = self.attentionblock2(conv2, up3, stats)
        up2 = self.up_concat2(g2, up3)
        up1 = self.up_concat1(conv1, up2)
        fused = torch.cat([self.dsv1(up1), self.dsv2(up2), self.dsv3(up3),
                           self.dsv4(up4)], dim=1)
        return self.final(fused)
