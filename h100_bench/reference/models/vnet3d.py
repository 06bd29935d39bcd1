"""VNet family for LA / Pancreas 3D segmentation (port of
chap_tpu/models/vnet3d.py): ConvBlock3d, ResidualConvBlock3d, DownBlock3d,
UpBlock3d (modes 0, 1, 2), VEncoder, VDecoder, VNet, the deep-supervised
VNetDS with its SideConv3d heads, and DualDecoder3d; normalisation
batchnorm, groupnorm, instancenorm or none.

NCDHW ``[B, C, X, Y, Z]`` where chap_tpu is ``[B, X, Y, Z, C]``, with the
reference torch module names (``encoder.block_one.conv.0`` ...), which are the
names chap_tpu's converter rules spell out (convert/torch_import.py:101-166).

chap_tpu's ``s2d_stem``, ``s2d_stage2`` and ``zpack_stage2`` are exact
relayouts of the same convolutions for the TPU's lanes (chap_tpu/ops/s2d.py);
the port computes in the plain layout (models/factory.py logs that the flags
change nothing), so chap_tpu's phase-view perturbation of an s2d skip is the
plain-layout perturbation here.

Dropout: with ``has_dropout``, a train-mode forward drops elements of the
bottleneck x5 and of each decoder's last features with probability 0.5
(chap_tpu's ``bernoulli(rng, 0.5)``, keep where u < 0.5). The uniforms are
passed in as ``drop_u = [u_x5, u_decoder1(, u_decoder2)]``, each shaped like
the tensor it drops (``dropout_shapes``, and every 3D model's
``dropout_shapes(rows, spatial)`` method); None draws from the global
generator.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.models.layers import (BatchNorm3d, Conv3d,
                                          ConvTranspose3d, FlaxBatchNorm,
                                          GroupNorm, Stats,
                                          dropout_from_uniform,
                                          set_stats_keys, split_drop_u,
                                          upsample2x_nearest,
                                          upsample2x_trilinear)
from h100_bench.reference.models.perturb import perform_dropout

DROPOUT_P = 0.5


def dropout_shapes(rows: int, n_filters: int, spatial: Sequence[int],
                   decoders: int) -> List[Tuple[int, ...]]:
    """Shapes of ``drop_u`` for a train-mode forward of ``rows`` patches of
    ``spatial`` [X, Y, Z]: the bottleneck [rows, 16 nf, X/16, Y/16, Z/16],
    then each decoder's output features [rows, nf, X, Y, Z]."""
    x, y, z = (int(s) for s in spatial)
    return ([(rows, 16 * n_filters, x >> 4, y >> 4, z >> 4)]
            + [(rows, n_filters, x, y, z)] * decoders)


# Flax's GroupNorm epsilon, which chap_tpu's groupnorm and instancenorm keep
# (torch's nn.GroupNorm / nn.InstanceNorm3d default to 1e-5)
GN_EPS = 1e-6


def _norm(normalization: str, channels: int) -> Optional[nn.Module]:
    """chap_tpu's _norm (vnet3d.py:22-33): Flax BatchNorm, GroupNorm of 16
    groups with scale and bias, or an affine-free GroupNorm of one channel a
    group (an instance norm), both at Flax's epsilon 1e-6. Flax takes the
    group variance in one pass, E[x^2] - E[x]^2; torch's group_norm in two,
    the exact value (tests/test_torch_zoo3d.py holds the difference). In
    bf16 both take float32 statistics and round only their output, as
    Flax's GroupNorm(dtype=) does."""
    if normalization == "batchnorm":
        return BatchNorm3d(channels)
    if normalization == "groupnorm":
        return GroupNorm(16, channels, eps=GN_EPS)
    if normalization == "instancenorm":
        return GroupNorm(channels, channels, eps=GN_EPS, affine=False)
    if normalization == "none":
        return None
    raise ValueError(f"unknown normalization {normalization!r}")


def _run(seq: nn.Sequential, x: torch.Tensor, stats: Optional[Stats]
         ) -> torch.Tensor:
    """Walk a Sequential by hand, handing the stats dict to each BatchNorm."""
    for module in seq:
        x = module(x, stats) if isinstance(module, FlaxBatchNorm) else module(x)
    return x


class _Upsample2x(nn.Module):
    """The parameterless Upsample at index 0 of a mode-1/2 UpBlock3d."""

    def __init__(self, mode: str):
        super().__init__()
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "trilinear":
            return upsample2x_trilinear(x)
        return upsample2x_nearest(x)


class ConvBlock3d(nn.Module):
    """n_stages x (conv3x3x3 -> norm -> relu) (vnet.py:8-34)."""

    def __init__(self, n_stages: int, in_channels: int, out_channels: int,
                 normalization: str = "none"):
        super().__init__()
        ops: List[nn.Module] = []
        for i in range(n_stages):
            ops.append(Conv3d(in_channels if i == 0 else out_channels,
                                 out_channels, 3, padding=1))
            norm = _norm(normalization, out_channels)
            if norm is not None:
                ops.append(norm)
            ops.append(nn.ReLU())
        self.conv = nn.Sequential(*ops)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> torch.Tensor:
        return _run(self.conv, x, stats)


class ResidualConvBlock3d(nn.Module):
    """Residual variant: the last stage's relu comes after the skip-add
    (vnet.py:37-67)."""

    def __init__(self, n_stages: int, in_channels: int, out_channels: int,
                 normalization: str = "none"):
        super().__init__()
        ops: List[nn.Module] = []
        for i in range(n_stages):
            ops.append(Conv3d(in_channels if i == 0 else out_channels,
                                 out_channels, 3, padding=1))
            norm = _norm(normalization, out_channels)
            if norm is not None:
                ops.append(norm)
            if i != n_stages - 1:
                ops.append(nn.ReLU())
        self.conv = nn.Sequential(*ops)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> torch.Tensor:
        return F.relu(_run(self.conv, x, stats) + x)


class DownBlock3d(nn.Module):
    """Strided-conv downsample, kernel = stride = 2, norm, relu
    (vnet.py:70-94)."""

    def __init__(self, in_channels: int, out_channels: int,
                 normalization: str = "none"):
        super().__init__()
        ops: List[nn.Module] = [Conv3d(in_channels, out_channels, 2, stride=2)]
        norm = _norm(normalization, out_channels)
        if norm is not None:
            ops.append(norm)
        ops.append(nn.ReLU())
        self.conv = nn.Sequential(*ops)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> torch.Tensor:
        return _run(self.conv, x, stats)


class UpBlock3d(nn.Module):
    """Upsampling_function (vnet.py:97-125): mode 0 a k2 s2 transpose conv,
    1 trilinear + conv3x3x3, 2 nearest + conv3x3x3; then norm and relu."""

    def __init__(self, in_channels: int, out_channels: int,
                 normalization: str = "none", mode_upsampling: int = 1):
        super().__init__()
        if mode_upsampling == 0:
            ops: List[nn.Module] = [ConvTranspose3d(in_channels, out_channels,
                                                       2, stride=2)]
        elif mode_upsampling in (1, 2):
            ops = [_Upsample2x("trilinear" if mode_upsampling == 1 else "nearest"),
                   Conv3d(in_channels, out_channels, 3, padding=1)]
        else:
            raise ValueError(f"unknown mode_upsampling {mode_upsampling}")
        norm = _norm(normalization, out_channels)
        if norm is not None:
            ops.append(norm)
        ops.append(nn.ReLU())
        self.conv = nn.Sequential(*ops)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> torch.Tensor:
        return _run(self.conv, x, stats)


def _dropout(module: nn.Module, x: torch.Tensor,
             u: Optional[torch.Tensor]) -> torch.Tensor:
    if module.has_dropout and module.training:
        return dropout_from_uniform(x, DROPOUT_P, u)
    return x


class VEncoder(nn.Module):
    """5-scale strided-conv encoder, stages (1, 2, 3, 3, 3), channels
    nf x (1, 2, 4, 8, 16), with dropout on the bottleneck (vnet.py:127-168)."""

    def __init__(self, in_chns: int = 1, n_filters: int = 16,
                 normalization: str = "none", has_dropout: bool = False,
                 has_residual: bool = False):
        super().__init__()
        self.has_dropout = has_dropout
        block = ResidualConvBlock3d if has_residual else ConvBlock3d
        nf, norm = n_filters, normalization
        self.block_one = block(1, in_chns, nf, norm)
        self.block_one_dw = DownBlock3d(nf, 2 * nf, norm)
        self.block_two = block(2, 2 * nf, 2 * nf, norm)
        self.block_two_dw = DownBlock3d(2 * nf, 4 * nf, norm)
        self.block_three = block(3, 4 * nf, 4 * nf, norm)
        self.block_three_dw = DownBlock3d(4 * nf, 8 * nf, norm)
        self.block_four = block(3, 8 * nf, 8 * nf, norm)
        self.block_four_dw = DownBlock3d(8 * nf, 16 * nf, norm)
        self.block_five = block(3, 16 * nf, 16 * nf, norm)

    def forward(self, x: torch.Tensor, u_x5: Optional[torch.Tensor] = None,
                stats: Optional[Stats] = None) -> List[torch.Tensor]:
        x1 = self.block_one(x, stats)
        x2 = self.block_two(self.block_one_dw(x1, stats), stats)
        x3 = self.block_three(self.block_two_dw(x2, stats), stats)
        x4 = self.block_four(self.block_three_dw(x3, stats), stats)
        x5 = self.block_five(self.block_four_dw(x4, stats), stats)
        return [x1, x2, x3, x4, _dropout(self, x5, u_x5)]


class VDecoder(nn.Module):
    """Additive-skip decoder, stages (3, 3, 2, 1), dropout on its last
    features, 1x1x1 out conv (vnet.py:170-223)."""

    def __init__(self, num_classes: int, n_filters: int = 16,
                 normalization: str = "none", has_dropout: bool = False,
                 has_residual: bool = False, up_type: int = 0):
        super().__init__()
        self.has_dropout = has_dropout
        block = ResidualConvBlock3d if has_residual else ConvBlock3d
        nf, norm = n_filters, normalization
        self.block_five_up = UpBlock3d(16 * nf, 8 * nf, norm, up_type)
        self.block_six = block(3, 8 * nf, 8 * nf, norm)
        self.block_six_up = UpBlock3d(8 * nf, 4 * nf, norm, up_type)
        self.block_seven = block(3, 4 * nf, 4 * nf, norm)
        self.block_seven_up = UpBlock3d(4 * nf, 2 * nf, norm, up_type)
        self.block_eight = block(2, 2 * nf, 2 * nf, norm)
        self.block_eight_up = UpBlock3d(2 * nf, nf, norm, up_type)
        self.block_nine = block(1, nf, nf, norm)
        self.out_conv = Conv3d(nf, num_classes, 1)

    def stages(self, features: Sequence[torch.Tensor],
               u_out: Optional[torch.Tensor] = None,
               stats: Optional[Stats] = None
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(logits, [x6, x7, x8]): the output and the three coarsest
        decoder stages' features."""
        x1, x2, x3, x4, x5 = features
        x6 = self.block_six(self.block_five_up(x5, stats) + x4, stats)
        x7 = self.block_seven(self.block_six_up(x6, stats) + x3, stats)
        x8 = self.block_eight(self.block_seven_up(x7, stats) + x2, stats)
        x = self.block_nine(self.block_eight_up(x8, stats) + x1, stats)
        return self.out_conv(_dropout(self, x, u_out)), [x6, x7, x8]

    def forward(self, features: Sequence[torch.Tensor],
                u_out: Optional[torch.Tensor] = None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        return self.stages(features, u_out, stats)[0]


class DualDecoder3d(nn.Module):
    """Shared encoder, decoder1 trilinear-up, decoder2 deconv-up
    (vnet.py:225-238). With ``dropout_level`` the encoder pyramid is split
    into two channel-perturbed copies (models/perturb.py, rank-generic)
    before the two decodes, as chap_tpu's extended forward does."""

    num_decoders = 2

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 n_filters: int = 16, normalization: str = "none",
                 has_dropout: bool = False, has_residual: bool = False):
        super().__init__()
        self.n_filters = n_filters
        self.encoder = VEncoder(in_chns, n_filters, normalization, has_dropout,
                                has_residual)
        self.decoder1 = VDecoder(num_classes, n_filters, normalization,
                                 has_dropout, has_residual, 1)
        self.decoder2 = VDecoder(num_classes, n_filters, normalization,
                                 has_dropout, has_residual, 0)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]
                       ) -> List[Tuple[int, ...]]:
        return dropout_shapes(rows, self.n_filters, spatial, 2)

    def forward(self, x: torch.Tensor, *, drop_u=None,
                dropout_level: Optional[Sequence[int]] = None,
                scores: Optional[Sequence[Optional[torch.Tensor]]] = None,
                comp_dropout: bool = False, perturb_draws=None,
                perturb_gate=None, clean_rows: Optional[int] = None,
                stats: Optional[Stats] = None):
        """x: [B, Cin, X, Y, Z] -> (logits1, logits2); ``clean_rows`` as in
        models/perturb.py perform_dropout."""
        u_x5, u_1, u_2 = split_drop_u(drop_u, 3)
        features = self.encoder(x, u_x5, stats)
        if dropout_level is None:
            f1 = f2 = features
        else:
            f1, f2 = perform_dropout(features, dropout_level, scores,
                                     comp_dropout, gate=perturb_gate,
                                     draws=perturb_draws, clean_rows=clean_rows)
        return self.decoder1(f1, u_1, stats), self.decoder2(f2, u_2, stats)
