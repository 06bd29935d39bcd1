"""CycleGAN-era legacy networks (port of chap_tpu/models/gan_legacy.py; the
reference's networks_other.py:260-525). No trainer uses them; they belong
to the model zoo's surface.

  * ``gan_loss`` / ``GANLoss``: LSGAN (MSE) or vanilla (BCE, predictions
    clipped to [1e-7, 1 - 1e-7]) against a constant real / fake target;
  * ``ResnetGenerator``: reflect-padded 7x7 stem, two stride-2 downs, n
    residual blocks, two stride-2 ups, reflect-padded 7x7 tanh head;
  * ``UnetGenerator`` / ``UnetSkipConnectionBlock``: recursive 4x4
    stride-2 U-Net, LeakyReLU(0.2) downs, ReLU ups, concat skips, tanh
    outermost;
  * ``NLayerDiscriminator``: PatchGAN 4x4 stack, LeakyReLU(0.2), a
    one-channel head, optional sigmoid.

NCHW, with the reference's names (the CycleGAN ``model`` Sequentials and
their indices; ResnetBlock's ``conv_block``). ``norm`` is ``batchnorm``
(Flax-semantics BatchNorm2d, models/layers.py) or ``instancenorm`` (no
parameters; Flax's affine-free GroupNorm of one channel a group, epsilon
1e-6, with its float32 statistics in bf16), which turns the conv biases
on, as the reference's use_bias.

Two departures of chap_tpu from the reference, kept here since chap_tpu is
what the port is held to: its "SAME" 3x3 stride-2 transposed convs of
ResnetGenerator pad the dilated input (2, 1) where the reference's
padding 1 / output_padding 1 pads (1, 2) (here: padding 0 and the last
row and column dropped); and UnetGenerator's outermost down conv has a
bias. Dropout (``use_dropout``, p 0.5) takes ``drop_u``, one uniform
tensor a dropout in call order (``dropout_shapes``), or draws from the
global generator.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                          FlaxBatchNorm, GroupNorm, Stats,
                                          dropout_from_uniform, set_stats_keys)

GAN_IN_EPS = 1e-6     # Flax GroupNorm's default epsilon


def gan_loss(pred: torch.Tensor, target_is_real: bool, use_lsgan: bool = True,
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """MSE (lsgan) or BCE against a constant target map (chap_tpu
    gan_legacy.py:43-54)."""
    target = real_label if target_is_real else fake_label
    if use_lsgan:
        return ((pred - target) ** 2).mean()
    eps = 1e-7
    p = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


class GANLoss:
    """Constructor-compatible wrapper (networks_other.py:260)."""

    def __init__(self, use_lsgan: bool = True, target_real_label: float = 1.0,
                 target_fake_label: float = 0.0):
        self.use_lsgan = use_lsgan
        self.real_label = target_real_label
        self.fake_label = target_fake_label

    def __call__(self, pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
        return gan_loss(pred, target_is_real, self.use_lsgan, self.real_label,
                        self.fake_label)


def _norm(norm: str, channels: int) -> nn.Module:
    if norm == "batchnorm":
        return BatchNorm2d(channels)
    if norm == "instancenorm":
        return GroupNorm(channels, channels, eps=GAN_IN_EPS, affine=False)
    raise ValueError(f"unknown norm {norm!r}")


class _Reflect(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (self.pad,) * 4, mode="reflect")


class _SameDeconv3(ConvTranspose2d):
    """Flax's 3x3 stride-2 "SAME" transposed conv: padding 0, the output's
    last row and column dropped."""

    def __init__(self, cin: int, cout: int, bias: bool):
        super().__init__(cin, cout, 3, 2, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        return super().forward(x)[:, :, :2 * h, :2 * w]


class _Dropout(nn.Identity):
    """Dropout of p 0.5 in train mode, its uniform the next of the caller's
    ``drop_u`` (``_walk`` applies it)."""


def _walk(seq: nn.Sequential, x: torch.Tensor, stats: Optional[Stats],
          drops: Iterator) -> torch.Tensor:
    """A Sequential's layers in order: BatchNorms take ``stats``, dropouts
    their next uniform, submodules both."""
    for layer in seq:
        if isinstance(layer, FlaxBatchNorm):
            x = layer(x, stats)
        elif isinstance(layer, _Dropout):
            if layer.training:
                x = dropout_from_uniform(x, 0.5, next(drops))
        elif isinstance(layer, (ResnetBlock, UnetSkipConnectionBlock)):
            x = layer(x, stats, drops)
        else:
            x = layer(x)
    return x


def _drop_iter(drop_u) -> Iterator:
    if drop_u is None:
        while True:
            yield None
    yield from drop_u


class ResnetBlock(nn.Module):
    """Reflect pad, 3x3 conv, norm, ReLU, [dropout], reflect pad, 3x3 conv,
    norm, plus x (networks_other.py:355-393)."""

    def __init__(self, dim: int, norm: str = "batchnorm", use_dropout: bool = False):
        super().__init__()
        bias = norm == "instancenorm"
        layers = [_Reflect(1), Conv2d(dim, dim, 3, bias=bias), _norm(norm, dim),
                  nn.ReLU()]
        if use_dropout:
            layers.append(_Dropout())
        layers += [_Reflect(1), Conv2d(dim, dim, 3, bias=bias), _norm(norm, dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None,
                drops: Optional[Iterator] = None) -> torch.Tensor:
        return x + _walk(self.conv_block, x, stats, drops or _drop_iter(None))


class ResnetGenerator(nn.Module):
    """forward(x [B, input_nc, H, W]) -> tanh map [B, output_nc, H, W]; H
    and W divisible by 4 (networks_other.py:300-351)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_blocks: int = 6, norm: str = "batchnorm",
                 use_dropout: bool = False):
        super().__init__()
        bias = norm == "instancenorm"
        self.ngf, self.n_blocks, self.use_dropout = ngf, n_blocks, use_dropout
        layers = [_Reflect(3), Conv2d(input_nc, ngf, 7, bias=bias),
                  _norm(norm, ngf), nn.ReLU()]
        for i in range(2):
            mult = 2 ** i
            layers += [Conv2d(ngf * mult, ngf * mult * 2, 3, 2, padding=1, bias=bias),
                       _norm(norm, ngf * mult * 2), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4, norm, use_dropout) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [_SameDeconv3(ngf * mult, ngf * mult // 2, bias),
                       _norm(norm, ngf * mult // 2), nn.ReLU()]
        layers += [_Reflect(3), Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> List[tuple]:
        if not self.use_dropout:
            return []
        h, w = (int(s) // 4 for s in spatial)
        return [(rows, self.ngf * 4, h, w)] * self.n_blocks

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        return _walk(self.model, x, stats, _drop_iter(drop_u))


class UnetSkipConnectionBlock(nn.Module):
    """4x4 stride-2 down, the submodule, 4x4 stride-2 up; every block but
    the outermost concatenates x before its output
    (networks_other.py:426-477)."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "batchnorm",
                 use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        bias = norm == "instancenorm"
        input_nc = outer_nc if input_nc is None else input_nc
        down = Conv2d(input_nc, inner_nc, 4, 2, padding=1, bias=bias or outermost)
        up_in = inner_nc if innermost else inner_nc * 2
        up = ConvTranspose2d(up_in, outer_nc, 4, 2, padding=1, bias=bias or outermost)
        if outermost:
            layers = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, _norm(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, _norm(norm, inner_nc), submodule,
                      nn.ReLU(), up, _norm(norm, outer_nc)]
            if use_dropout:
                layers.append(_Dropout())
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None,
                drops: Optional[Iterator] = None) -> torch.Tensor:
        h = _walk(self.model, x, stats, drops or _drop_iter(None))
        return h if self.outermost else torch.cat([x, h], 1)


class UnetGenerator(nn.Module):
    """forward(x [B, input_nc, H, W]) -> tanh map [B, output_nc, H, W];
    H and W divisible by 2 ** num_downs (networks_other.py:396-423)."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int = 7,
                 ngf: int = 64, norm: str = "batchnorm", use_dropout: bool = False):
        super().__init__()
        self.ngf, self.num_downs, self.use_dropout = ngf, num_downs, use_dropout
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block,
                                            norm=norm, use_dropout=use_dropout)
        for mult in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2,
                                            submodule=block, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc,
                                             submodule=block, outermost=True,
                                             norm=norm)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> List[tuple]:
        """The dropouts' shapes in call order: the deepest block's first
        (each drops its up branch after its submodule has run)."""
        if not self.use_dropout:
            return []
        h, w = (int(s) for s in spatial)
        return [(rows, self.ngf * 8, h >> d, w >> d)
                for d in range(self.num_downs - 2, 3, -1)]

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        return self.model(x, stats, _drop_iter(drop_u))


class NLayerDiscriminator(nn.Module):
    """PatchGAN: forward(x [B, input_nc, H, W]) -> [B, 1, h, w] logits, or
    probabilities with ``use_sigmoid`` (networks_other.py:480-525)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batchnorm", use_sigmoid: bool = False):
        super().__init__()
        bias = norm == "instancenorm"
        layers = [Conv2d(input_nc, ndf, 4, 2, padding=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [Conv2d(ndf * prev, ndf * mult, 4, 2, padding=1, bias=bias),
                       _norm(norm, ndf * mult), nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [Conv2d(ndf * prev, ndf * mult, 4, 1, padding=1, bias=bias),
                   _norm(norm, ndf * mult), nn.LeakyReLU(0.2),
                   Conv2d(ndf * mult, 1, 4, 1, padding=1)]
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)
        set_stats_keys(self)

    def forward(self, x: torch.Tensor, *, stats: Optional[Stats] = None) -> torch.Tensor:
        return _walk(self.model, x, stats, _drop_iter(None))
