"""2D UNet family (port of chap_tpu/models/unet2d.py): DualDecoder, UNet,
UNetPlus, UNetCCT and UNetURPC.

NCHW, channels [16, 32, 64, 128, 256], with the reference torch module names
(``encoder.in_conv.conv_conv.0``, ``decoder2.up1.up`` ...), which are the
names chap_tpu's converter rules spell out (convert/torch_import.py:43-100).

Every random draw of a train-mode pass comes in as a uniform tensor, so a
test can feed chap_tpu's: ``drop_u``, the encoder's dropout per level
(``dropout_shapes``), and for CCT and URPC ``perturb_u``, their feature
perturbations (``perturb_shapes``). A draw left None is made on the input's
device from the global generator.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (Conv2d, ConvBlock, DownBlock, Stats,
                                          UpBlock, dropout_from_uniform,
                                          set_stats_keys, split_drop_u)
from chap_tpu_torch.models.perturb import (feature_dropout, feature_noise,
                                           perform_dropout)

DEFAULT_CHNS = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


class Encoder(nn.Module):
    """5-scale encoder: in_conv + 4x(maxpool -> ConvBlock) (unet.py:125-151)."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int] = DEFAULT_CHNS,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        ch, dr = feature_chns, dropout
        self.in_conv = ConvBlock(in_chns, ch[0], dr[0])
        self.down1 = DownBlock(ch[0], ch[1], dr[1])
        self.down2 = DownBlock(ch[1], ch[2], dr[2])
        self.down3 = DownBlock(ch[2], ch[3], dr[3])
        self.down4 = DownBlock(ch[3], ch[4], dr[4])

    def forward(self, x: torch.Tensor,
                drop_u: Optional[Sequence[Optional[torch.Tensor]]] = None,
                stats: Optional[Stats] = None) -> List[torch.Tensor]:
        """drop_u: one dropout uniform per level, shaped like that level's
        first conv output (None: drawn from the global generator)."""
        u = list(drop_u) if drop_u is not None else [None] * 5
        x0 = self.in_conv(x, u[0], stats)
        x1 = self.down1(x0, u[1], stats)
        x2 = self.down2(x1, u[2], stats)
        x3 = self.down3(x2, u[3], stats)
        x4 = self.down4(x3, u[4], stats)
        return [x0, x1, x2, x3, x4]


class Decoder(nn.Module):
    """4x UpBlock + 3x3 out conv (unet.py:153-190). bilinear=False is the
    mcnet transpose-conv decoder2; ``plus`` selects additive skips
    (Decoder_plus, unet.py:193-242)."""

    def __init__(self, num_classes: int, feature_chns: Sequence[int] = DEFAULT_CHNS,
                 bilinear: bool = True, plus: bool = False):
        super().__init__()
        ch = feature_chns
        self.up1 = UpBlock(ch[4], ch[3], ch[3], 0.0, bilinear, plus)
        self.up2 = UpBlock(ch[3], ch[2], ch[2], 0.0, bilinear, plus)
        self.up3 = UpBlock(ch[2], ch[1], ch[1], 0.0, bilinear, plus)
        self.up4 = UpBlock(ch[1], ch[0], ch[0], 0.0, bilinear, plus)
        self.out_conv = Conv2d(ch[0], num_classes, 3, padding=1)

    def forward(self, feature: Sequence[torch.Tensor],
                stats: Optional[Stats] = None, with_features: bool = False):
        """Logits; with ``with_features`` (logits, the last up-block's
        output), chap_tpu's ``with_features`` (unet2d.py:58-60)."""
        x0, x1, x2, x3, x4 = feature
        x = self.up1(x4, x3, stats)
        x = self.up2(x, x2, stats)
        x = self.up3(x, x1, stats)
        x = self.up4(x, x0, stats)
        out = self.out_conv(x)
        return (out, x) if with_features else out


def DecoderPlus(num_classes: int, feature_chns: Sequence[int] = DEFAULT_CHNS,
                bilinear: bool = True) -> Decoder:
    """Additive-skip decoder (unet.py:193-242)."""
    return Decoder(num_classes, feature_chns, bilinear, plus=True)


class DualDecoder(nn.Module):
    """CHAP core model (unet.py:245-292): shared encoder, decoder1 bilinear,
    decoder2 by decoder_type in {same, plus, mcnet}.

    With ``dropout_level`` the encoder pyramid is split into two
    channel-perturbed copies (models/perturb.py) before the two decodes."""

    def __init__(self, in_chns: int, num_classes: int,
                 decoder_type: str = "mcnet",
                 feature_chns: Sequence[int] = DEFAULT_CHNS,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.feature_chns = tuple(feature_chns)
        self.encoder = Encoder(in_chns, feature_chns, dropout)
        self.decoder1 = Decoder(num_classes, feature_chns, True)
        if decoder_type == "same":
            self.decoder2 = Decoder(num_classes, feature_chns, True)
        elif decoder_type == "plus":
            self.decoder2 = DecoderPlus(num_classes, feature_chns, True)
        elif decoder_type == "mcnet":
            self.decoder2 = Decoder(num_classes, feature_chns, False)
        else:
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
        set_stats_keys(self)

    def forward(self, x: torch.Tensor, *,
                drop_u: Optional[Sequence[Optional[torch.Tensor]]] = None,
                dropout_level: Optional[Sequence[int]] = None,
                scores: Optional[Sequence[Optional[torch.Tensor]]] = None,
                comp_dropout: bool = False,
                perturb_draws=None,
                clean_rows: Optional[int] = None,
                stop_encoder_grad: bool = False,
                stats: Optional[Stats] = None):
        """x: [B, Cin, H, W]. Train mode (``model.train()``) normalises with
        batch statistics and writes them into ``stats`` (layers.FlaxBatchNorm).
        ``stop_encoder_grad`` detaches every pyramid level before the
        decoders (the ACAL decoder max-step); the encoder still runs as
        asked, its dropout draws and batch statistics included.
        ``clean_rows``: the rows the channel perturbation leaves clean
        (models/perturb.py). Returns (logits1, logits2)."""
        feature = self.forward_encoder(x, drop_u, stats)
        if stop_encoder_grad:
            feature = [f.detach() for f in feature]
        if dropout_level is not None:
            f1, f2 = perform_dropout(feature, dropout_level, scores,
                                     comp_dropout, draws=perturb_draws,
                                     clean_rows=clean_rows)
            return self.decoder1(f1, stats), self.decoder2(f2, stats)
        return self.forward_decoders(feature, stats)

    def forward_encoder(self, x: torch.Tensor,
                        drop_u: Optional[Sequence[Optional[torch.Tensor]]] = None,
                        stats: Optional[Stats] = None) -> List[torch.Tensor]:
        """The encoder pyramid alone (chap_tpu's ``forward_encoder``)."""
        return self.encoder(x, drop_u, stats)

    def forward_decoders(self, feature: Sequence[torch.Tensor],
                         stats: Optional[Stats] = None):
        """Both decoders over a precomputed pyramid (chap_tpu's
        ``forward_decoders``): (logits1, logits2)."""
        return self.decoder1(feature, stats), self.decoder2(feature, stats)


def encoder_dropout_shapes(rows: int, spatial: Sequence[int],
                           feature_chns: Sequence[int]) -> List[Tuple[int, ...]]:
    """The Encoder's ``drop_u`` shapes: each level's first conv output
    [rows, C_i, H >> i, W >> i]."""
    h, w = (int(s) for s in spatial)
    return [(rows, c, h >> i, w >> i) for i, c in enumerate(feature_chns)]


class UNet(nn.Module):
    """Plain single-decoder UNet (unet.py:498-552), key ``unet``. The
    decoder keeps the reference's name ``decoder1`` (chap_tpu's unet2d_rules,
    torch_import.py:85-87). forward -> logits; with ``with_feats`` (logits,
    the last decoder feature map), as DSNet's students ask."""

    def __init__(self, in_chns: int, num_classes: int,
                 feature_chns: Sequence[int] = DEFAULT_CHNS,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.feature_chns = tuple(feature_chns)
        self.encoder = Encoder(in_chns, feature_chns, dropout)
        self.decoder1 = Decoder(num_classes, feature_chns, True)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]):
        return encoder_dropout_shapes(rows, spatial, self.feature_chns)

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None, with_feats: bool = False):
        return self.decoder1(self.encoder(x, drop_u, stats), stats,
                             with_features=with_feats)


class UNetPlus(nn.Module):
    """UNet with the additive-skip decoder (unet.py:554-620), key ``unetp``:
    eval mode -> logits; train mode -> (logits, the last decoder feature
    map), as chap_tpu's (unet2d.py:193-196)."""

    def __init__(self, in_chns: int, num_classes: int,
                 feature_chns: Sequence[int] = DEFAULT_CHNS,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.feature_chns = tuple(feature_chns)
        self.encoder = Encoder(in_chns, feature_chns, dropout)
        self.decoder = DecoderPlus(num_classes, feature_chns, True)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]):
        return encoder_dropout_shapes(rows, spatial, self.feature_chns)

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None):
        out, feat = self.decoder(self.encoder(x, drop_u, stats), stats,
                                 with_features=True)
        return (out, feat) if self.training else out


class UNetCCT(nn.Module):
    """Main decoder and three aux decoders over perturbed copies of the
    pyramid (unet.py:776-801), key ``unet_cct``: feature noise, dropout
    of 0.3 and attention-guided feature dropout, in eval mode too (as
    chap_tpu's, unet2d.py:213-224). Returns (main, aux1, aux2, aux3)."""

    def __init__(self, in_chns: int, num_classes: int,
                 feature_chns: Sequence[int] = DEFAULT_CHNS,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.feature_chns = tuple(feature_chns)
        self.encoder = Encoder(in_chns, feature_chns, dropout)
        self.main_decoder = Decoder(num_classes, feature_chns, True)
        self.aux_decoder1 = Decoder(num_classes, feature_chns, True)
        self.aux_decoder2 = Decoder(num_classes, feature_chns, True)
        self.aux_decoder3 = Decoder(num_classes, feature_chns, True)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]):
        return encoder_dropout_shapes(rows, spatial, self.feature_chns)

    def perturb_shapes(self, rows: int, spatial: Sequence[int]):
        """chap_tpu's order: the noise of each level [C_i, H_i, W_i], the
        0.3-dropout of each [rows, C_i, H_i, W_i], the feature-dropout
        fraction of each (0-d)."""
        levels = encoder_dropout_shapes(rows, spatial, self.feature_chns)
        return [s[1:] for s in levels] + levels + [()] * len(levels)

    def forward(self, x: torch.Tensor, *, drop_u=None, perturb_u=None,
                stats: Optional[Stats] = None):
        feature = self.encoder(x, drop_u, stats)
        n = len(feature)
        u = split_drop_u(perturb_u, 3 * n)
        aux1 = [feature_noise(f, u[i]) for i, f in enumerate(feature)]
        aux2 = [dropout_from_uniform(f, 0.3, u[n + i])
                for i, f in enumerate(feature)]
        aux3 = [feature_dropout(f, u[2 * n + i]) for i, f in enumerate(feature)]
        return (self.main_decoder(feature, stats),
                self.aux_decoder1(aux1, stats),
                self.aux_decoder2(aux2, stats),
                self.aux_decoder3(aux3, stats))


class UNetURPC(nn.Module):
    """Multi-scale deep supervision with stage perturbations (unet.py:
    404-464, 804-822), key ``unet_urpc``: four logits maps at full
    resolution (nearest up-sampling, F.interpolate's default), the stage
    perturbations in train mode only. Module names follow the reference's
    Decoder_URPC (``decoder.out_conv_dp3`` ...)."""

    def __init__(self, in_chns: int, num_classes: int,
                 feature_chns: Sequence[int] = DEFAULT_CHNS,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.feature_chns = ch = tuple(feature_chns)
        self.encoder = Encoder(in_chns, feature_chns, dropout)
        self.decoder = nn.Module()
        self.decoder.up1 = UpBlock(ch[4], ch[3], ch[3], 0.0)
        self.decoder.up2 = UpBlock(ch[3], ch[2], ch[2], 0.0)
        self.decoder.up3 = UpBlock(ch[2], ch[1], ch[1], 0.0)
        self.decoder.up4 = UpBlock(ch[1], ch[0], ch[0], 0.0)
        self.decoder.out_conv = Conv2d(ch[0], num_classes, 3, padding=1)
        self.decoder.out_conv_dp3 = Conv2d(ch[3], num_classes, 3, padding=1)
        self.decoder.out_conv_dp2 = Conv2d(ch[2], num_classes, 3, padding=1)
        self.decoder.out_conv_dp1 = Conv2d(ch[1], num_classes, 3, padding=1)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]):
        return encoder_dropout_shapes(rows, spatial, self.feature_chns)

    def perturb_shapes(self, rows: int, spatial: Sequence[int]):
        """chap_tpu's order: the 0.5-dropout after up1 [rows, C3, H/8,
        W/8], the feature-dropout fraction after up2 (0-d), the noise after
        up3 [C1, H/2, W/2]."""
        h, w = (int(s) for s in spatial)
        ch = self.feature_chns
        return [(rows, ch[3], h >> 3, w >> 3), (), (ch[1], h >> 1, w >> 1)]

    def forward(self, x: torch.Tensor, *, drop_u=None, perturb_u=None,
                stats: Optional[Stats] = None):
        size = x.shape[2:]
        d = self.decoder
        x0, x1, x2, x3, x4 = self.encoder(x, drop_u, stats)
        u = split_drop_u(perturb_u, 3)
        train = self.training

        def head(conv, h):
            return F.interpolate(conv(h), size=size, mode="nearest")

        h = d.up1(x4, x3, stats)
        dp3 = head(d.out_conv_dp3, dropout_from_uniform(h, 0.5, u[0]) if train else h)
        h = d.up2(h, x2, stats)
        dp2 = head(d.out_conv_dp2, feature_dropout(h, u[1]) if train else h)
        h = d.up3(h, x1, stats)
        dp1 = head(d.out_conv_dp1, feature_noise(h, u[2]) if train else h)
        h = d.up4(h, x0, stats)
        return d.out_conv(h), dp1, dp2, dp3
