"""The 2D DualDecoder (a frozen copy of the port's ``models/unet2d.py``).

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

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from h100_bench.reference.models.layers import (Conv2d, ConvBlock, DownBlock,
                                                Stats, UpBlock, set_stats_keys)
from h100_bench.reference.models.perturb import perform_dropout

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


