"""SwinUNet, key ``swinunet`` (port of chap_tpu/models/swin_unet.py; the
reference's vision_transformer.py:24-121 over
swin_transformer_unet_skip_expand_decoder_sys.py:63-817): a Swin
Transformer encoder-decoder on tokens [B, L, C], windowed attention with a
relative position bias, shifted windows (a roll and an attention mask),
patch merging down, linear patch expanding up, skip concat + linear reduce,
and a 4x expanding head. ``SwinDecoder`` is the decoder alone, over a
5-level CNN feature pyramid.

The factory builds it at img_size 224, as chap_tpu's does
(chap_tpu/models/factory.py:55-57): the token grid is fixed at
construction, so an input of any other size raises, as the reshape at
chap_tpu swin_unet.py:303 does. A one-channel input is repeated to three
(vision_transformer.py:50-51). The window attention is plain matmuls
(chap_tpu's einsums, swin_unet.py:60,76); it was never a kernel. The
shifted-window masks are built once per resolution on the host at
construction. Flax semantics kept: Dense's GELU is the tanh approximation,
LayerNorm's epsilon 1e-5. In bf16 (models/layers.py) the window
attention promotes as chap_tpu's (swin_unet.py:57-78): the scores are
bf16, the float32 relative-position bias and shift mask make them float32,
the softmax and the product with the bf16 values are float32, and only
``proj`` casts back to bf16.

Module names are the reference's SwinTransformerSys names that chap_tpu's
``swinunet_rules`` spell out (convert/torch_import.py:214-263):
``patch_embed.proj``, ``layers.{i}.blocks.{d}.attn.qkv``,
``layers.{i}.downsample.reduction``, ``layers_up.0.expand``,
``layers_up.{j}.blocks.{d}``, ``concat_back_dim.{j}``, ``up.expand``,
``output`` ... chap_tpu has no torch names for SwinDecoder
(convert/torch_import.py has no rules for it); its modules here reuse
SwinUNet's decoder names (``layers_up``, ``concat_back_dim``, ``norm_up``,
``up``, ``output``) and convert/from_jax.py's ``swin_decoder_rules`` maps
chap_tpu's Flax names onto them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, LayerNorm,
                                          Linear, Stats, matmul,
                                          set_stats_keys)

LN_EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws * ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B * nW, ws * ws, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws * ws, ws * ws] mask of the shifted windows: -100 between
    tokens of different regions (swin...sys.py:210-226)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    windows = window_partition(torch.from_numpy(img_mask), ws)[..., 0].numpy()
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias (swin...sys.py:63-167)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        b_, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = matmul(q, k.transpose(-1, -2))
        bias = self.relative_position_bias_table[self.relative_position_index]
        # the float32 bias promotes bf16 scores to float32, as in JAX
        attn = attn + bias.reshape(n, n, -1).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, self.num_heads, n, n)
                    + mask[None, :, None]).reshape(-1, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = matmul(attn, v.to(attn.dtype))
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    """(S)W-MSA and MLP, each after a LayerNorm, with residuals
    (swin...sys.py:169-307). A grid no larger than the window takes one
    window and no shift, as there."""

    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int],
                 window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        h, w = resolution
        if min(h, w) <= window_size:
            window_size, shift_size = min(h, w), 0
        self.resolution, self.ws, self.shift = (h, w), window_size, shift_size
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = (torch.from_numpy(shift_attn_mask(h, w, window_size, shift_size))
                if shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, w), ws, shift = self.resolution, self.ws, self.shift
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask),
                           ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 token merge, LayerNorm, linear reduce to 2C (swin...sys.py:
    309-341)."""

    def __init__(self, dim: int, resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, (h // 2) * (w // 2), 4 * c)))


class PatchExpand(nn.Module):
    """Linear expand to ``scale`` ** 2 x ``out_dim`` channels, shuffled to
    a ``scale`` times finer grid, LayerNorm: PatchExpand (scale 2, half the
    channels, swin...sys.py:343-372) and FinalPatchExpand_X4 (scale 4, the
    same channels, :374-411)."""

    def __init__(self, dim: int, resolution: Tuple[int, int], scale: int = 2,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.resolution, self.scale = resolution, scale
        self.out_dim = dim // 2 if out_dim is None else out_dim
        self.expand = Linear(dim, scale * scale * self.out_dim, bias=False)
        self.norm = LayerNorm(self.out_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, s, c = x.shape[0], self.scale, self.out_dim
        x = self.expand(x).reshape(b, h, w, s, s, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, s * h * s * w, c)
        return self.norm(x)


class BasicLayer(nn.Module):
    """Swin blocks (shift on every second), then an optional resampler
    (``downsample`` in the encoder, ``upsample`` in the decoder)."""

    def __init__(self, dim: int, depth: int, num_heads: int, res: int,
                 window_size: int, resample: Optional[str]):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, (res, res), window_size,
                      0 if d % 2 == 0 else window_size // 2)
            for d in range(depth))
        if resample == "down":
            self.downsample = PatchMerging(dim, (res, res))
        elif resample == "up":
            self.upsample = PatchExpand(dim, (res, res))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, in_chns: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = Conv2d(in_chns, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinUNet(nn.Module):
    """forward(x [B, Cin, img_size, img_size]) -> logits [B, C, img_size,
    img_size]; img_size divisible by patch_size * 2 ** (len(depths) - 1)."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 img_size: int = 224, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        self.img_size = img_size
        n = len(depths)
        res0 = img_size // patch_size
        self.patch_embed = PatchEmbed(3 if in_chns == 1 else in_chns, embed_dim,
                                      patch_size)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], res0 >> i,
                       window_size, "down" if i < n - 1 else None)
            for i in range(n))
        self.norm = LayerNorm(embed_dim * 2 ** (n - 1), eps=LN_EPS)
        layers_up = [PatchExpand(embed_dim * 2 ** (n - 1), (res0 >> (n - 1),) * 2)]
        concat = [nn.Identity()]
        for j in range(1, n):
            i = n - 1 - j
            dim = embed_dim * 2 ** i
            layers_up.append(BasicLayer(dim, depths[i], num_heads[i], res0 >> i,
                                        window_size, "up" if j < n - 1 else None))
            concat.append(Linear(2 * dim, dim))
        self.layers_up = nn.ModuleList(layers_up)
        self.concat_back_dim = nn.ModuleList(concat)
        self.norm_up = LayerNorm(embed_dim, eps=LN_EPS)
        self.up = PatchExpand(embed_dim, (res0, res0), 4, embed_dim)
        self.output = Conv2d(embed_dim, num_classes, 1, bias=False)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> list:
        return []

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(f"SwinUNet is built for {self.img_size}^2 inputs, "
                             f"got {tuple(x.shape[2:])}")
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(x)     # a layer's input (swin...sys.py:762-763)
            x = layer(x)
            if hasattr(layer, "downsample"):
                x = layer.downsample(x)
        x = self.layers_up[0](self.norm(x))
        n = len(self.layers)
        for j in range(1, n):
            x = self.concat_back_dim[j](torch.cat([x, skips[n - 1 - j]], dim=-1))
            x = self.layers_up[j](x)
            if hasattr(self.layers_up[j], "upsample"):
                x = self.layers_up[j].upsample(x)
        x = self.up(self.norm_up(x))
        b, side = x.shape[0], 4 * self.up.resolution[0]
        x = x.reshape(b, side, side, -1).permute(0, 3, 1, 2)
        return self.output(x)


class SwinDecoder(nn.Module):
    """Decoder-only Swin (chap_tpu/models/swin_unet.py:194-279; the
    reference's SwinTransformer_Decoder, swin_..._original.py:807-1036):
    each level of a 5-level CNN pyramid (``in_chans`` channels, e.g. a UNet
    encoder's (16, 32, 64, 128, 256)) is patch-embedded by a stride
    ``patch_size`` conv to embed_dim * 2 ** i channels and a LayerNorm
    (``patch_embed.{i}``); the deepest embedding seeds the decoder through
    a PatchExpand (``layers_up.0``); each stage 1..4 concatenates the
    matching level's embedding, reduces it linearly (``concat_back_dim``)
    and runs Swin blocks, shifted on every second, with depths[lvl] and
    num_heads[lvl] of its level lvl = 4 - stage (the deepest level's
    entries are unused, as in chap_tpu); every stage but the last expands
    2x. Then ``norm_up``, a ``patch_size`` x expand that keeps the
    channels (``up``), and a bias-free 1x1 ``output`` conv.

    forward(features [B, in_chans[i], S / 2 ** i, S / 2 ** i] for i < 5,
    with_features=False, stats=None) -> logits [B, C, S, S], or with
    ``with_features`` (logits, projection [B, projection_dim, S, S]) from
    the projector head proj1 -> BatchNorm (Flax train-mode semantics) ->
    ReLU -> proj2. The token grids are fixed at construction from
    ``img_size`` = S, where chap_tpu's follow the features: the shifted
    windows' masks and each block's window (clamped to a grid no larger
    than it) are built then, and chap_tpu's parameter shapes follow the
    same grids, so a pyramid of another size raises. The window must
    divide every grid larger than it (224 with patch 2 and window 7: grids
    112 to 7). The wrong number of levels raises ValueError, as in
    chap_tpu."""

    def __init__(self, in_chans: Sequence[int] = (16, 32, 64, 128, 256),
                 num_classes: int = 4, img_size: int = 224, embed_dim: int = 48,
                 patch_size: int = 2, depths: Sequence[int] = (2, 2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24, 24),
                 window_size: int = 7, projection_dim: int = 64):
        super().__init__()
        n = len(depths)
        if len(in_chans) != n:
            raise ValueError(f"need {n} pyramid channel counts, got {len(in_chans)}")
        self.img_size, self.patch_size = img_size, patch_size
        self.grids = [img_size // 2 ** i // patch_size for i in range(n)]
        deepest = self.grids[-1]
        self.patch_embed = nn.ModuleList(
            PatchEmbed(c, embed_dim * 2 ** i, patch_size)
            for i, c in enumerate(in_chans))
        layers_up = [PatchExpand(embed_dim * 2 ** (n - 1), (deepest, deepest))]
        concat = [nn.Identity()]
        for inx in range(1, n):
            lvl = n - 1 - inx
            dim = embed_dim * 2 ** lvl
            layers_up.append(BasicLayer(dim, depths[lvl], num_heads[lvl],
                                        deepest << inx, window_size,
                                        "up" if inx < n - 1 else None))
            concat.append(Linear(2 * dim, dim))
        self.layers_up = nn.ModuleList(layers_up)
        self.concat_back_dim = nn.ModuleList(concat)
        self.norm_up = LayerNorm(embed_dim, eps=LN_EPS)
        side = deepest << (n - 1)
        self.up = PatchExpand(embed_dim, (side, side), patch_size, embed_dim)
        self.output = Conv2d(embed_dim, num_classes, 1, bias=False)
        self.proj1 = Conv2d(embed_dim, projection_dim, 1)
        self.proj_bn = BatchNorm2d(projection_dim)
        self.proj2 = Conv2d(projection_dim, projection_dim, 1)
        set_stats_keys(self)

    def forward(self, features: Sequence[torch.Tensor], *,
                with_features: bool = False, stats: Optional[Stats] = None):
        n = len(self.patch_embed)
        if len(features) != n:
            raise ValueError(f"need {n} pyramid levels, got {len(features)}")
        grids = [tuple(f.shape[2:]) for f in features]
        if grids != [(s * self.patch_size,) * 2 for s in self.grids]:
            raise ValueError(f"SwinDecoder is built for img_size {self.img_size} "
                             f"(level grids {[s * self.patch_size for s in self.grids]}"
                             f"), got {grids}")
        embeds = [embed(f) for embed, f in zip(self.patch_embed, features)]
        x = self.layers_up[0](embeds[-1])
        for inx in range(1, n):
            x = self.concat_back_dim[inx](torch.cat([x, embeds[n - 1 - inx]], dim=-1))
            x = self.layers_up[inx](x)
            if hasattr(self.layers_up[inx], "upsample"):
                x = self.layers_up[inx].upsample(x)
        x = self.up(self.norm_up(x))
        side = self.patch_size * self.up.resolution[0]
        x = x.reshape(x.shape[0], side, side, -1).permute(0, 3, 1, 2)
        logits = self.output(x)
        if not with_features:
            return logits
        p = F.relu(self.proj_bn(self.proj1(x), stats))
        return logits, self.proj2(p)
