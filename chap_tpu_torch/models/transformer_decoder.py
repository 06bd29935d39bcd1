"""Query-based transformer decoders whose cross-attention maps are the
segmentation maps (port of chap_tpu/models/transformer_decoder.py; the
reference's mask2former_transformer_decoder.py:215-938, attention_op.py
:20-171, position_encoding.py:12-64). No factory key builds them.

Learnable class queries attend over multi-level encoder features; at
every layer a per-layer seg head maps the queries' attention logits to a
segmentation map, and every layer's map is returned for deep supervision:
  * ``MaskTransformerDecoder``: multi-head cross-attention, queries cycling
    over the levels for ``num_layers`` rounds -> (seg maps, attention maps);
  * ``MaskTransformerDecoderV1``: one-head cross-attention, layer i reading
    level i (too few levels raise), a Q -> num_classes seg head, and
    mask2former's prediction heads on the initial queries -> (seg maps,
    (class logits [B, Q, num_classes + 1], masks [B, Q, H, W]));
  * ``KMaxTransformerDecoder``: k-means cross-attention, each pixel
    assigned to its argmax query by a straight-through one-hot (forward
    the one-hot, gradient the softmax's over the queries).

Features are NCHW (finest last for the cycling decoders); the maps come
out [B, Q or C, h, w], as chap_tpu's. LayerNorm epsilon 1e-6 (Flax's
default). Names follow mask2former's decoder (``input_proj.{i}``,
``query_feat`` / ``query_embed`` / ``level_embed`` embeddings,
``transformer_{cross_attention,self_attention,ffn}_layers.{l}``,
``decoder_norm``, ``class_embed``, ``mask_embed.layers.{i}``,
``seg_head_layers.{l}``); inside the layers chap_tpu's (``q``, ``k``,
``v``, ``proj``, ``norm``; ``linear1`` / ``linear2`` / ``norm``; the
self-attention ``self_attn`` has nn.MultiheadAttention's parameters, as
mask2former's).

In bf16 (models/layers.py; set_compute_dtype, as chap_tpu's ``dtype=``)
every Dense, LayerNorm and attention computes as Flax's does, and the
float32 tensors promote where chap_tpu's do: the query embeddings and the
level embeddings are float32 parameters and the sine position encoding a
float32 array, so a bf16 projection plus one of them is float32 until the
next Dense casts it. The attention scores are divided by sqrt(head_dim)
rounded to bf16 and their softmax is bf16; the self-attention is Flax's
nn.MultiHeadDotProductAttention (``MultiHeadDotProductAttention``), not
PyTorch's fused attention, which it runs at float32. KMax's straight-through argmax over bf16
logits takes the first of tied queries, as JAX's does. V1's mask einsum
of the bf16 query embedding and the mask features is in their promoted
dtype.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (Conv2d, LayerNorm, Linear,
                                          MultiHeadDotProductAttention, matmul,
                                          scale_in, softmax)

LN_EPS = 1e-6


@functools.lru_cache(maxsize=None)
def position_embedding_sine(h: int, w: int, dim: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """Sine / cosine 2D position encoding [H * W, dim], float32
    (chap_tpu transformer_decoder.py:19-33). Cached: read it, do not write
    it."""
    half = dim // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * 2 * np.pi
    x = x / (x[:, -1:] + eps) * 2 * np.pi
    dim_t = temperature ** (2 * (np.arange(half) // 2) / half)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], -1).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], -1).reshape(h * w, dim).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pos_on(h: int, w: int, dim: int, dtype: torch.dtype, device: torch.device
            ) -> torch.Tensor:
    return torch.from_numpy(position_embedding_sine(h, w, dim)).to(device, dtype)[None]


def _pos(h: int, w: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    """The encoding [1, H * W, dim] in ``like``'s dtype and device (a
    parameter: chap_tpu's encoding is float32 whatever the compute dtype),
    made once a size (the layers of a forward share it)."""
    return _pos_on(h, w, dim, like.dtype, like.device)


class CrossAttentionLayer(nn.Module):
    """Cross-attention returning (updated queries, the heads' mean
    attention logits [B, N, M]) (chap_tpu transformer_decoder.py:36-63)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v, self.proj = (Linear(dim, dim) for _ in range(4))
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, tgt, memory, query_pos, pos):
        b, n, c = tgt.shape
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], self.num_heads, hd).transpose(1, 2)

        q = heads(self.q(tgt + query_pos))
        k = heads(self.k(memory + pos))
        v = heads(self.v(memory))
        logits = matmul(q, k.transpose(-1, -2)) / scale_in(q.dtype, np.sqrt(hd))
        out = matmul(softmax(logits, -1), v)
        out = self.proj(out.transpose(1, 2).reshape(b, n, c))
        return self.norm(tgt + out), logits.mean(dim=1)


class SelfAttentionLayer(nn.Module):
    """Multi-head self-attention of the queries (q = k = tgt + query_pos,
    v = tgt), residual, LayerNorm (chap_tpu transformer_decoder.py:66-76)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads)
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        h = self.self_attn(q, q, tgt)
        return self.norm(tgt + h)


class FFNLayer(nn.Module):
    """Linear-ReLU-Linear, residual, LayerNorm (chap_tpu
    transformer_decoder.py:79-89)."""

    def __init__(self, dim: int, hidden: int = 2048):
        super().__init__()
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class KMaxCrossAttentionLayer(nn.Module):
    """k-means cross-attention (chap_tpu transformer_decoder.py:92-119):
    each pixel's hard assignment to its argmax query (a straight-through
    one-hot over the query axis), each query the mean of its cluster's
    values. Returns (updated queries, the assignment logits [B, N, M])."""

    def __init__(self, dim: int):
        super().__init__()
        self.q, self.k, self.v, self.proj = (Linear(dim, dim) for _ in range(4))
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, tgt, memory):
        n = tgt.shape[1]
        q = self.q(tgt)
        logits = (matmul(q, self.k(memory).transpose(-1, -2))
                  / scale_in(q.dtype, np.sqrt(tgt.shape[-1])))
        soft = softmax(logits, 1)
        hard = F.one_hot(logits.argmax(1), n).transpose(1, 2).to(soft.dtype)
        assign = soft + (hard - soft).detach()
        pooled = matmul(assign, self.v(memory))
        pooled = pooled / (assign.sum(-1, keepdim=True) + 1e-6)
        return self.norm(tgt + self.proj(pooled)), logits


class MlpHead(nn.Module):
    """``num_layers`` Linear layers, ReLU between (mask2former's MLP)."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(i, o) for i, o in
                                    zip(dims, dims[1:] + [out]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _QueryDecoder(nn.Module):
    """The parts the three decoders share: 1x1 input projections to
    ``hidden_dim`` tokens, the query features."""

    def __init__(self, in_channels: Sequence[int], num_queries: int,
                 hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.input_proj = nn.ModuleList(Conv2d(c, hidden_dim, 1) for c in in_channels)
        self.query_feat = nn.Embedding(num_queries, hidden_dim)

    def tokens(self, i: int, f: torch.Tensor) -> torch.Tensor:
        """Level i's [B, H W, hidden] tokens."""
        return self.input_proj[i](f).flatten(2).transpose(1, 2)

    def queries(self, b: int) -> torch.Tensor:
        return self.query_feat.weight[None].expand(b, -1, -1)


class MaskTransformerDecoder(_QueryDecoder):
    """MyTransformerDecoder: forward(features [B, C_i, h_i, w_i] per level)
    -> (seg maps, attention maps), one [B, Q, h, w] each a layer, layer l at
    level l mod the number of levels. ``in_channels``: each level's."""

    def __init__(self, in_channels: Sequence[int], num_queries: int = 4,
                 hidden_dim: int = 256, num_layers: int = 9, num_heads: int = 8):
        super().__init__(in_channels, num_queries, hidden_dim)
        self.num_layers = num_layers
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(len(in_channels), hidden_dim)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, num_heads) for _ in range(num_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, num_heads) for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim) for _ in range(num_layers))
        self.seg_head_layers = nn.ModuleList(Linear(1, 1) for _ in range(num_layers))

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        b, d = features[0].shape[0], self.hidden_dim
        tokens = [self.tokens(i, f) + self.level_embed.weight[i]
                  for i, f in enumerate(features)]
        hw = [tuple(f.shape[2:]) for f in features]
        tgt = self.queries(b)
        qpos = self.query_embed.weight[None].expand(b, -1, -1)
        seg_maps, attn_maps = [], []
        for layer in range(self.num_layers):
            lvl = layer % len(features)
            tgt, attn = self.transformer_cross_attention_layers[layer](
                tgt, tokens[lvl], qpos, _pos(*hw[lvl], d, qpos))
            tgt = self.transformer_self_attention_layers[layer](tgt, qpos)
            tgt = self.transformer_ffn_layers[layer](tgt)
            seg = self.seg_head_layers[layer](attn[..., None])[..., 0]
            seg_maps.append(seg.reshape(b, -1, *hw[lvl]))
            attn_maps.append(attn.reshape(b, -1, *hw[lvl]))
        return seg_maps, attn_maps


class MaskTransformerDecoderV1(_QueryDecoder):
    """MyTransformerDecoderV1: forward(features, one a layer at least;
    mask_features [B, C_m, H, W]) -> (seg maps [B, num_classes, h_l, w_l] a
    layer, (class logits [B, Q, num_classes + 1], masks [B, Q, H, W])).
    One-head cross-attention; ``num_heads`` is the self-attention's.
    ``in_channels``: the first ``num_layers`` levels' channels;
    ``mask_dim``: C_m."""

    def __init__(self, in_channels: Sequence[int], mask_dim: int,
                 num_queries: int = 4, num_classes: int = 4,
                 hidden_dim: int = 256, num_layers: int = 4, num_heads: int = 8):
        if num_layers > len(in_channels):
            raise ValueError("MyTransformerDecoderV1 indexes feature level i "
                             "at layer i (mask2former...py:635); need "
                             f"{num_layers} levels, got {len(in_channels)}")
        super().__init__(in_channels[:num_layers], num_queries, hidden_dim)
        self.num_layers, self.num_classes = num_layers, num_classes
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_layers, hidden_dim)
        self.decoder_norm = LayerNorm(hidden_dim, eps=LN_EPS)
        self.class_embed = Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MlpHead(hidden_dim, hidden_dim, mask_dim)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, 1) for _ in range(num_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, num_heads) for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim) for _ in range(num_layers))
        self.seg_head_layers = nn.ModuleList(
            Linear(num_queries, num_classes) for _ in range(num_layers))

    def forward(self, features: Sequence[torch.Tensor], mask_features: torch.Tensor):
        if self.num_layers > len(features):
            raise ValueError("MyTransformerDecoderV1 indexes feature level i "
                             "at layer i (mask2former...py:635); need "
                             f"{self.num_layers} levels, got {len(features)}")
        b, d = features[0].shape[0], self.hidden_dim
        tokens = [self.tokens(i, features[i]) + self.level_embed.weight[i]
                  for i in range(self.num_layers)]
        hw = [tuple(features[i].shape[2:]) for i in range(self.num_layers)]
        tgt = self.queries(b)
        qpos = self.query_embed.weight[None].expand(b, -1, -1)
        dec = self.decoder_norm(tgt)
        outputs_class = self.class_embed(dec)
        embed = self.mask_embed(dec)
        dt = torch.promote_types(embed.dtype, mask_features.dtype)
        outputs_mask = torch.einsum("bqc,bchw->bqhw", embed.to(dt),
                                    mask_features.to(dt))
        seg_maps = []
        for layer in range(self.num_layers):
            tgt, attn = self.transformer_cross_attention_layers[layer](
                tgt, tokens[layer], qpos, _pos(*hw[layer], d, qpos))
            seg = self.seg_head_layers[layer](attn.transpose(1, 2))   # [B, hw, C]
            seg_maps.append(seg.transpose(1, 2).reshape(b, self.num_classes, *hw[layer]))
            tgt = self.transformer_self_attention_layers[layer](tgt, qpos)
            tgt = self.transformer_ffn_layers[layer](tgt)
        return seg_maps, (outputs_class, outputs_mask)


class KMaxTransformerDecoder(_QueryDecoder):
    """MyKMaXTransformerDecoder: forward(features) -> seg maps [B, Q, h, w]
    a layer, layer l at level l mod the number of levels; the tokens carry
    the sine position encoding, the queries none."""

    def __init__(self, in_channels: Sequence[int], num_queries: int = 4,
                 hidden_dim: int = 256, num_layers: int = 6, num_heads: int = 8):
        super().__init__(in_channels, num_queries, hidden_dim)
        self.num_layers = num_layers
        self.transformer_cross_attention_layers = nn.ModuleList(
            KMaxCrossAttentionLayer(hidden_dim) for _ in range(num_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, num_heads) for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim) for _ in range(num_layers))
        self.seg_head_layers = nn.ModuleList(Linear(1, 1) for _ in range(num_layers))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        b, d = features[0].shape[0], self.hidden_dim
        hw = [tuple(f.shape[2:]) for f in features]
        tokens = [self.tokens(i, f) + _pos(*hw[i], d, self.query_feat.weight)
                  for i, f in enumerate(features)]
        tgt = self.queries(b)
        qpos = torch.zeros_like(tgt)
        seg_maps = []
        for layer in range(self.num_layers):
            lvl = layer % len(features)
            tgt, logits = self.transformer_cross_attention_layers[layer](tgt, tokens[lvl])
            tgt = self.transformer_self_attention_layers[layer](tgt, qpos)
            tgt = self.transformer_ffn_layers[layer](tgt)
            seg = self.seg_head_layers[layer](logits[..., None])[..., 0]
            seg_maps.append(seg.reshape(b, -1, *hw[lvl]))
        return seg_maps
