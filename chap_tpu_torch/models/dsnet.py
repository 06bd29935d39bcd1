"""Dual-student network, key ``dual_student`` (port of
chap_tpu/models/dsnet.py; the reference's unet.py:623-757 DSNet,
cross_attention.py:305-378 and club.py:4-68): two UNet students; in train
mode each student's last decoder feature map is projected to tokens, proxy
queries (shared + the student's own) attend over them, and the CLUB
mutual-information bound between the two students' own query embeddings
and its learning loss make a distance term.

Train mode -> (logits1, logits2, dist); eval mode -> (logits1, logits2).
The cross-attention is the same einsums as chap_tpu's, as matmuls; it was
never a kernel. Dropout: each student's encoder (five draws) and, per
attention module, the attention map, the projection and the feed-forward's
two, 18 uniforms in chap_tpu's call order (``dropout_shapes``). Dense and
LayerNorm carry Flax's semantics (LayerNorm epsilon 1e-6), also in bf16
(models/layers.py): the attention's scores and softmax stay in the compute
dtype, and the residual with the float32 proxy queries is float32 until
the feed-forward's Dense casts back, as in chap_tpu (dsnet.py:56-69).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.models.layers import (BatchNorm2d, Conv2d, LayerNorm,
                                          Linear, Stats, dropout_from_uniform,
                                          matmul, set_stats_keys, softmax,
                                          split_drop_u)
from chap_tpu_torch.models.unet2d import UNet

ATT_DROPOUT = 0.1
FLAX_LN_EPS = 1e-6


class FFN(nn.Module):
    """x + Dense(relu(Dense(x))) with two dropouts (dsnet.py:21-35)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, u1=None, u2=None):
        h = F.relu(self.fc1(x))
        if self.training:
            h = dropout_from_uniform(h, ATT_DROPOUT, u1)
        h = self.fc2(h)
        if self.training:
            h = dropout_from_uniform(h, ATT_DROPOUT, u2)
        return x + h


class MyCrossAttention(nn.Module):
    """Proxy queries [n, c] attend over feature tokens [B, S, c]; returns
    (the updated queries [B, n, c], the head-mean attention [B, n, S])
    (dsnet.py:38-68)."""

    def __init__(self, dim: int, num_heads: int = 2):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_fc = Linear(dim, dim, bias=False)
        self.k_fc = Linear(dim, dim, bias=False)
        self.v_fc = Linear(dim, dim, bias=False)
        self.proj = Linear(dim, dim, bias=False)
        self.ffn = FFN(dim, 3 * dim)
        self.norm = LayerNorm(dim, eps=FLAX_LN_EPS)

    def dropout_shapes(self, rows: int, n: int, tokens: int) -> list:
        """[attention [rows, heads, n, S], projection [rows, n, c], the
        feed-forward's [rows, n, 3c] and [rows, n, c]]."""
        c = self.dim
        return [(rows, self.num_heads, n, tokens), (rows, n, c), (rows, n, 3 * c),
                (rows, n, c)]

    def forward(self, parts: torch.Tensor, supp_feat: torch.Tensor, drop_u=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        u = split_drop_u(drop_u, 4)
        b = supp_feat.shape[0]
        n, c = parts.shape
        hd = self.dim // self.num_heads
        q_ori = parts[None].expand(b, n, c)

        def heads(t):
            return t.reshape(b, t.shape[1], self.num_heads, hd).transpose(1, 2)

        q, k, v = (heads(self.q_fc(q_ori)), heads(self.k_fc(supp_feat)),
                   heads(self.v_fc(supp_feat)))
        attn = softmax(matmul(q, k.transpose(-1, -2)) * hd ** -0.5, -1)
        if self.training:
            attn = dropout_from_uniform(attn, ATT_DROPOUT, u[0])
        x = matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        x = self.proj(x)
        if self.training:
            x = dropout_from_uniform(x, ATT_DROPOUT, u[1])
        x = self.ffn(x + q_ori, u[2], u[3])     # float32 until the Dense
        return self.norm(x), attn.mean(dim=1)


class CLUBMean(nn.Module):
    """Contrastive log-ratio upper bound of the mutual information, q(y|x)
    of unit variance (dsnet.py:71-93)."""

    def __init__(self, x_dim: int, y_dim: int, hidden: int = 512):
        super().__init__()
        self.fc1 = Linear(x_dim, hidden)
        self.fc2 = Linear(hidden, y_dim)

    def mu(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))

    def forward(self, x_samples: torch.Tensor, y_samples: torch.Tensor):
        mu = self.mu(x_samples)
        positive = -((mu - y_samples) ** 2) / 2.0
        negative = -((y_samples[None, :, :] - mu[:, None, :]) ** 2).mean(dim=1) / 2.0
        return (positive.sum(-1) - negative.sum(-1)).mean()

    def learning_loss(self, x_samples: torch.Tensor, y_samples: torch.Tensor):
        return ((self.mu(x_samples) - y_samples) ** 2).sum(dim=1).mean()


class ProjectorHead(nn.Module):
    """4x4 average pool, 1x1 conv-BN-ReLU-1x1 conv, flattened to tokens
    [B, L, C] (dsnet.py:153-167)."""

    def __init__(self, in_channels: int, project_dim: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, project_dim, 1)
        self.bn = BatchNorm2d(project_dim)
        self.conv2 = Conv2d(project_dim, project_dim, 1)

    def forward(self, f: torch.Tensor, stats: Optional[Stats] = None):
        h = F.relu(self.bn(self.conv1(F.avg_pool2d(f, 4)), stats))
        return self.conv2(h).flatten(2).transpose(1, 2)


class DSNet(nn.Module):
    """forward(x [B, Cin, H, W]); H and W divisible by 16."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 project_dim: int = 64, proxy_num: int = 4):
        super().__init__()
        self.project_dim, self.proxy_num = project_dim, proxy_num
        self.student1 = UNet(in_chns, num_classes)
        self.student2 = UNet(in_chns, num_classes)
        self.att1 = MyCrossAttention(project_dim, 2)
        self.att2 = MyCrossAttention(project_dim, 2)
        # nn.initializers.uniform(1.0): U[0, 1)
        for name in ("shared_proxy", "independent_proxy1", "independent_proxy2"):
            self.register_parameter(name, nn.Parameter(
                torch.rand(proxy_num, project_dim)))
        self.club = CLUBMean(project_dim, project_dim)
        feat = self.student1.feature_chns[0]
        self.projector1 = ProjectorHead(feat, project_dim)
        self.projector2 = ProjectorHead(feat, project_dim)
        set_stats_keys(self)

    def dropout_shapes(self, rows: int, spatial: Sequence[int]) -> list:
        h, w = (int(s) for s in spatial)
        tokens = (h // 4) * (w // 4)
        n = 2 * self.proxy_num
        return (2 * self.student1.dropout_shapes(rows, spatial)
                + 2 * self.att1.dropout_shapes(rows, n, tokens))

    def forward(self, x: torch.Tensor, *, drop_u=None,
                stats: Optional[Stats] = None):
        u = split_drop_u(drop_u, 18)
        out1, f1 = self.student1(x, drop_u=u[0:5], stats=stats, with_feats=True)
        out2, f2 = self.student2(x, drop_u=u[5:10], stats=stats, with_feats=True)
        if not self.training:
            return out1, out2
        kv1 = self.projector1(f1, stats)
        kv2 = self.projector2(f2, stats)
        q1 = torch.cat([self.shared_proxy, self.independent_proxy1])
        q2 = torch.cat([self.shared_proxy, self.independent_proxy2])
        out_q1, _ = self.att1(q1, kv1, u[10:14])
        out_q2, _ = self.att2(q2, kv2, u[14:18])
        return out1, out2, self._dist_loss(out_q1, out_q2)

    def _dist_loss(self, q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
        """The CLUB bound and its learning loss between the two students'
        own-query means (dsnet.py:128-139; the reference leaves the shared
        alignment term out)."""
        g = q1.shape[1] // 2
        dist1, dist2 = q1[:, g:].mean(1), q2[:, g:].mean(1)
        return self.club.learning_loss(dist1, dist2) + self.club(dist1, dist2)
