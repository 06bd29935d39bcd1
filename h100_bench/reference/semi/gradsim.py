"""Gradient-similarity channel scoring, GradSim (port of
chap_tpu/semi/gradsim.py).

Per encoder level, the EMA of the per-output-channel cosine similarity
between the labeled-loss and the unlabeled-loss gradient of that level's
final conv weight. The weights are torch's [O, I, kh, kw], so the
per-channel vector is ``w.reshape(O, -1)``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

# the final conv of each encoder level's ConvBlock, as torch parameter names
ENCODER_LEVEL_PATHS = (
    "encoder.in_conv.conv_conv.4.weight",
    "encoder.down1.maxpool_conv.1.conv_conv.4.weight",
    "encoder.down2.maxpool_conv.1.conv_conv.4.weight",
    "encoder.down3.maxpool_conv.1.conv_conv.4.weight",
    "encoder.down4.maxpool_conv.1.conv_conv.4.weight",
)

# the VNet 3D encoder (models/vnet3d.py VEncoder, batchnorm): the final conv
# of each scale's ConvBlock3d, stages (1, 2, 3, 3, 3), chap_tpu's
# VNET_LEVEL_PATHS (gradsim.py:37-43) as module paths. A [O, I, kx, ky, kz]
# weight holds the same per-channel elements as chap_tpu's kernel, in
# another order, which the cosine does not see.
VNET_LEVEL_PATHS = (
    "encoder.block_one.conv.0.weight",
    "encoder.block_two.conv.3.weight",
    "encoder.block_three.conv.6.weight",
    "encoder.block_four.conv.6.weight",
    "encoder.block_five.conv.6.weight",
)


def init_sim_scores(feature_chns: Sequence[int], device=None) -> List[torch.Tensor]:
    """All-zero scores. Zeros are scores, not "no scores": perform_dropout
    takes the score path, where they give drop probability sigmoid(0) = 0.5
    with the numel/sum rescale (chap_tpu behaves the same)."""
    return [torch.zeros(c, dtype=torch.float32, device=device) for c in feature_chns]


def level_weights(model: torch.nn.Module,
                  paths: Sequence[str] = ENCODER_LEVEL_PATHS) -> List[torch.Tensor]:
    params = dict(model.named_parameters())
    return [params[p] for p in paths]


def update_grad_sim(state: Sequence[torch.Tensor], grads_l: Sequence[torch.Tensor],
                    grads_u: Sequence[torch.Tensor], decay: float = 0.9
                    ) -> List[torch.Tensor]:
    """EMA-update per-level per-channel cos(g_labeled, g_unlabeled).
    grads_*: the level weights' gradients, each [O, I, *kernel]."""
    new_state = []
    for old, gl, gu in zip(state, grads_l, grads_u):
        a = gl.reshape(gl.shape[0], -1)
        b = gu.reshape(gu.shape[0], -1)
        na = torch.linalg.vector_norm(a, dim=1)
        nb = torch.linalg.vector_norm(b, dim=1)
        cos = (a * b).sum(dim=1) / (na * nb + 1e-12)
        new_state.append(decay * old + (1 - decay) * cos)
    return new_state
