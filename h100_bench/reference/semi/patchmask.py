"""Top-k disagreement patch mask gating the VAT loss (port of
chap_tpu/semi/patchmask.py). Rank-generic: [B, H, W] maps give a 2D patch
grid, [B, X, Y, Z] maps a 3D one."""
from __future__ import annotations

import torch


def create_mask_v1(pseudo1: torch.Tensor, pseudo2: torch.Tensor,
                   knowledge: torch.Tensor, scale_factor: int = 4,
                   topk: float = 0.1) -> torch.Tensor:
    """pseudo1 / pseudo2: [B, *spatial] integer maps; knowledge: [B, *spatial]
    per-pixel cross-CE. Returns a float {0,1} mask [B, *spatial] selecting
    each sample's top-k highest-conflict patches of side scale_factor. The
    threshold is the k-th largest patch score and the test is ``>=``, so
    ties are kept. A trailing remainder along an axis joins its last patch."""
    b, spatial = knowledge.shape[0], tuple(knowledge.shape[1:])
    grid = tuple(max(1, s // scale_factor) for s in spatial)
    score = (pseudo1 != pseudo2).float() + knowledge
    score = score[(slice(None),) + tuple(slice(0, g * scale_factor) for g in grid)]
    pooled = (b,)
    for g in grid:
        pooled += (g, scale_factor)
    patches = score.reshape(pooled).mean(dim=tuple(2 + 2 * i for i in range(len(grid))))
    flat = patches.flatten(1)
    k = max(1, int(round(topk * flat.shape[1])))
    kth = torch.topk(flat, k, dim=1).values[:, -1]
    keep = (flat >= kth[:, None]).float().reshape((b,) + grid)
    # each pixel takes its patch's value; the remainder takes the last patch's
    for axis, (s, g) in enumerate(zip(spatial, grid)):
        src = (torch.arange(s, device=keep.device) // scale_factor).clamp(max=g - 1)
        keep = keep.index_select(1 + axis, src)
    return keep
