"""Top-k disagreement patch mask gating the VAT loss (port of
chap_tpu/semi/patchmask.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def create_mask_v1(pseudo1: torch.Tensor, pseudo2: torch.Tensor,
                   knowledge: torch.Tensor, scale_factor: int = 4,
                   topk: float = 0.1) -> torch.Tensor:
    """pseudo1 / pseudo2: [B, H, W] integer maps; knowledge: [B, H, W]
    per-pixel cross-CE. Returns a float {0,1} mask [B, H, W] selecting each
    sample's top-k highest-conflict scale_factor patches. The threshold is
    the k-th largest patch score and the test is ``>=``, so ties are kept.
    A trailing remainder joins the last patch row / column."""
    if knowledge.dim() != 3:
        raise ValueError("create_mask_v1 is ported for 2D maps [B, H, W]")
    b, h, w = knowledge.shape
    gh, gw = max(1, h // scale_factor), max(1, w // scale_factor)
    th, tw = gh * scale_factor, gw * scale_factor
    score = (pseudo1 != pseudo2).float() + knowledge
    score = score[:, :th, :tw]
    patches = score.reshape(b, gh, scale_factor, gw, scale_factor).mean(dim=(2, 4))
    flat = patches.reshape(b, gh * gw)
    k = max(1, int(round(topk * gh * gw)))
    kth = torch.topk(flat, k, dim=1).values[:, -1]
    keep = (flat >= kth[:, None]).float().reshape(b, gh, gw)
    keep = keep.repeat_interleave(scale_factor, 1).repeat_interleave(scale_factor, 2)
    if (th, tw) != (h, w):
        keep = F.pad(keep[:, None], (0, w - tw, 0, h - th), mode="replicate")[:, 0]
    return keep
