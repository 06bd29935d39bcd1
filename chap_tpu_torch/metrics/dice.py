"""Dice metrics on tensors (port of chap_tpu/metrics/dice.py), for training
signals on the device; the host-side medpy-exact metrics are in
metrics/surface.py. The class axis is 1 (NCHW), where chap_tpu's is last.
"""
from __future__ import annotations

import torch


def soft_dice(probs: torch.Tensor, onehot: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Soft dice score per class, averaged. probs / onehot: [B, C, ...]."""
    axes = (0,) + tuple(range(2, probs.dim()))
    inter = torch.sum(probs * onehot, dim=axes)
    denom = torch.sum(probs, dim=axes) + torch.sum(onehot, dim=axes)
    return torch.mean((2.0 * inter + eps) / (denom + eps))


def hard_dice(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
              eps: float = 1e-6) -> torch.Tensor:
    """Per-foreground-class hard dice of integer label maps: a
    [num_classes - 1] vector (classes 1..C-1), 2|A∩B| / (|A| + |B|)."""
    scores = []
    for c in range(1, num_classes):
        p = (pred == c).float()
        g = (gt == c).float()
        scores.append(2.0 * torch.sum(p * g) / (torch.sum(p) + torch.sum(g) + eps))
    return torch.stack(scores)
