"""Cross-entropy / MSE primitives (port of chap_tpu/losses/ce.py), class
axis 1 (NCHW)."""
from __future__ import annotations

import torch

from chap_tpu_torch.models.layers import log_softmax
from chap_tpu_torch.parallel import dist


def cross_entropy_per_pixel(logits: torch.Tensor, labels: torch.Tensor
                            ) -> torch.Tensor:
    """Per-pixel CE, no reduction. logits [B, C, ...], labels integer [B, ...]
    (torch F.cross_entropy(reduction='none'))."""
    logp = log_softmax(logits, 1)
    return -torch.gather(logp, 1, labels.long().unsqueeze(1)).squeeze(1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE (torch CrossEntropyLoss default reduction), over the global
    batch with W > 1 ranks (parallel/dist.py ``global_mean``)."""
    return dist.global_mean(cross_entropy_per_pixel(logits, labels))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """sum(CE * mask) / (sum(mask) + eps) (train_ours_2D.py:208-209)."""
    ce = cross_entropy_per_pixel(logits, labels)
    m = mask.to(ce.dtype)
    return (ce * m).sum() / (m.sum() + eps)


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def mse_loss_noreduction(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b) ** 2


def kl_div_per_pixel(log_q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """KL(p || q) summed over the class axis 1, per pixel, with 0 log 0 = 0
    (torch F.kl_div(log_q, p, reduction='none').sum(1))."""
    safe_logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-30)),
                            torch.zeros((), dtype=p.dtype, device=p.device))
    return (p * (safe_logp - log_q)).sum(dim=1)
