"""Cross-entropy / MSE primitives (port of chap_tpu/losses/ce.py), class
axis 1 (NCHW)."""
from __future__ import annotations

import torch

from h100_bench.reference.models.layers import log_softmax
from h100_bench.reference.parallel import dist


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


def kl_div_per_pixel(log_q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """KL(p || q) summed over the class axis 1, per pixel, with 0 log 0 = 0
    (torch F.kl_div(log_q, p, reduction='none').sum(1))."""
    safe_logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-30)),
                            torch.zeros((), dtype=p.dtype, device=p.device))
    return (p * (safe_logp - log_q)).sum(dim=1)
