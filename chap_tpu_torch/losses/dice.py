"""Dice-family losses (port of chap_tpu/losses/dice.py), class axis 1."""
from __future__ import annotations

import torch

from chap_tpu_torch.ops.fused_losses import fused_masked_dice_ce
from chap_tpu_torch.parallel import dist


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer label map [B, ...] -> one-hot [B, C, ...] float32."""
    cls = torch.arange(num_classes, device=labels.device)
    cls = cls.view((1, num_classes) + (1,) * (labels.dim() - 1))
    return (labels.unsqueeze(1) == cls).float()


def _class_sums(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(0,) + tuple(range(2, x.dim())))


def dice_loss(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
              smooth: float = 1e-5) -> torch.Tensor:
    """Mean over classes of 1 - (2<p,t> + s) / (|p|^2 + |t|^2 + s).
    probs: [B, C, ...] softmax probabilities; labels: integer [B, ...]."""
    target = one_hot(labels, num_classes)
    intersect = _class_sums(probs * target)
    y_sum = _class_sums(target * target)
    z_sum = _class_sums(probs * probs)
    return torch.mean(1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth))


def dice_loss_bcp(probs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  num_classes: int, smooth: float = 1e-10) -> torch.Tensor:
    """Masked dice: sums restricted to mask==1 pixels (BCP mixing loss)."""
    target = one_hot(labels, num_classes)
    m = mask.float().unsqueeze(1)
    intersect = _class_sums(probs * target * m)
    y_sum = _class_sums(target * target * m)
    z_sum = _class_sums(probs * probs * m)
    return torch.mean(1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth))


def dice_ce_supervised(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """The supervised arm 0.5 * (CE + Dice) (train_share_encoder_2D.py:322-327),
    through K1 with an all-ones mask (its plain version on the CPU)."""
    if logits.shape[1] != num_classes:
        raise ValueError(f"logits have {logits.shape[1]} classes, expected "
                         f"{num_classes}")
    ones = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    dice, ce = fused_masked_dice_ce(logits, labels, ones, smooth_dice=1e-5)
    return 0.5 * (ce + dice)


def soft_dice_loss_masked(probs1: torch.Tensor, probs2: torch.Tensor,
                          mask: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """Dice between two soft probability maps [B, C, ...] restricted to
    mask==1 (train_share_encoder_2D.py:253-254); its class sums run over the
    global batch with W > 1 ranks (the VAT divergence's ``dice`` type)."""
    m = mask.float().unsqueeze(1)
    intersect, s1, s2 = dist.global_sums(_class_sums(probs1 * probs2 * m),
                                         _class_sums(probs1 * probs1 * m),
                                         _class_sums(probs2 * probs2 * m))
    return torch.mean(1.0 - (2.0 * intersect + smooth) / (s1 + s2 + smooth))
