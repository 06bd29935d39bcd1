"""Worst-case estimation loss (port of chap_tpu/losses/worst_case.py),
class axis 1.

chap_tpu reconstructs it from the reference's staging
``losses.WorstCaseEstimationLoss(loss_type=...)``
(train_share_encoder_2D.py:197), which builds it and never calls it; no
trainer calls it here either. Two terms over NCHW logits:

  * labeled:   the adversarial head's logits match the main head's hard
               labeled predictions (CE, or MSE on probabilities);
  * unlabeled: the adversarial head is pushed away from the main head's
               hard predictions, -log(1 - p) under a shifted, clipped log.
"""
from __future__ import annotations

import torch


def _shift_log(x: torch.Tensor, offset: float = 1e-6) -> torch.Tensor:
    """log(x + offset) clipped to <= log(1): a safe log(1 - p)."""
    return torch.log(torch.clamp(x + offset, max=1.0))


def worst_case_estimation_loss(y_l: torch.Tensor, y_l_adv: torch.Tensor,
                               y_u: torch.Tensor, y_u_adv: torch.Tensor,
                               loss_type: str = "ce",
                               eta_prime: float = 2.0) -> torch.Tensor:
    """y_l / y_u: the main head's labeled / unlabeled logits [B, C, ...]
    (detached targets); y_l_adv / y_u_adv: the adversarial head's logits on
    the same inputs. Returns eta_prime * labeled term + unlabeled term."""
    pred_l = y_l.detach().argmax(dim=1, keepdim=True)
    if loss_type == "ce":
        logp = torch.log_softmax(y_l_adv, dim=1)
        loss_l = -torch.gather(logp, 1, pred_l).mean()
    elif loss_type == "mse":
        loss_l = ((torch.softmax(y_l_adv, dim=1)
                   - torch.softmax(y_l.detach(), dim=1)) ** 2).mean()
    else:
        raise ValueError(f"unknown worst-case loss_type {loss_type!r}")
    pred_u = y_u.detach().argmax(dim=1, keepdim=True)
    p_adv = torch.softmax(y_u_adv, dim=1)
    loss_u = -torch.gather(_shift_log(1.0 - p_adv), 1, pred_u).mean()
    return eta_prime * loss_l + loss_u


class WorstCaseEstimationLoss:
    """The reference's constructor, ``WorstCaseEstimationLoss(loss_type=...)``
    (train_share_encoder_2D.py:197)."""

    def __init__(self, loss_type: str = "ce", eta_prime: float = 2.0):
        if loss_type not in ("ce", "mse"):
            raise ValueError(f"unknown worst-case loss_type {loss_type!r}")
        self.loss_type = loss_type
        self.eta_prime = eta_prime

    def __call__(self, y_l, y_l_adv, y_u, y_u_adv):
        return worst_case_estimation_loss(y_l, y_l_adv, y_u, y_u_adv,
                                          self.loss_type, self.eta_prime)
