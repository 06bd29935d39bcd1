"""K1's arithmetic in plain PyTorch: masked dice + cross-entropy over one
or two regions (a frozen copy of the port's plain versions in
``ops/fused_losses.py``), differentiated by autograd on every device.

For logits [B, C, *spatial], p = softmax over C and R in {1, 2} regions,
region r with integer labels l_r and weight w_r (w_1 = mask, w_2 = 1 -
mask), t_r = one_hot(l_r):
    I_rc = sum w_r p_c t_rc,  Z_rc = sum w_r p_c^2,  Y_rc = sum w_r t_rc,
    CE_rc = sum w_r t_rc (-log p_c),
    dice_r = mean_c 1 - (2 I_rc + s) / (Z_rc + Y_rc + s),
    ce_r = sum_c CE_rc / (sum_c Y_rc + eps).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch



# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _class_view(logits: torch.Tensor) -> torch.Tensor:
    """Class indices shaped [1, C, 1, ...] against logits [B, C, *spatial]."""
    c = logits.shape[1]
    return torch.arange(c, device=logits.device).view(
        (1, c) + (1,) * (logits.dim() - 2))


def _regions(mask: Optional[torch.Tensor], labels: torch.Tensor,
             labels2: Optional[torch.Tensor]):
    """[(labels, weight)] per region; mask None weighs every pixel 1."""
    if mask is None:
        if labels2 is not None:
            raise ValueError("mask=None (every pixel counts) takes one "
                             "region: region 2 is weighed by 1 - mask")
        return [(labels, torch.ones(labels.shape, device=labels.device))]
    m = mask.float()
    if labels2 is None:
        return [(labels, m)]
    return [(labels, m), (labels2, 1.0 - m)]


def region_stats_plain(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor],
                       labels2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1's statistics: [R, 4, C] rows (I, Z, Y, CE) per
    class for region 1 (labels, mask) and, with ``labels2``, region 2
    (labels2, 1 - mask). Logits [B, C, *spatial], integer labels of any
    dtype, mask None for every pixel (one region); differentiable."""
    x = logits.float()
    p = torch.softmax(x, dim=1)
    logp = torch.log_softmax(x, dim=1)
    cls = _class_view(logits)
    dims = (0,) + tuple(range(2, logits.dim()))
    rows = []
    for lab, w in _regions(mask, labels, labels2):
        t = (lab.unsqueeze(1) == cls).float()
        wt = w.unsqueeze(1) * t
        rows.append(torch.stack([(p * wt).sum(dims),
                                 (p * p * w.unsqueeze(1)).sum(dims),
                                 wt.sum(dims),
                                 (-logp * wt).sum(dims)]))
    return torch.stack(rows)


def compose_plain(stats: torch.Tensor, smooth_dice: float,
                  eps_ce: float) -> torch.Tensor:
    """[R, 4, C] statistics -> [R, 2] (dice, ce) per region."""
    inter, z, y, ce_c = stats.unbind(1)
    dice = torch.mean(1.0 - (2.0 * inter + smooth_dice)
                      / (z + y + smooth_dice), dim=1)
    ce = ce_c.sum(1) / (y.sum(1) + eps_ce)
    return torch.stack([dice, ce], dim=1)


def region_dice_ce(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor],
                   labels2: Optional[torch.Tensor] = None,
                   smooth_dice: float = 1e-10, eps_ce: float = 1e-16
                   ) -> Tuple[torch.Tensor, ...]:
    """(dice_1, ce_1[, dice_2, ce_2]), differentiable in ``logits`` by
    autograd: region 1 is (labels, mask), region 2 (labels2, 1 - mask);
    ``mask=None`` (one region) counts every pixel."""
    stats = region_stats_plain(logits, labels, mask, labels2)
    losses = compose_plain(stats, smooth_dice, eps_ce)
    return tuple(losses.view(-1).unbind())


def fused_masked_dice_ce(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor], smooth_dice: float = 1e-10,
                         eps_ce: float = 1e-16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_dice_loss, masked_ce_loss) over one region."""
    return region_dice_ce(logits, labels, mask, None, smooth_dice, eps_ce)
