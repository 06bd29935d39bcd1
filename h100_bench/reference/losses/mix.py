"""BCP mixed-supervision loss (port of chap_tpu/losses/mix.py).

A mixed input is supervised by its "image" label inside mask==1 and its
"patch" label inside mask==0. Both regions go through one call of K1
(ops/fused_losses.py, R = 2): one read of the logits gives both regions'
losses, and one backward launch both regions' gradient; a CPU tensor takes
K1's plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from h100_bench.reference.ops.fused_losses import region_dice_ce


def mix_loss(logits: torch.Tensor, img_l: torch.Tensor, patch_l: torch.Tensor,
             mask: torch.Tensor, num_classes: int, l_weight: float = 1.0,
             u_weight: float = 0.5, unlab: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss_image, loss_patch, total) like the reference's
    (loss_image, loss_patch, (dice+ce)/2) triple.

    logits: [B, C, *spatial] (2D [H, W] or 3D [X, Y, Z]); img_l / patch_l:
    integer [B, *spatial]; mask: {0,1} [B, *spatial], 1 selecting the
    surviving "image" region."""
    if logits.shape[1] != num_classes:
        raise ValueError(f"logits have {logits.shape[1]} classes, expected "
                         f"{num_classes}")
    image_weight, patch_weight = (u_weight, l_weight) if unlab else (l_weight, u_weight)
    d1, c1, d2, c2 = region_dice_ce(logits, img_l, mask.float(), patch_l)
    loss_dice1, loss_ce1 = d1 * image_weight, image_weight * c1
    loss_dice2, loss_ce2 = d2 * patch_weight, patch_weight * c2
    loss_image = (loss_dice1 + loss_ce1) / 2.0
    loss_patch = (loss_dice2 + loss_ce2) / 2.0
    total = (loss_dice1 + loss_dice2 + loss_ce1 + loss_ce2) / 2.0
    return loss_image, loss_patch, total
