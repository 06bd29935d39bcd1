"""Virtual adversarial training for the dual-decoder model (port of
chap_tpu/losses/vat.py:25-103).

Power iteration finds the divergence-maximising input direction, then the
divergence of the adversarial pass against both decoders' clean soft targets
is penalised inside the top-k disagreement mask. The power iteration takes
``torch.autograd.grad`` with respect to ``d`` only, so it leaves no
parameter gradient, like chap_tpu's stop-gradient on ``d``. The initial
uniform draw of ``d`` can be passed in. Everything runs in x's dtype, as in
chap_tpu: in bf16 the direction is bf16 and ``working_uniform`` makes the
draw one that chap_tpu's bf16 ``jax.random.uniform`` can give.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from chap_tpu_torch.losses.ce import kl_div_per_pixel
from chap_tpu_torch.models.layers import log_softmax, reduced_dtype, softmax
from chap_tpu_torch.losses.dice import soft_dice_loss_masked
from chap_tpu_torch.parallel import dist

ApplyFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def working_uniform(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A [0, 1) uniform draw as ``jax.random.uniform(..., dtype=dtype)``
    makes it (chap_tpu/losses/vat.py:73): below float32 JAX fills only the
    dtype's mantissa bits, so a bf16 draw is a multiple of 2^-7 below 1
    (rounding a float32 draw to the nearest bf16 could give 1.0). Floor to
    that grid; float32 (and float64) draws pass unchanged."""
    if not reduced_dtype(dtype):
        return u.to(dtype)
    eps = torch.finfo(dtype).eps
    return (torch.floor(u.float() / eps) * eps).to(dtype)


def l2_normalize_batch(d: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize each batch element's perturbation to unit L2 norm."""
    norm = torch.linalg.vector_norm(d.reshape(d.shape[0], -1), dim=1)
    return d / (norm.reshape((-1,) + (1,) * (d.dim() - 1)) + eps)


def _divergence(logits1: torch.Tensor, logits2: torch.Tensor,
                soft1: torch.Tensor, soft2: torch.Tensor,
                mask: torch.Tensor, losstype: str) -> torch.Tensor:
    """Masked divergence of perturbed predictions vs. the clean soft targets
    (logits / soft: [B, C, *spatial]; mask: [B, *spatial]), over the global
    batch with W > 1 ranks (its sums all-reduced, parallel/dist.py)."""
    if losstype == "kl":
        kl1 = kl_div_per_pixel(log_softmax(logits1, 1), soft1)
        kl2 = kl_div_per_pixel(log_softmax(logits2, 1), soft2)
        m = mask.to(kl1.dtype)
        sum1, sum2, m_sum = dist.global_sums((kl1 * m).sum(), (kl2 * m).sum(),
                                             m.sum())
        denom = m_sum + 1e-16
        return (sum1 + sum2) / denom
    if losstype == "dice":
        return (soft_dice_loss_masked(softmax(logits1, 1), soft1, mask)
                + soft_dice_loss_masked(softmax(logits2, 1), soft2, mask))
    raise ValueError(f"unknown adv_losstype {losstype!r}")


def vat_direction(apply_fn: ApplyFn, x: torch.Tensor, soft1: torch.Tensor,
                  soft2: torch.Tensor, mask: torch.Tensor,
                  d0: Optional[torch.Tensor] = None,
                  xi: float = 10.0, num_iters: int = 1,
                  losstype: str = "kl") -> torch.Tensor:
    """Power iteration only: the unit adversarial direction d (detached).
    d0: the initial uniform [0, 1) draw, shaped like x (drawn from the
    global generator when None), taken in x's dtype (``working_uniform``)."""
    soft1, soft2 = soft1.detach(), soft2.detach()
    if d0 is None:
        d0 = torch.rand(x.shape, device=x.device)
    d = l2_normalize_batch(working_uniform(d0, x.dtype) - 0.5)
    for _ in range(num_iters):
        d_req = d.detach().requires_grad_(True)
        l1, l2 = apply_fn(x + xi * d_req)
        dist = _divergence(l1, l2, soft1, soft2, mask, losstype)
        (grad_d,) = torch.autograd.grad(dist, [d_req])
        d = l2_normalize_batch(grad_d)
    return d.detach()


def vat_loss_2d(apply_fn: ApplyFn, x: torch.Tensor, soft1: torch.Tensor,
                soft2: torch.Tensor, mask: torch.Tensor,
                d0: Optional[torch.Tensor] = None,
                xi: float = 10.0, epi: float = 6.0, num_iters: int = 1,
                losstype: str = "kl") -> torch.Tensor:
    """VAT loss against a dual-headed model.

    apply_fn: x -> (logits1, logits2) with the parameters bound; parameter
    gradients flow through the final adversarial pass only. Rank-generic, as
    chap_tpu's: x [B, Cin, *spatial] (2D [H, W] or 3D [X, Y, Z]); soft1 /
    soft2: [B, C, *spatial] clean soft predictions; mask: [B, *spatial]."""
    d = vat_direction(apply_fn, x, soft1, soft2, mask, d0, xi=xi,
                      num_iters=num_iters, losstype=losstype)
    l1, l2 = apply_fn(x + epi * d)
    return _divergence(l1, l2, soft1.detach(), soft2.detach(), mask, losstype)
