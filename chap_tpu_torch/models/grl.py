"""Gradient reversal with a warm-start coefficient (port of
chap_tpu/models/grl.py; the reference's grl.py:12-81).

``gradient_reverse`` is the identity forward; its backward gives -coeff *
g to the input and no gradient to ``coeff``, as chap_tpu's custom VJP
(grl.py:14-26). ``warm_start_coeff`` is lambda(step) = 2 (hi - lo) / (1 +
exp(-alpha * p)) - (hi - lo) + lo at p = min(step, max_iters) / max_iters.
"""
from __future__ import annotations

import math
from typing import Union

import torch


class _GradientReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff):
        ctx.save_for_backward(coeff)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (coeff,) = ctx.saved_tensors
        return -coeff.to(g.dtype) * g, None


def gradient_reverse(x: torch.Tensor, coeff: Union[float, torch.Tensor]
                     ) -> torch.Tensor:
    """x unchanged; the gradient through it is scaled by -coeff."""
    return _GradientReverse.apply(x, torch.as_tensor(coeff, device=x.device))


def warm_start_coeff(step: float, alpha: float = 1.0, lo: float = 0.0,
                     hi: float = 1.0, max_iters: int = 1000) -> float:
    """The warm schedule of grl.py:71-74, as a float."""
    p = min(float(step), max_iters) / max_iters
    return 2.0 * (hi - lo) / (1.0 + math.exp(-alpha * p)) - (hi - lo) + lo
