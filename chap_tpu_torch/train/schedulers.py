"""LR schedule family (port of chap_tpu/train/schedulers.py; the
reference's networks_other.get_scheduler, :95-142).

The trainers use the poly schedule (train/state.make_lr_schedule); these
are the other policies of get_scheduler, as plain Python callables of the
epoch (or step) that return the LR multiplier: multiply the base LR by it,
or hand it to torch.optim.lr_scheduler.LambdaLR. 'plateau' is stateful and
metric-driven: a small host-side controller the loop consults after each
eval.
"""
from __future__ import annotations

from typing import Callable, Sequence


def lambda_linear(niter: int, niter_decay: int, epoch_count: int = 1
                  ) -> Callable[[int], float]:
    """'lambda': flat, then a linear decay to 0 over niter_decay epochs
    (networks_other.py:98-101)."""
    def schedule(epoch: int) -> float:
        over = max(0, epoch + 1 + epoch_count - niter)
        return 1.0 - over / float(niter_decay + 1)
    return schedule


def step_decay(step_size: int, gamma: float = 0.5) -> Callable[[int], float]:
    """'step' (gamma 0.5) / 'step2' (gamma 0.1): times gamma every
    step_size epochs (networks_other.py:102-105)."""
    def schedule(epoch: int) -> float:
        return gamma ** (epoch // step_size)
    return schedule


def step_warmstart(boundaries: Sequence[int] = (5, 100, 200)
                   ) -> Callable[[int], float]:
    """'step_warmstart': 0.1 warm-up, then 1.0, 0.1, 0.01 piecewise
    (networks_other.py:111-123); 'step_warmstart2' at (5, 50, 100)."""
    b0, b1, b2 = boundaries

    def schedule(epoch: int) -> float:
        if epoch < b0:
            return 0.1
        if epoch < b1:
            return 1.0
        return 0.1 if epoch < b2 else 0.01
    return schedule


class ReduceLROnPlateau:
    """'plateau' / 'plateau2' (networks_other.py:106-110): mode 'min',
    relative threshold 0.01, patience 5, factor 0.1 / 0.2. Call
    ``step(metric)`` after each eval; multiply the base LR by ``scale``."""

    def __init__(self, factor: float = 0.1, patience: int = 5,
                 threshold: float = 0.01):
        self.factor, self.patience, self.threshold = factor, patience, threshold
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


def get_lr_schedule(policy: str, **opt):
    """get_scheduler's policy names (networks_other.py:95-142): a
    multiplier schedule, or a ReduceLROnPlateau controller for the plateau
    policies."""
    if policy == "lambda":
        return lambda_linear(opt["niter"], opt["niter_decay"],
                             opt.get("epoch_count", 1))
    if policy == "step":
        return step_decay(opt["lr_decay_iters"], 0.5)
    if policy == "step2":
        return step_decay(opt["lr_decay_iters"], 0.1)
    if policy == "plateau":
        return ReduceLROnPlateau(factor=0.1)
    if policy == "plateau2":
        return ReduceLROnPlateau(factor=0.2)
    if policy == "step_warmstart":
        return step_warmstart((5, 100, 200))
    if policy == "step_warmstart2":
        return step_warmstart((5, 50, 100))
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")
