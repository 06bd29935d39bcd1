"""Train state: step, model (parameters and BN running stats), SGD with
momentum, GradSim scores (port of chap_tpu/train/state.py).

chap_tpu's TrainState is an immutable pytree the jitted step maps to a new
one. Here the state holds the model and its optimizer, and the step updates
them in place (parameters by ``optimizer.step()``, BN running stats by a
``copy_`` into the model's buffers, momentum inside the optimizer) to keep
one copy of each in memory.

SGD: ``torch.optim.SGD(lr, momentum=0.9, weight_decay=1e-4)`` adds the weight
decay to the gradient and then applies momentum, which is chap_tpu's
``optax.chain(add_decayed_weights, sgd(momentum))`` (state.py:35-42). The LR
is base * (1 - min(k, max) / max) ** 0.9 at the step count k BEFORE the
increment, as optax evaluates its schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn as nn

from chap_tpu_torch.models.layers import BN_MOMENTUM, BatchNorm2d
from chap_tpu_torch.semi.gradsim import init_sim_scores


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    sim_scores: List[torch.Tensor] = field(default_factory=list)


def make_lr_schedule(base_lr: float, max_iterations: int, power: float = 0.9
                     ) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        frac = 1.0 - min(step, max_iterations) / max_iterations
        return base_lr * frac ** power
    return schedule


def make_optimizer(model: nn.Module, base_lr: float, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.SGD:
    """torch SGD: grad += wd * param, then the momentum buffer, then lr."""
    return torch.optim.SGD(model.parameters(), lr=base_lr, momentum=momentum,
                           weight_decay=weight_decay)


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       sim_chns: Sequence[int] = ()) -> TrainState:
    device = next(model.parameters()).device
    return TrainState(step=0, model=model, optimizer=optimizer,
                      sim_scores=init_sim_scores(sim_chns, device))


def bn_running_stats(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{stats_key: (running_mean, running_var)} of the model's BatchNorms —
    the buffers themselves, not copies."""
    return {m.stats_key: (m.running_mean, m.running_var)
            for m in model.modules() if isinstance(m, BatchNorm2d)}



def fold_batch_stats(model: nn.Module,
                     pass_stats: Sequence[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]]
                     ) -> None:
    """Fold the batch statistics of train-mode passes, in order, into the
    model's BN running stats with Flax's momentum (running = 0.9 * running
    + 0.1 * batch per pass), in place."""
    with torch.no_grad():
        for key, (mean, var) in bn_running_stats(model).items():
            new_mean, new_var = mean.clone(), var.clone()
            for stats in pass_stats:
                b_mean, b_var = stats[key]
                new_mean = BN_MOMENTUM * new_mean + (1 - BN_MOMENTUM) * b_mean
                new_var = BN_MOMENTUM * new_var + (1 - BN_MOMENTUM) * b_var
            mean.copy_(new_mean)
            var.copy_(new_var)
