"""Model cost helpers: parameter count, a FLOP count, and a forward /
forward-backward timer (port of chap_tpu/utils/timing.py; the reference's
ptflops blocks, vnet.py:338-352, ResNet2d.py:535-553, and its CUDA-event
timer, networks_other.py:203-258).

``flops_estimate`` counts with torch.utils.flop_counter.FlopCounterMode
(2 per multiply-add of the convolutions and matrix products, nothing for
elementwise ops), which is not XLA's cost analysis: chap_tpu's figure is
another count of the same model. ``benchmark_fwd_bwd`` times with CUDA
events on the card and with perf_counter after a sync on the CPU.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """FlopCounterMode's total for one call of ``fn(*args)`` (None if it
    cannot count it)."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except RuntimeError:
        return None


def _first(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _ms_per_call(fn: Callable[[], None], num_iters: int, device: torch.device
                 ) -> float:
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(num_iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / num_iters
    t0 = time.perf_counter()
    for _ in range(num_iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / num_iters


def benchmark_fwd_bwd(model: nn.Module, sample: torch.Tensor, num_iters: int = 10,
                      train: bool = True) -> Dict[str, float]:
    """{'fwd_ms', 'fwd_bwd_ms', 'params'} of ``model`` on ``sample`` (on
    the model's device): the forward in eval mode, and the forward in
    ``train`` mode with the backward of its first output's sum; one
    warm-up call each."""
    device = sample.device
    was_training = model.training

    def fwd():
        with torch.no_grad():
            model(sample)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        _first(model(sample)).sum().backward()

    try:
        model.eval()
        fwd()
        fwd_ms = _ms_per_call(fwd, num_iters, device)
        model.train(train)
        fwd_bwd()
        fwd_bwd_ms = _ms_per_call(fwd_bwd, num_iters, device)
    finally:
        model.zero_grad(set_to_none=True)
        model.train(was_training)
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms, "params": param_count(model)}
