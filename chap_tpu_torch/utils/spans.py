"""Named host spans at the port's layer boundaries, recorded only while a
``torch.profiler`` session records.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records on the calling thread (autograd's threads inherit the session), so
the span lands in the same Kineto trace as the kernels, on its clock and
with its thread id; a kernel is tied to the span its launching runtime call
fell in through the call's ``correlation``. Otherwise it is one shared
``contextlib.nullcontext()``: no allocation, and about a twentieth of a
bare ``record_function``'s host cost. There is no switch: to see the spans,
profile, e.g. wrap a few iterations of ``cli/train_2d.py``'s loop in
``torch.profiler.profile(activities=[ProfilerActivity.CPU,
ProfilerActivity.CUDA])`` and open the exported Chrome trace.

The names, all under ``chap.``:
    chap.step             a train step's body (train/step_chap.py,
                          train/step_supervised.py)
    chap.step.<phase>     its phases, directly under chap.step: draws,
                          teacher, nms, student, dropout, vat, gradsim,
                          backward, update (CHAP); draws, forward, backward,
                          update (supervised)
    chap.model.pass       one train-mode pass of the CHAP step, each
                          recomputation under ``optim.remat`` included
    chap.data.batch       a device batch or patch function (data/device_data.py)
    chap.sw.<stage>       the sliding-window engine (eval/sliding_window.py):
                          upload, forward (one a patch batch), argmax, copy, nms
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the span ``name`` while a profiler records, else
    a shared no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
