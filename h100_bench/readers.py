"""What the metric readers (``metrics/<name>.py``) take from a run's
``harness.Measurements``. Each function returns None where the run has
nothing to read, and the harness then leaves the metric out of the line;
a share of a roofline or of a peak is never 0 for want of a reading."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

from h100_bench.counts.peaks import FLOP_PER_S, HBM_BYTES_PER_S


def rate(m, loop: str, scale: float = 1.0) -> Optional[float]:
    """Units of work (samples, voxels) over the window's wall time."""
    return m.units / m.window_s / scale if m.loop == loop else None


def busy_s(stretch, window_units: int) -> float:
    """The device's busy seconds in the traced run's window: the union of
    the device operations' intervals a step (or volume) of the profiled
    stretch, times the window's steps. The profiler slows the host's
    launches by as much as 2x, so the stretch's own wall time would read
    a host-paced cell's device as far idler than it is unprofiled."""
    return stretch.busy_s / stretch.units * window_units


def span_ms(m, span: str) -> Optional[float]:
    """Device ms a step of the kernels launched inside ``span``."""
    s = m.stretch
    if s is None or span not in s.span_s:
        return None
    return s.span_s[span] * 1e3 / s.units


def class_ms(m, kernel_class: str) -> Optional[float]:
    """Device ms a step of one class of kernels (trace.kernel_class)."""
    s = m.stretch
    if s is None or kernel_class not in s.class_s:
        return None
    return s.class_s[kernel_class] * 1e3 / s.units


def enqueue_ms(m) -> Optional[float]:
    """Median host ms for a step call to return, without a sync."""
    if m.stretch is None or not m.enqueue_s:
        return None
    return statistics.median(m.enqueue_s) * 1e3


def mfu_pct(m, peak: Optional[float] = None) -> Optional[float]:
    """FLOPs a step (or volume) times the window's steps, over the window,
    as a share of ``peak`` (default: the configuration's precision's)."""
    if m.stretch is None or not m.flops_per_unit:
        return None
    return (100.0 * m.flops_per_unit * m.window_units / m.window_s
            / (peak or m.peak_flops))


def roofline_pct(m, kernel: str, classes: Sequence[str]) -> Optional[float]:
    """A kernel's least time a step (its bytes at HBM's peak,
    counts/kernel_bytes.py) over its profiled time a step."""
    s = m.stretch
    if s is None or kernel not in m.k_bytes:
        return None
    t = sum(s.class_s.get(c, 0.0) for c in classes)
    if t <= 0:
        return None
    return 100.0 * m.k_bytes[kernel] / HBM_BYTES_PER_S / (t / s.units)


def idle_pct(m) -> Optional[float]:
    """The share of the traced run's window in which no device operation
    ran (``busy_s`` says why the window and not the stretch)."""
    s = m.stretch
    if s is None or not s.units:
        return None
    return 100.0 * (1.0 - busy_s(s, m.window_units) / m.window_s)


def peak_mem_gib(m) -> Optional[float]:
    """max_memory_allocated() over the window, after a reset at its start."""
    return m.peak_window_bytes / 2 ** 30 if m.peak_window_bytes else None


BF16_PEAK = FLOP_PER_S["bfloat16"]
