"""The traced run's device trace: a short steady stretch under
``torch.profiler``, exported as a Chrome trace and reduced to what the
per-layer metrics read.

* Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events; the device is busy over the union of their
  intervals.
* The stretch is the host span ``bench.stretch`` around its calls and the
  ``synchronize()`` after them, on the trace's own clock.
* A kernel belongs to the ``bench.*`` span in which the host launched it:
  its ``correlation`` names the runtime call that launched it, whatever
  thread made that call (autograd's backward launches from a thread of
  its own while the caller waits inside the span).
* An idle gap is named by the innermost ``bench.*`` span the host was in
  at the gap's middle.
* The session opens with a marker kernel and pauses at both ends, as
  ``chip_smoke.device_kernels`` does: a session has lost the first kernel
  launched right after it opened.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench.stretch"
MARGIN_S = 0.05


def kernel_class(name: str) -> str:
    """The class of a device operation by its name (``chip_smoke.py``'s
    ``_kernel_class``, with copies and fills apart)."""
    n = name.lower()
    if "k1_stats" in n or "k1_total" in n:
        return "K1_fwd"
    if "k1_grad" in n:
        return "K1_bwd"
    if "ccl3_" in n:
        return "K2_ccl3d"
    if "ccl_" in n:
        return "K2_ccl"
    if "sw_accumulate" in n:
        return "K3_sw"
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copy_fill"
    if "batch_norm" in n or "batchnorm" in n or "bn_" in n or "welford" in n:
        return "batchnorm"
    if any(k in n for k in ("conv", "xmma", "gemm", "cudnn", "wgrad", "dgrad",
                            "implicit", "winograd", "cutlass", "sm90")):
        return "conv"
    if "upsample" in n or "interp" in n or "max_pool" in n or "pool" in n:
        return "pool_upsample"
    if "reduce" in n or "softmax" in n:
        return "reduce_softmax"
    return "elementwise_other"


class Stretch(NamedTuple):
    """What one profiled stretch of ``units`` steps or volumes showed."""
    units: int
    window_s: float
    busy_s: float
    class_s: Dict[str, float]           # device seconds by kernel class
    span_s: Dict[str, float]            # device seconds by launching span
    gaps: List[Tuple[str, float]]       # idle gaps, longest first


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(spans: List[Tuple[float, float, str]], t: float) -> Optional[str]:
    """The shortest span that holds time ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


def reduce_trace(events: List[dict], units: int) -> Stretch:
    """Reduce a Chrome trace's events (times in microseconds) to a
    ``Stretch``; the trace must hold one ``bench.stretch`` span."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.")]
    stretch = [s for s in spans if s[2] == STRETCH]
    if len(stretch) != 1:
        raise ValueError(f"the trace holds {len(stretch)} {STRETCH} spans")
    lo, hi = stretch[0][:2]
    inner = [s for s in spans if s[2] != STRETCH]
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    ops = []
    class_s: Dict[str, float] = {}
    span_s: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if b <= a:
            continue
        ops.append((a, b))
        sec = (b - a) * 1e-6
        cls = kernel_class(str(e.get("name", "")))
        class_s[cls] = class_s.get(cls, 0.0) + sec
        t_launch = launch_ts.get(e.get("args", {}).get("correlation"))
        if t_launch is not None:
            name = _innermost(inner, t_launch) or "none"
            span_s[name] = span_s.get(name, 0.0) + sec
    busy = _union(ops)
    edges = [lo] + [v for iv in busy for v in iv] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_innermost(inner, (a + b) / 2) or "host_other",
                         (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Stretch(units, (hi - lo) * 1e-6, sum(b - a for a, b in busy) * 1e-6,
                   class_s, span_s, gaps)


@contextmanager
def span(name: str, on: bool):
    """A ``torch.profiler.record_function`` span named ``name`` when
    ``on``; nothing otherwise."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def profile_stretch(run_units: Callable[[], int], out: Path) -> Stretch:
    """Profile ``run_units()`` (which runs some steps or volumes inside
    ``bench.*`` spans and returns how many) in one session, export the
    Chrome trace to ``out`` and reduce it; the trace file is removed."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        with torch.profiler.record_function(STRETCH):
            units = run_units()
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    try:
        events = json.loads(out.read_text())["traceEvents"]
    finally:
        out.unlink(missing_ok=True)
    return reduce_trace(events, units)


def breakdown(stretch: Stretch) -> dict:
    """The result line's ``breakdown``: the kernel classes that took most
    device time and the longest idle gaps, ten each, in seconds."""
    ops = sorted(stretch.class_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in stretch.gaps[:10]]}
