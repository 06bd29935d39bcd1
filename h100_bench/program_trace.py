"""The program's own host spans in the traced run's device trace: the
``chap.*`` spans that chap_tpu_torch records while a profiler records
(chap_tpu_torch/utils/spans.py), reduced beside ``trace.reduce_trace``.

``trace.reduce_trace`` reads the ``bench.*`` spans alone. ``install()``
wraps it where ``trace.profile_stretch`` looks it up by name, so that the
same events are reduced once more here; the wrapper returns the Stretch
the inner reduction made, and keeps this reduction beside it (``program``
finds it by that Stretch). Every field of the Stretch, and every metric
read from it, stays as it was. A reader that imports this module calls
``install()``; the harness loads the readers before the run.

What the reduction reads:

* The stretch's thread is the one that holds ``bench.stretch``. Its
  ``chap.*`` and ``bench.*`` spans, but ``chap.model.pass`` (a count, not
  a phase), are the places the host can be in.
* Idle: each idle interval of the stretch (as ``reduce_trace`` finds them:
  no device operation running) is cut at the edges of those spans, and
  each piece goes to the innermost one covering it (``host_other``
  outside all).
* A device operation goes to the innermost of those spans that held the
  stretch's thread when its launching runtime call was made, whatever
  thread made it (autograd's backward launches from a thread of its own
  while the caller waits in ``chap.step.backward``; ``host_other``
  outside all).
* Launches a step: the device operations whose launching call, on any
  thread, falls inside a ``chap.step`` span.
* Passes: the ``chap.model.pass`` spans on any thread inside the stretch,
  recomputations under remat included.
* Gaps: the ten longest of those idle pieces, with their span and start.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

from h100_bench import trace
from h100_bench.readers import busy_s

PASS = "chap.model.pass"
STEP = "chap.step"


class ProgramStretch(NamedTuple):
    """What the program's spans showed in one profiled stretch."""
    units: int
    steps: List[float]              # chap.step starts after the stretch's
    idle_s: Dict[str, float]        # idle seconds by innermost span
    host_s: Dict[str, float]        # host seconds in each span name
    device_s: Dict[str, float]      # device seconds by span at launch
    launches: Dict[str, int]        # device operations by span at launch
    step_launches: int              # device operations launched in chap.step
    passes: int                     # chap.model.pass spans
    gaps: List[Tuple[str, float, float]]  # the longest idle pieces: (span,
                                          # seconds, start after the stretch's)


def reduce_program(events: List[dict], units: int) -> ProgramStretch:
    """Reduce a Chrome trace's events (times in microseconds) to a
    ``ProgramStretch``; the trace must hold one ``bench.stretch`` span."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(("bench.", "chap."))]
    stretch = [e for e in marks if e["name"] == trace.STRETCH]
    if len(stretch) != 1:
        raise ValueError(f"the trace holds {len(stretch)} {trace.STRETCH} spans")
    lo = stretch[0]["ts"]
    hi = lo + stretch[0].get("dur", 0.0)
    tid = stretch[0].get("tid")
    places: List[Tuple[float, float, str]] = []
    host_s: Dict[str, float] = {}
    steps: List[Tuple[float, float]] = []
    passes = 0
    for e in marks:
        a, b, name = e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]
        if name == PASS:
            passes += lo <= a <= hi
            continue
        if e.get("tid") != tid or name == trace.STRETCH:
            continue
        places.append((a, b, name))
        host_s[name] = host_s.get(name, 0.0) + (b - a) * 1e-6
        if name == STEP:
            steps.append((a, b))

    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    ops = []
    device_s: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    step_launches = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if b > a:
            ops.append((a, b))
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        step_launches += any(s <= t <= f for s, f in steps)
        name = trace._innermost(places, t) or "host_other"
        launches[name] = launches.get(name, 0) + 1
        device_s[name] = device_s.get(name, 0.0) + e.get("dur", 0.0) * 1e-6

    busy = trace._union(ops)
    edges = [lo] + [v for iv in busy for v in iv] + [hi]
    idle_s: Dict[str, float] = {}
    pieces = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        cuts = sorted({a, b} | {t for s in places for t in s[:2] if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            name = trace._innermost(places, (x + y) / 2) or "host_other"
            idle_s[name] = idle_s.get(name, 0.0) + (y - x) * 1e-6
            pieces.append((name, (y - x) * 1e-6, (x - lo) * 1e-6))
    pieces.sort(key=lambda g: -g[1])
    return ProgramStretch(units, [(a - lo) * 1e-6 for a, _ in steps], idle_s, host_s, device_s, launches,
                          step_launches, passes, pieces[:10])


# the last few (Stretch, ProgramStretch) pairs, newest last
_KEPT: List[Tuple[trace.Stretch, ProgramStretch]] = []


def install() -> None:
    """Wrap ``trace.reduce_trace`` (once) so that each reduction of a
    stretch also reduces the program's spans and keeps the result."""
    inner = trace.reduce_trace
    if getattr(inner, "keeps_program", False):
        return

    @functools.wraps(inner)
    def reduce_trace(events: List[dict], units: int) -> trace.Stretch:
        stretch = inner(events, units)
        _KEPT.append((stretch, reduce_program(events, units)))
        del _KEPT[:-4]
        return stretch
    reduce_trace.keeps_program = True
    trace.reduce_trace = reduce_trace


def program(m) -> Optional[ProgramStretch]:
    """The program's reduction of the run's profiled stretch, or None (no
    stretch, or a program that recorded no ``chap.*`` span in it)."""
    kept = [p for s, p in _KEPT if s is m.stretch]
    if m.stretch is None or not kept:
        return None
    p = kept[-1]
    return p if any(k.startswith("chap.") for k in p.host_s) else None


def idle_ms(m, name: str) -> Optional[float]:
    """Device idle ms a step (or volume) of the window while the host was
    in span ``name``: its share of the stretch's idle time times the
    window's idle time a step (the window's, as ``device.idle_pct``: the
    profiler slows a host-paced step). None where the span never ran."""
    p, s = program(m), m.stretch
    if p is None or name not in p.host_s:
        return None
    stretch_idle = s.window_s - s.busy_s
    if stretch_idle <= 0:
        return 0.0
    window_idle = (m.window_s - busy_s(s, m.window_units)) / m.window_units
    return 1e3 * p.idle_s.get(name, 0.0) / stretch_idle * window_idle


def step_launches(m) -> Optional[float]:
    """Device operations launched inside ``chap.step`` a step."""
    p = program(m)
    return None if p is None or not p.steps else p.step_launches / p.units


def passes(m) -> Optional[float]:
    """``chap.model.pass`` spans a step, recomputations included."""
    p = program(m)
    return None if p is None or not p.steps else p.passes / p.units


def host_ms(m, name: str) -> Optional[float]:
    """Host ms a step (or volume) inside span ``name``, as profiled."""
    p = program(m)
    if p is None or name not in p.host_s:
        return None
    return 1e3 * p.host_s[name] / p.units
