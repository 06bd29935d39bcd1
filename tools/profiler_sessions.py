"""Count the torch.profiler sessions that lose device kernels of K1's
Function, on one CUDA card.

chip_smoke.py counts the device kernels of K1's forward and backward with
torch.profiler (``kernel_counts``). This script repeats such a session many
times at phase 3's LA patch shape, [1, 2, 112, 112, 80] with R = 2, three
calls a session, two ways in turns: a bare session (fn's first launch
right after the session opens, as chip_smoke.py did before its marker
kernel and pauses) and ``chip_smoke.device_kernels``. A session lost
kernels when a kernel shows fewer than three times. For the bare sessions
it also reports the least gap between a kernel's start and its launch
call's start on the profiler's clock (negative: the device and host
clocks disagree by that much) and the first kernel's offset from the
session's start. Run from the repository's root:

    PYTHONPATH=. python3 tools/profiler_sessions.py --sessions 200

Prints one ``profiler_sessions`` JSON line and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from chap_tpu_torch.ops import fused_losses

CUDA = torch.autograd.DeviceType.CUDA


def bare_session(fn, n: int):
    """(kernel counts, least kernel-minus-launch start in ns, first
    kernel's start after the session's in ns) of one session."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    events = res.events()
    kernels = [e for e in events if e.device_type() == CUDA]
    launch = {e.correlation_id(): e for e in events
              if e.device_type() != CUDA and "aunch" in e.name()}
    gaps = [k.start_ns() - launch[k.correlation_id()].start_ns()
            for k in kernels if k.correlation_id() in launch]
    first = min((k.start_ns() for k in kernels), default=None)
    return (collections.Counter(k.name() for k in kernels),
            min(gaps, default=None),
            None if first is None else first - res.trace_start_ns())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=200,
                    help="sessions of each kind and direction")
    args = ap.parse_args()
    logits, labels, labels2, mask = chip_smoke.k1_inputs(
        (1, 2) + chip_smoke.LA_PATCH, 4, 2)
    x = logits.clone().requires_grad_(True)
    vals = fused_losses.region_dice_ce(x, labels, mask, labels2)
    grads = [torch.tensor(w, device="cuda") for w in (0.5, 0.35, 0.25, 0.6)]
    fns = {"fwd": lambda: fused_losses.region_dice_ce(x, labels, mask, labels2),
           "bwd": lambda: torch.autograd.grad(vals, [x], grads, retain_graph=True)}
    for fn in fns.values():     # compile and warm up
        fn()
    out = {f"{d}_{kind}": {"sessions": 0, "lost": 0, "lost_counts": []}
           for d in fns for kind in ("bare", "device_kernels")}
    least_gap, first_after = {}, {}
    rounds = 4
    for _ in range(rounds):
        for d, fn in fns.items():
            for kind in ("bare", "device_kernels"):
                st = out[f"{d}_{kind}"]
                for _ in range(args.sessions // rounds):
                    if kind == "bare":
                        counts, gap, first = bare_session(fn, 3)
                        if gap is not None:
                            least_gap[d] = min(gap, least_gap.get(d, gap))
                        if first is not None:
                            first_after.setdefault(d, []).append(first)
                    else:
                        counts = collections.Counter(
                            name for name, _ in chip_smoke.device_kernels(fn, 3))
                    st["sessions"] += 1
                    if not counts or min(counts.values()) < 3:
                        st["lost"] += 1
                        if len(st["lost_counts"]) < 5:
                            st["lost_counts"].append(dict(counts))
    for d, firsts in first_after.items():
        firsts.sort()
        out[f"{d}_bare"]["least_kernel_minus_launch_ns"] = least_gap.get(d)
        out[f"{d}_bare"]["first_kernel_after_start_ns"] = {
            "min": firsts[0], "median": firsts[len(firsts) // 2], "max": firsts[-1]}
    print("profiler_sessions", json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
