"""Where the host was while the card idled: the program's ``chap.*`` spans
in the traced run of benchmark cells, span by span, on one CUDA card.

    python3 tools/span_report.py --cells acdc_chap.train la_chap.eval \\
        --seed 7 --seconds 25 --out build/span_report.jsonl
    python3 tools/span_report.py --cost acdc_chap.train --repeats 3

With ``--cells`` each cell runs once with ``--trace 1`` through
``h100_bench.harness.run_cell`` (one process, one cell after another) and
prints its result line and one ``spans`` line: for each span of the
stretch's thread, host ms, device ms and launches a step (or volume) of
the device operations launched while the host was in it (innermost
span), the stretch's idle ms a step in it (raw) and the same scaled to
the window as the ``step.idle_ms`` and ``eval.idle_ms`` metrics scale it;
then the share of the operations launched in ``chap.step`` that were
launched in one of its phases, and the share of the idle time in
``bench.enqueue`` / ``bench.finalize`` that the four read stages hold.

With ``--cost`` it builds one train cell as a run does and profiles its
stretch ``--repeats`` times with the program's spans on and as many with
them off (the ``span`` the program's modules call, replaced by the shared
no-op), in turns, and prints the stretch's wall ms a step of each: the
spans' host cost while a profiler records. Both print the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from h100_bench import program_trace  # noqa: E402
from h100_bench.harness import (load_cell, load_json, power_limit,  # noqa: E402
                                run_cell)
from h100_bench.loops import LOOPS  # noqa: E402
from h100_bench.readers import busy_s  # noqa: E402

PHASE = "chap.step."
READ_STAGES = ("chap.sw.upload", "chap.sw.forward", "chap.sw.copy", "chap.sw.nms")
EVAL_PLACES = ("bench.enqueue", "bench.finalize", "chap.sw.upload",
               "chap.sw.forward", "chap.sw.argmax", "chap.sw.copy", "chap.sw.nms")


def span_table(line: dict, stretch, p) -> dict:
    """The ``spans`` line of one traced run (module docstring)."""
    units, window_units = p.units, line["attempted"]
    window_s = line["device"]["window_s"]
    stretch_idle = stretch.window_s - stretch.busy_s
    window_idle = (window_s - busy_s(stretch, window_units)) / window_units
    names = sorted(set(p.host_s) | set(p.idle_s) | set(p.launches))
    rows = {}
    for n in names:
        idle = p.idle_s.get(n, 0.0)
        rows[n] = {"host_ms": 1e3 * p.host_s.get(n, 0.0) / units,
                   "device_ms": 1e3 * p.device_s.get(n, 0.0) / units,
                   "launches": p.launches.get(n, 0) / units,
                   "idle_ms_raw": 1e3 * idle / units,
                   "idle_ms_scaled": (1e3 * idle / stretch_idle * window_idle
                                      if stretch_idle > 0 else 0.0)}
    out = {"spans": rows, "units": units,
           "stretch_ms": 1e3 * stretch.window_s / units,
           "stretch_idle_ms": 1e3 * stretch_idle / units,
           "window_idle_ms": 1e3 * window_idle,
           "step_launches": p.step_launches / units, "passes": p.passes / units,
           "gaps_ms": [[n, 1e3 * g, 1e3 * t] for n, g, t in p.gaps],
           "step_starts_ms": [1e3 * t for t in p.steps]}
    in_step = sum(v for k, v in p.launches.items() if k.startswith("chap.step"))
    if in_step:
        in_phases = sum(v for k, v in p.launches.items() if k.startswith(PHASE))
        out["phase_launch_share"] = in_phases / in_step
    eval_idle = sum(p.idle_s.get(k, 0.0) for k in EVAL_PLACES)
    if eval_idle:
        out["stage_idle_share"] = sum(p.idle_s.get(k, 0.0)
                                      for k in READ_STAGES) / eval_idle
    return out


def report(cells, seed: int, seconds: float, out: Path) -> None:
    program_trace.install()
    dev = torch.device("cuda", 0)
    for i, cell in enumerate(cells):
        line, _ = run_cell(cell, seed + i, seconds, True, dev, ROOT,
                           time.perf_counter())
        stretch, p = program_trace._KEPT[-1]
        rows = {"cell": cell, "seed": seed + i, "line": line,
                "table": span_table(line, stretch, p)}
        print(json.dumps(rows), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rows) + "\n")


def set_spans(on: bool) -> None:
    """Give each module that calls ``span`` the real one, or the no-op."""
    from chap_tpu_torch.data import device_data
    from chap_tpu_torch.eval import sliding_window
    from chap_tpu_torch.train import step_chap, step_supervised
    from chap_tpu_torch.utils import spans
    for module in (device_data, sliding_window, step_chap, step_supervised):
        module.span = spans.span if on else (lambda name: spans._OFF)


def cost(cell: str, seed: int, repeats: int, out: Path) -> None:
    program_trace.install()
    manifest = load_json(ROOT / "BENCHMARK.json")
    conf, traffic, _ = load_cell(manifest, ROOT, cell)
    run = LOOPS[traffic["loop"]](conf, traffic, seed, torch.device("cuda", 0), True,
                                 ROOT / "build" / "h100_bench")
    run.setup()
    ms = {"on": [], "off": []}
    gaps = {"on": [], "off": []}
    for k in range(2 * repeats):
        mode = ("on", "off")[k % 2]
        set_spans(mode == "on")
        s = run.stretch()
        ms[mode].append(1e3 * s.window_s / s.units)
        p = program_trace._KEPT[-1][1]
        gaps[mode].append({"steps_ms": [1e3 * t for t in p.steps],
                           "longest_ms": [[n, 1e3 * g, 1e3 * t]
                                          for n, g, t in p.gaps[:3]]})
    set_spans(True)
    run.release()
    rows = {"cell": cell, "seed": seed, "stretch_ms_a_step": ms, "gaps_ms": gaps,
            "median_on": statistics.median(ms["on"]),
            "median_off": statistics.median(ms["off"])}
    print(json.dumps(rows), flush=True)
    with out.open("a") as f:
        f.write(json.dumps(rows) + "\n")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", nargs="*", default=[])
    parser.add_argument("--cost", default=None)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 101)
    parser.add_argument("--seconds", type=float, default=25.0)
    parser.add_argument("--out", type=Path,
                        default=ROOT / "build" / "span_report.jsonl")
    args = parser.parse_args()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": power_limit(), "torch": torch.__version__}), flush=True)
    if args.cells:
        report(args.cells, args.seed, args.seconds, args.out)
    if args.cost:
        cost(args.cost, args.seed, args.repeats, args.out)


if __name__ == "__main__":
    main()
