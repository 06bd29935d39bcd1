"""Run one cell of BENCHMARK.json once and build its result line.

Everything a cell needs is found by name: the configuration's file
(``configs/<config>.json``, the ``file`` BENCHMARK.json names), the
traffic mix (``traffic/<traffic>.json``), the limits of its comparison
(``limits/<cell>.json``) and one reader a metric (``metrics/<name>.py``,
or the file of the name's stem, ``reader``).
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones; every run checks its outputs against the
plain reference.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from h100_bench.check import verdict
from h100_bench.loops import LOOPS
from h100_bench.readers import busy_s
from h100_bench.trace import Stretch, breakdown

BENCH = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "chap_tpu")


class Measurements(NamedTuple):
    """What a run measured, as the metric readers see it."""
    loop: str                    # the traffic mix's loop
    units: int                   # samples (train) or voxels (eval) of the window
    window_units: int            # steps or volumes of the window
    window_s: float
    setup_s: float
    enqueue_s: List[float]       # host seconds of each step call (train)
    peak_window_bytes: int
    stretch: Optional[Stretch]   # the profiled stretch (--trace 1)
    flops_per_unit: Optional[int]  # of a step or of a volume's forwards
    peak_flops: float
    k_bytes: Dict[str, int]      # the kernels' bytes a step or a volume


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def deep_update(base: dict, extra: dict) -> dict:
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_cell(manifest: dict, root: Path, name: str,
              overrides: Optional[dict] = None) -> Tuple[dict, dict, dict]:
    """(configuration, traffic mix, limits) of cell ``name``, each read
    from its file; ``overrides`` ({'config': {...}, 'pool': {...},
    'traffic': {...}}) is merged in: the CPU tests run a cell at small
    sizes."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf_file = {c["name"]: c["file"] for c in manifest["configs"]}[cell["config"]]
    conf = load_json(root / conf_file)
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")
    overrides = overrides or {}
    deep_update(conf, {k: v for k, v in overrides.items() if k != "traffic"})
    deep_update(traffic, overrides.get("traffic", {}))
    return conf, traffic, limits


def reader(name: str) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<stem>.py`` for the longest
    stem of the name, cut at a dot, that has a file, so that
    ``device.idle_pct.slices`` is read by ``device.idle_pct.py``. Unit,
    layer and the metric it moves are BENCHMARK.json's alone."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            break
    else:
        raise FileNotFoundError(f"no reader of metric {name!r} under metrics/")
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: end to end, or per layer."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, root: Path, t_start: float,
             overrides: Optional[dict] = None) -> Tuple[dict, Dict[str, dict]]:
    """Run cell ``name`` once; returns (result line, numbers compared);
    ``overrides`` as ``load_cell`` takes them."""
    manifest = load_json(root / "BENCHMARK.json")
    conf, traffic, limits = load_cell(manifest, root, name, overrides)
    readers = {m["name"]: reader(m["name"]) for m in cell_metrics(manifest, name, trace)}

    cuda = device.type == "cuda"
    run = LOOPS[traffic["loop"]](conf, traffic, seed, device, trace,
                                 root / "build" / "h100_bench")
    run.setup()
    if cuda:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    units, window_s = run.window(seconds)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    stretch = run.stretch() if trace and cuda else None
    run.release()
    numbers, flops = run.check(count=trace, wanted=limits)
    correct, shown = verdict(numbers, limits)

    m = Measurements(traffic["loop"], units, run.window_units, window_s, setup_s,
                     run.enqueue_s, peak_window, stretch, flops, run.peak_flops(),
                     run.k_bytes())
    metrics = {}
    for entry in cell_metrics(manifest, name, trace):
        value = readers[entry["name"]].read(m)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(peak_setup, peak_window)) if cuda else 0}
    if cuda:
        dev["power_limit"] = power_limit()
    if stretch is not None:
        dev["busy_s"], dev["window_s"] = busy_s(stretch, run.window_units), window_s
    line = {"correct": bool(correct), "attempted": run.window_units, "failed": 0,
            "metrics": metrics, "device": dev}
    if stretch is not None:
        line["breakdown"] = breakdown(stretch)
    line["checks"] = shown
    return line, shown


def forbidden_modules() -> List[str]:
    """Top-level names of ``FORBIDDEN`` modules loaded in this process."""
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def main(argv: List[str], t_start: float) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = BENCH.parent
    manifest = load_json(root / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, shown = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), root, t_start)
    found = forbidden_modules()
    if found:
        print(f"modules the run may not load: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, s in shown.items():
        print(f"check {k} {s['value']!r} limit {s['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
