"""Readings that the limits of ``correct`` are set from (PERF.md gives
them), on the card at the cell's own size, one process a cell:

    python3 h100_bench/calibrate.py --workload acdc_chap.train \
        --seeds 101-112 --control-seeds 101-104 --out build/cal.jsonl

For every seed the program's readings: the cell's set-up (for a train
cell its checked steps, for the eval cell one pass over the volumes)
against the reference: for a train cell in float32 with TF32 off, for
the eval cell at the configuration's own precision; for a CHAP cell also
``pseudo1`` against the reference's first step at the configuration's own
precision (TF32 for float32). For each control seed besides:
the control, the reference computed a precision below the
configuration's (bf16 for float32, float8 operands for bf16), against the
same fp32 reference; the reference at the configuration's own precision;
and each fault the cell can have, planted in the reference put in the
program's place (half of the batch left out) or in the program's answer
(a label map shifted by one voxel). A state left unchanged reads 1 by the
leaf-gap measure and needs no run. One JSON line a reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100_bench.check import label_share, pseudo_moved, train_numbers  # noqa: E402
from h100_bench.harness import load_cell, load_json  # noqa: E402
from h100_bench.loops import LOOPS, tf32  # noqa: E402

CONTROL = {"float32": "bfloat16", "bfloat16": "float8"}


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON merged into the cell's files (a CPU rehearsal "
                         "at small sizes, as harness.run_cell takes it)")
    args = ap.parse_args()
    conf, traffic, _ = load_cell(load_json(ROOT / "BENCHMARK.json"), ROOT,
                                 args.workload, json.loads(args.overrides))
    control_seeds = set(seeds(args.control_seeds)) if args.control_seeds else set()
    device = torch.device(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as out:
        def emit(**rec):
            rec["workload"] = args.workload
            line = json.dumps(rec)
            out.write(line + "\n")
            out.flush()
            print(line, flush=True)

        for seed in seeds(args.seeds):
            t0 = time.perf_counter()
            run = LOOPS[traffic["loop"]](conf, traffic, seed, device, False,
                                         ROOT / "build" / "h100_bench")
            run.setup()
            own = run.cfg.model.dtype
            control = CONTROL[own]
            if traffic["loop"] == "train":
                run.release()
                tf32(False)
                ref = run.reference_record("float32")
                own_ref = None
                if run.mode == "chap":
                    # step 1 at the configuration's own precision: pseudo1
                    tf32(True)
                    own_ref = run.reference_record(own, steps=1)
                    tf32(False)

                def pseudo(rec):
                    return pseudo_moved(rec, own_ref) if own_ref else {}
                emit(seed=seed, side="program", **train_numbers(run.program, ref, 5),
                     **pseudo(run.program))
                if seed in control_seeds:
                    ctrl = run.reference_record(control)
                    emit(seed=seed, side="control_" + control,
                         **train_numbers(ctrl, ref, 5), **pseudo(ctrl))
                    half = run.reference_record("float32", fault="half_batch")
                    emit(seed=seed, side="fault_half_batch",
                         **train_numbers(half, ref, 5), **pseudo(half))
                    if own == "float32":
                        tf32(True)
                    same = run.reference_record(own)
                    emit(seed=seed, side="reference_" + own
                         + ("_tf32" if own == "float32" else ""),
                         **train_numbers(same, ref, 5))
                    emit(seed=seed, side="program_vs_reference_" + own,
                         **train_numbers(run.program, same, 5))
                    if ref["pseudo"]:
                        # the look: how many pseudo-labels each precision moves
                        emit(seed=seed, side="pseudo_label_share_moved", **{
                            name: [float((a != b).float().mean())
                                   for a, b in zip(rec["pseudo"], ref["pseudo"])]
                            for name, rec in (("control", ctrl), ("same", same),
                                              ("half_batch", half))})
                tf32(True)
            else:
                run.run_volumes(traffic["volumes"])
                run.release()
                vids = run.checked_volumes()
                tf32(False)
                # the eval cell's reference computes at the configuration's
                # precision: the program agrees with it voxel for voxel
                ref, _ = run.reference_labels(own, vids)
                prog = {v: run.labels[v] for v in vids}
                emit(seed=seed, side="program", **label_share(prog, ref))
                if seed in control_seeds:
                    ctrl, _ = run.reference_labels(control, vids)
                    emit(seed=seed, side="control_" + control,
                         **label_share(ctrl, ref))
                    fp32, _ = run.reference_labels("float32", vids)
                    emit(seed=seed, side="reference_float32",
                         **label_share(fp32, ref))
                    emit(seed=seed, side="program_vs_reference_float32",
                         **label_share(prog, fp32))
                    emit(seed=seed, side="fault_shifted_answer", **label_share(
                        {v: np.roll(prog[v], 1, axis=0) for v in vids}, ref))
                tf32(True)
            emit(seed=seed, side="seconds", seconds=time.perf_counter() - t0)
            del run
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
