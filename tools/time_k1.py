"""Time K1 at every timed row of chip_smoke.py's phase 3, in whichever tree
of the port is first on the import path, on one CUDA card.

It holds two trees' K1 against each other on one card (one K1 Triton, the
other CUDA C++, say): run it once per tree from that tree's root with
``PYTHONPATH=.``, all in one command, in the order A B B A:

    cd <tree> && PYTHONPATH=. python3 <this file> --tag A --out <jsonl>

Each row is that tree's ``chip_smoke.phase_k1(..., timed=True)`` (the same
inputs from the same seeds in both trees: int32 labels and an fp32 mask),
which also holds the kernels to their plain version; the script keeps its
forward and backward figures (kernel ms from torch.profiler, device ms a
launch over 100 back-to-back calls, host us a call, the bounds) and, where
the tree times them, the figures at the supervised callers' inputs (uint8
labels, no mask). Prints one ``time_k1`` JSON line per row (also appended
to ``--out``) and the card's name and power limit. ``--summary <jsonl>``
prints each row's figures over the runs of every tag in that file.
"""
from __future__ import annotations

import argparse
import json

import torch

import chip_smoke

BF16 = torch.bfloat16
# (row, shape, seed, regions, dtype): phase 3's timed calls
ROWS = (("2d", (6, 4, 256, 256), 1, 2, torch.float32),
        ("2d_r1", (6, 4, 256, 256), 1, 1, torch.float32),
        ("3d", (1, 2) + chip_smoke.LA_PATCH, 4, 2, torch.float32),
        ("3d_r1", (2, 2) + chip_smoke.LA_PATCH, 4, 1, torch.float32),
        ("acal", (12, 4, 256, 256), 6, 1, torch.float32),
        ("brats", (4, 2) + chip_smoke.BRATS_PATCH, 7, 1, torch.float32),
        ("bf16", (1, 2) + chip_smoke.LA_PATCH, 8, 2, BF16),
        ("bf16_r1", (2, 2) + chip_smoke.LA_PATCH, 8, 1, BF16),
        ("bf16_brats", (4, 2) + chip_smoke.BRATS_PATCH, 9, 1, BF16),
        ("bf16_acal", (12, 4, 256, 256), 10, 1, BF16),
        ("bf16_zoo2d", (24, 4, 256, 256), 12, 1, BF16),
        ("zoo2d", (24, 4, 256, 256), 11, 1, torch.float32))
KEEP = ("kernel_ms", "device_ms", "host_us", "single_call_ms", "kernel_ms_by_name")


def summary(path: str) -> None:
    """One ``time_k1_summary`` line per row and direction from a jsonl of
    runs: each tag's kernel ms, host us and device ms a launch (every run's,
    and their mean), the bounds and the mean kernel ms over the bound."""
    runs = [json.loads(line) for line in open(path)]
    for row in dict.fromkeys(r["row"] for r in runs):
        for d in ("fwd", "bwd"):
            of_row = [r for r in runs if r["row"] == row]
            out = {"row": row, "dir": d, "shape": of_row[0]["shape"],
                   "regions": of_row[0]["regions"], "dtype": of_row[0]["dtype"],
                   "bound_ms": of_row[0][f"{d}_bound_ms"],
                   "caller_bound_ms": of_row[0].get(f"{d}_caller_bound_ms")}
            for tag in dict.fromkeys(r["tag"] for r in of_row):
                mine = [r for r in of_row if r["tag"] == tag]
                for key in ("kernel_ms", "host_us", "device_ms"):
                    vals = [r[d][key] for r in mine]
                    out[f"{tag}_{key}"] = vals
                    out[f"{tag}_{key}_mean"] = sum(vals) / len(vals)
                out[f"{tag}_x_bound"] = out[f"{tag}_kernel_ms_mean"] / out["bound_ms"]
                callers = [r[f"{d}_caller"] for r in mine if f"{d}_caller" in r]
                if callers:
                    for key in ("kernel_ms", "host_us", "device_ms"):
                        out[f"{tag}_caller_{key}"] = [c[key] for c in callers]
                    out[f"{tag}_caller_x_bound"] = (
                        sum(c["kernel_ms"] for c in callers) / len(callers)
                        / out["caller_bound_ms"])
            print("time_k1_summary", json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag")
    ap.add_argument("--out", default="build/time_k1.jsonl")
    ap.add_argument("--summary", metavar="JSONL",
                    help="summarise the runs in this file (no card needed)")
    args = ap.parse_args()
    if args.summary:
        summary(args.summary)
        return
    if not args.tag:
        ap.error("--tag is required to time")
    chip_smoke.set_tf32(False)
    card = chip_smoke.card_line()
    with open(args.out, "a") as log:
        for row, shape, seed, regions, dtype in ROWS:
            res = chip_smoke.phase_k1(shape, seed, regions, timed=True, dtype=dtype)
            out = {"tag": args.tag, "row": row, "shape": list(shape), "regions": regions,
                   "dtype": str(dtype), "card": card}
            for d in ("fwd", "bwd"):
                out[d] = {k: res[d][k] for k in KEEP}
                out[f"{d}_bound_ms"] = res[f"{d}_bound"][0]
                out[f"{d}_plain_ms"] = res[f"{d}_plain_ms"]
                if f"{d}_caller_bound" in res:
                    out[f"{d}_caller_bound_ms"] = res[f"{d}_caller_bound"][0]
                if f"{d}_caller" in res:
                    out[f"{d}_caller"] = {k: res[f"{d}_caller"][k] for k in KEEP}
            print("time_k1", json.dumps(out), flush=True)
            log.write(json.dumps(out) + "\n")
    print(card, flush=True)


if __name__ == "__main__":
    main()
