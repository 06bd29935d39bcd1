"""Dump and compare what Triton compiled for K1 at fp32 and at bf16 logits,
on one CUDA card.

K1 was a set of Triton kernels (``stats_partials``, ``stats_finalize``,
``stats_grad``) up to commit dabe82d, where its bf16 build ran 2-4.6x
slower than its fp32 build although it reads half the logits' bytes. This
script launches those kernels as that tree's wrappers did, at the LA
patch [1, 2, 112, 112, 80] with R = 2 and the BraTS batch [4, 2, 96, 96,
96] with R = 1, in fp32 and bf16, and for each compiled kernel reports:
registers and spills, the global loads and stores of its PTX by opcode
(width and vector count), its 64-bit integer divisions and remainders
(``div.s64`` / ``rem.s64``), its PTX and SASS instruction counts, the
SASS loads by opcode (``LDG.E.128`` ...), the blocked layouts of its
Triton GPU IR (elements per thread), and its device time per launch
(CUDA events over 50 launches). The PTX, SASS and Triton GPU IR of each go
to ``--out``. Run from the root of a tree whose ``chap_tpu_torch`` still
holds the Triton K1, e.g. the commit above unpacked into build/parent:

    PYTHONPATH=build/parent python3 tools/k1_triton_asm.py \\
        --out build/k1_triton_asm

Prints one ``k1_triton_asm`` JSON line per kernel and build, and the
card's name and power limit. ``--from <dir>`` summarises the files of an
earlier run again, on any machine.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import math
import os
import re
import subprocess

import torch

SHAPES = {"la_r2": ((1, 2, 112, 112, 80), 2), "brats_r1": ((4, 2, 96, 96, 96), 1)}


def inputs(shape, regions, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, *spatial = shape
    logits = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dtype)
    labs = [torch.randint(0, c, (b, *spatial), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(regions)]
    mask = (torch.rand((b, *spatial), generator=gen, device="cuda") < 0.6).float()
    return logits, labs[0], labs[-1], mask


def launchers(logits, lab1, lab2, mask, regions):
    """name -> a function that launches that Triton kernel once, with the
    arguments the tree's wrappers give it, and returns the compiled kernel."""
    from chap_tpu_torch.ops import fused_losses

    partials_k, finalize_k, grad_k = fused_losses._kernels()
    c = logits.shape[1]
    n_pix = lab1.numel()
    hw = math.prod(logits.shape[2:])
    c_pad = fused_losses._next_pow2(c)
    block = fused_losses.BLOCK
    n_part = max(1, min(-(-n_pix // block), fused_losses.PROGRAMS_PER_SM
                        * torch.cuda.get_device_properties(0).multi_processor_count))
    part = torch.empty((n_part, regions * 4 * c_pad), device="cuda")
    out = torch.empty((regions * 4 * c_pad + 2 * regions,), device="cuda")
    stats = torch.rand((regions, 4, c_pad), device="cuda") * n_pix
    g = [torch.tensor(v, device="cuda") for v in (0.5, 0.35, 0.25, 0.6)]
    grad = torch.empty_like(logits)
    return {
        "stats_partials": lambda: partials_k[(n_part,)](
            logits, lab1, lab2, mask, part, n_pix, hw, C=c, C_PAD=c_pad,
            R=regions, BLOCK=block, num_warps=4),
        "stats_finalize": lambda: finalize_k[(1,)](
            part, out, n_part, 1e-10, 1e-16, C=c, C_PAD=c_pad, R=regions,
            ROWS=fused_losses.FIN_ROWS, num_warps=4),
        "stats_grad": lambda: grad_k[(-(-n_pix // block),)](
            logits, lab1, lab2, mask, stats, *g, grad, n_pix, hw, 1e-10, 1e-16,
            C=c, C_PAD=c_pad, R=regions, BLOCK=block, num_warps=4)}


def sass_of(compiled, out: str) -> str:
    try:
        return compiled.asm["sass"]
    except Exception:       # older Triton: disassemble the cubin ourselves
        import triton
        tool = (glob.glob(os.path.join(os.path.dirname(triton.__file__),
                                       "backends/nvidia/bin/cuobjdump"))
                or ["/usr/local/cuda/bin/cuobjdump"])[0]
        path = os.path.join(out, "kernel.cubin")
        with open(path, "wb") as f:
            f.write(compiled.asm["cubin"])
        return subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True).stdout


def text_summary(ptx: str, sass: str, ttgir: str) -> dict:
    """Counts from one kernel's PTX, SASS (cuobjdump's or Triton's format)
    and Triton GPU IR."""
    ptx_ins = [l.strip() for l in ptx.splitlines()
               if re.match(r"\s+(@%p\d+ )?[a-z]", l) and not l.strip().startswith(".")]
    mem = collections.Counter(
        m.group(1) for l in ptx_ins
        for m in [re.search(r"((?:ld|st)\.(?:global|shared)[\w.]*)", l)] if m)
    sass_ops = [m.group(1) for l in sass.splitlines()
                for m in [re.match(r"(?:\s*/\*[0-9a-f]{4}\*/|[-0-9a-fY:]+\t)\s*"
                                   r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", l)] if m]
    ops = collections.Counter(sass_ops)
    return {"ptx_instructions": len(ptx_ins), "ptx_memory": dict(mem),
            "ptx_bar_sync": sum(l.startswith(("bar.sync", "barrier.sync")) for l in ptx_ins),
            "ptx_div_rem_64": sum(bool(re.search(r"\b(div|rem)\.[su]64", l))
                                  for l in ptx_ins),
            "sass_instructions": len(sass_ops),
            "sass_memory": {k: v for k, v in sorted(ops.items())
                            if k.split(".")[0] in ("LDG", "STG", "LDS", "STS", "BAR",
                                                   "SHFL", "CALL")},
            "layouts": re.findall(r"#blocked\d* = #(?:triton_gpu|ttg)\.blocked<\{[^}]*\}>",
                                  ttgir)}


def summary(compiled, out: str) -> dict:
    ptx = compiled.asm["ptx"]
    sass = sass_of(compiled, out)
    ttgir = compiled.asm.get("ttgir", "")
    compiled._init_handles()
    return {"n_regs": compiled.n_regs, "n_spills": compiled.n_spills,
            **text_summary(ptx, sass, ttgir), "asm": (ptx, sass, ttgir)}


def event_ms(fn, n: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/k1_triton_asm")
    ap.add_argument("--from", dest="saved", default=None,
                    help="summarise the files an earlier run wrote to this "
                         "directory instead of compiling (no card needed)")
    args = ap.parse_args()
    if args.saved:
        for ptx in sorted(glob.glob(os.path.join(args.saved, "*.ptx"))):
            stem = ptx[:-4]
            texts = [open(f"{stem}.{ext}").read() for ext in ("ptx", "sass", "ttgir")]
            res = {"file": os.path.basename(stem), **text_summary(*texts)}
            print("k1_triton_asm", json.dumps(res), flush=True)
        return
    os.makedirs(args.out, exist_ok=True)
    import triton
    for tag, (shape, regions) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            fns = launchers(*inputs(shape, regions, dtype), regions)
            for name, fn in fns.items():
                res = summary(fn(), args.out)
                stem = f"{name}_{tag}_{str(dtype)[6:]}"
                for text, ext in zip(res.pop("asm"), ("ptx", "sass", "ttgir")):
                    with open(os.path.join(args.out, f"{stem}.{ext}"), "w") as f:
                        f.write(text)
                res.update({"kernel": name, "shape": list(shape), "regions": regions,
                            "dtype": str(dtype), "ms": event_ms(fn),
                            "triton": triton.__version__})
                print("k1_triton_asm", json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
