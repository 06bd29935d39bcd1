"""Time alternatives to K1's CUDA design against the kept one, on one CUDA
card.

Each variant is csrc/fused_losses.cu with a few text substitutions (other
block sizes, partial-sum targets, occupancy, cache policies, the order of
the backward's loads), built with the repository's nvcc flags into
build/k1_variants/ (one nvcc each, started together) and bound like the
kept build. For every K1 row of PERF.md §6 (the shapes of chip_smoke.py's
phase 3, int32 labels and an fp32 mask, and for one region again at the
supervised callers' inputs: uint8 labels, no mask) it launches each
variant's forward and backward and reports the kernels' device time from
torch.profiler (us a call, mean over 20 calls, in all and by kernel) and
whether the forward's statistics agree with the kept build's to 1e-5
relative. Run from the repository's root:

    PYTHONPATH=. python3 tools/k1_variants.py --out build/k1_variants.jsonl

Prints one ``k1_variant`` JSON line per variant and row, and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess

import torch

import chip_smoke
from chap_tpu_torch.ops import cuda_build, fused_losses

LA, BRATS = chip_smoke.LA_PATCH, chip_smoke.BRATS_PATCH
ROWS = {"2d": ((6, 4, 256, 256), 2), "acal": ((12, 4, 256, 256), 1),
        "la": ((1, 2) + LA, 2), "brats": ((4, 2) + BRATS, 1),
        "zoo2d": ((24, 4, 256, 256), 1)}
# the backward's coefficients, and the first lines of its loads (they follow
# the coefficients in the kept build)
COEFS = """  float a[2][C], b[2][C], k[2], d[C];
  coefs<C>(stats, gd1, gc1, g, 0, a[0], b[0], k[0]);
  if (two) {
    coefs<C>(stats, gd2, gc2, g, 1, a[1], b[1], k[1]);
  } else {
    k[1] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) a[1][c] = b[1][c] = 0.0f;
  }
"""
GRAD_LOADS = "  Words<4> xv[C];\n  Words<V * sizeof(L) / 4> l1, l2;\n"
# name -> text substitutions in fused_losses.cu
VARIANTS = {
    "kept": (),
    "rows128": (("constexpr int kMaxRows = 256;", "constexpr int kMaxRows = 128;"),),
    "threads256": (("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                   ("constexpr int kMaxBlocksPerSm = 2;", "constexpr int kMaxBlocksPerSm = 4;")),
    "grad_threads128": (("constexpr int kGradThreads = 256;",
                         "constexpr int kGradThreads = 128;"),),
    "grad_threads512": (("constexpr int kGradThreads = 256;",
                         "constexpr int kGradThreads = 512;"),),
    "grad_occupancy5": (("__launch_bounds__(kGradThreads)\nk1_grad(",
                         "__launch_bounds__(kGradThreads, 5)\nk1_grad("),),
    "stream_loads": (("else return __ldg(p);", "else return __ldcs(p);"),),
    "grad_never_streams": (("  g.stream = bytes > 0.75 * l2_bytes();", "  g.stream = 0;"),),
    "grad_always_streams": (("  g.stream = bytes > 0.75 * l2_bytes();", "  g.stream = 1;"),),
    "stream_grad_stores": (("*reinterpret_cast<float4*>(p) = make_float4(g[0], g[1], g[2], g[3]);",
                            "__stcs(reinterpret_cast<float4*>(p), make_float4(g[0], g[1], g[2], g[3]));"),
                           ("*reinterpret_cast<uint4*>(p) = q;", "__stcs(reinterpret_cast<uint4*>(p), q);")),
    "coefs_last": ((COEFS + GRAD_LOADS, GRAD_LOADS), ("  if (g.vec) {\n    float out[C][V];",
                                                      COEFS + "  if (g.vec) {\n    float out[C][V];")),
    # a diagnostic, not a candidate (its gradient is wrong): the backward's
    # coefficients from constants, to time their loads
    "const_coefs": tuple((a, "1.0f") for a in (
        "__ldg(st + 2 * g.c_pad + c)", "__ldg(st + g.c_pad + c)", "__ldg(st + c)",
        "__ldg(g_dice)", "__ldg(g_ce)")),
}


def build(name: str, subs) -> ctypes.CDLL:
    text = (cuda_build.CSRC / "fused_losses.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    out = cuda_build.BUILD_DIR.parent / "k1_variants"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                           str(so), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return fused_losses.bind(ctypes.CDLL(str(so)))


def kernel_us(fn, n: int = 20) -> dict:
    """The kernels' us a call (mean over n calls), and each kernel's."""
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for name, us in chip_smoke.device_kernels(fn, n):
        name = chip_smoke.short_name(name).split("<")[0]
        by_name[name] = by_name.get(name, 0.0) + us / n
    return {"mean": sum(by_name.values()), **by_name}


def cases():
    """(row name, shape, R, dtype, caller inputs) of every timed K1 row."""
    for tag, (shape, r) in ROWS.items():
        for dtype in (torch.float32, torch.bfloat16):
            if tag == "2d" and dtype == torch.bfloat16:
                continue
            yield tag, shape, r, dtype, False
            if r == 1:
                yield tag, shape, r, dtype, True


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/k1_variants.jsonl")
    ap.add_argument("--only", nargs="*", default=None, help="variant names")
    args = ap.parse_args()
    names = args.only or list(VARIANTS)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]), names)))
    kept_lib = fused_losses._library
    with open(args.out, "a") as log:
        for tag, shape, r, dtype, caller in cases():
            logits, labels, labels2, mask = chip_smoke.k1_inputs(shape, 3, dtype=dtype)
            lab2 = labels2 if r == 2 else None
            if caller:
                labels, mask = labels.to(torch.uint8), None
            grads = [torch.tensor(w, device="cuda") for w in (0.5, 0.35, 0.25, 0.6)[:2 * r]]
            want = None
            for name in names:
                fused_losses._library = lambda lib=libs[name]: lib
                losses, stats = fused_losses.stats_kernel(logits, labels, mask, lab2)
                want = stats.clone() if want is None else want
                agree = chip_smoke.rel_err(stats, want) <= 1e-5
                res = {"variant": name, "row": tag, "shape": list(shape), "regions": r,
                       "dtype": str(dtype), "caller_inputs": caller, "agrees": agree,
                       "fwd_us": kernel_us(lambda: fused_losses.stats_kernel(
                           logits, labels, mask, lab2)),
                       "bwd_us": kernel_us(lambda: fused_losses.stats_grad_kernel(
                           logits, labels, mask, stats, grads, lab2))}
                print("k1_variant", json.dumps(res), flush=True)
                log.write(json.dumps(res) + "\n")
    fused_losses._library = kept_lib
    print(chip_smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
