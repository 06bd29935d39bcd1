#!/usr/bin/env python3
"""On-card check of chap_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
H100. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device    nvidia-smi name and power limit; torch / CUDA / Triton versions
  2. build     nvcc builds csrc/ccl.cu (K2) while Triton compiles K1
  3. K1        the fused masked dice+CE Triton kernels against their plain
               version at the main path's [6, 4, 256, 256] and a ragged
               [1, 4, 23, 29]: dice, ce and d/dlogits at rtol 2e-3, two calls
               bit-identical; median of 20 timed runs each
  4. K2        the CUDA largest-CC kernel against its plain version on the
               main path's 72 masks of 256^2 (24 maps x 3 classes) in three
               regimes (speckled, clean phantoms, percolating 30% fill):
               exactly equal
  5. parity    one CHAP step on the card (kernels) and one on the CPU (plain
               versions) from the same weights and draws, feature_chns
               (4, 8, 16, 16, 32), batch 8 at 32^2, TF32 off: the 7 metrics
               at rtol 2e-3
  6. slice     the CHAP train step at configs/acdc_chap.yml's values
               (widths 16-256, batch 24 = 12 labeled + 12 unlabeled at
               256^2, fp32, random weights from a seed) on phantom batches:
               1 warm-up and 5 timed steps; launch counters are set to 0
               just before the timed steps and read just after
  7. report    the kernels line (JSON), the card line, and the last line
               {"ok": true, "device": {...}}
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from chap_tpu_torch.config import acdc_chap_config
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.ops import cuda_build, fused_losses
from chap_tpu_torch.semi import nms
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.step_chap import build_chap_train_step, draw_step_uniforms

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # outside the tensor cores
RTOL = 2e-3
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of n runs, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def set_tf32(cudnn: bool, matmul: bool = False) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def tf32_settings() -> str:
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def k1_inputs(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape
    logits = torch.randn(shape, generator=gen, device="cuda") * 2
    labels = torch.randint(0, c, (b, h, w), generator=gen, device="cuda",
                           dtype=torch.int32)
    mask = (torch.rand((b, h, w), generator=gen, device="cuda") < 0.6).float()
    return logits, labels, mask


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def phase_k1(shape, seed):
    logits, labels, mask = k1_inputs(shape, seed)
    # forward statistics
    k_stats = fused_losses.stats_kernel(logits, labels, mask)
    again = fused_losses.stats_kernel(logits, labels, mask)
    check(torch.equal(k_stats, again), f"K1 forward deterministic at {shape}")
    p = fused_losses.masked_seg_stats_plain(logits, labels, mask)
    p_stats = torch.stack(p[:3])
    check(torch.allclose(k_stats[:3], p_stats, rtol=RTOL, atol=0),
          f"K1 I/Z/Y at {shape}")
    # the kernel keeps CE per class; the plain version sums it
    check(math.isclose(float(k_stats[3].sum()), float(p[3]), rel_tol=RTOL),
          f"K1 CE sum at {shape}")
    fwd_err = max(float((k_stats[:3] - p_stats).abs().max()),
                  abs(float(k_stats[3].sum()) - float(p[3])))
    # losses and the logits gradient through the autograd Function
    xk = logits.clone().requires_grad_(True)
    dk, ck = fused_losses.fused_masked_dice_ce(xk, labels, mask)
    (dk + 0.7 * ck).backward()
    xk2 = logits.clone().requires_grad_(True)
    dk2, ck2 = fused_losses.fused_masked_dice_ce(xk2, labels, mask)
    (dk2 + 0.7 * ck2).backward()
    check(torch.equal(xk.grad, xk2.grad) and torch.equal(dk, dk2)
          and torch.equal(ck, ck2), f"K1 backward deterministic at {shape}")
    xp = logits.clone().requires_grad_(True)
    dp, cp = fused_losses._compose(*fused_losses.masked_seg_stats_plain(
        xp, labels, mask), 1e-10, 1e-16)
    (dp + 0.7 * cp).backward()
    dk, ck, dp, cp = (float(v.detach()) for v in (dk, ck, dp, cp))
    check(math.isclose(dk, dp, rel_tol=RTOL), f"K1 dice at {shape}")
    check(math.isclose(ck, cp, rel_tol=RTOL), f"K1 ce at {shape}")
    g_err = rel_err(xk.grad, xp.grad)
    check(g_err <= RTOL, f"K1 gradient at {shape}: max|diff|/max|plain| = {g_err}")
    bwd_abs = float((xk.grad - xp.grad).abs().max())

    # timings: kernel and plain version, forward and backward
    coef = torch.zeros(2 * 4 + 2, device="cuda")
    coef[:4], coef[4:8], coef[8], coef[9] = -0.1, 0.01, 1.0, 1e-6
    fwd_ms = cuda_ms(lambda: fused_losses.stats_kernel(logits, labels, mask))
    fwd_plain_ms = cuda_ms(lambda: fused_losses.masked_seg_stats_plain(
        logits, labels, mask))
    bwd_ms = cuda_ms(lambda: fused_losses.stats_grad_kernel(logits, labels,
                                                            mask, coef))
    xg = logits.clone().requires_grad_(True)
    dg, cg = fused_losses._compose(*fused_losses.masked_seg_stats_plain(
        xg, labels, mask), 1e-10, 1e-16)
    total = dg + 0.7 * cg
    bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(total, [xg],
                                                       retain_graph=True))
    n = logits.numel() // logits.shape[1]
    io = logits.numel() * logits.element_size() + n * 4 + n * 4
    res = {"shape": list(shape), "dice": dk, "ce": ck,
           "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_abs,
           "bwd_rel_err": g_err, "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
           "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
           "fwd_bound": bound_ms(io, n * (16 * logits.shape[1] + 8)),
           "bwd_bound": bound_ms(io + logits.numel() * logits.element_size(),
                                 n * 20 * logits.shape[1])}
    print("K1", json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4: K2
# ---------------------------------------------------------------------------

def k2_regime(name: str, rs: np.random.RandomState, b=24, hw=256, c=4):
    if name == "clean":
        return phantom_batch(rs, b, hw, c)[1]
    if name == "speckled":
        lab = phantom_batch(rs, b, hw, c)[1]
        noise = rs.rand(b, hw, hw) < 0.08
        lab[noise] = rs.randint(0, c, int(noise.sum()))
        return lab
    u = rs.rand(b, hw, hw)
    return np.select([u < 0.3, u < 0.6, u < 0.9], [1, 2, 3], 0).astype(np.int32)


def phase_k2():
    out = {}
    for i, regime in enumerate(("speckled", "clean", "percolating")):
        seg = torch.from_numpy(k2_regime(regime, np.random.RandomState(100 + i))
                               ).to(device="cuda", dtype=torch.int32)
        k = nms.ccl_kernel(seg, 4)
        p = nms.largest_cc_batch_plain(seg, 4)
        check(torch.equal(k, p), f"K2 equals its plain version ({regime})")
        check(torch.equal(k, nms.ccl_kernel(seg, 4)), f"K2 deterministic ({regime})")
        # one int32 map read, one written
        res = {"masks": 3 * seg.shape[0], "kept_pixels": int((k > 0).sum()),
               "bound": bound_ms(2 * seg.numel() * seg.element_size(), 0),
               "max_abs_err": float((k - p).abs().max()),
               "kernel_ms": cuda_ms(lambda: nms.ccl_kernel(seg, 4)),
               "plain_ms": cuda_ms(lambda: nms.largest_cc_batch_plain(seg, 4),
                                   n=5, warmup=1)}
        print("K2", regime, json.dumps(res), flush=True)
        out[regime] = res
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: the train step
# ---------------------------------------------------------------------------

def make_step(cfg, device, seed=0, state_dict=None):
    torch.manual_seed(seed)
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = create_train_state(model, opt, cfg.model.feature_chns)
    return state, build_chap_train_step(model, opt, cfg, device=device)


def phantom_inputs(cfg, seed, device):
    images, labels = phantom_batch(np.random.RandomState(seed),
                                   cfg.data.batch_size, cfg.data.image_size[0],
                                   cfg.data.num_classes)
    return {"image": torch.from_numpy(images).to(device),
            "label": torch.from_numpy(labels).to(device)}


def phase_parity():
    set_tf32(False)
    cfg = acdc_chap_config()
    cfg.model.feature_chns = (4, 8, 16, 16, 32)
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.data.image_size = (32, 32)
    cpu_state, cpu_step = make_step(cfg, "cpu")
    cuda_state, cuda_step = make_step(cfg, "cuda",
                                      state_dict=cpu_state.model.state_dict())
    batch = phantom_inputs(cfg, 1, "cpu")
    draws = draw_step_uniforms(cfg, batch["image"].shape,
                               torch.Generator().manual_seed(2), "cpu")

    def to_cuda(obj):
        if isinstance(obj, torch.Tensor):
            return obj.cuda()
        if isinstance(obj, dict):
            return {k: to_cuda(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [to_cuda(v) for v in obj]
        return obj

    k1_before, k2_before = fused_losses.stats_kernel.launches, nms.ccl_kernel.launches
    on_cpu = cpu_step(cpu_state, batch, draws=draws).metrics
    on_card = cuda_step(cuda_state, to_cuda(batch), draws=to_cuda(draws)).metrics
    check(fused_losses.stats_kernel.launches - k1_before == 8
          and nms.ccl_kernel.launches - k2_before == 1,
          "the card's step went through K1 and K2")
    res = {}
    for k in METRICS:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-6),
              f"step parity {k}: card {a} vs cpu {b}")
        res[k] = [a, b]
    print("parity", tf32_settings(), json.dumps(res), flush=True)


def phase_slice():
    set_tf32(True)     # PyTorch's defaults: TF32 in cuDNN convs, not in matmuls
    cfg = acdc_chap_config()
    state, step = make_step(cfg, "cuda", seed=1337)
    batches = [phantom_inputs(cfg, 10 + i, "cuda") for i in range(6)]
    gen = torch.Generator(device="cuda").manual_seed(1337)
    out = step(state, batches[0], gen)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_losses.stats_kernel.launches = 0
    fused_losses.stats_grad_kernel.launches = 0
    nms.ccl_kernel.launches = 0
    times, metrics = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in out.metrics.items()})
    launches = {"K1_fwd": fused_losses.stats_kernel.launches,
                "K1_bwd": fused_losses.stats_grad_kernel.launches,
                "K2_ccl": nms.ccl_kernel.launches}
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check(launches["K1_fwd"] == 8 * 5, f"K1 forward 8 per step: {launches}")
    check(launches["K1_bwd"] > 0 and launches["K2_ccl"] >= 5,
          f"K1 backward and K2 launched: {launches}")
    res = {"step_ms": times, "median_step_ms": statistics.median(times),
           "slices_per_s": 1e3 * cfg.data.batch_size / statistics.median(times),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {k: v / 5 for k, v in launches.items()},
           "last_metrics": metrics[-1], "settings": tf32_settings(),
           "batch": cfg.data.batch_size, "image_size": list(cfg.data.image_size),
           "feature_chns": list(cfg.model.feature_chns),
           "remat": cfg.optim.remat}
    print("slice", json.dumps(res), flush=True)
    print("clocks", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    phase_profile(state, step, batches[1:3], gen)
    return launches


def _kernel_class(name: str) -> str:
    n = name.lower()
    if n.startswith(("stats_partials", "stats_finalize")):
        return "K1_fwd"
    if n.startswith("stats_grad"):
        return "K1_bwd"
    if "ccl_" in n:
        return "K2_ccl"
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


def phase_profile(state, step, batches, gen) -> None:
    """Device time by kernel class over two steps (torch.profiler), and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, top = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        cls = _kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / len(batches)
        top.append((dev_us / 1e3 / len(batches), ev.count // len(batches), ev.key[:70]))
    device_ms = sum(by_class.values())
    top.sort(reverse=True)
    print("profile", json.dumps({
        "steps": len(batches), "wall_ms_per_step": wall_ms / len(batches),
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (wall_ms / len(batches)),
        "ms_per_step_by_class": {k: round(v, 3) for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[round(t, 3), c, k] for t, c, k in top[:15]]}),
        flush=True)


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card")
    card = card_line()
    print("card", card, flush=True)
    import triton
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
          f"{triton.__version__} python {sys.version.split()[0]} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # phase 2: build (nvcc for K2 in a thread while Triton compiles K1)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(cuda_build.build, "ccl.cu")
        logits, labels, mask = k1_inputs((1, 4, 8, 8), 0)
        x = logits.clone().requires_grad_(True)
        d, c = fused_losses.fused_masked_dice_ce(x, labels, mask)
        (d + c).backward()
        torch.cuda.synchronize()
        triton_s = time.perf_counter() - t0
        built = nvcc.result()
    print(f"build nvcc_s={built['seconds']:.2f} triton_first_call_s={triton_s:.2f} "
          f"wall_s={time.perf_counter() - t0:.2f}", flush=True)
    print("ptxas", " | ".join(l.strip() for l in built["log"].splitlines()
                              if "registers" in l or "Compiling entry" in l),
          flush=True)

    # phase 3: K1
    set_tf32(False)
    k1 = phase_k1((6, 4, 256, 256), 1)
    phase_k1((1, 4, 23, 29), 2)
    # phase 4: K2
    k2 = phase_k2()
    # phase 5: CUDA-against-CPU step parity
    phase_parity()
    # phase 6: the slice at full width
    launches = phase_slice()

    # phase 7: report
    k2_bound = k2["clean"]["bound"]
    kernels = [
        {"name": "K1_fwd", "route": "triton",
         "source": "chap_tpu_torch/ops/fused_losses.py",
         "replaces": "chap_tpu/ops/fused_losses.py:99",
         "launches": launches["K1_fwd"], "max_abs_err": k1["fwd_max_abs_err"],
         "ms": k1["fwd_ms"], "plain_ms": k1["fwd_plain_ms"],
         "bound_ms": k1["fwd_bound"][0], "bound_by": k1["fwd_bound"][1],
         "library_ms": None},
        {"name": "K1_bwd", "route": "triton",
         "source": "chap_tpu_torch/ops/fused_losses.py",
         "replaces": "chap_tpu/ops/fused_losses.py:159",
         "launches": launches["K1_bwd"], "max_abs_err": k1["bwd_max_abs_err"],
         "ms": k1["bwd_ms"], "plain_ms": k1["bwd_plain_ms"],
         "bound_ms": k1["bwd_bound"][0], "bound_by": k1["bwd_bound"][1],
         "library_ms": None},
        {"name": "K2_ccl", "route": "cuda",
         "source": "chap_tpu_torch/csrc/ccl.cu",
         "replaces": "chap_tpu/semi/nms.py:118",
         "launches": launches["K2_ccl"],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         "ms": k2["clean"]["kernel_ms"], "plain_ms": k2["clean"]["plain_ms"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
