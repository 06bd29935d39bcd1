#!/usr/bin/env python3
"""On-card check of chap_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
H100. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device    nvidia-smi name and power limit; torch / CUDA / Triton versions
  2. build     nvcc builds csrc/ccl.cu (K2; registers and shared memory per
               phase kernel from -Xptxas=-v) while Triton compiles K1
  3. K1        the fused masked dice+CE Triton kernels, one region (R = 1)
               and two (R = 2, mix_loss's single call), against their plain
               version at the main path's [6, 4, 256, 256], a ragged
               [1, 4, 23, 29] and [2, 3, 23, 29] with labels outside
               [0, C) that match a padded class index: statistics, dice,
               ce and d/dlogits (also with one region's grads None) at
               rtol 2e-3, two calls bit-identical; torch.profiler counts the device kernels of
               one forward and one backward (at most 2 each); device ms per
               launch over 100 back-to-back calls, host us per call, and
               the median of single calls, each between two events
  4. K2        the CUDA largest-CC kernel exactly equal to its plain version
               on adversarial maps (ragged, a serpentine through every tile,
               all foreground / background, one-pixel components, ties
               across tiles, C = 2 and 4) and on the main path's 24 maps of
               256^2 in three regimes (speckled, clean phantoms, percolating
               30% fill), timed as K1
  5. parity    one CHAP step on the card (kernels) and one on the CPU (plain
               versions) from the same weights and draws, feature_chns
               (4, 8, 16, 16, 32), batch 8 at 32^2, TF32 off: the 7 metrics
               at rtol 2e-3
  6. slice     the CHAP train step at configs/acdc_chap.yml's values
               (widths 16-256, batch 24 = 12 labeled + 12 unlabeled at
               256^2, fp32, random weights from a seed) on phantom batches:
               1 warm-up and 5 timed steps; launch counters are set to 0
               just before the timed steps and read just after (4 K1
               forward, 12 K1 backward, 1 K2 per step); then torch.profiler
               over 2 steps: device ms per step by kernel class
  7. report    the kernels line (JSON), the card line, and the last line
               {"ok": true, "device": {...}}
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import re
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
# per CHAP step: 4 mix_loss calls, each one K1 forward over both regions and
# one K1 backward in each of grads_l, grads_u and total.backward(); one K2
LAUNCHES_PER_STEP = {"K1_fwd": 4, "K1_bwd": 12, "K2_ccl": 1}
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def launch_counts() -> dict:
    return {"K1_fwd": fused_losses.stats_kernel.launches,
            "K1_bwd": fused_losses.stats_grad_kernel.launches,
            "K2_ccl": nms.ccl_kernel.launches}


def single_call_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of n single calls, each between two CUDA events (with an empty
    queue it is mostly the host's enqueue)."""
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


def device_ms(fn, n: int = 100, warmup: int = 5) -> float:
    """Device time per call: one pair of CUDA events around n back-to-back
    calls, divided by n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int = 100, warmup: int = 5) -> float:
    """Host time per call: a host clock around n calls with no
    synchronisation inside, divided by n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def device_kernels(fn, n: int = 1) -> list:
    """(name, us) of each device kernel torch.profiler sees while fn runs n
    times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
            if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]


def timings(fn, n: int = 100) -> dict:
    """device_ms: events around n back-to-back calls (bounded below by the
    host's enqueue when that is slower); kernel_ms: the kernels' own device
    time per call, from torch.profiler over 20 calls; host_us; and the
    median of single calls between two events."""
    kernels = device_kernels(fn, 20)
    by_kernel = {}
    for name, us in kernels:
        name = re.sub(r"^\(anonymous namespace\)::|\(.*$", "", name)
        by_kernel[name] = by_kernel.get(name, 0.0) + us / 20 / 1e3
    return {"device_ms": device_ms(fn, n), "host_us": host_us(fn, n),
            "kernel_ms": sum(by_kernel.values()), "kernel_ms_by_name": by_kernel,
            "single_call_ms": single_call_ms(fn)}


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str) -> list:
    """(kernel, resource line) for each entry function in nvcc's
    -Xptxas=-v output: registers, shared memory, spills."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            short = re.search(r"\d+(ccl_[a-z]+)", entry.group(1))
            name = short.group(1) if short else entry.group(1)
        elif name and "Used" in line:
            out.append((name, line.split(":", 1)[-1].strip()))
            name = None
    return out


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

def k1_inputs(shape, seed, label_values=None):
    """Logits, two label maps with values in [0, label_values) (default C;
    larger values are labels outside [0, C), which count nowhere) and a
    {0, 1} mask."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape
    hi = label_values or c
    logits = torch.randn(shape, generator=gen, device="cuda") * 2
    labels = torch.randint(0, hi, (b, h, w), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels2 = torch.randint(0, hi, (b, h, w), generator=gen, device="cuda",
                            dtype=torch.int32)
    mask = (torch.rand((b, h, w), generator=gen, device="cuda") < 0.6).float()
    return logits, labels, labels2, mask


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _k1_grads(x, lab, mask, lab2, weights, used):
    """d/dlogits of sum_i weights[i] * loss_i over the losses in ``used``,
    through the card's Function (``kernel``) and the plain version."""
    out = {}
    for name, fn in (("kernel", fused_losses.region_dice_ce),
                     ("plain", lambda *a: tuple(fused_losses.compose_plain(
                         fused_losses.region_stats_plain(*a), 1e-10,
                         1e-16).view(-1).unbind()))):
        xg = x.clone().requires_grad_(True)
        vals = fn(xg, lab, mask, lab2)
        sum(weights[i] * vals[i] for i in used).backward()
        out[name] = (torch.stack([v.detach() for v in vals]), xg.grad)
    return out


def phase_k1(shape, seed, regions, timed=False, label_values=None):
    """K1 with R = ``regions`` against its plain version: statistics, losses,
    the Function's gradient and the backward kernel alone; bit-identical on
    repeat. At the main path's shape it also counts the device kernels of
    one forward and one backward and times kernel and plain version."""
    logits, labels, labels2, mask = k1_inputs(shape, seed, label_values)
    lab2 = labels2 if regions == 2 else None
    c = shape[1]
    tag = f"{shape} R={regions} labels<{label_values or c}"
    # forward: statistics and losses
    losses, stats = fused_losses.stats_kernel(logits, labels, mask, lab2)
    losses2, stats2 = fused_losses.stats_kernel(logits, labels, mask, lab2)
    check(torch.equal(losses, losses2) and torch.equal(stats, stats2),
          f"K1 forward deterministic at {tag}")
    p_stats = fused_losses.region_stats_plain(logits, labels, mask, lab2)
    p_losses = fused_losses.compose_plain(p_stats, 1e-10, 1e-16)
    k_stats = stats[:, :, :c]
    check(torch.allclose(k_stats, p_stats, rtol=RTOL, atol=1e-3),
          f"K1 I/Z/Y/CE at {tag}")
    check(torch.allclose(losses, p_losses, rtol=RTOL, atol=0),
          f"K1 dice/ce at {tag}: {losses.tolist()} vs {p_losses.tolist()}")
    fwd_err = float((k_stats - p_stats).abs().max())
    # the Function's gradient, every loss used and one region unused
    weights = (0.5, 0.35, 0.25, 0.6)
    patterns = [(0, 1)] if regions == 1 else [(0, 1, 2, 3), (2, 3)]
    g_err = bwd_abs = 0.0
    for used in patterns:
        g = _k1_grads(logits, labels, mask, lab2, weights, used)
        g2 = _k1_grads(logits, labels, mask, lab2, weights, used)
        check(torch.equal(g["kernel"][1], g2["kernel"][1]),
              f"K1 backward deterministic at {tag}")
        err = rel_err(g["kernel"][1], g["plain"][1])
        check(err <= RTOL, f"K1 gradient at {tag} {used}: "
                           f"max|diff|/max|plain| = {err}")
        g_err = max(g_err, err)
        bwd_abs = max(bwd_abs, float((g["kernel"][1] - g["plain"][1]).abs().max()))
    # the backward kernel alone against the plain analytic gradient
    grads = [torch.tensor(w, device="cuda") for w in weights[:2 * regions]]
    k_grad = fused_losses.stats_grad_kernel(logits, labels, mask, stats, grads,
                                            lab2)
    p_grad = fused_losses.stats_grad_plain(
        logits, labels, mask, stats, torch.stack(grads).view(regions, 2),
        1e-10, 1e-16, lab2)
    check(rel_err(k_grad, p_grad) <= RTOL, f"K1 backward kernel at {tag}")
    res = {"shape": list(shape), "regions": regions,
           "losses": losses.view(-1).tolist(), "fwd_max_abs_err": fwd_err,
           "bwd_max_abs_err": bwd_abs, "bwd_rel_err": g_err}
    if timed:
        x = logits.clone().requires_grad_(True)
        fwd_k = [k for k, _ in device_kernels(
            lambda: fused_losses.region_dice_ce(x, labels, mask, lab2))]
        vals = fused_losses.region_dice_ce(x, labels, mask, lab2)
        bwd_k = [k for k, _ in device_kernels(
            lambda: torch.autograd.grad(vals, [x], grads))]
        check(1 <= len(fwd_k) <= 2 and 1 <= len(bwd_k) <= 2,
              f"K1 Function's device kernels at {tag}: forward {fwd_k}, "
              f"backward {bwd_k}")
        xg = logits.clone().requires_grad_(True)
        p_vals = fused_losses.compose_plain(fused_losses.region_stats_plain(
            xg, labels, mask, lab2), 1e-10, 1e-16).view(-1)
        g_vec = torch.stack(grads)
        n = logits.numel() // c
        io = logits.numel() * logits.element_size() + n * 4 * (1 + regions)
        res.update({
            "fwd_device_kernels": fwd_k, "bwd_device_kernels": bwd_k,
            "fwd": timings(lambda: fused_losses.stats_kernel(
                logits, labels, mask, lab2)),
            "bwd": timings(lambda: fused_losses.stats_grad_kernel(
                logits, labels, mask, stats, grads, lab2)),
            "fwd_plain_ms": device_ms(lambda: fused_losses.compose_plain(
                fused_losses.region_stats_plain(logits, labels, mask, lab2),
                1e-10, 1e-16), n=20),
            "bwd_plain_ms": device_ms(lambda: torch.autograd.grad(
                p_vals, [xg], g_vec, retain_graph=True), n=20),
            # softmax ~10 flops a class, ~8 more a class per region
            "fwd_bound": bound_ms(io, n * c * (10 + 8 * regions)),
            "bwd_bound": bound_ms(io + logits.numel() * logits.element_size(),
                                  n * c * (10 + 12 * regions))})
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


def serpentine(h, w, stride=3):
    """One component that snakes through every row band: rows 0, stride,
    ... are full and joined alternately at the right and left ends, so it
    crosses every 32x32 tile of K2."""
    m = np.zeros((h, w), np.int32)
    rows = list(range(0, h, stride))
    for i, y in enumerate(rows):
        m[y] = 1
        if i + 1 < len(rows):
            x = w - 1 if i % 2 == 0 else 0
            m[y:rows[i + 1] + 1, x] = 1
    return m


def k2_adversarial(rs: np.random.RandomState) -> dict:
    """name -> (segmentation [B, H, W] int32, num_classes)."""
    u = rs.rand(2, 257, 100)
    one = np.zeros((2, 64, 64), np.int32)
    one[:, ::2, ::2] = 1
    ties = np.zeros((1, 96, 96), np.int32)
    for y, x in [(5, 5), (40, 70), (70, 10), (30, 31)]:
        ties[0, y:y + 3, x:x + 3] = 1          # equal squares in four tiles
    ties[0, 80:82, 80:82] = 2
    ties[0, 10:12, 60:62] = 2
    snakes = np.stack([serpentine(256, 256), serpentine(256, 256, 5) * 2,
                       serpentine(256, 256, 2) * 3])
    u4 = rs.rand(4, 64, 64)
    return {
        "ragged_3x23x29": (rs.randint(0, 4, (3, 23, 29)), 4),
        "ragged_2x257x100": (np.select([u < 0.2, u < 0.4, u < 0.55], [1, 2, 3], 0), 4),
        "serpentine_3x256x256": (snakes, 4),
        "serpentine_ragged_70x90": (serpentine(70, 90)[None] * 2, 4),
        "all_foreground": (np.full((2, 64, 64), 3), 4),
        "all_background": (np.zeros((2, 64, 64)), 4),
        "one_pixel_components": (one, 2),
        "ties_across_tiles": (ties, 4),
        "c2_percolating": ((rs.rand(3, 64, 64) < 0.45), 2),
        "c4_percolating": (np.select([u4 < 0.3, u4 < 0.6, u4 < 0.9], [1, 2, 3], 0), 4),
        "labels_out_of_range": (rs.randint(-1, 6, (2, 40, 40)), 4),
    }


def phase_k2():
    out = {}
    for name, (seg, c) in k2_adversarial(np.random.RandomState(7)).items():
        seg = torch.from_numpy(np.asarray(seg, np.int32)).cuda()
        k = nms.ccl_kernel(seg, c)
        torch.cuda.synchronize()
        check(torch.equal(k, nms.largest_cc_batch_plain(seg, c)),
              f"K2 equals its plain version ({name})")
    print("K2 adversarial cases equal to the plain version:",
          ", ".join(k2_adversarial(np.random.RandomState(7))), flush=True)
    for i, regime in enumerate(("speckled", "clean", "percolating")):
        seg = torch.from_numpy(k2_regime(regime, np.random.RandomState(100 + i))
                               ).to(device="cuda", dtype=torch.int32)
        k = nms.ccl_kernel(seg, 4)
        p = nms.largest_cc_batch_plain(seg, 4)
        check(torch.equal(k, p), f"K2 equals its plain version ({regime})")
        check(torch.equal(k, nms.ccl_kernel(seg, 4)), f"K2 deterministic ({regime})")
        # one int32 map read, one written
        res = {"maps": seg.shape[0], "kept_pixels": int((k > 0).sum()),
               "bound": bound_ms(2 * seg.numel() * seg.element_size(), 0),
               "max_abs_err": float((k - p).abs().max()),
               **timings(lambda: nms.ccl_kernel(seg, 4), n=50),
               "plain_ms": device_ms(lambda: nms.largest_cc_batch_plain(seg, 4),
                                     n=3, warmup=1)}
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

    before = launch_counts()
    on_cpu = cpu_step(cpu_state, batch, draws=draws).metrics
    on_card = cuda_step(cuda_state, to_cuda(batch), draws=to_cuda(draws)).metrics
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in after}
    check(ran == LAUNCHES_PER_STEP,
          f"the card's step went through K1 and K2: {ran} launches, "
          f"expected {LAUNCHES_PER_STEP}")
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
    n_steps = len(batches) - 1
    for batch in batches[1:]:
        t0 = time.perf_counter()
        out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in out.metrics.items()})
    launches = launch_counts()
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check(launches == {k: v * n_steps for k, v in LAUNCHES_PER_STEP.items()},
          f"launches over {n_steps} steps: {launches}, expected "
          f"{LAUNCHES_PER_STEP} per step")
    res = {"step_ms": times, "median_step_ms": statistics.median(times),
           "slices_per_s": 1e3 * cfg.data.batch_size / statistics.median(times),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {k: v / n_steps for k, v in launches.items()},
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
    by_class, top, ported = {}, [], {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        cls = _kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / len(batches)
        top.append((dev_us / 1e3 / len(batches), ev.count // len(batches), ev.key[:70]))
        if cls.startswith(("K1", "K2")):
            ported[ev.key[:70]] = [dev_us / 1e3 / len(batches),
                                   ev.count / len(batches)]
    device_ms = sum(by_class.values())
    top.sort(reverse=True)
    print("profile", json.dumps({
        "steps": len(batches), "wall_ms_per_step": wall_ms / len(batches),
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (wall_ms / len(batches)),
        "ms_per_step_by_class": dict(sorted(by_class.items(),
                                            key=lambda kv: -kv[1])),
        "ported_kernels_ms_and_calls_per_step": ported,
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
        logits, labels, labels2, mask = k1_inputs((1, 4, 8, 8), 0)
        for lab2 in (None, labels2):       # K1 with R = 1 and R = 2
            x = logits.clone().requires_grad_(True)
            sum(fused_losses.region_dice_ce(x, labels, mask, lab2)).backward()
        torch.cuda.synchronize()
        triton_s = time.perf_counter() - t0
        built = nvcc.result()
    print(f"build nvcc_s={built['seconds']:.2f} triton_first_call_s={triton_s:.2f} "
          f"wall_s={time.perf_counter() - t0:.2f}", flush=True)
    for kernel, use in ptxas_summary(built["log"]):
        print("ptxas", kernel, use, flush=True)

    # phase 3: K1
    set_tf32(False)
    k1 = phase_k1((6, 4, 256, 256), 1, 2, timed=True)   # mix_loss's shape
    k1_r1 = phase_k1((6, 4, 256, 256), 1, 1, timed=True)
    for regions in (1, 2):
        phase_k1((1, 4, 23, 29), 2, regions)
    # C = 3 pads the class axis to 4: labels 3 and 4 lie outside [0, C)
    phase_k1((2, 3, 23, 29), 3, 2, label_values=5)
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
         "launches": launches["K1_fwd"],
         "max_abs_err": max(k1["fwd_max_abs_err"], k1_r1["fwd_max_abs_err"]),
         "ms": k1["fwd"]["device_ms"], "kernel_ms": k1["fwd"]["kernel_ms"],
         "host_us": k1["fwd"]["host_us"],
         "plain_ms": k1["fwd_plain_ms"],
         "bound_ms": k1["fwd_bound"][0], "bound_by": k1["fwd_bound"][1],
         "library_ms": None},
        {"name": "K1_bwd", "route": "triton",
         "source": "chap_tpu_torch/ops/fused_losses.py",
         "replaces": "chap_tpu/ops/fused_losses.py:159",
         "launches": launches["K1_bwd"],
         "max_abs_err": max(k1["bwd_max_abs_err"], k1_r1["bwd_max_abs_err"]),
         "ms": k1["bwd"]["device_ms"], "kernel_ms": k1["bwd"]["kernel_ms"],
         "host_us": k1["bwd"]["host_us"],
         "plain_ms": k1["bwd_plain_ms"],
         "bound_ms": k1["bwd_bound"][0], "bound_by": k1["bwd_bound"][1],
         "library_ms": None},
        {"name": "K2_ccl", "route": "cuda",
         "source": "chap_tpu_torch/csrc/ccl.cu",
         "replaces": "chap_tpu/semi/nms.py:118",
         "launches": launches["K2_ccl"],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         "ms": k2["clean"]["device_ms"], "kernel_ms": k2["clean"]["kernel_ms"],
         "host_us": k2["clean"]["host_us"],
         "plain_ms": k2["clean"]["plain_ms"],
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
