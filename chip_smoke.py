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
               rtol 2e-3, two calls bit-identical; torch.profiler counts
               the device kernels of 3 forward calls (1 or 2 kernels each)
               and of 3 backward calls (1 each); device ms per
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
  7. eval      evaluate_volumes on the card (TF32 off) and on the CPU from
               the same weights, feature_chns (4, 8, 16, 16, 32) trained 30
               supervised steps on the card, 2 synthetic volumes of 6 x 64^2:
               >= 99.9% of predicted pixels agree, mean dice within 1e-3
  8. trainer   chap_tpu_torch.cli.train_2d.main in process at
               configs/acdc_chap.yml's values with --dataset synthetic
               (1,312-slice device pool, labeled_num 7): 20 CHAP steps with
               an eval every 10 on 2 val volumes of 10 x 256^2, --resume to
               30 (the step counter continues, the best slot is kept), then
               cli.test_2d on ``best``; 5 supervised steps and 10 CHAP steps
               on the host loader path (data.device_input=false). Launch
               counters are set to 0 just before each run and read just
               after: 4 / 12 / 1 per CHAP step, 2 / 2 / 0 per supervised
               step. Prints the ``trainer`` line (pool build s, steps/s
               between evals per path beside phase 6's bare step, eval s,
               checkpoint ms, val dice, peak memory)
  9. report    the kernels line (JSON), the card line, and the last line
               {"ok": true, "device": {...}}

Two diagnostics run only by hand, each from the repository root:

    python3 -c "import chip_smoke as c; c.phase_slice()"
    python3 -c "import chip_smoke as c; c.loop_breakdown('by_hand')"

the first is phase 6 alone; the second prints a ``loop`` line, the ms per
full-width step on phantom and on device-pool batches with a sync after
every step and after 5, and the batch function's own device ms.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from chap_tpu_torch.cli import test_2d as cli_test
from chap_tpu_torch.cli import train_2d as cli_train
from chap_tpu_torch.config import acdc_chap_config
from chap_tpu_torch.data.datasets import (SyntheticSliceDataset, SyntheticVolumeDataset,
                                          patients_to_slices, phantom_batch)
from chap_tpu_torch.data.device_data import build_device_batch_fn, build_device_pool
from chap_tpu_torch.eval.eval2d import evaluate_volumes, make_predictor, predict_volume
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.ops import cuda_build, fused_losses
from chap_tpu_torch.semi import nms
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.step_chap import build_chap_train_step, draw_step_uniforms
from chap_tpu_torch.train.step_supervised import build_supervised_train_step

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # outside the tensor cores
RTOL = 2e-3
# per CHAP step: 4 mix_loss calls, each one K1 forward over both regions and
# one K1 backward in each of grads_l, grads_u and total.backward(); one K2
LAUNCHES_PER_STEP = {"K1_fwd": 4, "K1_bwd": 12, "K2_ccl": 1}
# per supervised step: dice_ce_supervised on each decoder output, K1 with R = 1
SUPERVISED_LAUNCHES_PER_STEP = {"K1_fwd": 2, "K1_bwd": 2, "K2_ccl": 0}
# the trainer phase: configs/acdc_chap.yml through the CLI, synthetic data
RUNS_DIR = os.path.join("build", "chip_smoke_runs")
TRAINER_FLAGS = ["--cfg", "configs/acdc_chap.yml", "--dataset", "synthetic",
                 "--adv_noise", "--dropout", "--labeled_num", "7",
                 "--device", "cuda"]
TRAINER_OVERRIDES = ["eval.eval_every=10", "data.synthetic_val_volumes=2",
                     "run.log_every=10", f"run.snapshot_root={RUNS_DIR}"]
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def launch_counts() -> dict:
    return {"K1_fwd": fused_losses.stats_kernel.launches,
            "K1_bwd": fused_losses.stats_grad_kernel.launches,
            "K2_ccl": nms.ccl_kernel.launches}


def zero_launch_counts() -> None:
    fused_losses.stats_kernel.launches = 0
    fused_losses.stats_grad_kernel.launches = 0
    nms.ccl_kernel.launches = 0


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


def kernel_counts(fn, n: int) -> dict:
    """name -> number of device kernels torch.profiler sees while fn runs n
    times. A session that saw no device kernel at all is taken once more:
    torch.profiler has returned an empty session for a short call."""
    for _ in range(2):
        counts = {}
        for name, _ in device_kernels(fn, n):
            counts[name] = counts.get(name, 0) + 1
        if counts:
            break
    return counts


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
        # device kernels of 3 Function calls: each forward launches 1 or 2
        # kernels, each backward 1
        x = logits.clone().requires_grad_(True)
        fwd_k = kernel_counts(
            lambda: fused_losses.region_dice_ce(x, labels, mask, lab2), 3)
        vals = fused_losses.region_dice_ce(x, labels, mask, lab2)
        bwd_k = kernel_counts(
            lambda: torch.autograd.grad(vals, [x], grads, retain_graph=True), 3)
        check(1 <= len(fwd_k) <= 2 and set(fwd_k.values()) == {3}
              and len(bwd_k) == 1 and set(bwd_k.values()) == {3},
              f"K1 Function's device kernels over 3 calls at {tag}: forward "
              f"{fwd_k}, backward {bwd_k}")
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
    zero_launch_counts()
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
    return launches, res["median_step_ms"]


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


# ---------------------------------------------------------------------------
# phases 7 and 8: eval parity and the trainer through its CLI
# ---------------------------------------------------------------------------

def phase_eval_parity() -> dict:
    """Slice-wise eval on the card and on the CPU from the same weights,
    trained briefly on phantoms so the predictions are not one class."""
    set_tf32(False)
    cfg = acdc_chap_config()
    cfg.model.feature_chns = (4, 8, 16, 16, 32)
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.data.image_size = (64, 64)
    torch.manual_seed(5)
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device="cuda")
    opt = make_optimizer(model, cfg.optim.base_lr)
    state = create_train_state(model, opt, cfg.model.feature_chns)
    step = build_supervised_train_step(model, opt, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(30):
        step(state, phantom_inputs(cfg, 200 + i, "cuda"), gen)
    cpu_model = net_factory(cfg.model.name, cfg.data.in_chns,
                            cfg.data.num_classes, cfg.model, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    ds = SyntheticVolumeDataset((6, 64, 64), cfg.data.num_classes, length=2)
    on_card = make_predictor(model, device="cuda")
    on_cpu = make_predictor(cpu_model, device="cpu")
    agree = [float(np.mean(predict_volume(on_card, ds[i]["image"], (64, 64))
                           == predict_volume(on_cpu, ds[i]["image"], (64, 64))))
             for i in range(len(ds))]
    m_card = evaluate_volumes(ds, on_card, cfg.data.num_classes, (64, 64))
    m_cpu = evaluate_volumes(ds, on_cpu, cfg.data.num_classes, (64, 64))
    dice = [float(m_card[:, 0].mean()), float(m_cpu[:, 0].mean())]
    res = {"pixel_agreement": agree, "mean_dice_card_cpu": dice,
           "mean_hd95_card_cpu": [float(m_card[:, 1].mean()),
                                  float(m_cpu[:, 1].mean())],
           "settings": tf32_settings()}
    print("eval_parity", json.dumps(res), flush=True)
    check(min(agree) >= 0.999, f"eval predictions agree on >= 99.9%: {agree}")
    check(abs(dice[0] - dice[1]) <= 1e-3, f"eval mean dice card vs cpu {dice}")
    return res


def _records(save_dir: str) -> list:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _meta(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "checkpoints", "meta.json")) as f:
        return json.load(f)


def trainer_run(flags, overrides, steps, per_step) -> dict:
    """One cli.train_2d.main call with the launch counters set to 0 just
    before it and read just after; they must be ``steps`` x ``per_step``
    (eval and checkpoints launch no K1 or K2)."""
    zero_launch_counts()
    t0 = time.perf_counter()
    out = cli_train.main(TRAINER_FLAGS + flags + TRAINER_OVERRIDES + overrides)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {k: v * steps for k, v in per_step.items()}
    check(launches == want, f"trainer launches {launches}, expected {want} "
                            f"({per_step} per step over {steps} steps)")
    records = _records(out["save_dir"])
    return {**out, "wall_s": wall_s, "launches": launches, "records": records}


def phase_trainer(bare_step_ms: float) -> dict:
    set_tf32(True)     # PyTorch's defaults, as in phase 6
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    first = trainer_run(["--max_iterations", "20"], [], 20, LAUNCHES_PER_STEP)
    peak = torch.cuda.max_memory_allocated()
    save_dir = first["save_dir"]
    check(first["steps"] == 20, f"20 CHAP steps, ran {first['steps']}")
    best_before = _meta(save_dir)
    resumed = trainer_run(["--max_iterations", "30", "--resume"], [], 10,
                          LAUNCHES_PER_STEP)
    check(resumed["save_dir"] == save_dir and resumed["steps"] == 30,
          f"resume continues the run to step 30: {resumed['steps']}")
    evals = [r for r in resumed["records"] if "val_mean_dice" in r]
    check([r["step"] for r in evals] == [10, 20, 30],
          f"evals at 10, 20, 30: {[r['step'] for r in evals]}")
    best_after = _meta(save_dir)
    check(best_after["best_metric"] >= best_before["best_metric"] and
          (best_after == best_before or best_after["best_iteration"] == 30),
          f"best slot kept across the resume: {best_before} -> {best_after}")
    t0 = time.perf_counter()
    test_mean = cli_test.main(["--snapshot", save_dir, "--ckpt", "best",
                               "--device", "cuda"])
    test_s = time.perf_counter() - t0
    check(np.isfinite(test_mean).all() and test_mean.shape == (3, 4),
          f"cli.test_2d metrics {test_mean}")
    check(os.path.exists(os.path.join(save_dir, "performance.txt")),
          "cli.test_2d wrote performance.txt")
    supervised = trainer_run(["--max_iterations", "5", "--mode", "supervised",
                              "--exp", "supervised"], ["eval.eval_every=5"],
                             5, SUPERVISED_LAUNCHES_PER_STEP)
    # 10 steps with an eval every 5: the second stretch runs without the
    # first step's warm-up or the loader's start
    host = trainer_run(["--max_iterations", "10", "--exp", "host_input"],
                       ["eval.eval_every=5", "data.device_input=false"],
                       10, LAUNCHES_PER_STEP)

    def rates(run, key="steps_per_sec_since_eval", after=0):
        return [r[key] for r in run["records"] if key in r and r["step"] > after]
    for run in (first, resumed, supervised, host):
        for r in run["records"]:
            if "loss" in r:
                check(math.isfinite(r["loss"]), f"finite loss {r}")
    pool = [r["pool_build_s"] for r in resumed["records"] if "pool_build_s" in r]
    with open(os.path.join(save_dir, "config.json")) as f:
        data_cfg = json.load(f)["data"]
    res = {
        "card": card_line(), "batch": data_cfg["batch_size"],
        "labeled_bs": data_cfg["labeled_bs"], "image_size": data_cfg["image_size"],
        "pool_slices": data_cfg["synthetic_train_size"], "pool_build_s": pool,
        "device_input_steps_per_s": rates(resumed),
        "host_input_steps_per_s": rates(host),
        "supervised_steps_per_s": rates(supervised),
        "bare_step_steps_per_s": 1e3 / bare_step_ms,
        # steps over the wall time from the run's loop start to each log
        # step, the evals and checkpoints before it included
        "window_steps_per_s": {
            "chap_20": rates(first, "steps_per_sec"),
            "resume_10": rates(resumed, "steps_per_sec", after=20)},
        "eval_s": [r["eval_s"] for r in evals],
        "checkpoint_ms": [r["checkpoint_ms"] for r in evals],
        "val_dice": [r["val_mean_dice"] for r in evals],
        "best": best_after, "test_2d_mean": test_mean.mean(axis=0).tolist(),
        "test_2d_s": test_s, "peak_mem_bytes": peak,
        "wall_s": {"chap_20": first["wall_s"], "resume_10": resumed["wall_s"],
                   "supervised_5": supervised["wall_s"], "host_10": host["wall_s"]},
        "launches": {"chap_20": first["launches"], "resume_10": resumed["launches"],
                     "supervised_5": supervised["launches"],
                     "host_10": host["launches"]},
        "settings": tf32_settings()}
    print("trainer", json.dumps(res), flush=True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return res


def loop_breakdown(when: str, rounds: int = 2, n: int = 5) -> dict:
    """What the trainer's loop adds to the bare step, in one process at one
    moment: ms per step on phase 6's phantom batches and on batches the
    device pool's batch function draws each step, each with a sync after
    every step and with one sync after ``n`` steps (the trainer's way),
    alternated over ``rounds``; and the batch function's own device ms.
    ``when`` tags the line. main does not run it: call it by hand."""
    set_tf32(True)     # PyTorch's defaults, as in phase 6
    cfg =cli_train.build_config(cli_train.parse_args(
        TRAINER_FLAGS + TRAINER_OVERRIDES))
    state, step = make_step(cfg, "cuda", seed=1337)
    slices = cfg.data.synthetic_train_size
    labeled = patients_to_slices(cfg.data.dataset, cfg.data.labeled_num)
    pool = build_device_pool(SyntheticSliceDataset(
        cfg.data.image_size[0], cfg.data.num_classes, slices),
        cfg.data.image_size, device="cuda")
    batch_fn = build_device_batch_fn(slices, labeled, cfg.data.batch_size,
                                     cfg.data.labeled_bs)
    gen = torch.Generator(device="cuda").manual_seed(1337)
    bgen = torch.Generator(device="cuda").manual_seed(7)
    phantoms = [phantom_inputs(cfg, 10 + i, "cuda") for i in range(n)]
    step(state, phantoms[0], gen)                    # warm-up
    torch.cuda.synchronize()

    def run(pooled: bool, sync_each: bool) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            step(state, batch_fn(pool, bgen) if pooled else phantoms[i], gen)
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    kinds = {"phantom_sync_each": (False, True), "pool_sync_each": (True, True),
             "pool_sync_end": (True, False), "phantom_sync_end": (False, False)}
    ms = {k: [] for k in kinds}
    for _ in range(rounds):
        for k, (pooled, sync_each) in kinds.items():
            ms[k].append(run(pooled, sync_each))
    res = {"ms_per_step": ms,
           "batch_fn_device_ms": device_ms(lambda: batch_fn(pool, bgen), 50),
           "batch_fn_host_us": host_us(lambda: batch_fn(pool, bgen), 50),
           "steps": n, "rounds": rounds, "when": when}
    print("loop", json.dumps(res), flush=True)
    return res


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
    launches, bare_step_ms = phase_slice()
    # phase 7: eval parity, card against CPU
    phase_eval_parity()
    # phase 8: the trainer through its CLI at full width
    trainer = phase_trainer(bare_step_ms)

    # phase 9: report
    k2_bound = k2["clean"]["bound"]
    kernels = [
        {"name": "K1_fwd", "route": "triton",
         "source": "chap_tpu_torch/ops/fused_losses.py",
         "replaces": "chap_tpu/ops/fused_losses.py:99",
         "launches": launches["K1_fwd"],
         "trainer_launches": sum(r["K1_fwd"] for r in trainer["launches"].values()),
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
         "trainer_launches": sum(r["K1_bwd"] for r in trainer["launches"].values()),
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
         "trainer_launches": sum(r["K2_ccl"] for r in trainer["launches"].values()),
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
