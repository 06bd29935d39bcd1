"""Inputs and weights made from the seed on the run's device, in a few
large calls: the 2D slice pool, the 3D volume pool, the eval volumes and
the initial parameters. The program and the reference are both handed
what is made here.

The images are phantoms, so that the pseudo-labels' largest-component
cleanup sees components and not noise: a 2D slice holds a right
ventricle (class 1), a myocardial ring (2) around a left-ventricle
cavity (3), ACDC's four classes; a 3D volume holds a left atrium
(class 1) with an appendage, LA's two. Intensities by class, plus a
smooth background and noise.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# intensity of each class of the 2D phantoms, and of the 3D ones
SLICE_LEVELS = (0.1, 0.5, 0.3, 0.8)
VOLUME_LEVELS = (0.15, 0.7)
NOISE = 0.05
CHUNK = 64          # slices or volumes made in one call


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of draws of a run (``tags`` name the
    stream), from the run's seed, which may exceed 32 bits."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32 & 0xFFFFFFFF, *tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(device: torch.device, seed: int, *tags: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


def _grid(shape: Sequence[int], device: torch.device) -> List[torch.Tensor]:
    """Coordinates in [0, 1] along each axis, shaped to broadcast."""
    axes = []
    for i, n in enumerate(shape):
        view = [1] * (len(shape) + 1)
        view[i + 1] = n
        axes.append(torch.linspace(0.0, 1.0, n, device=device).view(view))
    return axes


def slice_pool(n: int, size: Tuple[int, int], gen: torch.Generator,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` phantom slices: images [n, H, W] in ``dtype`` and labels
    [n, H, W] uint8, on the generator's device."""
    dev = gen.device
    images = torch.empty((n,) + tuple(size), dtype=dtype, device=dev)
    labels = torch.empty((n,) + tuple(size), dtype=torch.uint8, device=dev)
    yy, xx = _grid(size, dev)
    levels = torch.tensor(SLICE_LEVELS, device=dev)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        u = torch.rand((m, 8), generator=gen, device=dev).view(m, 8, 1, 1)
        cy, cx = 0.35 + 0.3 * u[:, 0], 0.35 + 0.3 * u[:, 1]
        r_lv = 0.05 + 0.05 * u[:, 2]
        ring = 0.02 + 0.02 * u[:, 3]
        ang = math.pi * u[:, 4]
        ry, rx = 0.08 + 0.06 * u[:, 5], 0.12 + 0.08 * u[:, 6]
        dy, dx = yy - cy, xx - cx
        r = torch.sqrt(dy * dy + dx * dx)
        # the right ventricle: an ellipse beside the ring, at angle ``ang``
        oy = dy - (r_lv + ring + 0.5 * ry) * torch.sin(ang)
        ox = dx - (r_lv + ring + 0.5 * ry) * torch.cos(ang)
        a = oy * torch.cos(ang) - ox * torch.sin(ang)
        b = oy * torch.sin(ang) + ox * torch.cos(ang)
        rv = (a / ry) ** 2 + (b / rx) ** 2 <= 1.0
        lab = torch.where(r <= r_lv, 3, torch.where(r <= r_lv + ring, 2,
                                                    torch.where(rv, 1, 0)))
        noise = torch.randn((m,) + tuple(size), generator=gen, device=dev)
        img = levels[lab] + 0.1 * u[:, 7] * (yy + xx) + NOISE * noise
        images[lo:lo + m] = img.to(dtype)
        labels[lo:lo + m] = lab.to(torch.uint8)
    return images, labels


def volumes(n: int, extent: Tuple[int, int, int], gen: torch.Generator,
            dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` phantom volumes [n, X, Y, Z] in ``dtype`` and their labels
    uint8, on the generator's device."""
    dev = gen.device
    images = torch.empty((n,) + tuple(extent), dtype=dtype, device=dev)
    labels = torch.empty((n,) + tuple(extent), dtype=torch.uint8, device=dev)
    gx, gy, gz = _grid(extent, dev)
    levels = torch.tensor(VOLUME_LEVELS, device=dev)
    for lo in range(0, n, max(1, CHUNK // 8)):
        m = min(max(1, CHUNK // 8), n - lo)
        u = torch.rand((m, 10), generator=gen, device=dev).view(m, 10, 1, 1, 1)
        c = [0.4 + 0.2 * u[:, i] for i in range(3)]
        rad = [0.15 + 0.1 * u[:, 3 + i] for i in range(3)]
        body = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip((gx, gy, gz), c, rad))
        # the appendage: a smaller ball at the body's edge
        ac = [ci + 0.8 * ri * (2 * u[:, 6 + i] - 1) for i, (ci, ri) in
              enumerate(zip(c, rad))]
        ar = 0.05 + 0.04 * u[:, 9]
        app = sum((g - ci) ** 2 for g, ci in zip((gx, gy, gz), ac)) / ar ** 2
        lab = ((body <= 1.0) | (app <= 1.0)).to(torch.int64)
        noise = torch.randn((m,) + tuple(extent), generator=gen, device=dev)
        img = levels[lab] + 0.1 * gz + NOISE * noise
        images[lo:lo + m] = img.to(dtype)
        labels[lo:lo + m] = lab.to(torch.uint8)
    return images, labels


def init_params(shapes: Dict[str, torch.Size], gen: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Initial float32 parameters for the named ``shapes``, from one normal
    draw: a kernel (two or more axes) He-normal over its fan-in as PyTorch
    counts it, a BatchNorm scale (a 1-axis ``weight``) 1, a bias 0."""
    names = list(shapes)
    counts = [math.prod(shapes[k]) for k in names]
    mean, std = [], []
    for k in names:
        s = shapes[k]
        if len(s) >= 2:
            fan_in = s[1] * math.prod(s[2:])
            mean.append(0.0)
            std.append(math.sqrt(2.0 / fan_in))
        else:
            mean.append(1.0 if k.endswith("weight") else 0.0)
            std.append(0.0)
    dev = gen.device
    rep = torch.tensor(counts, device=dev)
    flat = torch.randn(sum(counts), generator=gen, device=dev)
    flat = (torch.repeat_interleave(torch.tensor(mean, device=dev), rep)
            + torch.repeat_interleave(torch.tensor(std, device=dev), rep) * flat)
    return {k: v.view(shapes[k]) for k, v in zip(names, flat.split(counts))}
