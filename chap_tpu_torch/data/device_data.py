"""Device-resident input, the 2D half (port of chap_tpu/data/device_data.py,
the default ``data.device_input=true`` path): upload the slice pool to the
card once, then sample and augment every training batch on the card, so a
step needs no host->device copy and no host sync for its input.

  * pool build: every raw slice is loaded once, order-0 resized to the
    network size on the host, and copied in one transfer (at ACDC scale
    1,312 x 256^2 x (4 + 1) B, about 430 MB of fp32 images + uint8 labels);
  * sampling: two-stream batches drawn with ``torch.randint`` from a
    ``torch.Generator`` on the pool's device, uniform with replacement over
    the labeled / unlabeled index ranges (the host TwoStreamBatchSampler
    shuffles without replacement within an epoch; the host path stays
    available with ``data.device_input=false``);
  * augmentation: the RandomGenerator recipe (50% rot90+flip, else 50% a
    nearest rotation by an integer angle in [-20, 20) degrees) as one
    nearest-neighbour gather per sample, vectorised over the batch. rot90 and
    flip are exact integer index maps; the rotation follows scipy's order-0
    ``rotate(reshape=False)``: the inverse map about (size - 1) / 2,
    nearest = floor(x + 0.5), constant 0 outside [0, size - 1].

The 3D volume pool and patch sampler wait for the 3D slice (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from chap_tpu_torch.data.transforms import resize_slice
from chap_tpu_torch.device import resolve_device


class DevicePool(NamedTuple):
    """images [N,H,W] float32 and labels [N,H,W] uint8 on one device (the
    train steps widen the labels)."""
    images: torch.Tensor
    labels: torch.Tensor


def build_device_pool(dataset, image_size: Tuple[int, int],
                      dtype: torch.dtype = torch.float32,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> DevicePool:
    """Load every raw (untransformed) slice once, resize it to ``image_size``
    (order 0, like the RandomGenerator tail) and upload the pool in one copy
    to ``device`` (the card unless ``device="cpu"``). ``dataset`` yields
    {'image': HxW, 'label': HxW}; its ``transform``, if any, is bypassed
    while the pool is read and restored afterwards."""
    device = resolve_device(device)
    n = len(dataset)
    h, w = image_size
    images = np.empty((n, h, w), np.float32)
    labels = np.empty((n, h, w), np.uint8)
    transform = getattr(dataset, "transform", None)
    if transform is not None:
        dataset.transform = None
    try:
        for i in range(n):
            s = dataset[i]
            img, lab = s["image"], s["label"]
            if img.shape != (h, w):
                img = resize_slice(img, (h, w), order=0)
                lab = resize_slice(lab, (h, w), order=0)
            images[i] = img
            labels[i] = lab.astype(np.uint8)
    finally:
        if transform is not None:
            dataset.transform = transform
    return DevicePool(torch.from_numpy(images).to(device=device, dtype=dtype),
                      torch.from_numpy(labels).to(device))


def apply_augment(img: torch.Tensor, lab: torch.Tensor, mode, k, ax, ang
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parameter-forced augmentation of a batch, img / lab [B,H,W]; each of
    mode, k, ax (integers) and ang (radians, float32) is a [B] tensor or a
    scalar for the whole batch. Per sample: mode 0 = flip(rot90(x, k), ax),
    mode 1 = nearest rotation by ``ang`` with constant-0 padding, mode 2 =
    identity. One gather per sample."""
    b, h, w = img.shape
    dev = img.device

    def per_sample(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(b).view(b, 1, 1)

    mode, k, ax = (per_sample(v, torch.int64) for v in (mode, k, ax))
    ang = per_sample(ang, torch.float32)
    ii = torch.arange(h, device=dev).view(1, h, 1).expand(b, h, w)
    jj = torch.arange(w, device=dev).view(1, 1, w).expand(b, h, w)

    # mode 0: out[i, j] = rot90(img, k)[fi, fj] with (fi, fj) the flipped
    # output coordinates; np.rot90(img, k)[a, b]'s source indices per k
    fi = torch.where(ax == 0, h - 1 - ii, ii)
    fj = torch.where(ax == 1, w - 1 - jj, jj)
    si_r = torch.where(k == 0, fi, torch.where(k == 1, fj, torch.where(
        k == 2, h - 1 - fi, h - 1 - fj)))
    sj_r = torch.where(k == 0, fj, torch.where(k == 1, w - 1 - fi, torch.where(
        k == 2, w - 1 - fj, fi)))

    # mode 1: inverse rotation about the centre, in float32 as chap_tpu
    c_i, c_j = (h - 1) / 2.0, (w - 1) / 2.0
    di = ii.float() - c_i
    dj = jj.float() - c_j
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    src_i = cos_a * di + sin_a * dj + c_i
    src_j = -sin_a * di + cos_a * dj + c_j
    in_bounds = (src_i >= 0) & (src_i <= h - 1) & (src_j >= 0) & (src_j <= w - 1)
    si_a = torch.floor(src_i + 0.5).long().clamp(0, h - 1)
    sj_a = torch.floor(src_j + 0.5).long().clamp(0, w - 1)

    si = torch.where(mode == 0, si_r, torch.where(mode == 1, si_a, ii))
    sj = torch.where(mode == 0, sj_r, torch.where(mode == 1, sj_a, jj))
    flat = (si * w + sj).view(b, h * w)
    img_out = torch.gather(img.reshape(b, h * w), 1, flat).view(b, h, w)
    lab_out = torch.gather(lab.reshape(b, h * w), 1, flat).view(b, h, w)
    pad = (mode == 1) & ~in_bounds
    img_out = img_out.masked_fill(pad, 0)
    lab_out = lab_out.masked_fill(pad, 0)
    return img_out, lab_out


def draw_augment(batch_size: int, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, ...]:
    """One sample's RandomGenerator draws per row, on the generator's device:
    (mode, k, ax, ang in radians). mode: 0 if u1 > 0.5, else 1 if u2 > 0.5,
    else 2 (transforms.py's branch order)."""
    dev = generator.device
    u = torch.rand((2, batch_size), generator=generator, device=dev)
    k = torch.randint(0, 4, (batch_size,), generator=generator, device=dev)
    ax = torch.randint(0, 2, (batch_size,), generator=generator, device=dev)
    deg = torch.randint(-20, 20, (batch_size,), generator=generator, device=dev)
    mode = torch.where(u[0] > 0.5, 0, torch.where(u[1] > 0.5, 1, 2))
    return mode, k, ax, deg.float() * (math.pi / 180.0)


def build_device_batch_fn(num_slices: int, num_labeled: int, batch_size: int,
                          labeled_bs: int, augment: bool = True) -> Callable:
    """Returns batch_fn(pool, generator) -> {'image': [B,1,H,W], 'label':
    [B,H,W] uint8} with the two-stream layout [labeled_bs rows drawn from
    [0, num_labeled) ; the rest from [num_labeled, num_slices)]. Every draw
    comes from ``generator``, which lies on the pool's device: no host sync."""
    if not 0 < num_labeled < num_slices:
        raise ValueError(f"need 0 < num_labeled ({num_labeled}) < num_slices "
                         f"({num_slices}) for two streams")

    def batch_fn(pool: DevicePool, generator: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
        dev = pool.images.device
        if augment and pool.images.shape[1] != pool.images.shape[2]:
            raise ValueError(f"on-device rot90 augmentation needs square "
                             f"slices, the pool holds "
                             f"{tuple(pool.images.shape[1:])}")
        lab_idx = torch.randint(0, num_labeled, (labeled_bs,),
                                generator=generator, device=dev)
        unlab_idx = torch.randint(num_labeled, num_slices,
                                  (batch_size - labeled_bs,),
                                  generator=generator, device=dev)
        idx = torch.cat([lab_idx, unlab_idx])
        imgs, labs = pool.images[idx], pool.labels[idx]
        if augment:
            imgs, labs = apply_augment(imgs, labs,
                                       *draw_augment(batch_size, generator))
        return {"image": imgs.unsqueeze(1), "label": labs}

    return batch_fn
