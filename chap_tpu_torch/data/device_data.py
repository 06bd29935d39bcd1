"""Device-resident input (port of chap_tpu/data/device_data.py, the default
``data.device_input=true`` path). The 2D half: upload the slice pool to the
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

The 3D half (chap_tpu/data/device_data.py:142-253): the volume pool, every
volume centre-padded to the patch and then zero-padded into one common box
with its true extent kept; and the patch function, which draws the two
streams' volume ids, a uniform crop start inside each volume's extent and
the RandomRotFlip parameters on the card, and cuts and augments the whole
batch with one gather per tensor (the crop offsets composed with the
rot90 / flip index map), with no per-sample Python.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from chap_tpu_torch.data.transforms import resize_slice
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.parallel import dist


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
                          labeled_bs: int, augment: bool = True,
                          roles: int = 1, rank: int = 0, world: int = 1
                          ) -> Callable:
    """Returns batch_fn(pool, generator) -> {'image': [B,1,H,W], 'label':
    [B,H,W] uint8} with the two-stream layout [labeled_bs rows drawn from
    [0, num_labeled) ; the rest from [num_labeled, num_slices)]. Every draw
    comes from ``generator``, which lies on the pool's device: no host sync.

    Data parallel (``world`` > 1): every draw is made for the global batch,
    so each rank's generator, seeded alike, draws the same numbers; the rank
    then gathers and augments only its rows (parallel/dist.py ``rank_rows``
    with ``roles`` equal roles: 4 for the CHAP step, 1 for the supervised
    one) from the pool, which it holds whole. B is then the rank's rows."""
    if not 0 < num_labeled < num_slices:
        raise ValueError(f"need 0 < num_labeled ({num_labeled}) < num_slices "
                         f"({num_slices}) for two streams")
    rows = None
    if world > 1:
        rows = dist.rank_rows(batch_size, roles, rank, world)

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
        params = draw_augment(batch_size, generator) if augment else None
        if rows is not None:
            sel = torch.tensor(rows, device=dev)
            idx = idx[sel]
            if params is not None:
                params = tuple(p[sel] for p in params)
        imgs, labs = pool.images[idx], pool.labels[idx]
        if augment:
            imgs, labs = apply_augment(imgs, labs, *params)
        return {"image": imgs.unsqueeze(1), "label": labs}

    return batch_fn


# ---------------------------------------------------------------------------
# 3D: volume pool and patch function
# ---------------------------------------------------------------------------

class DeviceVolumePool(NamedTuple):
    """images [N, X, Y, Z] float32 and labels [N, X, Y, Z] uint8 on one
    device, in a common box; shapes [N, 3] int64 the true per-volume extents
    inside it (volumes smaller than the patch centre-padded to it first, as
    transforms3d.random_crop_3d does)."""
    images: torch.Tensor
    labels: torch.Tensor
    shapes: torch.Tensor


def build_device_volume_pool(volumes, patch: Tuple[int, int, int],
                             dtype: torch.dtype = torch.float32,
                             device: Optional[Union[str, torch.device]] = None
                             ) -> DeviceVolumePool:
    """volumes: a sequence of {'image': [X, Y, Z], 'label': [X, Y, Z]} host
    dicts, uploaded in one copy each to ``device`` (the card unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    n = len(volumes)
    shapes = np.zeros((n, 3), np.int64)
    padded = []
    for i in range(n):
        img = np.asarray(volumes[i]["image"], np.float32)
        lab = np.asarray(volumes[i]["label"], np.uint8)
        pads = [max(patch[d] - img.shape[d], 0) for d in range(3)]
        if any(pads):
            pad = [(p // 2, p - p // 2) for p in pads]
            img = np.pad(img, pad, mode="constant")
            lab = np.pad(lab, pad, mode="constant")
        shapes[i] = img.shape
        padded.append((img, lab))
    box = tuple(int(shapes[:, d].max()) for d in range(3))
    images = np.zeros((n, *box), np.float32)
    labels = np.zeros((n, *box), np.uint8)
    for i, (img, lab) in enumerate(padded):
        sl = (i,) + tuple(slice(0, s) for s in shapes[i])
        images[sl] = img
        labels[sl] = lab
    return DeviceVolumePool(torch.from_numpy(images).to(device=device, dtype=dtype),
                            torch.from_numpy(labels).to(device),
                            torch.from_numpy(shapes).to(device))


def rot_flip_index_3d(k: torch.Tensor, ax: torch.Tensor, patch: Tuple[int, int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source indices inside a patch of out = flip(rot90(x, k, axes=(0, 1)),
    ax) per sample (chap_tpu's _augment_patch_3d); k, ax: [B] int64, ax 3
    for no flip. Returns (si [B, px, py], sj [B, px, py], sk [B, pz])."""
    px, py, pz = patch
    if px != py:
        raise ValueError(f"XY-rot90 augmentation needs a square XY patch, got "
                         f"{tuple(patch)}")
    dev = k.device
    k, ax = k.view(-1, 1, 1), ax.view(-1, 1, 1)
    ii = torch.arange(px, device=dev).view(1, px, 1)
    jj = torch.arange(py, device=dev).view(1, 1, py)
    fi = torch.where(ax == 0, px - 1 - ii, ii)
    fj = torch.where(ax == 1, py - 1 - jj, jj)
    si = torch.where(k == 0, fi, torch.where(k == 1, fj, torch.where(
        k == 2, px - 1 - fi, px - 1 - fj)))
    sj = torch.where(k == 0, fj, torch.where(k == 1, py - 1 - fi, torch.where(
        k == 2, py - 1 - fj, fi)))
    kk = torch.arange(pz, device=dev).view(1, pz)
    sk = torch.where(ax.view(-1, 1) == 2, pz - 1 - kk, kk)
    return si, sj, sk


def gather_patches(pool: DeviceVolumePool, vids: torch.Tensor,
                   starts: torch.Tensor, k: torch.Tensor, ax: torch.Tensor,
                   patch: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut patch ``b`` of volume vids[b] at starts[b] ([B, 3]) and apply its
    rot / flip (k[b], ax[b]): one gather per tensor for the whole batch.
    Returns images [B, px, py, pz] and labels [B, px, py, pz]."""
    si, sj, sk = rot_flip_index_3d(k, ax, patch)
    b = vids.shape[0]
    xs = (starts[:, 0].view(b, 1, 1) + si)[:, :, :, None]
    ys = (starts[:, 1].view(b, 1, 1) + sj)[:, :, :, None]
    zs = (starts[:, 2].view(b, 1) + sk)[:, None, None, :]
    v = vids.view(b, 1, 1, 1)
    return pool.images[v, xs, ys, zs], pool.labels[v, xs, ys, zs]


def draw_augment_3d(batch_size: int, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RandomRotFlip draws per row, on the generator's device: with
    probability 0.5 (u > 0.5) k in 0..3 and a flip axis in 0..2, else the
    identity (k 0, ax 3)."""
    dev = generator.device
    do = torch.rand(batch_size, generator=generator, device=dev) > 0.5
    k = torch.randint(0, 4, (batch_size,), generator=generator, device=dev)
    ax = torch.randint(0, 3, (batch_size,), generator=generator, device=dev)
    return torch.where(do, k, 0), torch.where(do, ax, 3)


def build_device_patch_fn(num_volumes: int, num_labeled: int, batch_size: int,
                          labeled_bs: int, patch: Tuple[int, int, int],
                          augment: bool = True) -> Callable:
    """Returns patch_fn(pool, generator) -> {'image': [B, 1, *patch],
    'label': [B, *patch] uint8}: two-stream volume ids (labeled ids <
    num_labeled), a uniform crop inside each volume's true extent and
    RandomRotFlip, every draw from ``generator`` on the pool's device."""
    if not 0 < num_labeled < num_volumes:
        raise ValueError(f"need 0 < num_labeled ({num_labeled}) < num_volumes "
                         f"({num_volumes}) for two streams")

    def patch_fn(pool: DeviceVolumePool, generator: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
        dev = pool.images.device
        vids = torch.cat([
            torch.randint(0, num_labeled, (labeled_bs,), generator=generator,
                          device=dev),
            torch.randint(num_labeled, num_volumes, (batch_size - labeled_bs,),
                          generator=generator, device=dev)])
        u = torch.rand((batch_size, 3), generator=generator, device=dev)
        room = pool.shapes[vids] - torch.tensor(patch, device=dev) + 1
        starts = torch.floor(u * room.float()).long()
        if augment:
            k, ax = draw_augment_3d(batch_size, generator)
        else:
            k = torch.zeros(batch_size, dtype=torch.int64, device=dev)
            ax = torch.full((batch_size,), 3, dtype=torch.int64, device=dev)
        imgs, labs = gather_patches(pool, vids, starts, k, ax, patch)
        return {"image": imgs.unsqueeze(1), "label": labs}

    return patch_fn
