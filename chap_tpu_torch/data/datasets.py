"""Datasets (a copy of chap_tpu/data/datasets.py, kept here so the port never
imports the JAX package): the ACDC h5 train slices and val/test volumes,
deterministic cardiac-MR-like phantoms (plain and hard), ``build_datasets``
and the labeled patients -> slices table.

ACDC on-disk layout (list-file driven, as chap_tpu's):
    <root>/train_slices.list            one slice id per line
    <root>/val.list / test.list         one case id per line
    <root>/data/slices/<slice_id>.h5    datasets 'image' [H,W], 'label' [H,W]
    <root>/data/<case_id>.h5            datasets 'image' [D,H,W], 'label' [D,H,W]

``h5py`` is imported only where an h5 file is read, so the synthetic path
needs nothing beyond numpy. The samples are numpy host arrays; the loaders
(data/pipeline.py, data/device_data.py) turn them into NCHW tensors.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def _read_h5(path: str) -> Dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as h5f:
        return {"image": h5f["image"][:], "label": h5f["label"][:]}


class AcdcSliceDataset:
    """Train-split slice dataset."""

    def __init__(self, base_dir: str, transform: Optional[Callable] = None,
                 num: Optional[int] = None):
        self.base_dir = base_dir
        self.transform = transform
        with open(os.path.join(base_dir, "train_slices.list")) as f:
            self.slice_ids = [line.strip() for line in f if line.strip()]
        if num is not None:
            self.slice_ids = self.slice_ids[:num]

    def __len__(self) -> int:
        return len(self.slice_ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = _read_h5(os.path.join(self.base_dir, "data", "slices",
                                       self.slice_ids[idx] + ".h5"))
        if self.transform:
            sample = self.transform(sample)
        return sample


class AcdcVolumeDataset:
    """Val/test-split full-volume dataset."""

    def __init__(self, base_dir: str, split: str = "val"):
        self.base_dir = base_dir
        with open(os.path.join(base_dir, f"{split}.list")) as f:
            self.case_ids = [line.strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.case_ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = _read_h5(os.path.join(self.base_dir, "data",
                                       self.case_ids[idx] + ".h5"))
        sample["case"] = self.case_ids[idx]
        return sample


# ---------------------------------------------------------------------------
# Synthetic data: deterministic cardiac-MR-like phantoms. Class layout mimics
# ACDC (background + 3 nested structures) so Dice/HD95 and the semi-supervised
# losses see realistic label statistics without data on disk.
# ---------------------------------------------------------------------------

def _phantom_slice(rng: np.random.RandomState, size: int, num_classes: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx, cy = rng.uniform(0.35, 0.65, 2) * size
    label = np.zeros((size, size), np.int32)
    radii = sorted(rng.uniform(0.08, 0.3, num_classes - 1) * size, reverse=True)
    for cls_offset, r in enumerate(radii):
        ecc = rng.uniform(0.7, 1.3)
        mask = ((xx - cx) ** 2 + ecc * (yy - cy) ** 2) < r ** 2
        label[mask] = cls_offset + 1
    image = label.astype(np.float32) / max(num_classes - 1, 1)
    image = image + rng.normal(0, 0.15, image.shape).astype(np.float32)
    return image, label


def _phantom_slice_hard(rng: np.random.RandomState, size: int,
                        num_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """The hard phantom protocol of the SSL-efficacy benchmark: appearance
    alone is ambiguous and a tiny labeled set cannot cover the variance.

      * nested anatomy with strong per-sample shape variance: wobbly
        sinusoidal boundaries (radial harmonics), random eccentricity/pose;
      * distractor blobs in the background whose intensity matches a random
        foreground class, so pixels cannot be classified by intensity;
      * per-sample class-intensity jitter, a smooth multiplicative bias field
        and heavy noise: class intensity distributions overlap.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx, cy = rng.uniform(0.3, 0.7, 2) * size
    ecc = rng.uniform(0.7, 1.4)
    ang = rng.uniform(0, np.pi)
    ca, sa = np.cos(ang), np.sin(ang)
    rx = ca * (xx - cx) + sa * (yy - cy)
    ry = -sa * (xx - cx) + ca * (yy - cy)
    rad = np.sqrt(rx ** 2 + ecc * ry ** 2) + 1e-6
    theta = np.arctan2(ry, rx)
    label = np.zeros((size, size), np.int32)

    def wobbly(r0: float) -> np.ndarray:
        r = np.full_like(theta, r0)
        for k in range(2, 6):
            r += r0 * rng.uniform(-0.15, 0.15) * np.sin(
                k * theta + rng.uniform(0, 2 * np.pi))
        return r

    base_r = rng.uniform(0.16, 0.30) * size
    shrink = (1.0, 0.62, 0.34)
    for ci in range(min(num_classes - 1, 3)):
        label[rad < wobbly(base_r * shrink[ci])] = ci + 1

    # class intensities: jittered per sample, heavily overlapping
    levels = np.linspace(0.0, 1.0, num_classes) \
        + rng.uniform(-0.12, 0.12, num_classes)
    image = levels[label].astype(np.float32)

    # distractor blobs: background pixels wearing a foreground intensity
    for _ in range(rng.randint(2, 6)):
        dx, dy = rng.uniform(0.05, 0.95, 2) * size
        dr = rng.uniform(0.02, 0.07) * size
        blob = ((xx - dx) ** 2 + (yy - dy) ** 2) < dr ** 2
        blob &= label == 0
        image[blob] = levels[rng.randint(1, num_classes)]

    # smooth multiplicative bias field + heavy additive noise
    gx, gy = rng.uniform(-1, 1, 2)
    bias = 1.0 + 0.25 * (gx * (xx / size - 0.5) + gy * (yy / size - 0.5)) \
        + 0.2 * np.sin(2 * np.pi * (xx / size) * rng.uniform(0.5, 1.5)
                       + rng.uniform(0, 2 * np.pi)) * 0.5
    image = image * bias.astype(np.float32)
    image = image + rng.normal(0, 0.25, image.shape).astype(np.float32)
    return image, label


def phantom_batch(rng: np.random.RandomState, batch: int, size: int,
                  num_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """[batch, 1, size, size] float32 images and [batch, size, size] int32
    labels of independent phantoms."""
    pairs = [_phantom_slice(rng, size, num_classes) for _ in range(batch)]
    images = np.stack([p[0] for p in pairs])[:, None]
    labels = np.stack([p[1] for p in pairs])
    return images, labels


class SyntheticSliceDataset:
    """Deterministic per-index phantom slices (hard=True: the SSL-efficacy
    protocol of :func:`_phantom_slice_hard`)."""

    def __init__(self, size: int = 256, num_classes: int = 4, length: int = 1312,
                 seed: int = 0, transform: Optional[Callable] = None,
                 hard: bool = False):
        self.size, self.num_classes, self.length = size, num_classes, length
        self.seed = seed
        self.transform = transform
        self.hard = hard

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        gen = _phantom_slice_hard if self.hard else _phantom_slice
        image, label = gen(rng, self.size, self.num_classes)
        sample = {"image": image, "label": label}
        if self.transform:
            sample = self.transform(sample)
        return sample


class SyntheticVolumeDataset:
    """Deterministic phantom volumes (the 2D trainer's val path)."""

    def __init__(self, shape: Tuple[int, int, int] = (10, 256, 256),
                 num_classes: int = 4, length: int = 8, seed: int = 1,
                 hard: bool = False):
        self.shape, self.num_classes, self.length, self.seed = shape, num_classes, length, seed
        self.hard = hard

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 99991 + idx)
        gen = _phantom_slice_hard if self.hard else _phantom_slice
        images, labels = [], []
        for _ in range(self.shape[0]):
            img, lab = gen(rng, self.shape[1], self.num_classes)
            images.append(img)
            labels.append(lab)
        return {"image": np.stack(images), "label": np.stack(labels),
                "case": f"synthetic_{idx:03d}"}


def build_datasets(cfg, transform: Optional[Callable] = None):
    """(train_slices, val_volumes) per the data config."""
    if cfg.dataset in ("synthetic", "synthetic_hard"):
        hard = cfg.dataset == "synthetic_hard"
        train = SyntheticSliceDataset(cfg.image_size[0], cfg.num_classes,
                                      cfg.synthetic_train_size,
                                      transform=transform, hard=hard)
        val = SyntheticVolumeDataset((10, cfg.image_size[0], cfg.image_size[1]),
                                     cfg.num_classes, cfg.synthetic_val_volumes,
                                     hard=hard)
        return train, val
    train = AcdcSliceDataset(cfg.root_path, transform=transform)
    val = AcdcVolumeDataset(cfg.root_path, split="val")
    return train, val


def patients_to_slices(dataset: str, patients_num: int) -> int:
    """Labeled-patient -> labeled-slice table (train_ours_2D.py:38-48)."""
    acdc = {3: 68, 7: 136, 14: 256, 21: 396, 28: 512, 35: 664, 140: 1312}
    prostate = {2: 27, 4: 53, 8: 120, 12: 179, 16: 256, 21: 312, 42: 623}
    table = (acdc if "ACDC" in dataset or dataset.startswith("synthetic")
             else prostate)
    return table[patients_num]
