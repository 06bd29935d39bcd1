"""Synthetic cardiac-MR-like phantoms (a copy of chap_tpu/data/datasets.py::
_phantom_slice, :96-108). Background plus nested ellipses for classes
1..C-1, so the losses and the largest-CC cleanup see realistic label
statistics without data on disk. The rest of data/ is ported later."""
from __future__ import annotations

from typing import Tuple

import numpy as np


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


def phantom_batch(rng: np.random.RandomState, batch: int, size: int,
                  num_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """[batch, 1, size, size] float32 images and [batch, size, size] int32
    labels of independent phantoms."""
    pairs = [_phantom_slice(rng, size, num_classes) for _ in range(batch)]
    images = np.stack([p[0] for p in pairs])[:, None]
    labels = np.stack([p[1] for p in pairs])
    return images, labels
