"""3D patch augmentation for LA / Pancreas / BraTS training (a copy of
chap_tpu/data/transforms3d.py, kept here so the port never imports the JAX
package): the RandomCrop + RandomRotFlip recipe the reference's 3D
protocols assume. The one change: ``RandomGenerator3D`` returns the image
channel-first [1, X, Y, Z] (chap_tpu: [X, Y, Z, 1]), so the host loader
collates NCDHW batches."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def random_crop_3d(image: np.ndarray, label: np.ndarray,
                   patch: Sequence[int], rng: np.random.RandomState
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Random patch crop with pad-to-patch for small volumes."""
    pads = [max(patch[i] - image.shape[i], 0) for i in range(3)]
    if any(pads):
        pad = [(p // 2, p - p // 2) for p in pads]
        image = np.pad(image, pad, mode="constant")
        label = np.pad(label, pad, mode="constant")
    starts = [rng.randint(0, image.shape[i] - patch[i] + 1) for i in range(3)]
    sl = tuple(slice(s, s + p) for s, p in zip(starts, patch))
    return image[sl], label[sl]


def random_rot_flip_3d(image: np.ndarray, label: np.ndarray,
                       rng: np.random.RandomState
                       ) -> Tuple[np.ndarray, np.ndarray]:
    k = rng.randint(0, 4)
    image = np.rot90(image, k, axes=(0, 1))
    label = np.rot90(label, k, axes=(0, 1))
    axis = rng.randint(0, 3)
    return np.flip(image, axis).copy(), np.flip(label, axis).copy()


class RandomGenerator3D:
    """{'image','label'} volumes [X, Y, Z] -> augmented fixed-size patches:
    image [1, X, Y, Z] float32, label [X, Y, Z] int32."""

    def __init__(self, patch_size: Sequence[int], seed: int = 0):
        self.patch = tuple(patch_size)
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        image, label = sample["image"], sample["label"]
        if self.rng.rand() > 0.5:
            image, label = random_rot_flip_3d(image, label, self.rng)
        image, label = random_crop_3d(image, label, self.patch, self.rng)
        return {"image": image.astype(np.float32)[None],
                "label": label.astype(np.int32)}
