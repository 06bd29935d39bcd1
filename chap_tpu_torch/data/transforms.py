"""Host-side augmentation for 2D slices (a copy of
chap_tpu/data/transforms.py): random rot90/flip or small rotation, then
nearest resize to the network input size. numpy/scipy host code for the
host loader path (data/pipeline.py); the default device path does the same
recipe on the card (data/device_data.py).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy.ndimage import rotate, zoom


def random_rot_flip(image: np.ndarray, label: np.ndarray, rng: np.random.RandomState):
    k = rng.randint(0, 4)
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = rng.randint(0, 2)
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def random_rotate(image: np.ndarray, label: np.ndarray, rng: np.random.RandomState):
    angle = rng.randint(-20, 20)
    image = rotate(image, angle, order=0, reshape=False)
    label = rotate(label, angle, order=0, reshape=False)
    return image, label


class RandomGenerator:
    """Callable transform: {'image': HxW, 'label': HxW} -> same at output_size.

    The SSL-standard recipe: 50% rot90+flip, else 50% small-angle rotation,
    then order-0 zoom to output_size. Its RandomState is shared by every
    caller, so the draws follow the order in which samples are transformed.
    """

    def __init__(self, output_size: Sequence[int], seed: int = 0):
        self.output_size = tuple(output_size)
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        image, label = sample["image"], sample["label"]
        if self.rng.rand() > 0.5:
            image, label = random_rot_flip(image, label, self.rng)
        elif self.rng.rand() > 0.5:
            image, label = random_rotate(image, label, self.rng)
        x, y = image.shape
        if (x, y) != self.output_size:
            image = zoom(image, (self.output_size[0] / x, self.output_size[1] / y), order=0)
            label = zoom(label, (self.output_size[0] / x, self.output_size[1] / y), order=0)
        return {"image": image.astype(np.float32), "label": label.astype(np.int32)}


def resize_slice(image: np.ndarray, size: Sequence[int], order: int = 0) -> np.ndarray:
    """zoom-to-size used by slice-wise eval (val_2D.py:58-60)."""
    x, y = image.shape
    return zoom(image, (size[0] / x, size[1] / y), order=order)
