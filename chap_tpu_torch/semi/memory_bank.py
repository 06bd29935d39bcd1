"""Hard-sample replay buffer of the ACAL min-max game (a numpy copy of
chap_tpu/semi/memory_bank.py, kept here so the port never imports the JAX
package; images NCHW).

The reference's ``Image_MemoryBank`` contract (train_share_encoder_2D.py:
199, 344, 368-371):
  - add(unlabeled_images, knowledge, n): store the n hardest images of the
    batch, ranked by their best patch_size x patch_size window of the
    "knowledge" (cross-pseudo-supervision disagreement) map, with a binary
    mask of that window;
  - get_samples(n): a replay batch {'image', 'mask'} drawn from the hardest
    2n entries.

It lives on the host, as chap_tpu's does: every feed copies the knowledge
map off the card. The same calls give the same arrays as chap_tpu's bank,
bit for bit (same RandomState, box filter, tuple sort and eviction order).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class ImageMemoryBank:
    def __init__(self, capacity: int = 256, image_size: Sequence[int] = (256, 256),
                 patch_size: int = 64, seed: int = 0):
        self.capacity = capacity
        self.image_size = tuple(image_size)
        self.patch_size = patch_size
        self.rng = np.random.RandomState(seed)
        self._images: List[np.ndarray] = []
        self._masks: List[np.ndarray] = []
        self._scores: List[float] = []

    def __len__(self) -> int:
        return len(self._images)

    def _best_patch(self, knowledge: np.ndarray) -> Tuple[int, int, float]:
        """Corner and score of the window with the largest summed knowledge
        (integral-image box filter, O(HW))."""
        p = self.patch_size
        ii = knowledge.cumsum(0).cumsum(1)
        ii = np.pad(ii, ((1, 0), (1, 0)))
        h, w = knowledge.shape
        sums = (ii[p:h + 1, p:w + 1] - ii[:h - p + 1, p:w + 1]
                - ii[p:h + 1, :w - p + 1] + ii[:h - p + 1, :w - p + 1])
        idx = np.unravel_index(np.argmax(sums), sums.shape)
        return int(idx[0]), int(idx[1]), float(sums[idx])

    def add(self, images: np.ndarray, knowledge: np.ndarray, n: int) -> None:
        """images: [B, H, W] or [B, 1, H, W]; knowledge: [B, H, W]."""
        images = np.asarray(images)
        if images.ndim == 4:
            images = images[:, 0]
        knowledge = np.asarray(knowledge)
        per_image = []
        for i in range(images.shape[0]):
            y, x, s = self._best_patch(knowledge[i])
            per_image.append((s, i, y, x))
        per_image.sort(reverse=True)
        for s, i, y, x in per_image[:n]:
            mask = np.zeros(self.image_size, np.float32)
            mask[y:y + self.patch_size, x:x + self.patch_size] = 1.0
            self._images.append(images[i].astype(np.float32))
            self._masks.append(mask)
            self._scores.append(s)
        if len(self._images) > self.capacity:
            order = np.argsort(self._scores)[::-1][:self.capacity]
            self._images = [self._images[j] for j in order]
            self._masks = [self._masks[j] for j in order]
            self._scores = [self._scores[j] for j in order]

    def get_samples(self, batch_size: int = 12) -> Dict[str, np.ndarray]:
        """{'image': [n, 1, H, W], 'mask': [n, H, W]} with n = min(batch_size,
        len(self)), drawn at random from the hardest 2n entries."""
        if not self._images:
            raise RuntimeError("memory bank is empty")
        n = min(batch_size, len(self._images))
        order = np.argsort(self._scores)[::-1]
        top = order[:max(n * 2, n)]
        chosen = self.rng.choice(top, size=n, replace=len(top) < n)
        images = np.stack([self._images[j] for j in chosen])[:, None]
        masks = np.stack([self._masks[j] for j in chosen])
        return {"image": images, "mask": masks}
