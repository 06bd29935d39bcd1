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
chap_tpu ranks a knowledge map in the dtype its step returns it in: a bf16
step's map is bf16, and numpy's bf16 (ml_dtypes) rounds every add of the
box filter's cumulative sums and differences to bf16. numpy here has no
bf16, so a bf16 host tensor is ranked on float32 copies of its values with
each of those adds rounded to bf16 (to nearest even, ``_round_bf16``): the
same sums, bit for bit, and so the same windows and scores.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded in place to the nearest bf16 (ties to even):
    ml_dtypes' (and torch's) float32 -> bf16 cast, for finite values.
    Returns ``x``."""
    bits = x.view(np.uint32)
    bits += np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
    bits &= np.uint32(0xFFFF0000)
    return x


def _cumsum_bf16(x: np.ndarray, axis: int) -> np.ndarray:
    """np.cumsum of a bf16 array along ``axis``: each running sum rounded
    to bf16 after every add (float32 in, float32 out)."""
    x = np.ascontiguousarray(np.moveaxis(x, axis, 0))
    out = np.empty(x.shape, np.float32)
    out[0] = x[0]
    for i in range(1, x.shape[0]):
        _round_bf16(np.add(out[i - 1], x[i], out=out[i]))
    return np.moveaxis(out, 0, axis)


def _host(x: Array) -> Tuple[np.ndarray, bool]:
    """(float32 or as-given numpy values, whether they are bf16)."""
    if isinstance(x, torch.Tensor):
        bf16 = x.dtype == torch.bfloat16
        x = x.detach().cpu()
        return (x.float() if bf16 else x).numpy(), bf16
    return np.asarray(x), False


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

    def _box_sums(self, knowledge: np.ndarray, bf16: bool) -> np.ndarray:
        """The summed knowledge of every patch_size window of each map of
        [B, H, W] (integral-image box filter, O(HW), all maps at once: the
        same sequential sums as chap_tpu's per map); ``bf16``: the values
        are bf16 and every add rounds to bf16 (module docstring)."""
        p = self.patch_size
        if bf16:
            ii = _cumsum_bf16(_cumsum_bf16(knowledge, 1), 2)
            rnd = _round_bf16
        else:
            ii = knowledge.cumsum(1).cumsum(2)
            rnd = lambda v: v   # noqa: E731
        ii = np.pad(ii, ((0, 0), (1, 0), (1, 0)))
        h, w = knowledge.shape[1:]
        return rnd(rnd(rnd(ii[:, p:h + 1, p:w + 1] - ii[:, :h - p + 1, p:w + 1])
                       - ii[:, p:h + 1, :w - p + 1]) + ii[:, :h - p + 1, :w - p + 1])

    def add(self, images: Array, knowledge: Array, n: int) -> None:
        """images: [B, H, W] or [B, 1, H, W]; knowledge: [B, H, W]; numpy
        arrays or host tensors (a bf16 map is ranked in bf16). Each map's
        best window is its largest box sum (the first on ties)."""
        images = _host(images)[0]
        if images.ndim == 4:
            images = images[:, 0]
        knowledge, bf16 = _host(knowledge)
        per_image = []
        for i, sums in enumerate(self._box_sums(knowledge, bf16)):
            y, x = np.unravel_index(np.argmax(sums), sums.shape)
            per_image.append((float(sums[y, x]), i, int(y), int(x)))
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
