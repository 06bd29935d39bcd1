"""Two-stream batch sampling: every batch = labeled head + unlabeled tail
(a copy of chap_tpu/data/sampler.py; its numpy RNG makes the host path's
batch order identical to chap_tpu's for the same seed).

The labeled stream is iterated in shuffled epochs, the unlabeled stream is
sampled eternally, and each emitted batch is [primary_bs labeled ;
secondary_bs unlabeled], the positional contract every CHAP loss depends on.
``RankBatchSampler`` gives each data-parallel rank its rows of every batch.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from chap_tpu_torch.parallel.dist import rank_rows


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int], secondary_indices: Sequence[int],
                 batch_size: int, secondary_batch_size: int, seed: int = 0):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.primary_batch_size = batch_size - secondary_batch_size
        self.secondary_batch_size = secondary_batch_size
        assert self.primary_batch_size > 0 and self.secondary_batch_size >= 0
        if len(self.primary_indices) < self.primary_batch_size:
            raise ValueError(
                f"need >= {self.primary_batch_size} labeled slices for the "
                f"labeled half of each batch, got {len(self.primary_indices)} "
                f"(labeled_num maps through the patients->slices table, e.g. "
                f"ACDC 3->68, 7->136; raise the dataset size or lower "
                f"labeled_bs/labeled_num)")
        if self.secondary_batch_size and \
                len(self.secondary_indices) < self.secondary_batch_size:
            raise ValueError(
                f"need >= {self.secondary_batch_size} UNlabeled slices for the "
                f"unlabeled half of each batch, got "
                f"{len(self.secondary_indices)}: the labeled split "
                f"(labeled_num) covers too much of the dataset — raise the "
                f"dataset size (data.synthetic_train_size for synthetic) or "
                f"lower labeled_num")
        self.rng = np.random.RandomState(seed)
        self._secondary_pool: List[int] = []

    def __len__(self) -> int:
        return len(self.primary_indices) // self.primary_batch_size

    def _next_secondary(self, n: int) -> List[int]:
        out: List[int] = []
        while len(out) < n:
            if not self._secondary_pool:
                pool = list(self.secondary_indices)
                self.rng.shuffle(pool)
                self._secondary_pool = pool
            out.append(self._secondary_pool.pop())
        return out

    def __iter__(self) -> Iterator[List[int]]:
        primary = list(self.primary_indices)
        self.rng.shuffle(primary)
        for start in range(0, len(primary) - self.primary_batch_size + 1,
                           self.primary_batch_size):
            labeled = primary[start:start + self.primary_batch_size]
            unlabeled = self._next_secondary(self.secondary_batch_size)
            yield labeled + unlabeled


class RankBatchSampler:
    """Each rank's rows of every batch of a global batch sampler (the
    counterpart of chap_tpu's ProcessLocalBatchSampler, parallel/mesh.py):
    every rank builds the same global sampler (same seed) and loads only its
    rows, chosen by parallel/dist.py ``rank_rows`` with ``roles`` equal roles
    (4 for the CHAP step's [img_a ; img_b ; uimg_a ; uimg_b], 1 for the
    supervised step), not chap_tpu's contiguous slice."""

    def __init__(self, sampler, roles: int, rank: int, world: int):
        self.sampler = sampler
        self.roles, self.rank, self.world = roles, rank, world

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[List[int]]:
        for batch in self.sampler:
            yield [batch[i] for i in rank_rows(len(batch), self.roles,
                                               self.rank, self.world)]
