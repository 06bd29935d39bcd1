"""One process, one device: the reference's stand-in for the port's data
parallelism. Every collective is the identity and every rank helper sees
the whole batch, which is what the port's ``parallel/dist.py`` computes at
W = 1."""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

CHAP_ROLES = (0, 1, 0, 1)
ONE_ROLE = (0,)


class Halves(NamedTuple):
    labeled: int


Layout = object


def world_size() -> int:
    return 1


def rank() -> int:
    return 0


def global_sums(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return xs


def global_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def sum_tensors(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return list(tensors)


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    return None


def check_batch(batch_size: int, world: int, what: str) -> None:
    return None


def stream_rows(s: int, stream: int = 0, streams: int = 1,
                rank_: Optional[int] = None, world: Optional[int] = None
                ) -> range:
    return range(s)


def shard_rows(x, roles=ONE_ROLE, rank_=None, world=None):
    return x
