"""The bytes that K1, K2 and K3 cannot avoid moving, from the shapes of
the work alone, so that a roofline share reads the same whatever
implements the kernel (PERF.md says why each count is what it is).

* K1, the masked dice + CE losses: for each logits tensor the step takes
  a loss of, the forward reads the logits once in their dtype and each
  region's labels at one byte a pixel, as the pool holds them (the BCP
  mask is a box of six numbers and is not counted); the backward reads
  the logits and labels once more and writes one gradient in the logits'
  dtype for each backward pass of the step through that loss.
* K2, the largest-component cleanup: one byte a pixel in, one out.
* K3, the sliding-window accumulation: the logits of every patch read
  once in their dtype.
"""
from __future__ import annotations

import math
from typing import Sequence


def k1_bytes(calls: int, rows: int, classes: int, spatial: Sequence[int],
             regions: int, logit_bytes: int, backward_passes: int) -> int:
    """K1's bytes over ``calls`` losses of logits [rows, classes,
    *spatial] with ``regions`` label maps each, through ``backward_passes``
    backward passes of the step."""
    pixels = rows * math.prod(spatial)
    logits = pixels * classes * logit_bytes
    labels = pixels * regions
    forward = logits + labels
    backward = logits + labels + backward_passes * logits
    return calls * (forward + backward)


def k2_bytes(maps: int, spatial: Sequence[int]) -> int:
    """K2's bytes over ``maps`` label maps of ``spatial``."""
    return 2 * maps * math.prod(spatial)


def k3_bytes(patches: int, outputs: int, classes: int, patch: Sequence[int],
             logit_bytes: int) -> int:
    """K3's bytes over ``patches`` patches of ``outputs`` logits tensors
    [classes, *patch] each."""
    return patches * outputs * classes * math.prod(patch) * logit_bytes
