"""Sliding-window 3D inference in plain PyTorch (a frozen copy of the
port's ``eval/sliding_window.py`` with K3's plain version): pad-to-patch,
the ceil-div patch grid with a min-clamped last stride, the overlapping
softmax accumulation of the two decoders' mean logits, count
normalisation, argmax, unpad and the host largest-CC.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from h100_bench.reference.semi.nms import _largest_cc_host


def compute_grid(shape: Tuple[int, int, int], patch: Tuple[int, int, int],
                 stride_xy: int, stride_z: int) -> np.ndarray:
    """Patch start positions, ceil-div strides with min-clamped last step
    (val_3D.py:42-54 geometry)."""
    ww, hh, dd = shape
    sx = math.ceil(max(ww - patch[0], 0) / stride_xy) + 1
    sy = math.ceil(max(hh - patch[1], 0) / stride_xy) + 1
    sz = math.ceil(max(dd - patch[2], 0) / stride_z) + 1
    starts = []
    for x in range(sx):
        xs = min(stride_xy * x, ww - patch[0])
        for y in range(sy):
            ys = min(stride_xy * y, hh - patch[1])
            for z in range(sz):
                zs = min(stride_z * z, dd - patch[2])
                starts.append((xs, ys, zs))
    return np.array(starts, np.int32)


def batch_box(starts: np.ndarray, patch: Sequence[int]
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(low corner, size) of the box that holds every patch of a batch."""
    lo = starts.min(axis=0)
    hi = starts.max(axis=0) + np.asarray(patch)
    return tuple(int(v) for v in lo), tuple(int(v) for v in hi - lo)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def sw_accumulate_plain(logits1: torch.Tensor, logits2: Optional[torch.Tensor],
                        starts: np.ndarray, score: torch.Tensor,
                        cnt: torch.Tensor) -> None:
    """K3's plain version, in place: the softmax of the patches' mean logits
    summed, in patch order, over the batch's box, then added to ``score``
    and ``cnt`` (the kernel's order of additions). The mean of two outputs
    is taken in the logits' dtype (bf16 logits: their sum rounded to bf16,
    then halved), the softmax in float32."""
    out = logits1 if logits2 is None else (logits1 + logits2) / 2.0
    probs = torch.softmax(out.float(), dim=1)
    patch = tuple(logits1.shape[2:])
    lo, size = batch_box(starts, patch)
    buf = torch.zeros((probs.shape[1],) + size, dtype=torch.float32,
                      device=score.device)
    hits = torch.zeros(size, dtype=torch.float32, device=score.device)
    for i, s in enumerate(starts):
        sl = tuple(slice(int(s[d]) - lo[d], int(s[d]) - lo[d] + patch[d])
                   for d in range(3))
        buf[(slice(None),) + sl] += probs[i]
        hits[sl] += 1.0
    box = tuple(slice(lo[d], lo[d] + size[d]) for d in range(3))
    score[(slice(None),) + box] += buf
    cnt[box] += hits


def predict_volume(model: torch.nn.Module, image: torch.Tensor,
                   patch: Tuple[int, int, int], stride_xy: int, stride_z: int,
                   num_classes: int, sw_batch: int, nms: bool) -> np.ndarray:
    """The label map [X, Y, Z] (int32, host) of one volume ``image`` [X, Y,
    Z] (float32, on the model's device): the model in eval mode over the
    patch grid in batches of ``sw_batch``, the softmax of the two outputs'
    mean logits accumulated and normalised by the counts, the argmax, and
    with ``nms`` the largest component of each class."""
    w, h, d = image.shape
    pads = [max(patch[i] - image.shape[i], 0) for i in range(3)]
    pad_lo = [p // 2 for p in pads]
    if any(pads):
        image = torch.nn.functional.pad(
            image, [v for i in (2, 1, 0) for v in (pad_lo[i], pads[i] - pad_lo[i])])
    shape = tuple(image.shape)
    starts = compute_grid(shape, patch, stride_xy, stride_z)
    score = torch.zeros((num_classes,) + shape, dtype=torch.float32,
                        device=image.device)
    cnt = torch.zeros(shape, dtype=torch.float32, device=image.device)
    px, py, pz = patch
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for i in range(0, starts.shape[0], sw_batch):
                batch = starts[i:i + sw_batch]
                patches = torch.stack([image[x:x + px, y:y + py, z:z + pz]
                                       for x, y, z in batch.tolist()])
                o1, o2 = model(patches.unsqueeze(1))
                sw_accumulate_plain(o1, o2, batch, score, cnt)
    finally:
        model.train(was_training)
    label = torch.argmax(score / cnt.clamp_min(1e-8)[None], dim=0)
    label_map = label.cpu().numpy().astype(np.int32)
    label_map = label_map[pad_lo[0]:pad_lo[0] + w, pad_lo[1]:pad_lo[1] + h,
                          pad_lo[2]:pad_lo[2] + d]
    if nms:
        label_map = _largest_cc_host(label_map[None], num_classes)[0]
    return label_map
