"""Largest-connected-component pseudo-label cleanup, "NMS", in plain
PyTorch (a frozen copy of the port's plain version of K2 in
``semi/nms.py``): for each sample and each foreground class keep only the
largest component, with full connectivity (8 neighbours in 2D, 26 in 3D);
components are labelled by their largest linear index and ties in size go
to the smallest label. ``_largest_cc_host`` is the scipy version the
sliding-window eval applies on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F



def _largest_cc_host(segmentation: np.ndarray, num_classes: int) -> np.ndarray:
    """Host oracle, a copy of chap_tpu's: [B, ...spatial] int -> same, with
    the per-class largest CC kept (scipy.ndimage, full connectivity)."""
    from scipy import ndimage

    seg = np.asarray(segmentation)
    out = np.zeros_like(seg)
    structure = np.ones((3,) * (seg.ndim - 1), bool)
    for i in range(seg.shape[0]):
        for c in range(1, num_classes):
            mask = seg[i] == c
            if not mask.any():
                continue
            labels, n = ndimage.label(mask, structure=structure)
            if n == 0:
                continue
            sizes = np.bincount(labels.ravel())[1:]
            largest = labels == (np.argmax(sizes) + 1)
            out[i][largest] = c
    return out.astype(seg.dtype)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _label_mask_batch_plain(mask: torch.Tensor) -> torch.Tensor:
    """Component labels of a [M, H, W] or [M, X, Y, Z] bool mask: each
    component gets the max linear index it contains; background -1.
    Synchronises with the host once a round (the fixpoint test)."""
    m, spatial = mask.shape[0], tuple(mask.shape[1:])
    pool = {2: F.max_pool2d, 3: F.max_pool3d}.get(len(spatial))
    if pool is None:
        raise ValueError(f"mask must be [M, H, W] or [M, X, Y, Z], got "
                         f"{tuple(mask.shape)}")
    n = math.prod(spatial)
    if n >= 1 << 24:
        raise ValueError("the plain labelling pools labels as float32: a map "
                         "must hold fewer than 2**24 pixels")
    idx = torch.arange(n, device=mask.device).view((1,) + spatial).expand(mask.shape)
    labels = torch.where(mask, idx, -1)
    while True:
        neigh = pool(labels.float().unsqueeze(1), 3, stride=1,
                     padding=1).squeeze(1).long()
        new = torch.where(mask, torch.maximum(labels, neigh), -1)
        # pointer jump: adopt the label of the pixel your label names (it is
        # in the same component and its label is at least as large)
        flat = new.reshape(m, n)
        jumped = torch.gather(flat, 1, flat.clamp(min=0))
        new = torch.where(flat >= 0, jumped, -1).view(mask.shape)
        if torch.equal(new, labels):
            return labels
        labels = new


def largest_cc_mask_plain(mask: torch.Tensor) -> torch.Tensor:
    """[M, *spatial] bool -> bool mask of each sample's largest component
    (ties: smallest label)."""
    m = mask.shape[0]
    flat = _label_mask_batch_plain(mask).reshape(m, -1)
    n = flat.shape[1]
    counts = torch.zeros((m, n + 1), dtype=torch.int64, device=mask.device)
    counts.scatter_add_(1, flat + 1, torch.ones_like(flat))
    largest = counts[:, 1:].argmax(dim=1)          # first max: smallest id
    keep = flat == largest[:, None]
    return keep.reshape(mask.shape) & mask


def largest_cc_batch_plain(segmentation: torch.Tensor, num_classes: int
                           ) -> torch.Tensor:
    """Plain version of K2 on [B, H, W] or [B, X, Y, Z] integer maps."""
    b = segmentation.shape[0]
    masks = torch.cat([segmentation == c for c in range(1, num_classes)])
    keep = largest_cc_mask_plain(masks)
    out = torch.zeros_like(segmentation)
    for ci, c in enumerate(range(1, num_classes)):
        out = torch.where(keep[ci * b:(ci + 1) * b],
                          torch.full_like(segmentation, c), out)
    return out


def largest_cc_batch(segmentation: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[B, H, W] or [B, X, Y, Z] integer maps -> the same with each class's
    largest component kept, on any device."""
    return largest_cc_batch_plain(segmentation, num_classes)
