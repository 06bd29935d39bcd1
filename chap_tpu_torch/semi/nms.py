"""Largest-connected-component pseudo-label cleanup, "NMS" (port of
chap_tpu/semi/nms.py).

For each sample and each foreground class, keep only the largest
8-connected component of the label map. Components are labelled by their
largest linear index and ties in size go to the smallest label, exactly as
chap_tpu's device path does (the scipy host path breaks ties its own way).

On a CUDA tensor this runs kernel K2, union-find labelling written in CUDA
C++ (csrc/ccl.cu, which says what bounds it and how its design meets that):
one labelling per map with same-class adjacency, tile-local union-find in
shared memory, with no host synchronisation. On a CPU tensor it runs K2's
plain version: chap_tpu's algorithm in PyTorch (3x3 max-pool propagation
inside the mask, with pointer jumps, until fixpoint; then the modal label
with the same tie rule). ``ccl_kernel.launches`` counts K2 launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from chap_tpu_torch.ops import cuda_build

_SOURCE = "ccl.cu"


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
    """Component labels of a [M, H, W] bool mask: each component gets the
    max linear index it contains; background -1. Synchronises with the host
    once a round (the fixpoint test)."""
    m, h, w = mask.shape
    n = h * w
    if n >= 1 << 24:
        raise ValueError("the plain labelling pools labels as float32: H*W "
                         "must stay below 2**24")
    idx = torch.arange(n, device=mask.device).view(1, h, w).expand(m, h, w)
    labels = torch.where(mask, idx, -1)
    while True:
        neigh = F.max_pool2d(labels.float().unsqueeze(1), 3, stride=1,
                             padding=1).squeeze(1).long()
        new = torch.where(mask, torch.maximum(labels, neigh), -1)
        # pointer jump: adopt the label of the pixel your label names (it is
        # in the same component and its label is at least as large)
        flat = new.reshape(m, n)
        jumped = torch.gather(flat, 1, flat.clamp(min=0))
        new = torch.where(flat >= 0, jumped, -1).view(m, h, w)
        if torch.equal(new, labels):
            return labels
        labels = new


def largest_cc_mask_plain(mask: torch.Tensor) -> torch.Tensor:
    """[M, H, W] bool -> bool mask of each sample's largest component (ties:
    smallest label)."""
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
    """Plain version of K2 on [B, H, W] integer maps."""
    b = segmentation.shape[0]
    masks = torch.cat([segmentation == c for c in range(1, num_classes)])
    keep = largest_cc_mask_plain(masks)
    out = torch.zeros_like(segmentation)
    for ci, c in enumerate(range(1, num_classes)):
        out = torch.where(keep[ci * b:(ci + 1) * b],
                          torch.full_like(segmentation, c), out)
    return out


# ---------------------------------------------------------------------------
# K2 wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    fn = lib.chap_largest_cc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ccl_kernel(segmentation: torch.Tensor, num_classes: int) -> torch.Tensor:
    """K2 on the card: [B, H, W] integer maps -> int32 maps with each class's
    largest component kept."""
    if not segmentation.is_cuda:
        raise ValueError("K2 takes CUDA tensors only")
    if segmentation.dim() != 3 or segmentation.dtype.is_floating_point:
        raise ValueError(f"segmentation must be integer [B, H, W], got "
                         f"{tuple(segmentation.shape)} {segmentation.dtype}")
    if num_classes < 2:
        raise ValueError("num_classes must be >= 2")
    b, h, w = segmentation.shape
    if b * h * w >= 1 << 31 or b > 65535:
        raise ValueError("K2 indexes pixels with int32 and maps with the "
                         "grid's z dimension (at most 65535)")
    seg = segmentation.to(torch.int32).contiguous()
    out = torch.empty_like(seg)
    parent = torch.empty(b * h * w, dtype=torch.int32, device=seg.device)
    size = torch.empty(b * h * w, dtype=torch.int32, device=seg.device)
    slot = torch.empty(b * (num_classes - 1), dtype=torch.int64,
                       device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = _library().chap_largest_cc(seg.data_ptr(), out.data_ptr(),
                                     parent.data_ptr(), size.data_ptr(),
                                     slot.data_ptr(), b, h, w, num_classes,
                                     stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    ccl_kernel.launches += 1
    return out


ccl_kernel.launches = 0


def largest_cc_batch(segmentation: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class largest-CC cleanup of [B, H, W] integer label maps: K2 on
    a CUDA tensor, its plain version on a CPU tensor. Keeps the dtype."""
    if segmentation.device.type == "cpu":
        return largest_cc_batch_plain(segmentation, num_classes)
    return ccl_kernel(segmentation, num_classes).to(segmentation.dtype)


def largest_cc_mask(mask: torch.Tensor) -> torch.Tensor:
    """[M, H, W] bool -> bool mask of each sample's largest component."""
    if mask.device.type == "cpu":
        return largest_cc_mask_plain(mask)
    return ccl_kernel(mask.to(torch.int32), 2) == 1

