"""Largest-connected-component pseudo-label cleanup, "NMS" (port of
chap_tpu/semi/nms.py).

For each sample and each foreground class, keep only the largest
component of the label map, with full connectivity: 8 neighbours for
[B, H, W] slices, 26 for [B, X, Y, Z] volumes. Components are labelled by
their largest linear index (the last axis fastest) and ties in size go to
the smallest label, exactly as chap_tpu's device path does (the scipy host
path breaks ties its own way).

On a CUDA tensor this runs kernel K2, union-find labelling written in CUDA
C++ (csrc/ccl.cu, which says what bounds it and how its design meets that):
one labelling per map with same-class adjacency, tile-local union-find in
shared memory, with no host synchronisation; 2D and 3D maps have entry
points of their own. In 3D (8x16x16 tiles) the tiles merge through one
global union per distinct pair of touching tile-local components, found
on each tile's low faces and deduplicated in shared memory, and the later
passes walk per-tile lists of tile-local roots (a scratch array the
wrapper allocates) instead of every voxel. On a CPU tensor it runs K2's
plain version: chap_tpu's algorithm in PyTorch (3^d max-pool propagation
inside the mask, with pointer jumps, until fixpoint; then the modal label
with the same tie rule). ``ccl_kernel.launches`` and
``ccl3d_kernel.launches`` count the 2D and the 3D launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

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


# ---------------------------------------------------------------------------
# K2 wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load(_SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' arguments on a loaded build of ccl.cu."""
    fn = lib.chap_largest_cc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn3 = lib.chap_largest_cc_3d
    fn3.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn3.restype = ctypes.c_int
    lib.chap_largest_cc_3d_scratch.argtypes = [ctypes.c_int] * 4
    lib.chap_largest_cc_3d_scratch.restype = ctypes.c_int
    return lib


def _launch_k2(entry: str, segmentation: torch.Tensor, num_classes: int,
               rank: int, lib: ctypes.CDLL = None) -> torch.Tensor:
    """Check, allocate the outputs and scratch, and launch one K2 entry
    point on [B, *spatial] maps of ``rank`` spatial axes (from ``lib``, a
    bound build of ccl.cu, by default the repository's)."""
    if not segmentation.is_cuda:
        raise ValueError("K2 takes CUDA tensors only")
    if segmentation.dim() != rank + 1 or segmentation.dtype.is_floating_point:
        want = "[B, H, W]" if rank == 2 else "[B, X, Y, Z]"
        raise ValueError(f"segmentation must be integer {want}, got "
                         f"{tuple(segmentation.shape)} {segmentation.dtype}")
    if num_classes < 2:
        raise ValueError("num_classes must be >= 2")
    b = segmentation.shape[0]
    total = segmentation.numel()
    if total >= 1 << 31 or b > 65535:
        raise ValueError("K2 indexes pixels with int32 and maps with a grid "
                         "dimension (at most 65535)")
    lib = lib or _library()
    seg = segmentation.to(torch.int32).contiguous()
    out = torch.empty_like(seg)
    parent = torch.empty(total, dtype=torch.int32, device=seg.device)
    size = torch.empty(total, dtype=torch.int32, device=seg.device)
    slot = torch.empty(b * (num_classes - 1), dtype=torch.int64,
                       device=seg.device)
    ptrs = [seg.data_ptr(), out.data_ptr(), parent.data_ptr(),
            size.data_ptr(), slot.data_ptr()]
    if rank == 3:
        # the 3D entry's lists of tile-local roots, one per tile
        n = lib.chap_largest_cc_3d_scratch(*seg.shape)
        if n < 0:
            raise ValueError(f"maps {tuple(seg.shape)} too large for K2 in 3D")
        tiles = torch.empty(n, dtype=torch.int32, device=seg.device)
        ptrs.append(tiles.data_ptr())
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = getattr(lib, entry)(*ptrs, *seg.shape, num_classes, stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    return out


def ccl_kernel(segmentation: torch.Tensor, num_classes: int) -> torch.Tensor:
    """K2 on the card: [B, H, W] integer maps -> int32 maps with each class's
    largest 8-connected component kept."""
    out = _launch_k2("chap_largest_cc", segmentation, num_classes, 2)
    ccl_kernel.launches += 1
    return out


ccl_kernel.launches = 0


def ccl3d_kernel(segmentation: torch.Tensor, num_classes: int) -> torch.Tensor:
    """K2 in 3D on the card: [B, X, Y, Z] integer maps -> int32 maps with
    each class's largest 26-connected component kept."""
    out = _launch_k2("chap_largest_cc_3d", segmentation, num_classes, 3)
    ccl3d_kernel.launches += 1
    return out


ccl3d_kernel.launches = 0


def _kernel_for(x: torch.Tensor):
    return ccl3d_kernel if x.dim() == 4 else ccl_kernel


def largest_cc_batch(segmentation: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class largest-CC cleanup of [B, H, W] or [B, X, Y, Z] integer
    label maps: K2 on a CUDA tensor, its plain version on a CPU tensor.
    Keeps the dtype. No maps (a data-parallel rank without rows) launch
    nothing."""
    if segmentation.shape[0] == 0:      # a rank without rows: no launch
        return segmentation.clone()
    if segmentation.device.type == "cpu":
        return largest_cc_batch_plain(segmentation, num_classes)
    kernel = _kernel_for(segmentation)
    return kernel(segmentation, num_classes).to(segmentation.dtype)


def largest_cc_mask(mask: torch.Tensor) -> torch.Tensor:
    """[M, *spatial] bool -> bool mask of each sample's largest component."""
    if mask.device.type == "cpu":
        return largest_cc_mask_plain(mask)
    return _kernel_for(mask)(mask.to(torch.int32), 2) == 1


def get_masks_with_nms(logits: torch.Tensor, num_classes: int,
                       nms: bool = True) -> torch.Tensor:
    """Argmax pseudo-labels [B, *spatial] int32 of logits [B, C, *spatial],
    each class's largest component kept where ``nms`` (get_ACDC_masks;
    chap_tpu's argmax is over its last axis, the class axis here is 1): K2
    on a CUDA tensor, its plain version on a CPU one."""
    pseudo = torch.argmax(logits, dim=1).to(torch.int32)
    return largest_cc_batch(pseudo, num_classes) if nms else pseudo
