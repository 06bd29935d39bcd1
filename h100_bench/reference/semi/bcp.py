"""Bidirectional copy-paste (BCP) mixing primitives (port of
chap_tpu/semi/bcp.py). The box starts can be passed in, so a test can
reproduce chap_tpu's draw."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def patch_size_nd(spatial: Sequence[int], patch_frac: float = 2.0 / 3.0):
    return tuple(int(int(s) * patch_frac) for s in spatial)


def draw_box_starts(spatial: Sequence[int], generator: Optional[torch.Generator],
                    patch_frac: float = 2.0 / 3.0,
                    device: Optional[torch.device] = None) -> List[torch.Tensor]:
    """One start per axis, uniform in [0, size - patch) like chap_tpu's
    jax.random.randint(key, (), 0, size - psize); 0-d tensors on the
    generator's device, or without one on ``device`` from its default
    generator (no host sync)."""
    dev = generator.device if generator is not None else device
    return [torch.randint(0, int(s) - p, (), generator=generator, device=dev)
            for s, p in zip(spatial, patch_size_nd(spatial, patch_frac))]


def generate_mask_nd(spatial: Sequence[int], starts: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     patch_frac: float = 2.0 / 3.0,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Mask [*spatial] int32 in {0,1}: 0 inside a patch_frac-sided
    axis-aligned box starting at ``starts`` (ints or 0-d tensors), 1
    outside."""
    spatial = tuple(int(s) for s in spatial)
    if starts is None:
        starts = draw_box_starts(spatial, generator, patch_frac, device)
    inside = None
    for axis, (size, psize, st) in enumerate(
            zip(spatial, patch_size_nd(spatial, patch_frac), starts)):
        st = torch.as_tensor(st, device=device)
        coord = torch.arange(size, device=st.device).reshape(
            tuple(size if a == axis else 1 for a in range(len(spatial))))
        in_axis = (coord >= st) & (coord < st + psize)
        inside = in_axis if inside is None else (inside & in_axis)
    return torch.where(inside, 0, 1).to(torch.int32)


def mix_images(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """a * mask + b * (1 - mask); mask [*spatial] broadcast over batch (and
    channel) dims. a / b: [B, *spatial] or [B, C, *spatial]."""
    m = mask.to(a.dtype)
    if a.dim() == mask.dim() + 2:          # channel axis after the batch
        m = m[None, None]
    elif a.dim() == mask.dim() + 1:
        m = m[None]
    else:
        raise ValueError(f"rank mismatch: image {tuple(a.shape)} vs mask "
                         f"{tuple(mask.shape)}")
    return a * m + b * (1 - m)
