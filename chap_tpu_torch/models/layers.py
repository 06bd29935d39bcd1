"""Building blocks of the 2D UNet family, and the BatchNorm and upsampling
the 3D VNet family shares with it (port of chap_tpu/models/layers.py).

NCHW / NCDHW, with the original torch module names (``conv_conv.0`` ...), so
a reference ``state_dict`` loads by name and chap_tpu's converter rules apply.

BatchNorm follows chap_tpu's Flax semantics, not torch's: in train mode it
normalises with the biased batch statistics and does NOT touch its running
buffers. It reports the batch mean and biased variance in a ``stats`` dict
instead, and the train step folds them into the running stats with Flax's
momentum (running = 0.9 * running + 0.1 * batch). That keeps the step the
owner of the running stats, as chap_tpu's TrainState is, and makes passes
whose updates are discarded (VAT) and re-run forwards (checkpointing) safe.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.9     # Flax convention: weight of the old running value
BN_EPS = 1e-5

Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """torch nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def upsample2x_trilinear(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='trilinear', align_corners=True) on
    NCDHW (vnet.py:105). An axis of size 1 becomes two copies of its value,
    as chap_tpu's scale 2.0 for that axis (layers.py:44) gives."""
    return F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=True)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of jax.image.resize's 'linear' method along one
    axis (jax/_src/image/scale.py compute_weight_mat, antialias on): a
    triangle kernel at the half-pixel sample points, widened by n_in / n_out
    when downsampling, renormalised where it reaches past the edges."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n_in)[None, :])
                   / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_linear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """jax.image.resize(x, ..., method="linear") over the spatial axes of an
    NC... tensor: half-pixel centred, edge weights renormalised. Where no
    axis shrinks this is F.interpolate(align_corners=False) (the same
    weights); an axis that shrinks gets JAX's antialiased (widened) kernel,
    which F.interpolate lacks, applied as a [out, in] matrix."""
    size = tuple(int(s) for s in size)
    spatial = tuple(x.shape[2:])
    if size == spatial:
        return x
    if all(o >= i for o, i in zip(size, spatial)):
        mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(size)]
        return F.interpolate(x, size=size, mode=mode, align_corners=False)
    for axis, (n_in, n_out) in enumerate(zip(spatial, size)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(_resize_weights(n_in, n_out)).to(x.device, x.dtype)
        x = torch.movedim(torch.movedim(x, axis + 2, -1) @ w.T, -1, axis + 2)
    return x


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free per-sample, per-channel normalisation with the biased
    variance: chap_tpu's ``_instance_norm`` (voxresnet.py:12-16) and
    UnetConv3 norm (unet3d.py:29-33). A map of one voxel normalises to 0, as
    there, where F.instance_norm refuses it."""
    if x[0, 0].numel() == 1:
        return torch.zeros_like(x)
    return F.instance_norm(x, eps=eps)


class InstanceNorm(nn.Module):
    """``instance_norm`` as a module without parameters or buffers (the
    reference's affine-free nn.InstanceNorm3d)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Repeat every spatial axis of an NC... tensor twice (chap_tpu's
    upsample2x_nearest over the spatial dims)."""
    for axis in range(2, x.dim()):
        x = x.repeat_interleave(2, dim=axis)
    return x


def dropout_from_uniform(x: torch.Tensor, p: float,
                         u: Optional[torch.Tensor]) -> torch.Tensor:
    """Flax nn.Dropout with its draw passed in: keep where u < 1-p (JAX's
    bernoulli(key, 1-p) is uniform(key) < 1-p), kept values scaled by
    1/(1-p). ``u=None`` draws from the global generator."""
    if u is None:
        u = torch.rand_like(x)
    keep = 1.0 - p
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def split_drop_u(drop_u, n: int) -> List[Optional[torch.Tensor]]:
    """A model's ``drop_u`` as its ``n`` uniforms (None: n Nones, each
    drawn from the global generator)."""
    if drop_u is None:
        return [None] * n
    drop_u = list(drop_u)
    if len(drop_u) != n:
        raise ValueError(f"drop_u holds {len(drop_u)} uniforms, the model "
                         f"consumes {n} (its dropout_shapes)")
    return drop_u


class FlaxBatchNorm:
    """BatchNorm with Flax train-mode semantics (see the module docstring),
    mixed into torch's BatchNorm2d / BatchNorm3d for their parameters and
    buffers.

    ``stats_key`` is the module's qualified name in its model; the owning
    model sets it (``set_stats_keys``)."""

    stats_key: str = ""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if stats is not None:
            with torch.no_grad():
                var, mean = torch.var_mean(
                    x, dim=(0,) + tuple(range(2, x.dim())), correction=0)
            stats[self.stats_key] = (mean, var)
        # running buffers are not passed: nothing is updated in place
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm2d(FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(FlaxBatchNorm, nn.BatchNorm3d):
    pass


def set_stats_keys(model: nn.Module) -> None:
    """Name every FlaxBatchNorm of ``model`` by its qualified name, the key
    under which it reports its batch statistics."""
    for name, module in model.named_modules():
        if isinstance(module, FlaxBatchNorm):
            module.stats_key = name


class ConvBlock(nn.Module):
    """conv3x3-BN-LeakyReLU-dropout-conv3x3-BN-LeakyReLU (unet.py:44-60).
    ``conv_conv`` keeps the reference's Sequential indices for the names;
    forward walks it by hand to pass the dropout draw and the stats dict."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.conv_conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            BatchNorm2d(out_channels),
            nn.LeakyReLU(0.01),
            nn.Dropout(self.dropout_p),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
            BatchNorm2d(out_channels),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x: torch.Tensor, drop_u: Optional[torch.Tensor] = None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        c = self.conv_conv
        x = F.leaky_relu(c[1](c[0](x), stats), 0.01)
        if self.training and self.dropout_p > 0:
            x = dropout_from_uniform(x, self.dropout_p, drop_u)
        return F.leaky_relu(c[5](c[4](x), stats), 0.01)


class DownBlock(nn.Module):
    """maxpool2x2 then ConvBlock (unet.py:63-75)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_p: float = 0.0):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), ConvBlock(in_channels, out_channels, dropout_p))

    def forward(self, x: torch.Tensor, drop_u: Optional[torch.Tensor] = None,
                stats: Optional[Stats] = None) -> torch.Tensor:
        return self.maxpool_conv[1](self.maxpool_conv[0](x), drop_u, stats)


class UpBlock(nn.Module):
    """1x1 conv + bilinear up (or ConvTranspose2d k2 s2 for the mcnet
    decoder2) + skip concat + ConvBlock (unet.py:78-99). ``plus`` fuses the
    skip by addition instead (UpBlock_plus, unet.py:101-123)."""

    def __init__(self, in_channels1: int, in_channels2: int, out_channels: int,
                 dropout_p: float = 0.0, bilinear: bool = True,
                 plus: bool = False):
        super().__init__()
        self.bilinear = bilinear
        self.plus = plus
        if bilinear:
            self.conv1x1 = nn.Conv2d(in_channels1, in_channels2, 1)
        else:
            self.up = nn.ConvTranspose2d(in_channels1, in_channels2, 2, stride=2)
        self.conv = ConvBlock(in_channels2 * (1 if plus else 2), out_channels,
                              dropout_p)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                stats: Optional[Stats] = None) -> torch.Tensor:
        x1 = upsample2x_bilinear(self.conv1x1(x1)) if self.bilinear else self.up(x1)
        x = x2 + x1 if self.plus else torch.cat([x2, x1], dim=1)
        return self.conv(x, None, stats)
