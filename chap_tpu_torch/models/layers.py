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

Compute dtype (``model.dtype``), as chap_tpu's Flax ``dtype=`` means it:
the parameters stay float32 and the optimizer updates them in float32;
every convolution casts its input, kernel and bias to the compute dtype
and gives its output in it (``Conv2d`` ... ``ConvTranspose3d`` below,
nn.Conv(dtype=) at chap_tpu/models/layers.py:69-75); the BatchNorm and
GroupNorm statistics are float32 and the normalisation runs in float32 on
a float32 copy of the input, its output cast to the compute dtype (Flax's
``_compute_stats`` / ``_normalize``); the affine-free instance norms take
``jnp.mean`` / ``jnp.var`` of a bf16 input, which come back in bf16, and
normalise in bf16 (``instance_norm``); the align-corners up-sampling builds
its interpolation weights in the input's dtype, the half-pixel resize in
float32 rounded to it (``upsample2x_*``, ``resize_linear``). Every other op
runs in its inputs' dtype, as in JAX. ``set_compute_dtype`` sets the dtype
of a built model (models/factory.py calls it); float32 is the default, and
at float32 nothing is cast: the model runs in its parameters' dtype (also
float64, as the tests' float64 references do), PyTorch's own path.
Softmax and log-softmax of a bf16 tensor round step by step as JAX's do
(``softmax``, ``log_softmax``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from chap_tpu_torch.parallel import dist

BN_MOMENTUM = 0.9     # Flax convention: weight of the old running value
BN_EPS = 1e-5

Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reduced_dtype(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` takes the reduced-precision semantics above: bf16,
    the one reduced compute dtype of COMPUTE_DTYPES."""
    return dtype == torch.bfloat16

def compute_dtype(name: str) -> torch.dtype:
    """``model.dtype`` (float32 | bfloat16) as a torch dtype."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"model.dtype {name!r} is not one of "
                         f"{', '.join(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax in x's dtype. In bf16 each step rounds to bf16 as
    JAX's ops do (x - max, exp, the sum, the quotient; bit-equal to JAX's
    eager softmax on the CPU), so near-ties that bf16 rounds together go to
    the first class under argmax, as chap_tpu's pseudo-labels do
    (chap_tpu/train/step_chap.py:120-123); torch.softmax rounds once and
    would split them otherwise. float32 is torch.softmax."""
    if not reduced_dtype(x.dtype):
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def log_softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.log_softmax in x's dtype, rounded step by step in bf16 as
    ``softmax``; float32 is torch.log_softmax."""
    if not reduced_dtype(x.dtype):
        return torch.log_softmax(x, dim)
    shifted = x - x.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))


class _ComputeDtype:
    """Mixin of the modules whose forward follows the model's compute dtype
    (an attribute that ``set_compute_dtype`` sets; float32 by default)."""

    compute_dtype: torch.dtype = torch.float32


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every convolution and norm of ``model`` compute in ``dtype``
    over its float32 parameters (the module docstring says how); returns
    the model. ``model.compute_dtype`` records it."""
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
    for module in model.modules():
        if isinstance(module, _ComputeDtype):
            module.compute_dtype = dtype
    model.compute_dtype = dtype
    return model


def _cast_conv(conv, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """``conv(x, weight, bias)`` with all three cast to ``dt``, the output
    in ``dt``. On the CPU in bf16 the same product of the bf16 operands is
    taken in float32 and rounded once, which is what the card's bf16
    convolution computes (float32 accumulation): oneDNN's own bf16
    convolution gives wrong sums for some strided shapes (a [2, 32, 6, 4,
    2] input, 3^3 kernel, stride 2, padding 1 comes out 7.6 off at a scale
    of 6.6 with torch 2.13's CPU build)."""
    if not reduced_dtype(dt):
        # a float32 model takes reduced-precision input in its own dtype, as
        # Flax's nn.Conv(dtype=float32) promotes it
        return conv(x.to(weight.dtype), weight, bias)
    x, weight = x.to(dt), weight.to(dt)
    bias = None if bias is None else bias.to(dt)
    if x.device.type != "cpu":
        return conv(x, weight, bias)
    return conv(x.float(), weight.float(),
                None if bias is None else bias.float()).to(dt)


class _CastConv(_ComputeDtype):
    """A convolution in the compute dtype: input, kernel and bias cast to it
    (Flax nn.Conv(dtype=) / nn.ConvTranspose(dtype=)), so the gradient
    reaches the float32 kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _cast_conv(self._apply_conv, x, self.weight, self.bias,
                          self.compute_dtype)


class Conv2d(_CastConv, nn.Conv2d):
    def _apply_conv(self, x, weight, bias):
        return self._conv_forward(x, weight, bias)


class Conv3d(_CastConv, nn.Conv3d):
    def _apply_conv(self, x, weight, bias):
        return self._conv_forward(x, weight, bias)


class ConvTranspose2d(_CastConv, nn.ConvTranspose2d):
    def _apply_conv(self, x, weight, bias):
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(_CastConv, nn.ConvTranspose3d):
    def _apply_conv(self, x, weight, bias):
        return F.conv_transpose3d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


@functools.lru_cache(maxsize=None)
def _align_corners_weights(n_in: int, scale: float, dtype: torch.dtype,
                           device: torch.device) -> torch.Tensor:
    """[2 n_in, n_in] weights of chap_tpu's align-corners 2x up-sampling
    along one axis in a reduced dtype, as jax.image.scale_and_translate
    computes them there (jax/_src/image/scale.py compute_weight_mat): the
    scale and translation are arrays of the input's dtype
    (chap_tpu/models/layers.py:33-34,48-49), so every step of the weight
    matrix is rounded to it. In bf16 the sample positions keep 8
    significant bits: at 56 -> 112 they are off by up to 1/8 of a voxel,
    which chap_tpu's bf16 models live with (ROADMAP §3). Cached: a model
    asks for the same few sizes every pass."""
    n_out = 2 * n_in
    one = torch.ones((), dtype=dtype)
    s = torch.tensor(scale, dtype=dtype)
    t = torch.tensor(0.5 * (1.0 - scale), dtype=dtype)
    inv = one / s
    kernel_scale = torch.maximum(inv, one)
    sample = ((torch.arange(n_out, dtype=dtype) + 0.5) * inv - t * inv) - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=dtype)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0)                     # the triangle
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, one),
                    torch.zeros((), dtype=dtype))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros((), dtype=dtype)).T \
        .contiguous().to(device)


def _apply_axis_weights(x: torch.Tensor, weights) -> torch.Tensor:
    """Contract each spatial axis of an NC... tensor with its [out, in]
    weight matrix (None: the axis stays), one axis at a time, in x's
    dtype (an einsum of chap_tpu's resize, output rounded per axis)."""
    for axis, w in enumerate(weights):
        if w is not None:
            x = torch.movedim(torch.movedim(x, axis + 2, -1) @ w.T, -1, axis + 2)
    return x


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """align_corners 2x up-sampling of every spatial axis of a reduced-
    precision x, with chap_tpu's weights in x's dtype. An axis of size 1
    takes scale 2.0, as chap_tpu's (layers.py:27-28,44)."""
    weights = []
    for n in x.shape[2:]:
        scale = (2 * n - 1) / (n - 1) if n > 1 else 2.0
        weights.append(_align_corners_weights(n, scale, x.dtype, x.device))
    return _apply_axis_weights(x, weights)


@functools.lru_cache(maxsize=None)
def _resize_weight_tensor(n_in: int, n_out: int, dtype: torch.dtype,
                          device: torch.device) -> torch.Tensor:
    """``_resize_weights`` rounded to ``dtype`` on ``device`` (cached)."""
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device, dtype)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """torch nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True);
    below float32, chap_tpu's weights in x's dtype."""
    if reduced_dtype(x.dtype):
        return _upsample2x_align_corners(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def upsample2x_trilinear(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='trilinear', align_corners=True) on
    NCDHW (vnet.py:105). An axis of size 1 becomes two copies of its value,
    as chap_tpu's scale 2.0 for that axis (layers.py:44) gives. Below
    float32, chap_tpu's weights in x's dtype."""
    if reduced_dtype(x.dtype):
        return _upsample2x_align_corners(x)
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
    which F.interpolate lacks, applied as a [out, in] matrix. Below float32
    every resized axis takes the matrix, its float32 weights rounded to x's
    dtype and the contraction in it, as jax.image.resize does."""
    size = tuple(int(s) for s in size)
    spatial = tuple(x.shape[2:])
    if size == spatial:
        return x
    if reduced_dtype(x.dtype):
        return _apply_axis_weights(x, [
            None if n_in == n_out else
            _resize_weight_tensor(n_in, n_out, x.dtype, x.device)
            for n_in, n_out in zip(spatial, size)])
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
    there, where F.instance_norm refuses it.

    Below float32 these take ``jnp.mean`` / ``jnp.var`` of x, which reduce
    in float32 and return x's dtype, and normalise in x's dtype: so the
    mean and variance are rounded to bf16 before ``(x - mean) / sqrt(var +
    eps)``, as there. VNet's ``instancenorm`` is not this: it is Flax's
    affine-free GroupNorm of one channel a group (``GroupNorm``)."""
    if x[0, 0].numel() == 1:
        return torch.zeros_like(x)
    if not reduced_dtype(x.dtype):
        return F.instance_norm(x, eps=eps)
    var, mean = torch.var_mean(x.float(), dim=tuple(range(2, x.dim())),
                               keepdim=True, correction=0)
    return (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + eps)


class InstanceNorm(nn.Module):
    """``instance_norm`` as a module without parameters or buffers (the
    reference's affine-free nn.InstanceNorm3d)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)


class GroupNorm(_ComputeDtype, nn.GroupNorm):
    """nn.GroupNorm as Flax's GroupNorm(dtype=): float32 statistics and
    normalisation over a float32 copy of x, the output in the compute
    dtype (chap_tpu/models/vnet3d.py:25-26)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not reduced_dtype(self.compute_dtype):
            return F.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps)
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


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


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank (W > 1), with the
    biased variance of the concatenated rows. Each rank's (count, mean,
    sum of squared deviations) float32 are gathered with one all-reduce of a
    zero-filled [W, 2C + 1] buffer and combined on every rank in rank order
    (Chan's pairwise formula: the deviations of the rank means from the
    global mean are taken before squaring). So the statistics are the
    one-process ones up to float32 summation order. Flax's one-pass
    E[x^2] - E[x]^2 over all-reduced (sum x, sum x^2), which chap_tpu's mesh
    takes, loses digits to cancellation where a channel's mean is large
    against its spread: on the CPU tests' CHAP run it moved the VAT loss by
    3% at the sixth step against the one-process port, the combination
    here by 2e-7.

    The backward all-reduces its two cotangent sums (sum dy, sum dy x_hat),
    as SyncBatchNorm does (``all_reduce_partial``'s rule: every row's output
    depends on the other ranks' rows through the statistics); the weight and
    bias gradients stay this rank's part, which the step's
    ``all_reduce_grads`` sums. Returns (y, mean, var); mean and var carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        n = x.numel() // c
        var_r, mean_r = torch.var_mean(x, dims, correction=0)
        ranks = torch.zeros((dist.world_size(), 2 * c + 1), dtype=x.dtype,
                            device=x.device)
        ranks[dist.rank(), :c] = mean_r
        ranks[dist.rank(), c:2 * c] = var_r * n
        ranks[dist.rank(), 2 * c] = n
        dist.all_reduce_(ranks)
        counts = ranks[:, 2 * c:]
        count = counts.sum()
        mean = (ranks[:, :c] * counts).sum(0) / count
        var = (ranks[:, c:2 * c]
               + counts * (ranks[:, :c] - mean) ** 2).sum(0) / count
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, count)
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight.view(shape) + bias.view(shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd, count = ctx.saved_tensors
        c = xhat.shape[1]
        dims = (0,) + tuple(range(2, xhat.dim()))
        shape = (1, c) + (1,) * (xhat.dim() - 2)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        d_bias, d_weight = local[:c].clone(), local[c:].clone()
        total = dist.all_reduce_(local) / count
        dx = (dy - total[:c].view(shape) - xhat * total[c:].view(shape)) \
            * (invstd * weight).view(shape)
        return dx, d_weight, d_bias, None


class FlaxBatchNorm(_ComputeDtype):
    """BatchNorm with Flax train-mode semantics (see the module docstring),
    mixed into torch's BatchNorm2d / BatchNorm3d for their parameters and
    buffers. In a reduced compute dtype, as Flax's BatchNorm(dtype=): the
    batch statistics (reported and used) come from a float32 copy of x,
    the normalisation runs in float32, and its output is cast to the
    compute dtype; the running statistics stay float32.

    With a process group of W > 1 ranks (parallel/dist.py), train mode
    normalises with the statistics of every rank's rows and reports those
    (``_GlobalBatchNorm``), so the running stats are global too; eval mode
    is unchanged. No nn.SyncBatchNorm: it keeps torch's unbiased running
    variance and takes CUDA tensors only.

    ``stats_key`` is the module's qualified name in its model; the owning
    model sets it (``set_stats_keys``)."""

    stats_key: str = ""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None
                ) -> torch.Tensor:
        dt = self.compute_dtype
        if reduced_dtype(dt):
            x = x.float()
        else:
            dt = x.dtype
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(dt)
        if dist.world_size() > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                                  self.eps)
            if stats is not None:
                stats[self.stats_key] = (mean, var)
            return y.to(dt)
        if stats is not None:
            with torch.no_grad():
                var, mean = torch.var_mean(
                    x, dim=(0,) + tuple(range(2, x.dim())), correction=0)
            stats[self.stats_key] = (mean, var)
        # running buffers are not passed: nothing is updated in place
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(dt)


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
            Conv2d(in_channels, out_channels, 3, padding=1),
            BatchNorm2d(out_channels),
            nn.LeakyReLU(0.01),
            nn.Dropout(self.dropout_p),
            Conv2d(out_channels, out_channels, 3, padding=1),
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
            self.conv1x1 = Conv2d(in_channels1, in_channels2, 1)
        else:
            self.up = ConvTranspose2d(in_channels1, in_channels2, 2, stride=2)
        self.conv = ConvBlock(in_channels2 * (1 if plus else 2), out_channels,
                              dropout_p)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                stats: Optional[Stats] = None) -> torch.Tensor:
        x1 = upsample2x_bilinear(self.conv1x1(x1)) if self.bilinear else self.up(x1)
        x = x2 + x1 if self.plus else torch.cat([x2, x1], dim=1)
        return self.conv(x, None, stats)
