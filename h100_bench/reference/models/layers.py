"""Building blocks of the 2D UNet and the 3D VNet in plain PyTorch (a
frozen copy of the port's ``models/layers.py``), with its semantics:

BatchNorm follows Flax: in train mode it normalises with the biased batch
statistics, leaves its running buffers alone and reports the batch mean
and variance in a ``stats`` dict, which the train step folds into the
running stats (running = 0.9 * running + 0.1 * batch).

Compute dtype: the parameters stay float32; every convolution casts its
input, kernel and bias to the compute dtype and gives its output in it;
BatchNorm takes float32 statistics of a float32 copy of its input and
casts its output to the compute dtype. At float32 nothing is cast.

``set_fp8_operands`` is the benchmark's control, not a path of the port:
a bf16 model whose convolutions round their input and kernel to float8
e4m3 (each scaled by its largest magnitude over 448) before the bf16
convolution, the precision below the bf16 one that the LA configuration
states.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


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
    (an attribute that ``set_compute_dtype`` sets; float32 by default). A
    module whose ``follows_model`` is False keeps float32."""

    compute_dtype: torch.dtype = torch.float32
    follows_model: bool = True


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every convolution, dense layer, norm and attention of ``model``
    compute in ``dtype`` over its float32 parameters (the module docstring
    says how); returns the model. ``model.compute_dtype`` records it."""
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
    for module in model.modules():
        if isinstance(module, _ComputeDtype) and module.follows_model:
            module.compute_dtype = dtype
    model.compute_dtype = dtype
    return model


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two activations of one dtype (JAX's einsum of them). On
    the CPU a bf16 product is the float32 product rounded once (the
    module docstring says why); elsewhere PyTorch's own."""
    if reduced_dtype(a.dtype) and a.device.type == "cpu":
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


def _cast_conv(conv, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], dt: torch.dtype,
               bias_inside: bool = False) -> torch.Tensor:
    """``conv(x, weight, bias)`` with all three cast to ``dt``, the output
    in ``dt``. On the CPU in bf16 the product of the bf16 operands is taken
    in float32 and rounded once, and the bf16 bias is then added in bf16
    (rounded again): what the card's bf16 convolution computes (float32
    accumulation; PyTorch adds a cuDNN convolution's bias after it, as
    Flax's nn.Conv adds its bias to the bf16 product); chip_smoke.py's
    ``bf16_products`` check holds this to the card's product. ``bias_inside``:
    the bias joins the float32 accumulation and the sum is rounded once, as
    the card's bf16 GEMM adds a Linear's bias in its epilogue. Not
    oneDNN's own bf16 convolution: it gives wrong sums for some strided
    shapes (a [2, 32, 6, 4, 2] input, 3^3 kernel, stride 2, padding 1 comes
    out 7.6 off at a scale of 6.6 with torch 2.13's CPU build)."""
    if not reduced_dtype(dt):
        # a float32 model takes reduced-precision input in its own dtype, as
        # Flax's nn.Conv(dtype=float32) promotes it
        return conv(x.to(weight.dtype), weight, bias)
    x, weight = x.to(dt), weight.to(dt)
    bias = None if bias is None else bias.to(dt)
    if x.device.type != "cpu":
        return conv(x, weight, bias)
    if bias is None or bias_inside:
        return conv(x.float(), weight.float(),
                    None if bias is None else bias.float()).to(dt)
    y = conv(x.float(), weight.float(), None).to(dt)
    return y + bias.view((1, -1) + (1,) * (y.dim() - 2))


class _CastConv(_ComputeDtype):
    """A convolution in the compute dtype: input, kernel and bias cast to it
    (Flax nn.Conv(dtype=) / nn.ConvTranspose(dtype=)), so the gradient
    reaches the float32 kernel."""

    bias_inside = False

    fp8_operands = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight
        if self.fp8_operands:
            x, weight = fp8_round(x), fp8_round(weight)
        return _cast_conv(self._apply_conv, x, weight, self.bias,
                          self.compute_dtype, self.bias_inside)


FP8_MAX = 448.0     # the largest finite float8 e4m3 value


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to FP8_MAX), back in its own dtype; differentiable as
    the identity (a straight-through rounding)."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def set_fp8_operands(model: nn.Module) -> nn.Module:
    """Round every convolution's input and kernel of ``model`` to float8
    e4m3 (``fp8_round``); the model's compute dtype stays as it is."""
    for module in model.modules():
        if isinstance(module, _CastConv):
            module.fp8_operands = True
    return model


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

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=1.0 - BN_MOMENTUM)

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
