"""K1: fused masked dice + cross-entropy over one or two regions, a CUDA
C++ kernel for Hopper (csrc/fused_losses.cu) bound with ctypes.

Replaces chap_tpu/ops/fused_losses.py::masked_seg_stats -> _stats_kernel
(the Pallas kernel, :36-72 and :99-133) and the XLA custom-VJP backward
``_bwd`` (:159-179), together with the two calls of it that
chap_tpu/losses/mix.py makes on ``mask`` and ``1 - mask`` over the same
logits.

What it computes, for logits [B, C, *spatial] (spatial: [H, W] or
[X, Y, Z]; the kernels see the spatial axes flattened, class stride their
product), p = softmax over C and R in {1, 2} regions, region r with integer
labels l_r [B, *spatial] and weight w_r
(w_1 = mask, w_2 = 1 - mask), t_r = one_hot(l_r):
    I_rc = sum w_r p_c t_rc,  Z_rc = sum w_r p_c^2,  Y_rc = sum w_r t_rc,
    CE_rc = sum w_r t_rc (-log p_c),
    dice_r = mean_c 1 - (2 I_rc + s) / (Z_rc + Y_rc + s),
    ce_r = sum_c CE_rc / (sum_c Y_rc + eps)
(a pixel counts only where its label is in [0, C), as in chap_tpu).

The kernels take the logits in fp32, bf16 or fp16 (computing in fp32 and
storing the gradient in the logits' dtype), the labels in the dtype the
caller holds (uint8, int32 or int64, both regions one dtype) and an fp32
mask, or ``mask=None`` with one region, meaning every pixel counts:
``dice_ce_supervised`` passes no mask and ``_prepare`` converts no dtype.
What bounds them on the H100 is bytes (tens of flops a pixel against 5-18
bytes); the design (the source's header has it in full): a grid of
(chunk of the spatial plane, batch row) with one base pointer per class
plane and no per-pixel division, 16-byte loads and stores where the plane
length and the pointers allow (else a scalar path), a forward of two
launches (the blocks' partial sums, then one block that adds them in a
fixed order and composes dice and ce on the device: no float atomics, so
two calls are bit-identical), and one backward launch for both regions
that recomputes p and takes the coefficients from the saved statistics
and the incoming grads on the device. The backward is the gradient of the
forward also where a label lies outside [0, C), where chap_tpu's ``_bwd``
is not (it keeps m p / (sum Y + eps) for such a pixel). Until commit dabe82d K1 was
three Triton kernels; PERF.md §6 has both designs' times on the card.

Beside the kernels, the plain PyTorch versions used for CPU tensors and by
chip_smoke.py as the kernels' reference: ``region_stats_plain`` and
``compose_plain`` (forward, differentiable by autograd) and
``stats_grad_plain`` (the backward's analytic gradient), which take the
same labels and masks. A CUDA tensor launches the kernels or raises.
``stats_kernel.launches`` and ``stats_grad_kernel.launches`` count
launches of the forward and the backward, and their ``launches_bf16`` the
launches at bf16 logits (a bf16 model's).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from chap_tpu_torch.ops import cuda_build
from chap_tpu_torch.parallel import dist

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _class_view(logits: torch.Tensor) -> torch.Tensor:
    """Class indices shaped [1, C, 1, ...] against logits [B, C, *spatial]."""
    c = logits.shape[1]
    return torch.arange(c, device=logits.device).view(
        (1, c) + (1,) * (logits.dim() - 2))


def _regions(mask: Optional[torch.Tensor], labels: torch.Tensor,
             labels2: Optional[torch.Tensor]):
    """[(labels, weight)] per region; mask None weighs every pixel 1."""
    if mask is None:
        if labels2 is not None:
            raise ValueError("mask=None (every pixel counts) takes one "
                             "region: region 2 is weighed by 1 - mask")
        return [(labels, torch.ones(labels.shape, device=labels.device))]
    m = mask.float()
    if labels2 is None:
        return [(labels, m)]
    return [(labels, m), (labels2, 1.0 - m)]


def region_stats_plain(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor],
                       labels2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1's statistics: [R, 4, C] rows (I, Z, Y, CE) per
    class for region 1 (labels, mask) and, with ``labels2``, region 2
    (labels2, 1 - mask). Logits [B, C, *spatial], integer labels of any
    dtype, mask None for every pixel (one region); differentiable."""
    x = logits.float()
    p = torch.softmax(x, dim=1)
    logp = torch.log_softmax(x, dim=1)
    cls = _class_view(logits)
    dims = (0,) + tuple(range(2, logits.dim()))
    rows = []
    for lab, w in _regions(mask, labels, labels2):
        t = (lab.unsqueeze(1) == cls).float()
        wt = w.unsqueeze(1) * t
        rows.append(torch.stack([(p * wt).sum(dims),
                                 (p * p * w.unsqueeze(1)).sum(dims),
                                 wt.sum(dims),
                                 (-logp * wt).sum(dims)]))
    return torch.stack(rows)


def compose_plain(stats: torch.Tensor, smooth_dice: float,
                  eps_ce: float) -> torch.Tensor:
    """[R, 4, C] statistics -> [R, 2] (dice, ce) per region."""
    inter, z, y, ce_c = stats.unbind(1)
    dice = torch.mean(1.0 - (2.0 * inter + smooth_dice)
                      / (z + y + smooth_dice), dim=1)
    ce = ce_c.sum(1) / (y.sum(1) + eps_ce)
    return torch.stack([dice, ce], dim=1)


def masked_seg_stats_plain(logits: torch.Tensor, labels: torch.Tensor,
                           mask: Optional[torch.Tensor]) -> Stats:
    """(I[C], Z[C], Y[C], ce_sum, mask_sum) for logits [B, C, *spatial]
    (chap_tpu's _masked_seg_stats_xla)."""
    inter, z, y, ce_c = region_stats_plain(logits, labels, mask)[0]
    return inter, z, y, ce_c.sum(), y.sum()


def stats_grad_plain(logits: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor], stats: torch.Tensor,
                     grads: torch.Tensor, smooth_dice: float, eps_ce: float,
                     labels2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1's backward, the arithmetic ``stats_grad`` does on
    the device: d/dlogits of sum_r g_dice_r dice_r + g_ce_r ce_r from the
    saved statistics [R, 4, >= C] and the incoming grads [R, 2]. Unlike
    chap_tpu's ``_bwd``, a pixel whose label lies outside [0, C) gets no CE
    gradient: it has no CE term in the forward."""
    c = logits.shape[1]
    p = torch.softmax(logits.float(), dim=1)
    cls = _class_view(logits)
    dl_dp = torch.zeros_like(p)
    d_ce = torch.zeros_like(p)
    for r, (lab, w) in enumerate(_regions(mask, labels, labels2)):
        inter, z, y = (v[:c].view(cls.shape) for v in stats[r, :3].float())
        g_dice, g_ce = grads[r].float()
        denom = z + y + smooth_dice
        a = g_dice * (-2.0 / denom / c)                          # dL/dI_c
        b = g_dice * 2.0 * (2.0 * inter + smooth_dice) / denom ** 2 / c
        k = g_ce / (y.sum() + eps_ce)
        t = (lab.unsqueeze(1) == cls).float()
        w = w.unsqueeze(1)
        dl_dp = dl_dp + w * (a * t + b * p)
        valid = ((lab >= 0) & (lab < c)).float().unsqueeze(1)
        d_ce = d_ce + k * w * valid * (p - t)
    inner = (dl_dp * p).sum(1, keepdim=True)
    return (p * (dl_dp - inner) + d_ce).to(logits.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers (csrc/fused_losses.cu)
# ---------------------------------------------------------------------------

_SOURCE = "fused_losses.cu"
LOGIT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LABEL_TYPES = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load(_SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' arguments on a loaded build of
    fused_losses.cu."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chap_k1_forward.argtypes = [ptr] * 6 + [i32] * 9 + [f32, f32, ptr]
    lib.chap_k1_forward.restype = i32
    lib.chap_k1_backward.argtypes = [ptr] * 10 + [i32] * 7 + [f32, f32, ptr]
    lib.chap_k1_backward.restype = i32
    lib.chap_k1_max_rows.restype = i32
    lib.max_rows = lib.chap_k1_max_rows()
    return lib


def _prepare(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor],
             labels2: Optional[torch.Tensor] = None):
    """Check what the kernels take: float logits [B, C, *spatial] on the card
    with one to three spatial axes; uint8, int32 or int64 labels [B,
    *spatial] (both regions one dtype); an fp32 mask [B, *spatial], or None
    (every pixel counts, one region only). No dtype is converted: a tensor
    is copied only when it is not contiguous."""
    if not 3 <= logits.dim() <= 5 or logits.dtype not in LOGIT_TYPES:
        raise ValueError(f"logits must be float [B, C, *spatial] with 1-3 "
                         f"spatial axes ([B, C, H, W], [B, C, X, Y, Z]), got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if logits.numel() >= 1 << 31:
        raise ValueError("K1 indexes pixels with int32: logits must hold "
                         "fewer than 2**31 values")
    if logits.shape[0] > 65535:
        raise ValueError("K1 takes at most 65535 rows (a grid dimension)")
    want = logits.shape[:1] + logits.shape[2:]
    maps = [t for t in (labels, mask, labels2) if t is not None]
    if any(t.shape != want for t in maps):
        raise ValueError(f"labels / mask {[tuple(t.shape) for t in maps]} "
                         f"must be {tuple(want)}")
    if mask is None and labels2 is not None:
        raise ValueError("mask=None (every pixel counts) takes one region: "
                         "region 2 is weighed by 1 - mask")
    if labels.dtype not in LABEL_TYPES or (
            labels2 is not None and labels2.dtype != labels.dtype):
        raise ValueError(f"labels must be uint8, int32 or int64 maps, both "
                         f"regions one dtype, got {labels.dtype}"
                         + ("" if labels2 is None else f" and {labels2.dtype}"))
    if mask is not None and mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32 or None, got {mask.dtype}")
    if not logits.is_cuda:
        raise ValueError("K1 kernels take CUDA tensors only")
    if any(t.device != logits.device for t in maps):
        raise ValueError("labels and mask must be on the logits' device")
    return tuple(None if t is None else t.contiguous()
                 for t in (logits, labels, mask, labels2))


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _geometry(logits: torch.Tensor, labels2: Optional[torch.Tensor]):
    """(B, C, C_PAD, HW, R) of a K1 call: HW the pixels of a class plane."""
    c = logits.shape[1]
    return (logits.shape[0], c, _next_pow2(c), math.prod(logits.shape[2:]),
            1 if labels2 is None else 2)


def stats_kernel(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor],
                 labels2: Optional[torch.Tensor] = None,
                 smooth_dice: float = 1e-10, eps_ce: float = 1e-16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 forward on the card, two launches: ([R, 2] (dice, ce) per region,
    [R, 4, C_PAD] fp32 statistics (I, Z, Y, CE) per class). One region with
    ``labels2=None``; else region 2 is (labels2, 1 - mask). ``mask=None``
    (one region) counts every pixel. Zero rows (a data-parallel rank
    without any) launch one block that sums nothing, so the statistics are
    zeros."""
    logits, labels, mask, labels2 = _prepare(logits, labels, mask, labels2)
    lib = _library()
    b, c, c_pad, hw, r = _geometry(logits, labels2)
    index = logits.device.index
    rows = max(b, lib.max_rows)
    n_stats = r * 4 * c_pad
    buf = torch.empty((n_stats + 2 * r + rows * r * 4 * c,),
                      device=logits.device, dtype=torch.float32)
    err = lib.chap_k1_forward(
        logits.data_ptr(), labels.data_ptr(), _ptr(labels2), _ptr(mask),
        buf.data_ptr() + 4 * (n_stats + 2 * r), buf.data_ptr(), b, c, c_pad,
        hw, r, LOGIT_TYPES[logits.dtype], LABEL_TYPES[labels.dtype],
        _sm_count(index), rows,
        smooth_dice, eps_ce, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"K1 forward launch failed: cudaError {err}")
    stats_kernel.launches += 1
    stats_kernel.launches_bf16 += logits.dtype == torch.bfloat16
    return (torch.as_strided(buf, (r, 2), (2, 1), n_stats),
            torch.as_strided(buf, (r, 4, c_pad), (4 * c_pad, c_pad, 1)))


stats_kernel.launches = 0
stats_kernel.launches_bf16 = 0


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    """A device zero that stands for an incoming grad autograd left None."""
    return torch.zeros((), device=device, dtype=torch.float32)


def stats_grad_kernel(logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor], stats: torch.Tensor,
                      grads: Sequence[Optional[torch.Tensor]],
                      labels2: Optional[torch.Tensor] = None,
                      smooth_dice: float = 1e-10, eps_ce: float = 1e-16
                      ) -> torch.Tensor:
    """K1 backward on the card, one launch: d/dlogits of
    sum_r g_dice_r dice_r + g_ce_r ce_r, same shape and dtype as logits.
    stats: the forward's [R, 4, C_PAD]; grads: 2R scalar tensors on the
    device, (g_dice_1, g_ce_1[, g_dice_2, g_ce_2]), None for zero. Zero
    rows launch nothing (and count nothing): the gradient is empty."""
    logits, labels, mask, labels2 = _prepare(logits, labels, mask, labels2)
    b, c, c_pad, hw, r = _geometry(logits, labels2)
    if (tuple(stats.shape) != (r, 4, c_pad) or stats.dtype != torch.float32
            or not stats.is_contiguous() or len(grads) != 2 * r):
        raise ValueError(f"stats must be contiguous fp32 {(r, 4, c_pad)} and "
                         f"grads {2 * r} scalars")
    zero = _zero(logits.device)
    g = [zero if x is None else x.to(torch.float32) for x in grads]
    g += [zero] * (4 - len(g))
    grad = torch.empty_like(logits)
    if labels.numel() == 0:     # a rank without rows: no pixel, no launch
        return grad
    stream = torch._C._cuda_getCurrentRawStream(logits.device.index)
    err = _library().chap_k1_backward(
        logits.data_ptr(), labels.data_ptr(), _ptr(labels2), _ptr(mask),
        stats.data_ptr(), *(x.data_ptr() for x in g), grad.data_ptr(), b, c,
        c_pad, hw, r, LOGIT_TYPES[logits.dtype], LABEL_TYPES[labels.dtype],
        smooth_dice, eps_ce, stream)
    if err != 0:
        raise RuntimeError(f"K1 backward launch failed: cudaError {err}")
    stats_grad_kernel.launches += 1
    stats_grad_kernel.launches_bf16 += logits.dtype == torch.bfloat16
    return grad


stats_grad_kernel.launches = 0
stats_grad_kernel.launches_bf16 = 0


class _RegionDiceCE(torch.autograd.Function):
    """K1 forward and backward on the card (chap_tpu's custom_vjp pair, over
    one or two regions): returns (dice_1, ce_1[, dice_2, ce_2]).

    With W > 1 ranks (parallel/dist.py) the kernel's statistics are this
    rank's rows only: they are all-reduced, dice and CE are composed from
    the global statistics by ``compose_plain`` (a few tensor ops on
    [R, 4, C]; the kernel's own compose is then unused), and the
    global statistics are saved for the backward kernel, since the gradient
    of dice with respect to this rank's logits depends on the global I, Z
    and Y. The compose is replicated, so its statistics take
    ``all_reduce_replicated``'s rule: the incoming grads are already whole
    and are not reduced again."""

    @staticmethod
    def forward(ctx, logits, labels, mask, labels2, smooth_dice, eps_ce):
        losses, stats = stats_kernel(logits, labels, mask, labels2,
                                     smooth_dice, eps_ce)
        if dist.world_size() > 1:
            stats = dist.all_reduce_(stats.clone())
            losses = compose_plain(stats[:, :, :logits.shape[1]], smooth_dice,
                                   eps_ce)
        ctx.set_materialize_grads(False)   # a None grad is a device zero
        ctx.save_for_backward(logits, labels, mask, labels2, stats)
        ctx.smooth_dice, ctx.eps_ce = smooth_dice, eps_ce
        return tuple(losses.view(-1).unbind())

    @staticmethod
    def backward(ctx, *grads):
        logits, labels, mask, labels2, stats = ctx.saved_tensors
        grad = stats_grad_kernel(logits, labels, mask, stats, grads, labels2,
                                 ctx.smooth_dice, ctx.eps_ce)
        return grad, None, None, None, None, None


def masked_seg_stats(logits: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> Stats:
    """(I[C], Z[C], Y[C], ce_sum, mask_sum) for logits [B, C, *spatial]:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if logits.device.type == "cpu":
        return masked_seg_stats_plain(logits, labels, mask)
    c = logits.shape[1]
    inter, z, y, ce_c = stats_kernel(logits, labels, mask)[1][0, :, :c]
    return inter, z, y, ce_c.sum(), y.sum()


def region_dice_ce(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor],
                   labels2: Optional[torch.Tensor] = None,
                   smooth_dice: float = 1e-10, eps_ce: float = 1e-16
                   ) -> Tuple[torch.Tensor, ...]:
    """(dice_1, ce_1[, dice_2, ce_2]), differentiable in ``logits``: region
    1 is (labels, mask), region 2 (labels2, 1 - mask); ``mask=None`` (one
    region) counts every pixel. CUDA: K1's forward and backward kernels, one
    call for both regions. CPU: the plain version
    under autograd (the same function, so the same gradient). With W > 1
    ranks the losses are those of the global batch: the per-class
    statistics are all-reduced between the two halves (``_RegionDiceCE``)."""
    if logits.device.type == "cpu":
        stats = dist.all_reduce_replicated(
            region_stats_plain(logits, labels, mask, labels2))
        losses = compose_plain(stats, smooth_dice, eps_ce)
        return tuple(losses.view(-1).unbind())
    return _RegionDiceCE.apply(logits, labels, mask, labels2,
                               float(smooth_dice), float(eps_ce))


def fused_masked_dice_ce(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor], smooth_dice: float = 1e-10,
                         eps_ce: float = 1e-16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_dice_loss, masked_ce_loss) over one region, differentiable in
    ``logits`` (chap_tpu's fused_masked_dice_ce)."""
    return region_dice_ce(logits, labels, mask, None, smooth_dice, eps_ce)
