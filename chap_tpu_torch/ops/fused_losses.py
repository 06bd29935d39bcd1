"""K1: fused masked dice + cross-entropy over one or two regions, in Triton.

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

What bounds it on the H100: bytes, and on the main path the host. At
mix_loss's shape [6, 4, 256, 256] a forward reads 6.3 MB of fp32 logits,
two 1.6 MB int32 label maps and a 1.6 MB fp32 mask (11.0 MB, 3.3 us at
3.35 TB/s); the backward reads the same and writes 6.3 MB of gradient
(17.3 MB, 5.2 us). At the 3D CHAP step's [1, 2, 112, 112, 80] (R = 2) a
forward reads 8.0 MB of logits and 12.0 MB of labels and mask (20.1 MB,
6.0 us). Both are tens of flops a pixel, far below the rate the card
computes at. What the design does about it:
  * one read of the logits serves both regions: mix_loss calls K1 once
    (R = 2, ``1 - mask`` formed in registers), not once per region;
  * forward, two launches: ``stats_partials`` (two programs per SM) reduces
    a strided range of pixels per program into fp32 partials
    [P, R, 4, C_PAD]; ``stats_finalize`` (one program, one pass over the
    partials) sums them in a fixed order and composes dice_r and ce_r on
    the device, so two calls are bit-identical (no atomics) and no tiny
    PyTorch kernels follow;
  * backward, one launch for any R: ``stats_grad`` recomputes p once,
    forms every region's per-class coefficients from the saved statistics
    and the incoming grads (pointers, never read on the host), and writes
    one gradient, the sum over the regions. A region whose grads are None
    reads a device zero and contributes nothing. It is the gradient of the
    forward also where a label lies outside [0, C), where chap_tpu's
    ``_bwd`` is not (it keeps m p / (sum Y + eps) for such a pixel).
Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W at that shape with
R = 2: 11.5 us of kernel time forward (two kernels) and 4.5-5.2 us
backward, at its bytes bound; the host's 37-120 us per call to launch them
now costs more than the card's work does.

Beside the kernels, the plain PyTorch versions used for CPU tensors and by
chip_smoke.py as the kernels' reference: ``region_stats_plain`` and
``compose_plain`` (forward, differentiable by autograd) and
``stats_grad_plain`` (the backward's analytic gradient). A CUDA tensor
launches the kernels or raises. ``stats_kernel.launches`` and
``stats_grad_kernel.launches`` count launches of the forward and the
backward, and their ``launches_bf16`` the launches at bf16 logits (a bf16
model's: Triton compiles the kernels again for that pointer type; they load
the logits as bf16 and compute in fp32, and the gradient is stored in
bf16). At bf16 logits chip_smoke.py measured (same card) 0.031 / 0.031 ms
forward / backward at [1, 2, 112, 112, 80] R = 2 and 0.088 / 0.101 ms at
[4, 2, 96, 96, 96] R = 1, 2-4.6x the fp32 instantiation's time though the
logits' bytes halve; why is not yet known (ROADMAP §2).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from chap_tpu_torch.parallel import dist

BLOCK = 512            # pixels per tile, forward and backward
PROGRAMS_PER_SM = 2    # forward programs; more pixels loop inside a program
FIN_ROWS = 128         # partial rows the finalising program sums per step

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


def _regions(mask: torch.Tensor, labels: torch.Tensor,
             labels2: Optional[torch.Tensor]):
    m = mask.float()
    if labels2 is None:
        return [(labels, m)]
    return [(labels, m), (labels2, 1.0 - m)]


def region_stats_plain(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor,
                       labels2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1's statistics: [R, 4, C] rows (I, Z, Y, CE) per
    class for region 1 (labels, mask) and, with ``labels2``, region 2
    (labels2, 1 - mask). Logits [B, C, *spatial]; differentiable."""
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
                           mask: torch.Tensor) -> Stats:
    """(I[C], Z[C], Y[C], ce_sum, mask_sum) for logits [B, C, *spatial]
    (chap_tpu's _masked_seg_stats_xla)."""
    inter, z, y, ce_c = region_stats_plain(logits, labels, mask)[0]
    return inter, z, y, ce_c.sum(), y.sum()


def stats_grad_plain(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, stats: torch.Tensor,
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
# Triton kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels on first use (Triton is imported here, not
    when the module is imported: the CPU tests import every module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def _load_probs(logits_ptr, offs, ok, hw, C: tl.constexpr,
                    C_PAD: tl.constexpr):
        cls = tl.arange(0, C_PAD)
        cls_ok = cls < C
        o64 = offs.to(tl.int64)
        b = o64 // hw
        base = b * (C * hw) + (o64 - b * hw)
        off = base[None, :] + (cls.to(tl.int64) * hw)[:, None]
        ld = cls_ok[:, None] & ok[None, :]
        x = tl.load(logits_ptr + off, mask=ld, other=0.0).to(tl.float32)
        x = tl.where(cls_ok[:, None], x, float("-inf"))
        mx = tl.max(x, axis=0)
        xs = x - mx[None, :]
        ex = tl.exp(xs)
        den = tl.sum(ex, axis=0)
        p = ex / den[None, :]
        logp = xs - tl.log(den)[None, :]
        return p, logp, off, ld

    @triton.jit
    def _load_labels(lab_ptr, offs, ok, C: tl.constexpr):
        """Labels, with those outside [0, C) (and the tile's tail) as -1:
        they match no class, also not a padded one in [C, C_PAD)."""
        lab = tl.load(lab_ptr + offs, mask=ok, other=-1)
        return tl.where(lab < C, lab, -1)

    @triton.jit
    def stats_partials(logits_ptr, lab1_ptr, lab2_ptr, mask_ptr, part_ptr,
                       n_pix, hw, C: tl.constexpr, C_PAD: tl.constexpr,
                       R: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        nprog = tl.num_programs(0)
        cls = tl.arange(0, C_PAD)
        i1 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        z1 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        y1 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        ce1 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        i2 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        z2 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        y2 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        ce2 = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        for start in range(pid * BLOCK, n_pix, nprog * BLOCK):
            offs = start + tl.arange(0, BLOCK)
            ok = offs < n_pix
            p, logp, _, _ = _load_probs(logits_ptr, offs, ok, hw, C, C_PAD)
            pp = p * p
            m = tl.load(mask_ptr + offs, mask=ok, other=0.0)
            lab = _load_labels(lab1_ptr, offs, ok, C)
            t = cls[:, None] == lab[None, :]
            wt = tl.where(t, m[None, :], 0.0)
            i1 += p * wt
            z1 += pp * m[None, :]
            y1 += wt
            ce1 += tl.where(t, -logp * m[None, :], 0.0)
            if R == 2:
                w2 = tl.where(ok, 1.0 - m, 0.0)
                lab = _load_labels(lab2_ptr, offs, ok, C)
                t = cls[:, None] == lab[None, :]
                wt = tl.where(t, w2[None, :], 0.0)
                i2 += p * wt
                z2 += pp * w2[None, :]
                y2 += wt
                ce2 += tl.where(t, -logp * w2[None, :], 0.0)
        out = part_ptr + pid * (R * 4 * C_PAD) + cls
        tl.store(out, tl.sum(i1, axis=1))
        tl.store(out + C_PAD, tl.sum(z1, axis=1))
        tl.store(out + 2 * C_PAD, tl.sum(y1, axis=1))
        tl.store(out + 3 * C_PAD, tl.sum(ce1, axis=1))
        if R == 2:
            tl.store(out + 4 * C_PAD, tl.sum(i2, axis=1))
            tl.store(out + 5 * C_PAD, tl.sum(z2, axis=1))
            tl.store(out + 6 * C_PAD, tl.sum(y2, axis=1))
            tl.store(out + 7 * C_PAD, tl.sum(ce2, axis=1))

    @triton.jit
    def stats_finalize(part_ptr, out_ptr, n_part, smooth, eps,
                       C: tl.constexpr, C_PAD: tl.constexpr, R: tl.constexpr,
                       ROWS: tl.constexpr):
        rows = tl.arange(0, ROWS)
        kk = tl.arange(0, 4 * R)              # (I, Z, Y, CE) of each region
        cls = tl.arange(0, C_PAD)
        col = kk[:, None] * C_PAD + cls[None, :]
        acc = tl.zeros([ROWS, 4 * R, C_PAD], dtype=tl.float32)
        for start in range(0, n_part, ROWS):
            r = start + rows
            acc += tl.load(part_ptr + r[:, None, None] * (4 * R * C_PAD)
                           + col[None, :, :],
                           mask=(r < n_part)[:, None, None], other=0.0)
        tot = tl.sum(acc, axis=0)             # rows summed in a fixed order
        tl.store(out_ptr + col, tot)
        cls_ok = cls < C
        for q in tl.static_range(R):
            inter = tl.sum(tl.where(kk[:, None] == 4 * q, tot, 0.0), axis=0)
            z = tl.sum(tl.where(kk[:, None] == 4 * q + 1, tot, 0.0), axis=0)
            y = tl.sum(tl.where(kk[:, None] == 4 * q + 2, tot, 0.0), axis=0)
            ce = tl.sum(tl.where(kk[:, None] == 4 * q + 3, tot, 0.0), axis=0)
            frac = (2.0 * inter + smooth) / (z + y + smooth)
            dice = tl.sum(tl.where(cls_ok, 1.0 - frac, 0.0), axis=0) / C
            ce_loss = tl.sum(ce, axis=0) / (tl.sum(y, axis=0) + eps)
            tl.store(out_ptr + R * 4 * C_PAD + 2 * q, dice)
            tl.store(out_ptr + R * 4 * C_PAD + 2 * q + 1, ce_loss)

    @triton.jit
    def _region_coef(stats_ptr, g_dice_ptr, g_ce_ptr, smooth, eps,
                     C: tl.constexpr, C_PAD: tl.constexpr):
        """Per-class dL/dI (a), the dL/dp coefficient of p (b) and the CE
        scale (k) of one region, from its statistics and incoming grads."""
        cls = tl.arange(0, C_PAD)
        cls_ok = cls < C
        inter = tl.load(stats_ptr + cls)
        y = tl.load(stats_ptr + 2 * C_PAD + cls)
        denom = tl.load(stats_ptr + C_PAD + cls) + y + smooth
        g_dice = tl.load(g_dice_ptr)
        a = tl.where(cls_ok, g_dice * (-2.0 / denom / C), 0.0)
        b = tl.where(cls_ok, g_dice * 2.0 * (2.0 * inter + smooth)
                     / (denom * denom) / C, 0.0)
        k = tl.load(g_ce_ptr) / (tl.sum(y, axis=0) + eps)
        return a, b, k

    @triton.jit
    def stats_grad(logits_ptr, lab1_ptr, lab2_ptr, mask_ptr, stats_ptr,
                   gd1_ptr, gc1_ptr, gd2_ptr, gc2_ptr, grad_ptr, n_pix, hw,
                   smooth, eps, C: tl.constexpr, C_PAD: tl.constexpr,
                   R: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cls = tl.arange(0, C_PAD)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        ok = offs < n_pix
        p, _, off, ld = _load_probs(logits_ptr, offs, ok, hw, C, C_PAD)
        m = tl.load(mask_ptr + offs, mask=ok, other=0.0)[None, :]
        a, b, k = _region_coef(stats_ptr, gd1_ptr, gc1_ptr, smooth, eps,
                               C, C_PAD)
        lab = _load_labels(lab1_ptr, offs, ok, C)
        t = tl.where(cls[:, None] == lab[None, :], 1.0, 0.0)
        dl_dp = m * (a[:, None] * t + b[:, None] * p)
        # a pixel whose label is outside [0, C) adds nothing to CE
        d_ce = tl.where(lab[None, :] >= 0, k * m, 0.0) * (p - t)
        if R == 2:
            w2 = tl.where(ok, 1.0 - m, 0.0)
            a, b, k = _region_coef(stats_ptr + 4 * C_PAD, gd2_ptr, gc2_ptr,
                                   smooth, eps, C, C_PAD)
            lab = _load_labels(lab2_ptr, offs, ok, C)
            t = tl.where(cls[:, None] == lab[None, :], 1.0, 0.0)
            dl_dp += w2 * (a[:, None] * t + b[:, None] * p)
            d_ce += tl.where(lab[None, :] >= 0, k * w2, 0.0) * (p - t)
        inner = tl.sum(dl_dp * p, axis=0)
        g = p * (dl_dp - inner[None, :]) + d_ce
        tl.store(grad_ptr + off, g.to(grad_ptr.dtype.element_ty), mask=ld)

    return stats_partials, stats_finalize, stats_grad


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _prepare(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             labels2: Optional[torch.Tensor] = None):
    """Check what the kernels take: float logits [B, C, *spatial] on the card
    with one to three spatial axes, labels and mask [B, *spatial]. Labels
    become int32 and the mask fp32 (no-ops when they already are)."""
    if not 3 <= logits.dim() <= 5 or logits.dtype not in (
            torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"logits must be float [B, C, *spatial] with 1-3 "
                         f"spatial axes ([B, C, H, W], [B, C, X, Y, Z]), got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if logits.numel() >= 1 << 31:
        raise ValueError("K1 indexes pixels with int32: logits must hold "
                         "fewer than 2**31 values")
    want = (logits.shape[0],) + tuple(logits.shape[2:])
    maps = [labels, mask] + ([] if labels2 is None else [labels2])
    if any(tuple(t.shape) != want for t in maps):
        raise ValueError(f"labels / mask {[tuple(t.shape) for t in maps]} "
                         f"must be {want}")
    if not logits.is_cuda:
        raise ValueError("K1 kernels take CUDA tensors only")
    if any(t.device != logits.device for t in maps):
        raise ValueError("labels and mask must be on the logits' device")
    if labels.dtype.is_floating_point or (
            labels2 is not None and labels2.dtype.is_floating_point):
        raise ValueError("labels must be integer maps")

    def lab(t):
        return None if t is None else t.to(torch.int32).contiguous()

    return (logits.contiguous(), lab(labels),
            mask.to(torch.float32).contiguous(), lab(labels2))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stats_kernel(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, labels2: Optional[torch.Tensor] = None,
                 smooth_dice: float = 1e-10, eps_ce: float = 1e-16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 forward on the card, two launches: ([R, 2] (dice, ce) per region,
    [R, 4, C_PAD] fp32 statistics (I, Z, Y, CE) per class). One region with
    ``labels2=None``; else region 2 is (labels2, 1 - mask). Zero rows (a
    data-parallel rank without any) launch one partials program that sums
    nothing, so the statistics are zeros."""
    logits, labels, mask, labels2 = _prepare(logits, labels, mask, labels2)
    partials_k, finalize_k, _ = _kernels()
    c = logits.shape[1]
    n_pix = labels.numel()
    hw = math.prod(logits.shape[2:])       # the class stride
    c_pad = _next_pow2(c)
    r = 1 if labels2 is None else 2
    n_part = max(1, min(-(-n_pix // BLOCK),
                        PROGRAMS_PER_SM * _sm_count(logits.device)))
    part = torch.empty((n_part, r * 4 * c_pad), device=logits.device,
                       dtype=torch.float32)
    out = torch.empty((r * 4 * c_pad + 2 * r,), device=logits.device,
                      dtype=torch.float32)
    lab2 = labels if labels2 is None else labels2
    partials_k[(n_part,)](logits, labels, lab2, mask, part, n_pix, hw,
                          C=c, C_PAD=c_pad, R=r, BLOCK=BLOCK, num_warps=4)
    finalize_k[(1,)](part, out, n_part, float(smooth_dice), float(eps_ce),
                     C=c, C_PAD=c_pad, R=r, ROWS=FIN_ROWS, num_warps=4)
    stats_kernel.launches += 1
    stats_kernel.launches_bf16 += logits.dtype == torch.bfloat16
    n_stats = r * 4 * c_pad
    return out[n_stats:].view(r, 2), out[:n_stats].view(r, 4, c_pad)


stats_kernel.launches = 0
stats_kernel.launches_bf16 = 0


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    """A device zero that stands for an incoming grad autograd left None."""
    return torch.zeros((), device=device, dtype=torch.float32)


def stats_grad_kernel(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, stats: torch.Tensor,
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
    _, _, grad_k = _kernels()
    c = logits.shape[1]
    n_pix = labels.numel()
    hw = math.prod(logits.shape[2:])       # the class stride
    c_pad = _next_pow2(c)
    r = 1 if labels2 is None else 2
    if (tuple(stats.shape) != (r, 4, c_pad) or stats.dtype != torch.float32
            or not stats.is_contiguous() or len(grads) != 2 * r):
        raise ValueError(f"stats must be contiguous fp32 {(r, 4, c_pad)} and "
                         f"grads {2 * r} scalars")
    zero = _zero(logits.device)
    g = [zero if x is None else x.to(torch.float32) for x in grads]
    g += [zero] * (4 - len(g))
    grad = torch.empty_like(logits)
    if n_pix == 0:          # a rank without rows: no pixel, no launch
        return grad
    lab2 = labels if labels2 is None else labels2
    grad_k[(-(-n_pix // BLOCK),)](
        logits, labels, lab2, mask, stats, *g, grad, n_pix, hw,
        float(smooth_dice), float(eps_ce), C=c, C_PAD=c_pad, R=r,
        BLOCK=BLOCK, num_warps=4)
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
    [R, 4, C]; the finalize kernel's own compose is then unused), and the
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
                     mask: torch.Tensor) -> Stats:
    """(I[C], Z[C], Y[C], ce_sum, mask_sum) for logits [B, C, *spatial]:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if logits.device.type == "cpu":
        return masked_seg_stats_plain(logits, labels, mask)
    c = logits.shape[1]
    inter, z, y, ce_c = stats_kernel(logits, labels, mask)[1][0, :, :c]
    return inter, z, y, ce_c.sum(), y.sum()


def region_dice_ce(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, labels2: Optional[torch.Tensor] = None,
                   smooth_dice: float = 1e-10, eps_ce: float = 1e-16
                   ) -> Tuple[torch.Tensor, ...]:
    """(dice_1, ce_1[, dice_2, ce_2]), differentiable in ``logits``: region
    1 is (labels, mask), region 2 (labels2, 1 - mask). CUDA: K1's Triton
    forward and backward, one call for both regions. CPU: the plain version
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
                         mask: torch.Tensor, smooth_dice: float = 1e-10,
                         eps_ce: float = 1e-16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_dice_loss, masked_ce_loss) over one region, differentiable in
    ``logits`` (chap_tpu's fused_masked_dice_ce)."""
    return region_dice_ce(logits, labels, mask, None, smooth_dice, eps_ce)
