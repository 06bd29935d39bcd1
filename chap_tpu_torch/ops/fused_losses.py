"""K1: fused masked dice + cross-entropy statistics, as Triton kernels.

Replaces chap_tpu/ops/fused_losses.py::masked_seg_stats -> _stats_kernel
(the Pallas kernel, :36-72 and :99-133) and the XLA custom-VJP backward
``_bwd`` (:159-179).

What it computes, for logits [B, C, H, W], integer labels [B, H, W] and a
{0,1} mask [B, H, W], with p = softmax over C and t = one_hot(label):
    I_c = sum m p_c t_c,  Z_c = sum m p_c^2,  Y_c = sum m t_c,
    CE  = sum m (-log p_label),  and the mask sum = sum_c Y_c
(only masked pixels whose label is in [0, C) count, as in chap_tpu), then
dice = mean_c 1 - (2 I_c + s) / (Z_c + Y_c + s) and ce = CE / (sum Y + eps).

What bounds it on the H100: bytes. One call at the main path's shape
[6, 4, 256, 256] reads 6.3 MB of fp32 logits, 1.6 MB of int32 labels and
1.6 MB of fp32 mask and does ~60 flops a pixel: 9.4 MB / 3.35 TB/s = 2.8 us,
against well under a microsecond of arithmetic. So the design reads each
input once and keeps every intermediate in registers:
  * the forward reads NCHW logits in place, class stride H*W, as [C_PAD,
    BLOCK] tiles (the Pallas kernel's class-major [C, N] layout is what NCHW
    already is, so there is no transpose copy); each program reduces a
    strided range of pixels into fp32 partials [P, 4, C_PAD]; a second
    one-program pass sums the partials in a fixed order, so two calls give
    bit-identical results (no atomics);
  * the backward is one elementwise pass: p is recomputed, the dice and CE
    chain rule of chap_tpu's _bwd is applied, and the C-wide inner sum is
    done per pixel in registers. The per-class coefficients stay on the
    device, so neither direction synchronises with the host.

Beside the kernels: ``masked_seg_stats_plain``, the plain PyTorch version,
used for CPU tensors only and by chip_smoke.py as the kernels' reference. A
CUDA tensor launches the kernels or raises. ``stats_kernel.launches`` and
``stats_grad_kernel.launches`` count launches.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

BLOCK = 512          # pixels per tile
MAX_PROGRAMS = 1024  # forward programs; more pixels loop inside a program

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def masked_seg_stats_plain(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor) -> Stats:
    """Plain PyTorch version of K1's forward: (I[C], Z[C], Y[C], ce_sum,
    mask_sum) for logits [B, C, H, W] (chap_tpu's _masked_seg_stats_xla)."""
    c = logits.shape[1]
    x = logits.float()
    p = torch.softmax(x, dim=1)
    logp = torch.log_softmax(x, dim=1)
    cls = torch.arange(c, device=logits.device).view(1, c, 1, 1)
    t = (labels.unsqueeze(1) == cls).float()
    m = mask.float().unsqueeze(1)
    dims = (0, 2, 3)
    inter = (p * t * m).sum(dims)
    z = (p * p * m).sum(dims)
    y = (t * m).sum(dims)
    ce_sum = (-logp * t * m).sum()
    return inter, z, y, ce_sum, y.sum()


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
    def stats_partials(logits_ptr, labels_ptr, mask_ptr, part_ptr, n_pix, hw,
                       C: tl.constexpr, C_PAD: tl.constexpr,
                       BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        nprog = tl.num_programs(0)
        cls = tl.arange(0, C_PAD)
        acc_i = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        acc_z = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        acc_y = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        acc_ce = tl.zeros([C_PAD, BLOCK], dtype=tl.float32)
        for start in range(pid * BLOCK, n_pix, nprog * BLOCK):
            offs = start + tl.arange(0, BLOCK)
            ok = offs < n_pix
            p, logp, _, _ = _load_probs(logits_ptr, offs, ok, hw, C, C_PAD)
            lab = tl.load(labels_ptr + offs, mask=ok, other=-1)
            m = tl.load(mask_ptr + offs, mask=ok, other=0.0)
            t = cls[:, None] == lab[None, :]
            tm = tl.where(t, m[None, :], 0.0)
            acc_i += p * tm
            acc_z += p * p * m[None, :]
            acc_y += tm
            acc_ce += tl.where(t, -logp * m[None, :], 0.0)
        out = part_ptr + pid * (4 * C_PAD) + cls
        tl.store(out, tl.sum(acc_i, axis=1))
        tl.store(out + C_PAD, tl.sum(acc_z, axis=1))
        tl.store(out + 2 * C_PAD, tl.sum(acc_y, axis=1))
        tl.store(out + 3 * C_PAD, tl.sum(acc_ce, axis=1))

    @triton.jit
    def stats_finalize(part_ptr, out_ptr, n_part, W: tl.constexpr,
                       P_PAD: tl.constexpr):
        rows = tl.arange(0, P_PAD)
        cols = tl.arange(0, W)
        v = tl.load(part_ptr + rows[:, None] * W + cols[None, :],
                    mask=rows[:, None] < n_part, other=0.0)
        tl.store(out_ptr + cols, tl.sum(v, axis=0))

    @triton.jit
    def stats_grad(logits_ptr, labels_ptr, mask_ptr, coef_ptr, grad_ptr,
                   n_pix, hw, C: tl.constexpr, C_PAD: tl.constexpr,
                   BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cls = tl.arange(0, C_PAD)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        ok = offs < n_pix
        p, _, off, ld = _load_probs(logits_ptr, offs, ok, hw, C, C_PAD)
        lab = tl.load(labels_ptr + offs, mask=ok, other=-1)
        m = tl.load(mask_ptr + offs, mask=ok, other=0.0)[None, :]
        t = tl.where(cls[:, None] == lab[None, :], 1.0, 0.0)
        dl_di = tl.load(coef_ptr + cls)[:, None]
        dl_dz = tl.load(coef_ptr + C_PAD + cls)[:, None]
        g_dice = tl.load(coef_ptr + 2 * C_PAD)
        g_ce = tl.load(coef_ptr + 2 * C_PAD + 1)   # g_ce / (mask_sum + eps)
        dl_dp = m * (dl_di * t + dl_dz * 2.0 * p)
        inner = tl.sum(dl_dp * p, axis=0)
        d_dice = p * (dl_dp - inner[None, :])
        d_ce = m * (p - t)
        g = g_dice * d_dice + g_ce * d_ce
        tl.store(grad_ptr + off, g.to(grad_ptr.dtype.element_ty), mask=ld)

    return stats_partials, stats_finalize, stats_grad


def _prepare(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Check what the kernels take: NCHW float logits on the card, labels and
    mask [B, H, W]. Labels become int32 and the mask fp32 (no-ops when they
    already are)."""
    if not logits.is_cuda:
        raise ValueError("K1 kernels take CUDA tensors only")
    if logits.dim() != 4 or logits.dtype not in (torch.float32, torch.bfloat16,
                                                 torch.float16):
        raise ValueError(f"logits must be float [B, C, H, W], got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    b, _, h, w = logits.shape
    if tuple(labels.shape) != (b, h, w) or tuple(mask.shape) != (b, h, w):
        raise ValueError(f"labels {tuple(labels.shape)} / mask "
                         f"{tuple(mask.shape)} must be {(b, h, w)}")
    if labels.dtype.is_floating_point:
        raise ValueError("labels must be an integer map")
    return (logits.contiguous(), labels.to(torch.int32).contiguous(),
            mask.to(torch.float32).contiguous())


def stats_kernel(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """K1 forward on the card: [4, C] fp32 rows (I, Z, Y, CE per class)."""
    logits, labels, mask = _prepare(logits, labels, mask)
    partials_k, finalize_k, _ = _kernels()
    b, c, h, w = logits.shape
    n_pix = b * h * w
    c_pad = _next_pow2(c)
    n_part = max(1, min(-(-n_pix // BLOCK), MAX_PROGRAMS))
    part = torch.empty((n_part, 4 * c_pad), device=logits.device,
                       dtype=torch.float32)
    out = torch.empty((4 * c_pad,), device=logits.device, dtype=torch.float32)
    partials_k[(n_part,)](logits, labels, mask, part, n_pix, h * w,
                          C=c, C_PAD=c_pad, BLOCK=BLOCK, num_warps=4)
    finalize_k[(1,)](part, out, n_part, W=4 * c_pad,
                     P_PAD=_next_pow2(n_part), num_warps=4)
    stats_kernel.launches += 1
    return out.view(4, c_pad)[:, :c]


stats_kernel.launches = 0


def stats_grad_kernel(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """K1 backward on the card: d loss / d logits, same shape and dtype as
    logits. coef: fp32 [2 C_PAD + 2] = (dL/dI_c, dL/dZ_c, g_dice,
    g_ce / (mask_sum + eps)), on the device."""
    logits, labels, mask = _prepare(logits, labels, mask)
    _, _, grad_k = _kernels()
    b, c, h, w = logits.shape
    n_pix = b * h * w
    c_pad = _next_pow2(c)
    if coef.shape != (2 * c_pad + 2,) or coef.dtype != torch.float32:
        raise ValueError(f"coef must be fp32 [{2 * c_pad + 2}]")
    grad = torch.empty_like(logits)
    grad_k[(-(-n_pix // BLOCK),)](logits, labels, mask, coef.contiguous(),
                                  grad, n_pix, h * w, C=c, C_PAD=c_pad,
                                  BLOCK=BLOCK, num_warps=4)
    stats_grad_kernel.launches += 1
    return grad


stats_grad_kernel.launches = 0


def _compose(inter, z, y, ce_sum, m_sum, smooth_dice: float, eps_ce: float):
    dice = torch.mean(1.0 - (2.0 * inter + smooth_dice) / (z + y + smooth_dice))
    ce = ce_sum / (m_sum + eps_ce)
    return dice, ce


class _FusedDiceCE(torch.autograd.Function):
    """K1 forward and backward on the card (chap_tpu's custom_vjp pair)."""

    @staticmethod
    def forward(ctx, logits, labels, mask, smooth_dice, eps_ce):
        stats = stats_kernel(logits, labels, mask)
        inter, z, y, ce_c = stats
        m_sum = y.sum()
        ctx.save_for_backward(logits, labels, mask, inter, z, y, m_sum)
        ctx.smooth_dice, ctx.eps_ce = smooth_dice, eps_ce
        return _compose(inter, z, y, ce_c.sum(), m_sum, smooth_dice, eps_ce)

    @staticmethod
    def backward(ctx, g_dice, g_ce):
        logits, labels, mask, inter, z, y, m_sum = ctx.saved_tensors
        c = inter.shape[0]
        c_pad = _next_pow2(c)
        s = ctx.smooth_dice
        denom = z + y + s
        coef = torch.zeros(2 * c_pad + 2, device=logits.device,
                           dtype=torch.float32)
        coef[:c] = -2.0 / denom / c
        coef[c_pad:c_pad + c] = (2.0 * inter + s) / denom ** 2 / c
        coef[2 * c_pad] = g_dice
        coef[2 * c_pad + 1] = g_ce / (m_sum + ctx.eps_ce)
        return stats_grad_kernel(logits, labels, mask, coef), None, None, None, None


def masked_seg_stats(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> Stats:
    """(I[C], Z[C], Y[C], ce_sum, mask_sum) for logits [B, C, H, W]: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if logits.device.type == "cpu":
        return masked_seg_stats_plain(logits, labels, mask)
    inter, z, y, ce_c = stats_kernel(logits, labels, mask)
    return inter, z, y, ce_c.sum(), y.sum()


def fused_masked_dice_ce(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, smooth_dice: float = 1e-10,
                         eps_ce: float = 1e-16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_dice_loss, masked_ce_loss), differentiable in ``logits``.
    CUDA: K1's Triton forward and backward. CPU: the plain version under
    autograd (the same function, so the same gradient)."""
    if logits.device.type == "cpu":
        return _compose(*masked_seg_stats_plain(logits, labels, mask),
                        smooth_dice, eps_ce)
    labels = labels.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return _FusedDiceCE.apply(logits.contiguous(), labels, mask,
                              float(smooth_dice), float(eps_ce))
