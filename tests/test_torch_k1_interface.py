"""K1's interface as its callers use it, on the CPU: the plain versions with
``mask=None`` (every pixel counts) and with uint8, int32 or int64 labels,
``dice_ce_supervised`` (which passes no mask) against chap_tpu's fused
dice + CE, the refusals of the card's wrappers, and a module that imports
with neither Triton nor nvcc. The CUDA kernels themselves run only on the
card; chip_smoke.py's phase 3 holds them against these plain versions at
the same label dtypes and with ``mask=None``."""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce_supervised
from chap_tpu_torch.losses import dice as port_dice
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.ops import fused_losses
from test_torch_bf16 import BF, hold_bf16, to_bf16

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARITY = 5e-4          # the fp32 parity bar (ROADMAP: chap_tpu within 5e-4)
LABEL_DTYPES = (torch.uint8, torch.int32, torch.int64)
SHAPES = ((2, 4, 12, 10), (1, 2, 6, 5, 4))   # 2D [B, C, H, W], 3D [B, C, X, Y, Z]


def inputs(shape, seed, label_values=None):
    """Logits [B, C, *spatial] and two int32 label maps with values in
    [0, label_values) (default C; larger ones lie outside [0, C)), and a
    {0, 1} float32 mask, from a numpy seed."""
    rs = np.random.RandomState(seed)
    b, c, *spatial = shape
    hi = label_values or c
    logits = (rs.randn(*shape) * 2).astype(np.float32)
    lab = rs.randint(0, hi, (b, *spatial)).astype(np.int32)
    lab2 = rs.randint(0, hi, (b, *spatial)).astype(np.int32)
    mask = (rs.rand(b, *spatial) < 0.6).astype(np.float32)
    return (torch.from_numpy(logits), torch.from_numpy(lab), torch.from_numpy(lab2),
            torch.from_numpy(mask))


def grad_of(logits, labels, mask, labels2=None, coef=(0.7, 1.3, 0.4, 1.1)):
    """(losses, d/dlogits of sum_i coef_i loss_i) through region_dice_ce."""
    x = logits.clone().requires_grad_(True)
    vals = fused_losses.region_dice_ce(x, labels, mask, labels2)
    sum(k * v for k, v in zip(coef, vals)).backward()
    return torch.stack([v.detach() for v in vals]), x.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_without_mask_equals_all_ones_mask(shape, dtype):
    """mask=None counts every pixel: the statistics, the losses, the
    analytic backward and autograd's gradient equal those of an all-ones
    float32 mask, bit for bit."""
    logits, lab, _, _ = inputs(shape, 1, label_values=shape[1] + 2)
    logits = logits.to(dtype)
    ones = torch.ones(lab.shape)
    s_none = fused_losses.region_stats_plain(logits, lab, None)
    s_ones = fused_losses.region_stats_plain(logits, lab, ones)
    assert torch.equal(s_none, s_ones)
    for a, b in zip(fused_losses.masked_seg_stats_plain(logits, lab, None),
                    fused_losses.masked_seg_stats_plain(logits, lab, ones)):
        assert torch.equal(a, b)
    g = torch.tensor([[0.6, 0.9]])
    assert torch.equal(
        fused_losses.stats_grad_plain(logits, lab, None, s_none, g, 1e-5, 1e-16),
        fused_losses.stats_grad_plain(logits, lab, ones, s_ones, g, 1e-5, 1e-16))
    (v_none, g_none), (v_ones, g_ones) = grad_of(logits, lab, None), grad_of(logits, lab, ones)
    assert torch.equal(v_none, v_ones) and torch.equal(g_none, g_ones)
    assert g_none.dtype == dtype


@pytest.mark.parametrize("regions", [1, 2])
@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int64])
@pytest.mark.parametrize("shape", SHAPES)
def test_label_dtypes_give_the_same_stats_and_gradient(shape, label_dtype, regions):
    """uint8 and int64 labels give the int32 labels' statistics, losses,
    analytic backward and gradient exactly, labels outside [0, C) (C and C
    + 1) included, with a mask and (one region) without."""
    logits, lab, lab2, mask = inputs(shape, 2, label_values=shape[1] + 2)
    for m in ((mask,) if regions == 2 else (mask, None)):
        l2 = lab2 if regions == 2 else None
        want_s = fused_losses.region_stats_plain(logits, lab, m, l2)
        want = grad_of(logits, lab, m, l2)
        o1, o2 = lab.to(label_dtype), None if l2 is None else l2.to(label_dtype)
        got_s = fused_losses.region_stats_plain(logits, o1, m, o2)
        got = grad_of(logits, o1, m, o2)
        assert torch.equal(got_s, want_s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        g = torch.tensor([[0.6, 0.9], [0.3, 1.2]])[:regions]
        assert torch.equal(
            fused_losses.stats_grad_plain(logits, o1, m, got_s, g, 1e-10, 1e-16, o2),
            fused_losses.stats_grad_plain(logits, lab, m, want_s, g, 1e-10, 1e-16, l2))


def _jax_supervised(logits, labels, dtype):
    """chap_tpu's dice_ce_supervised through its fused K1 (an all-ones mask)
    on channel-last logits in ``dtype``: (loss, d loss / d logits) as float64
    numpy, the gradient back in the port's [B, C, *spatial] layout."""
    c = logits.shape[1]
    x = jnp.asarray(np.moveaxis(logits.numpy(), 1, -1), dtype)

    def f(lg):
        return jax_dice_ce_supervised(lg, jnp.asarray(labels.numpy()), c, fused=True)

    loss, grad = jax.value_and_grad(f)(x)
    return (np.float64(loss), np.moveaxis(np.asarray(grad.astype(jnp.float32),
                                                     np.float64), -1, 1))


def _port_supervised(logits, labels):
    x = logits.clone().requires_grad_(True)
    loss = dice_ce_supervised(x, labels, logits.shape[1])
    loss.backward()
    return loss.detach().double().numpy(), x.grad


@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("shape", SHAPES)
def test_dice_ce_supervised_without_mask_matches_chap_tpu(shape, label_dtype):
    """dice_ce_supervised (no mask) against chap_tpu's fused dice + CE with
    its all-ones mask, fp32: the loss within 5e-4 and the gradient within
    5e-4 of its largest entry."""
    logits, lab, _, _ = inputs(shape, 3)
    want_loss, want_grad = _jax_supervised(logits, lab.to(torch.int32), jnp.float32)
    loss, grad = _port_supervised(logits, lab.to(label_dtype))
    np.testing.assert_allclose(loss, want_loss, rtol=PARITY, atol=PARITY)
    err = np.abs(grad.double().numpy() - want_grad).max()
    assert err <= PARITY * np.abs(want_grad).max(), err


@pytest.mark.parametrize("shape", SHAPES)
def test_dice_ce_supervised_without_mask_matches_chap_tpu_in_bf16(shape):
    """The same at bf16 logits, by the bars of tests/test_torch_bf16.py
    (its hold_bf16: within twice chap_tpu's own bf16-vs-float32 gap of
    chap_tpu's bf16 and float32, and off the port's float32): the loss
    (float32 in both, so its gap is the float32 one) and the bf16
    gradient."""
    logits, lab, _, _ = inputs(shape, 4)
    logits = torch.from_numpy(to_bf16(logits.numpy()))      # exact in bf16
    lab8 = lab.to(torch.uint8)
    ref_bf = _jax_supervised(logits, lab, BF)
    ref_32 = _jax_supervised(logits, lab, jnp.float32)
    port_bf = _port_supervised(logits.to(torch.bfloat16), lab8)
    port_32 = _port_supervised(logits, lab8)
    assert port_bf[1].dtype == torch.bfloat16
    hold_bf16("loss", port_bf[0], ref_bf[0], ref_32[0], port_32[0])
    hold_bf16("gradient", port_bf[1], ref_bf[1], ref_32[1], port_32[1], atol=1e-9)


def test_dice_ce_supervised_passes_no_mask(monkeypatch):
    """The supervised arm hands K1 no mask: no all-ones map is made."""
    seen = []

    def spy(logits, labels, mask, **kw):
        seen.append(mask)
        return fused_losses.fused_masked_dice_ce(logits, labels, mask, **kw)

    monkeypatch.setattr(port_dice, "fused_masked_dice_ce", spy)
    logits, lab, _, _ = inputs(SHAPES[0], 5)
    dice_ce_supervised(logits, lab.to(torch.uint8), SHAPES[0][1])
    assert seen == [None]


def test_mask_none_with_two_regions_is_refused():
    """Region 2 is weighed by 1 - mask, so mask=None takes one region only:
    the plain versions and the card's wrappers refuse it."""
    logits, lab, lab2, _ = inputs(SHAPES[0], 6)
    with pytest.raises(ValueError, match="one region"):
        fused_losses.region_stats_plain(logits, lab, None, lab2)
    with pytest.raises(ValueError, match="one region"):
        fused_losses.region_dice_ce(logits, lab, None, lab2)
    with pytest.raises(ValueError, match="one region"):
        fused_losses.stats_kernel(logits, lab, None, lab2)


@pytest.mark.parametrize("case", ["uint8_no_mask", "int64_mask", "int32_two_regions",
                                  "int16_labels", "int32_mask"])
def test_wrappers_refuse_cpu_tensors_without_launching(monkeypatch, case):
    """A CPU tensor, or a label or mask dtype K1 does not read, is refused by
    both wrappers before any library is loaded or launch counted."""
    def no_library():
        raise AssertionError("the CUDA library was asked for")

    monkeypatch.setattr(fused_losses, "_library", no_library)
    logits, lab, lab2, mask = inputs(SHAPES[0], 7)
    args = {"uint8_no_mask": (lab.to(torch.uint8), None, None),
            "int64_mask": (lab.long(), mask, None),
            "int32_two_regions": (lab, mask, lab2),
            "int16_labels": (lab.to(torch.int16), mask, None),
            "int32_mask": (lab, mask.int(), None)}[case]
    r = 1 if args[2] is None else 2
    before = (fused_losses.stats_kernel.launches, fused_losses.stats_grad_kernel.launches)
    with pytest.raises(ValueError):
        fused_losses.stats_kernel(logits, *args[:2], args[2])
    with pytest.raises(ValueError):
        fused_losses.stats_grad_kernel(logits, *args[:2], torch.zeros(r, 4, 4),
                                       [None] * (2 * r), args[2])
    assert (fused_losses.stats_kernel.launches,
            fused_losses.stats_grad_kernel.launches) == before


def test_module_imports_with_neither_triton_nor_nvcc(tmp_path):
    """chap_tpu_torch.ops.fused_losses and the losses above it import, and
    their CPU route runs, in a process where importing triton fails and no
    nvcc can be found; nothing imports triton on the way."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "from chap_tpu_torch.ops import fused_losses\n"
        "from chap_tpu_torch.losses.dice import dice_ce_supervised\n"
        "from chap_tpu_torch.losses.mix import mix_loss\n"
        "x = torch.randn(2, 4, 8, 8, requires_grad=True)\n"
        "lab = torch.randint(0, 4, (2, 8, 8), dtype=torch.uint8)\n"
        "dice_ce_supervised(x, lab, 4).backward()\n"
        "mix_loss(x, lab.int(), lab.int(), torch.ones(2, 8, 8), 4)[2].backward()\n"
        "assert sys.modules['triton'] is None\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_no_module_of_the_port_imports_triton():
    """Every kernel of the port is CUDA C++ under csrc/: no module of
    chap_tpu_torch imports triton, at its top or inside a function."""
    found = []
    for path in sorted((ROOT / "chap_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names
                      if n.split(".")[0] == "triton"]
    assert not found, found
