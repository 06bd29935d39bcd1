"""K1's plain version and the port's losses, held against chap_tpu on the
same numpy-seeded inputs (CPU). K1's Triton kernels themselves run only on
the card; chip_smoke.py holds them against this plain version there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
from chap_tpu.losses.mix import mix_loss as jax_mix_loss
from chap_tpu.losses.vat import vat_loss_2d as jax_vat_loss_2d
from chap_tpu.models.unet2d import DualDecoder as JaxDualDecoder
from chap_tpu.ops.fused_losses import (_compose as jax_compose,
                                       _masked_seg_stats_xla,
                                       fused_masked_dice_ce as jax_fused,
                                       masked_seg_stats as jax_masked_seg_stats)
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.losses.mix import mix_loss
from chap_tpu_torch.losses.vat import vat_loss_2d
from chap_tpu_torch.models.unet2d import DualDecoder
from chap_tpu_torch.ops import fused_losses
from test_torch_models import JaxFeed, RandomFeed

torch.set_num_threads(1)

RTOL = 2e-3   # losses and gradients (tests/test_pallas_ops.py:59)


def make_inputs(seed=0, b=2, h=64, w=64, c=4, out_of_range=False):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(b, h, w, c) * 2).astype(np.float32)
    labels = rs.randint(0, c, (b, h, w)).astype(np.int32)
    if out_of_range:   # ignored labels count in neither Y nor the mask sum
        labels[rs.rand(b, h, w) < 0.1] = 255
    mask = (rs.rand(b, h, w) < 0.6).astype(np.float32)
    return logits, labels, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return _t(np.transpose(x, (0, 3, 1, 2)))


def _close(a, b, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape,out_of_range", [((2, 64, 64), False),
                                                ((1, 23, 29), False),
                                                ((2, 32, 32), True)])
def test_k1_plain_matches_xla_stats(shape, out_of_range):
    logits, labels, mask = make_inputs(1, *shape, out_of_range=out_of_range)
    want = _masked_seg_stats_xla(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(mask))
    got = fused_losses.masked_seg_stats(_nchw(logits), _t(labels), _t(mask))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_k1_plain_matches_pallas_interpret_ragged():
    logits, labels, mask = make_inputs(2, 1, 23, 29)
    want = jax_masked_seg_stats(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask), interpret=True)
    got = fused_losses.masked_seg_stats_plain(_nchw(logits), _t(labels), _t(mask))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("weights", [(1.0, 0.7), (0.5, 0.0), (0.0, 1.3)])
def test_k1_loss_and_gradient_match_custom_vjp(weights):
    logits, labels, mask = make_inputs(3, 1, 32, 32)
    wd, wc = weights

    def f(lg):
        d, c = jax_fused(lg, jnp.asarray(labels), jnp.asarray(mask))
        return wd * d + wc * c

    want_loss, want_grad = jax.value_and_grad(f)(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    d, c = fused_losses.fused_masked_dice_ce(x, _t(labels), _t(mask))
    loss = wd * d + wc * c
    loss.backward()
    _close(loss.item(), want_loss)
    _close(x.grad.numpy(), np.transpose(np.asarray(want_grad), (0, 3, 1, 2)),
           atol=1e-7)


def test_k1_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on the card or raise; the CPU path is the
    dispatcher's choice, never a fallback inside a wrapper."""
    logits, labels, mask = make_inputs(4, 1, 8, 8)
    with pytest.raises(ValueError):
        fused_losses.stats_kernel(_nchw(logits), _t(labels), _t(mask))
    assert fused_losses.stats_kernel.launches == 0


@pytest.mark.parametrize("unlab", [False, True])
def test_mix_loss_matches_chap_tpu(unlab):
    rs = np.random.RandomState(5)
    logits = rs.randn(3, 24, 24, 4).astype(np.float32)
    img_l = rs.randint(0, 4, (3, 24, 24)).astype(np.int32)
    patch_l = rs.randint(0, 4, (3, 24, 24)).astype(np.int32)
    mask = np.ones((3, 24, 24), np.int32)
    mask[:, 4:20, 6:22] = 0
    want = jax_mix_loss(jnp.asarray(logits), jnp.asarray(img_l), jnp.asarray(patch_l),
                        jnp.asarray(mask), 4, unlab=unlab)
    got = mix_loss(_nchw(logits), _t(img_l), _t(patch_l), _t(mask), 4, unlab=unlab)
    for g, w in zip(got, want):
        _close(g.item(), w)


def test_ce_primitives_match_chap_tpu():
    import chap_tpu.losses.ce as jax_ce
    from chap_tpu_torch.losses import ce
    logits, labels, mask = make_inputs(8, 2, 16, 16)
    rs = np.random.RandomState(9)
    p = rs.dirichlet(np.ones(4), (2, 16, 16)).astype(np.float32)
    p[0, 0, 0] = (1.0, 0.0, 0.0, 0.0)          # 0 log 0 = 0
    jl, jy, jm = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)
    x, y, m = _nchw(logits), _t(labels), _t(mask)
    _close(ce.cross_entropy_per_pixel(x, y).numpy(), jax_ce.cross_entropy_per_pixel(jl, jy),
           rtol=1e-5)
    _close(ce.cross_entropy(x, y).item(), jax_ce.cross_entropy(jl, jy), rtol=1e-5)
    _close(ce.masked_cross_entropy(x, y, m).item(), jax_ce.masked_cross_entropy(jl, jy, jm),
           rtol=1e-5)
    _close(ce.mse_loss(x, x.flip(0)).item(), jax_ce.mse_loss(jl, jl[::-1]), rtol=1e-5)
    _close(ce.mse_loss_noreduction(x, x.flip(0)).numpy(),
           np.transpose(np.asarray(jax_ce.mse_loss_noreduction(jl, jl[::-1])), (0, 3, 1, 2)),
           rtol=1e-5)
    log_q = jax.nn.log_softmax(jl, -1)
    _close(ce.kl_div_per_pixel(torch.log_softmax(x, 1), _nchw(p)).numpy(),
           jax_ce.kl_div_per_pixel(log_q, jnp.asarray(p)), rtol=1e-5)


def test_dice_losses_match_chap_tpu():
    import chap_tpu.losses.dice as jax_dice
    from chap_tpu_torch.losses import dice
    logits, labels, mask = make_inputs(10, 2, 16, 16)
    jprobs = jax.nn.softmax(jnp.asarray(logits), -1)
    jother = jax.nn.softmax(jnp.asarray(logits[::-1].copy()), -1)
    probs, other = _nchw(np.asarray(jprobs)), _nchw(np.asarray(jother))
    np.testing.assert_array_equal(
        dice.one_hot(_t(labels), 4).numpy(),
        np.transpose(np.asarray(jax_dice.one_hot(jnp.asarray(labels), 4)), (0, 3, 1, 2)))
    _close(dice.dice_loss(probs, _t(labels), 4).item(),
           jax_dice.dice_loss(jprobs, jnp.asarray(labels), 4), rtol=1e-5)
    _close(dice.dice_loss_bcp(probs, _t(labels), _t(mask), 4).item(),
           jax_dice.dice_loss_bcp(jprobs, jnp.asarray(labels), jnp.asarray(mask), 4),
           rtol=1e-5)
    _close(dice.soft_dice_loss_masked(probs, other, _t(mask)).item(),
           jax_dice.soft_dice_loss_masked(jprobs, jother, jnp.asarray(mask)), rtol=1e-5)


def test_dice_ce_supervised_matches_chap_tpu():
    from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce
    logits, labels, _ = make_inputs(6, 2, 16, 16)
    want = jax_dice_ce(jnp.asarray(logits), jnp.asarray(labels), 4, fused=False)
    _close(dice_ce_supervised(_nchw(logits), _t(labels), 4).item(), want)


@pytest.mark.parametrize("losstype", ["kl", "dice"])
def test_vat_loss_matches_chap_tpu(monkeypatch, losstype):
    """VAT through the DualDecoder (eval mode, same weights), with the
    initial direction's uniform draw fed to both."""
    chns = (4, 8, 8, 16, 16)
    jmodel = JaxDualDecoder(num_classes=4, decoder_type="mcnet", feature_chns=chns)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16, 16, 1))))
    model = DualDecoder(1, 4, "mcnet", chns).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]))
    rs = np.random.RandomState(7)
    x = rs.rand(2, 16, 16, 1).astype(np.float32)
    soft1 = jax.nn.softmax(jnp.asarray(rs.randn(2, 16, 16, 4).astype(np.float32)), -1)
    soft2 = jax.nn.softmax(jnp.asarray(rs.randn(2, 16, 16, 4).astype(np.float32)), -1)
    mask = (rs.rand(2, 16, 16) < 0.3).astype(np.float32)
    u = rs.rand(2, 16, 16, 1).astype(np.float32)
    monkeypatch.setattr(jax_vat, "jax", JaxFeed(RandomFeed([u])))
    want = jax_vat_loss_2d(lambda xx: jmodel.apply(variables, xx, train=False),
                           jnp.asarray(x), soft1, soft2, jnp.asarray(mask),
                           jax.random.PRNGKey(0), losstype=losstype)
    got = vat_loss_2d(lambda xx: model(xx), _nchw(x),
                      _nchw(np.asarray(soft1)), _nchw(np.asarray(soft2)), _t(mask),
                      d0=_nchw(u), losstype=losstype)
    _close(got.item(), want)


# ---------------------------------------------------------------------------
# K1 over two regions (mix_loss's single call)
# ---------------------------------------------------------------------------

def make_mix_inputs(seed, b, h, w, c=4, label_values=None):
    """label_values > c draws labels outside [0, c) too."""
    rs = np.random.RandomState(seed)
    logits = (rs.randn(b, h, w, c) * 2).astype(np.float32)
    img_l = rs.randint(0, label_values or c, (b, h, w)).astype(np.int32)
    patch_l = rs.randint(0, label_values or c, (b, h, w)).astype(np.int32)
    mask = (rs.rand(b, h, w) < 0.5).astype(np.float32)
    return logits, img_l, patch_l, mask


# (g_dice_1, g_ce_1, g_dice_2, g_ce_2); zeros as grads_l / grads_u give them
MIX_WEIGHTS = [(1.0, 1.0, 1.0, 1.0), (0.0, 0.0, 0.5, 1.3), (0.7, 1.0, 0.0, 0.0)]


@pytest.mark.parametrize("weights", MIX_WEIGHTS)
@pytest.mark.parametrize("shape", [(1, 23, 29), (2, 32, 32)])
def test_k1_two_regions_plain_matches_chap_tpu(shape, weights):
    """region_dice_ce(R = 2) against two chap_tpu fused_masked_dice_ce calls
    on mask and 1 - mask: the four losses and d/dlogits."""
    logits, img_l, patch_l, mask = make_mix_inputs(20, *shape)
    w = jnp.asarray(weights)

    def f(lg):
        d1, c1 = jax_fused(lg, jnp.asarray(img_l), jnp.asarray(mask))
        d2, c2 = jax_fused(lg, jnp.asarray(patch_l), 1.0 - jnp.asarray(mask))
        vals = jnp.stack([d1, c1, d2, c2])
        return jnp.sum(w * vals), vals

    (_, want_vals), want_grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    vals = fused_losses.region_dice_ce(x, _t(img_l), _t(mask), _t(patch_l))
    sum(wi * v for wi, v in zip(weights, vals)).backward()
    _close([v.item() for v in vals], want_vals)
    _close(x.grad.numpy(), np.transpose(np.asarray(want_grad), (0, 3, 1, 2)),
           atol=1e-7)


@pytest.mark.parametrize("unlab", [False, True])
def test_mix_loss_ragged_loss_and_gradient_match_chap_tpu(unlab):
    logits, img_l, patch_l, mask = make_mix_inputs(21, 1, 23, 29)
    mask = mask.astype(np.int32)

    def f(lg):
        out = jax_mix_loss(lg, jnp.asarray(img_l), jnp.asarray(patch_l),
                           jnp.asarray(mask), 4, unlab=unlab, fused=True)
        return out[2], out

    (_, want), want_grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    got = mix_loss(x, _t(img_l), _t(patch_l), _t(mask), 4, unlab=unlab)
    got[2].backward()
    for g, w in zip(got, want):
        _close(g.item(), w)
    _close(x.grad.numpy(), np.transpose(np.asarray(want_grad), (0, 3, 1, 2)),
           atol=1e-7)


def _padded(stats, c_pad):
    """Statistics [R, 4, C] laid out as the kernel saves them, [R, 4, C_PAD]."""
    out = torch.zeros(stats.shape[0], 4, c_pad)
    out[:, :, :stats.shape[2]] = stats
    return out


@pytest.mark.parametrize("weights", MIX_WEIGHTS[:2] + [(0.7, 1.0)])
@pytest.mark.parametrize("c,label_values", [(3, None), (4, None), (3, 5)])
def test_k1_analytic_gradient_matches_autograd(c, label_values, weights):
    """stats_grad_plain, the arithmetic K1's backward kernel does, against
    torch autograd of the plain statistics, for R = 1 and R = 2, also with
    labels outside [0, C) (3 and 4 for C = 3, one of them a padded class
    index of the kernel)."""
    logits, img_l, patch_l, mask = make_mix_inputs(22, 2, 17, 19, c,
                                                   label_values)
    r = len(weights) // 2
    lab2 = _t(patch_l) if r == 2 else None
    grads = torch.tensor(weights, dtype=torch.float32).view(r, 2)
    x = _nchw(logits).requires_grad_(True)
    stats = fused_losses.region_stats_plain(x, _t(img_l), _t(mask), lab2)
    (grads * fused_losses.compose_plain(stats, 1e-10, 1e-16)).sum().backward()
    got = fused_losses.stats_grad_plain(x.detach(), _t(img_l), _t(mask),
                                        _padded(stats.detach(), 4), grads,
                                        1e-10, 1e-16, lab2)
    _close(got.numpy(), x.grad.numpy(), atol=1e-7)


def test_k1_two_region_wrappers_refuse_cpu_tensors():
    logits, img_l, patch_l, mask = make_mix_inputs(23, 1, 8, 8)
    x, l1, l2, m = _nchw(logits), _t(img_l), _t(patch_l), _t(mask)
    with pytest.raises(ValueError):
        fused_losses.stats_kernel(x, l1, m, l2)
    with pytest.raises(ValueError):
        fused_losses.stats_grad_kernel(x, l1, m, torch.zeros(2, 4, 4),
                                       [None] * 4, l2)
    assert fused_losses.stats_kernel.launches == 0
    assert fused_losses.stats_grad_kernel.launches == 0


@pytest.mark.parametrize("used", [(0, 1, 2, 3), (2, 3), (0,), (1,)])
def test_k1_autograd_function_wiring(monkeypatch, used):
    """The card's autograd Function, with its two kernel wrappers replaced by
    their plain versions so that it runs here: one backward for both
    regions, None grads (an unused region) read as zero."""
    logits, img_l, patch_l, mask = make_mix_inputs(24, 1, 12, 10)

    def fake_stats(lg, lab, m, lab2=None, smooth=1e-10, eps=1e-16):
        stats = fused_losses.region_stats_plain(lg, lab, m, lab2)
        return fused_losses.compose_plain(stats, smooth, eps), _padded(stats, 4)

    def fake_grad(lg, lab, m, stats, grads, lab2=None, smooth=1e-10, eps=1e-16):
        g = torch.stack([torch.zeros(()) if v is None else v for v in grads])
        return fused_losses.stats_grad_plain(lg, lab, m, stats, g.view(-1, 2),
                                             smooth, eps, lab2)

    monkeypatch.setattr(fused_losses, "stats_kernel", fake_stats)
    monkeypatch.setattr(fused_losses, "stats_grad_kernel", fake_grad)
    coef = (0.7, 1.1, 0.4, 1.3)
    x = _nchw(logits).requires_grad_(True)
    vals = fused_losses._RegionDiceCE.apply(x, _t(img_l), _t(mask), _t(patch_l),
                                            1e-10, 1e-16)
    sum(coef[i] * vals[i] for i in used).backward()
    xp = _nchw(logits).requires_grad_(True)
    want = fused_losses.region_dice_ce(xp, _t(img_l), _t(mask), _t(patch_l))
    sum(coef[i] * want[i] for i in used).backward()
    _close([v.item() for v in vals], [v.item() for v in want], rtol=1e-6)
    _close(x.grad.numpy(), xp.grad.numpy(), atol=1e-7)


@pytest.mark.parametrize("regions", [1, 2])
def test_k1_gradient_with_labels_outside_classes(regions):
    """With labels outside [0, C) the port's gradient is the gradient of
    chap_tpu's forward (jax.grad of its XLA twin); chap_tpu's custom VJP
    (_bwd) departs from it on exactly the masked pixels with such labels,
    a fault of the reference the port does not copy."""
    logits, img_l, patch_l, mask = make_mix_inputs(25, 2, 9, 11, 3, 5)
    jl, jm = jnp.asarray(logits), jnp.asarray(mask)
    regs = [(img_l, jm), (patch_l, 1.0 - jm)][:regions]

    def autodiff(lg):
        return sum(sum(jax_compose(_masked_seg_stats_xla(lg, jnp.asarray(lab), w),
                                   1e-10, 1e-16)) for lab, w in regs)

    def custom_vjp(lg):
        return sum(sum(jax_fused(lg, jnp.asarray(lab), w)) for lab, w in regs)

    want = np.transpose(np.asarray(jax.grad(autodiff)(jl)), (0, 3, 1, 2))
    x = _nchw(logits).requires_grad_(True)
    lab2 = _t(patch_l) if regions == 2 else None
    sum(fused_losses.region_dice_ce(x, _t(img_l), _t(mask), lab2)).backward()
    _close(x.grad.numpy(), want, atol=1e-7)
    vjp = np.transpose(np.asarray(jax.grad(custom_vjp)(jl)), (0, 3, 1, 2))
    differs = np.abs(vjp - want).max(1) > 1e-5
    outside = np.zeros_like(differs)
    for lab, w in regs:
        outside |= (lab >= 3) & (np.asarray(w) > 0)
    assert differs.any() and not (differs & ~outside).any()


# ---------------------------------------------------------------------------
# 5-D logits [B, C, X, Y, Z]: the 3D step's calls at small shapes
# ---------------------------------------------------------------------------

def _ncdhw(x):
    """chap_tpu's channel-last [B, X, Y, Z, C] -> the port's [B, C, X, Y, Z]."""
    return _t(np.moveaxis(x, -1, 1))


@pytest.mark.parametrize("regions,shape", [(1, (2, 9, 8, 6)), (2, (1, 9, 8, 6)),
                                           (2, (2, 7, 5, 3))])
def test_k1_plain_5d_matches_chap_tpu(regions, shape):
    """K1's plain version on 5-D logits, R = 1 (dice_ce_supervised on the
    labeled half) and R = 2 (the 3D mix_loss's single call), 2 classes: the
    losses and d/dlogits against chap_tpu's fused_masked_dice_ce on
    channel-last logits, rtol 2e-3."""
    rs = np.random.RandomState(30 + regions)
    logits = (rs.randn(*shape, 2) * 2).astype(np.float32)
    lab1 = rs.randint(0, 2, shape).astype(np.int32)
    lab2 = rs.randint(0, 2, shape).astype(np.int32)
    mask = (rs.rand(*shape) < 0.5).astype(np.float32)
    weights = (1.0, 0.7, 0.5, 1.3)[:2 * regions]
    regs = [(lab1, mask), (lab2, 1.0 - mask)][:regions]

    def f(lg):
        vals = jnp.stack([v for lab, w in regs
                          for v in jax_fused(lg, jnp.asarray(lab), jnp.asarray(w))])
        return jnp.sum(jnp.asarray(weights) * vals), vals

    (_, want_vals), want_grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    x = _ncdhw(logits).requires_grad_(True)
    vals = fused_losses.region_dice_ce(x, _t(lab1), _t(mask),
                                       _t(lab2) if regions == 2 else None)
    sum(w * v for w, v in zip(weights, vals)).backward()
    _close([v.item() for v in vals], want_vals)
    _close(x.grad.numpy(), np.moveaxis(np.asarray(want_grad), -1, 1), atol=1e-7)


def test_k1_wrapper_refuses_other_ranks():
    """The kernels take [B, C, *spatial] with 1-3 spatial axes; anything
    else is refused with the layout it needs, before any device check."""
    with pytest.raises(ValueError, match=r"\[B, C, X, Y, Z\]"):
        fused_losses.stats_kernel(torch.zeros(1, 2, 3, 3, 3, 3),
                                  torch.zeros(1, 3, 3, 3, 3, dtype=torch.int32),
                                  torch.zeros(1, 3, 3, 3, 3))
    with pytest.raises(ValueError, match="must be"):
        fused_losses.stats_kernel(torch.zeros(1, 2, 4, 4, 4),
                                  torch.zeros(1, 4, 4, dtype=torch.int32),
                                  torch.zeros(1, 4, 4))
    assert fused_losses.stats_kernel.launches == 0


@pytest.mark.parametrize("unlab", [False, True])
def test_mix_loss_and_dice_ce_5d_match_chap_tpu(unlab):
    """The 3D mix_loss (a cuboid BCP mask) and dice_ce_supervised on 5-D
    logits, rtol 2e-3."""
    from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce
    rs = np.random.RandomState(33)
    logits = rs.randn(2, 10, 9, 8, 2).astype(np.float32)
    img_l = rs.randint(0, 2, (2, 10, 9, 8)).astype(np.int32)
    patch_l = rs.randint(0, 2, (2, 10, 9, 8)).astype(np.int32)
    mask = np.ones((2, 10, 9, 8), np.int32)
    mask[:, 2:8, 1:7, 2:6] = 0
    want = jax_mix_loss(jnp.asarray(logits), jnp.asarray(img_l), jnp.asarray(patch_l),
                        jnp.asarray(mask), 2, unlab=unlab)
    got = mix_loss(_ncdhw(logits), _t(img_l), _t(patch_l), _t(mask), 2, unlab=unlab)
    for g, w in zip(got, want):
        _close(g.item(), w)
    want = jax_dice_ce(jnp.asarray(logits), jnp.asarray(img_l), 2, fused=False)
    _close(dice_ce_supervised(_ncdhw(logits), _t(img_l), 2).item(), want)


@pytest.mark.parametrize("losstype", ["kl", "dice"])
def test_vat_loss_5d_matches_chap_tpu(monkeypatch, losstype):
    """VAT on [B, 1, X, Y, Z] volumes through a small two-headed function
    (a tanh of the input and its neighbour along Y), the initial direction's
    uniform fed to both, rtol 2e-3."""
    rs = np.random.RandomState(34)
    x = rs.rand(2, 8, 6, 5, 1).astype(np.float32)
    soft1 = jax.nn.softmax(jnp.asarray(rs.randn(2, 8, 6, 5, 2).astype(np.float32)), -1)
    soft2 = jax.nn.softmax(jnp.asarray(rs.randn(2, 8, 6, 5, 2).astype(np.float32)), -1)
    mask = (rs.rand(2, 8, 6, 5) < 0.4).astype(np.float32)
    u = rs.rand(2, 8, 6, 5, 1).astype(np.float32)

    def jax_apply(xx):
        h = jnp.tanh(2.0 * xx + 0.3 * jnp.roll(xx, 1, axis=2))
        return (jnp.concatenate([h, 1.0 - h], -1),
                jnp.concatenate([0.5 * h, -h], -1))

    def port_apply(xx):
        h = torch.tanh(2.0 * xx + 0.3 * torch.roll(xx, 1, dims=3))
        return torch.cat([h, 1.0 - h], 1), torch.cat([0.5 * h, -h], 1)

    monkeypatch.setattr(jax_vat, "jax", JaxFeed(RandomFeed([u])))
    want = jax_vat_loss_2d(jax_apply, jnp.asarray(x), soft1, soft2, jnp.asarray(mask),
                           jax.random.PRNGKey(0), losstype=losstype)
    got = vat_loss_2d(port_apply, _ncdhw(x), _ncdhw(np.asarray(soft1)),
                      _ncdhw(np.asarray(soft2)), _t(mask), d0=_ncdhw(u),
                      losstype=losstype)
    _close(got.item(), want)
