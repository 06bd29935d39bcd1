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
from chap_tpu.ops.fused_losses import (_masked_seg_stats_xla,
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
