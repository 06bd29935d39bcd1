"""bf16 compute (``model.dtype=bfloat16``) in the port against chap_tpu's bf16
compute, on the CPU: the shared layers, the 2D DualDecoder (and the
``acalnet`` key), K1's plain version at bf16 logits, the 2D CHAP and
supervised steps, the 2D eval, the data path, and the ablation and ACAL
trainers set up in bf16.

The bar, for each compared tensor, from the same numpy inputs, float32
weights and draws. ``e_ref`` is chap_tpu's own bf16 error, max |chap_tpu
bf16 - chap_tpu float32|, measured in each test on its inputs:
  1. the port's output has chap_tpu's dtype;
  2. max |port bf16 - chap_tpu bf16| <= 2 e_ref + 1e-6, and max |port bf16 -
     chap_tpu float32| <= 2 e_ref + 1e-6;
  3. max |port bf16 - port float32| >= 0.1 e_ref: a port that quietly
     computed in float32 would fail here;
  4. integer maps (pseudo-labels, label maps) agree with chap_tpu's bf16 maps
     on at least the share on which chap_tpu's bf16 and float32 maps agree,
     less 0.5 points.
The e_ref measured on these inputs stands beside each test.

A compared tensor is a whole output: a logits tensor, a label map, the
step's loss metrics together, the GradSim scores of all levels together,
the BatchNorm statistics of all layers together. A single scalar or a short
per-layer vector is one draw of a rounding error: on one input, chap_tpu's
bf16 loss_l was 6.9e-4 from its float32 under this suite's XLA options and
2.9e-3 at XLA's default optimisation, and over five inputs the port's gap
on one metric was 0.1-1.7x chap_tpu's, so 2 e_ref taken from a single draw
would be a coin toss, not a bar; so a step's metrics are held as one
vector over the step run on several batches (``BATCH_SEEDS``). Parameter
updates are held as tests/test_torch_step3d.py holds them (each leaf's
update against its norm, all leaves' together), its bars scaled by
chap_tpu's measured bf16 gap of the updates, and along chap_tpu's float32
step, which tells a missing or reversed update from a right one where bf16
noise is as large as the update (``hold_updates``).

chap_tpu's losses take K1 (``fused_masked_dice_ce``) on its TPU and its XLA
twin elsewhere only when asked: its mix and supervised losses on a CPU
default to a composition in the logits' dtype. bf16 means what it means on
chap_tpu's TPU, where K1 upcasts the logits to float32, so these tests run
chap_tpu's steps with ``fused=True`` (its float32 runs too, so e_ref
measures the dtype alone). chap_tpu's bf16 ``jax.random.uniform`` (the VAT
direction) can only give multiples of 2^-7; the tests draw such values and
feed them to both."""
import functools

import flax.linen as fnn
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chap_tpu.losses.mix as jax_mix
import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.train.step_chap as jax_step_chap
import chap_tpu.train.step_supervised as jax_step_supervised
from chap_tpu.config import Config as JaxConfig
from chap_tpu.eval.eval2d import make_predictor as jax_make_predictor
from chap_tpu.eval.eval2d import predict_volume as jax_predict_volume
from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce_supervised
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.models.attention3d import _resize_trilinear as jax_resize
from chap_tpu.models.layers import upsample2x_bilinear as jax_bilinear
from chap_tpu.models.layers import upsample2x_trilinear as jax_trilinear
from chap_tpu.models.voxresnet import _instance_norm as jax_instance_norm
from chap_tpu.ops.fused_losses import fused_masked_dice_ce as jax_fused
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
import chap_tpu_torch.train.step_chap as step_chap
from chap_tpu_torch.config import Config, ModelConfig
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.pipeline import compact_batch, prefetch_to_device
from chap_tpu_torch.eval.eval2d import make_predictor, predict_volume
from chap_tpu_torch.losses.vat import working_uniform
from chap_tpu_torch.models.factory import net_factory, net_factory_3d
from chap_tpu_torch.models.layers import (BatchNorm3d, Conv3d, GroupNorm,
                                          instance_norm, resize_linear,
                                          set_compute_dtype,
                                          upsample2x_bilinear,
                                          upsample2x_trilinear)
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.ops.fused_losses import region_dice_ce
from chap_tpu_torch.semi.bcp import generate_mask_nd
from chap_tpu_torch.train import trainer_2d, trainer_share
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.step_supervised import build_supervised_train_step
from test_torch_eval import ZoomedVolumes
from test_torch_models import JaxFeed, RandomFeed, _flax_model, _nchw

torch.set_num_threads(1)

BF = jnp.bfloat16
ULP = 2.0 ** -7          # one bf16 unit in the last place, relative


def as_np(t):
    """A port tensor (bf16 or not) or a JAX array as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


def hold_bf16(name, port_bf, ref_bf, ref_f32, port_f32, atol=1e-6):
    """The bar of the module docstring (2 and 3) for one tensor; returns
    (e_ref, max |port bf16 - chap_tpu bf16|)."""
    port_bf, ref_bf, ref_f32, port_f32 = (as_np(a) for a in
                                          (port_bf, ref_bf, ref_f32, port_f32))
    assert port_bf.shape == ref_bf.shape == ref_f32.shape == port_f32.shape, name
    e_ref = float(np.abs(ref_bf - ref_f32).max(initial=0.0))
    d_ref = float(np.abs(port_bf - ref_bf).max(initial=0.0))
    d_f32 = float(np.abs(port_bf - ref_f32).max(initial=0.0))
    d_own = float(np.abs(port_bf - port_f32).max(initial=0.0))
    assert d_ref <= 2 * e_ref + atol, (
        f"{name}: port bf16 is {d_ref:.4g} from chap_tpu bf16, e_ref {e_ref:.4g}")
    assert d_f32 <= 2 * e_ref + atol, (
        f"{name}: port bf16 is {d_f32:.4g} from chap_tpu float32, e_ref {e_ref:.4g}")
    assert d_own >= 0.1 * e_ref, (
        f"{name}: port bf16 is only {d_own:.4g} from the port's float32, "
        f"e_ref {e_ref:.4g}: not computed in bf16")
    return e_ref, d_ref


def stacked(values):
    """Several tensors (or scalars) as one flat float64 vector, to hold as
    one compared tensor."""
    return np.concatenate([as_np(v).ravel() for v in values])


def hold_maps(name, port_bf, ref_bf, ref_f32):
    """Integer maps: bar 4 of the module docstring; returns both shares."""
    port_bf, ref_bf, ref_f32 = (np.asarray(a) for a in (port_bf, ref_bf, ref_f32))
    share_ref = float(np.mean(ref_bf == ref_f32))
    share = float(np.mean(port_bf == ref_bf))
    assert share >= share_ref - 0.005, (
        f"{name}: port bf16 agrees with chap_tpu bf16 on {share:.4%}, chap_tpu's "
        f"bf16 with its float32 on {share_ref:.4%}")
    return share, share_ref


def to_bf16(x):
    """numpy float32 -> the same values rounded to bf16, as float32 numpy
    (exact in both packages' bf16)."""
    return np.asarray(jnp.asarray(x, BF).astype(jnp.float32))


def bf16_grid_uniform(rs, shape):
    """Uniforms that chap_tpu's bf16 jax.random.uniform can give."""
    return (np.floor(rs.rand(*shape) * 128) / 128).astype(np.float32)


# ---------------------------------------------------------------------------
# the shared layers
# ---------------------------------------------------------------------------

LAYER_CASES = {
    # name: (chap_tpu function of NDHWC / NHWC, port function, input shape)
    "bilinear_32": (jax_bilinear, upsample2x_bilinear, (2, 32, 32, 3)),
    "trilinear_56": (jax_trilinear, upsample2x_trilinear, (1, 56, 8, 4, 2)),
    "trilinear_7x7x5": (jax_trilinear, upsample2x_trilinear, (2, 7, 7, 5, 3)),
    "trilinear_size1": (jax_trilinear, upsample2x_trilinear, (1, 1, 3, 14, 2)),
    "resize_up": (lambda x: jax_resize(x, (12, 12, 12)),
                  lambda x: resize_linear(x, (12, 12, 12)), (1, 6, 6, 6, 2)),
    "resize_down": (lambda x: jax_resize(x, (6, 5, 4)),
                    lambda x: resize_linear(x, (6, 5, 4)), (1, 12, 10, 8, 2)),
    "instance_norm_mean5": (lambda x: jax_instance_norm(x, BF), instance_norm,
                            (2, 3, 2, 1, 8)),
}


def _channels_first(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layers_compute_as_chap_tpu_in_bf16(case):
    """Up-sampling builds chap_tpu's weights in bf16 (its align-corners
    scale and translation are bf16 arrays), the half-pixel resize rounds
    float32 weights to bf16, and the affine-free instance norm rounds its
    mean and variance to bf16 before normalising: within one bf16 unit of
    chap_tpu (bit-equal but where the contraction order rounds otherwise),
    and far from what float32 would give where chap_tpu's bf16 is far from
    it (trilinear at 56: 0.72 at a scale of 3.3; the instance norm of
    mean-5 maps: 0.12). "One bf16 unit" is at the output's scale: the
    order of the per-axis contractions moves a small value by a unit of the
    large ones."""
    jfn, pfn, shape = LAYER_CASES[case]
    rs = np.random.RandomState(0)
    x = to_bf16((rs.randn(*shape) * (0.3 if "norm" in case else 1.0)
                 + (5.0 if "norm" in case else 0.0)).astype(np.float32))
    want = jfn(jnp.asarray(x, BF))
    want32 = as_np(jfn(jnp.asarray(x)))
    got = pfn(_channels_first(x).to(torch.bfloat16))
    assert want.dtype == BF and got.dtype == torch.bfloat16
    got = np.moveaxis(as_np(got), 1, -1)
    want = as_np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP * np.abs(want).max())
    if case in ("trilinear_56", "instance_norm_mean5"):
        # chap_tpu's own bf16 departure from float32, which the port keeps
        assert np.abs(got - want32).max() > 0.1


def test_instance_norm_gradient_in_bf16():
    """The gradient through the bf16 affine-free instance norm at a
    32 x 32 x 16 map, for a cotangent with a per-channel mean (as a loss's
    logits gradient has, so that most of it cancels): the port's is within
    10% of chap_tpu's float32 gradient (measured: 3.9%), its sums of the
    cotangent taken in float32. chap_tpu's own bf16 gradient on the CPU is
    9.7 times the gradient's norm off: XLA sums the bf16 cotangent over the
    16,384 voxels in bf16 (ROADMAP.md §3)."""
    rs = np.random.RandomState(0)
    x = to_bf16((rs.randn(2, 32, 32, 16, 4) * 0.5 + 1.0).astype(np.float32))
    g = (1.0 + 0.1 * rs.randn(2, 32, 32, 16, 4)).astype(np.float32)
    want = as_np(jax.grad(lambda v: jnp.sum(jax_instance_norm(v, jnp.float32) * g))(
        jnp.asarray(x)))
    xt = _channels_first(x).to(torch.bfloat16).requires_grad_()
    out = instance_norm(xt, 1e-5)
    assert out.dtype == torch.bfloat16
    (out.float() * _channels_first(g)).sum().backward()
    got = np.moveaxis(as_np(xt.grad), 1, -1)
    assert np.linalg.norm(got - want) <= 0.1 * np.linalg.norm(want)


def test_bf16_conv_on_the_cpu_is_the_cards_product():
    """A bf16 convolution on the CPU is the float32 product of the bf16
    operands rounded once, the bf16 bias then added in bf16 (the card's
    bf16 convolution: float32 accumulation, and PyTorch adds a cuDNN
    convolution's bias after it, as Flax's nn.Conv adds its bias to the
    bf16 product; chip_smoke.py's ``bf16_products`` line holds the CPU's
    product to the card's), also at the strided shape where oneDNN's own
    bf16 convolution is 7.6 off at a scale of 6.6; the gradient reaches the
    float32 kernel."""
    torch.manual_seed(0)
    conv = set_compute_dtype(Conv3d(32, 64, 3, stride=2, padding=1), torch.bfloat16)
    x = torch.randn(2, 32, 6, 4, 2)
    out = conv(x)
    assert out.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    want = F.conv3d(x.bfloat16().float(), conv.weight.bfloat16().float(),
                    None, stride=2, padding=1).bfloat16()
    want = want + conv.bias.bfloat16().view(1, -1, 1, 1, 1)
    assert torch.equal(out, want)
    out.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    assert float(conv.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("norm", ["batchnorm", "groupnorm", "vnet_instancenorm"])
def test_float32_statistics_norms_in_bf16(norm):
    """BatchNorm, GroupNorm and VNet's instancenorm (a Flax GroupNorm of one
    channel a group) take float32 statistics of a bf16 input, normalise in
    float32 and round only the output, as Flax's norms with dtype=bf16:
    the output within one bf16 unit of chap_tpu's, the BatchNorm's batch
    statistics float32 and equal to chap_tpu's at float32 precision (1e-5
    relative: Flax's one-pass variance against the port's two-pass; bf16
    statistics would be 4e-3 off)."""
    rs = np.random.RandomState(1)
    x = to_bf16((rs.randn(2, 6, 5, 4, 16) * 2.0 + 3.0).astype(np.float32))
    if norm == "batchnorm":
        jmod = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=BF)
        port = BatchNorm3d(16)
    elif norm == "groupnorm":
        jmod = fnn.GroupNorm(num_groups=16, dtype=BF)
        port = GroupNorm(16, 16, eps=1e-6)
    else:
        jmod = fnn.GroupNorm(num_groups=None, group_size=1, use_bias=False,
                             use_scale=False, dtype=BF)
        port = GroupNorm(16, 16, eps=1e-6, affine=False)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out = jmod.apply(variables, jnp.asarray(x, BF), mutable=["batch_stats"])
    want, upd = out if norm == "batchnorm" else (out[0], None)
    xt = _channels_first(x).to(torch.bfloat16)
    set_compute_dtype(port, torch.bfloat16)
    port.stats_key = "bn"
    stats = {}
    got = port(xt, stats) if norm == "batchnorm" else port(xt)
    assert want.dtype == BF and got.dtype == torch.bfloat16
    np.testing.assert_allclose(np.moveaxis(as_np(got), 1, -1), as_np(want),
                               rtol=ULP, atol=2e-2 * ULP)
    if norm == "batchnorm":
        mean, var = stats["bn"]
        assert mean.dtype == var.dtype == torch.float32
        # Flax's running stats after one pass: 0.9 * init + 0.1 * batch
        for got_s, init, new in ((mean, 0.0, upd["batch_stats"]["mean"]),
                                 (var, 1.0, upd["batch_stats"]["var"])):
            np.testing.assert_allclose(0.9 * init + 0.1 * got_s.numpy(),
                                       np.asarray(new), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the factories
# ---------------------------------------------------------------------------

KEYS_2D = ("unet", "unetp", "dualdecoder", "acalnet", "unet_cct", "unet_urpc",
           "resunet", "dual_student", "swinunet", "enet", "pnet", "efficient_unet")
KEYS_3D = ("unet_3D", "attention_unet", "unet_3D_dv_semi", "voxresnet", "vnet",
           "vnet_ds", "dualdecoder", "resvnet")


@pytest.mark.parametrize("key", [f"2d:{k}" for k in KEYS_2D]
                         + [f"3d:{k}" for k in KEYS_3D])
def test_factories_build_every_key_in_bf16(key):
    """model.dtype=bfloat16 builds every key of both factories: float32
    parameters, bf16 outputs (train and eval), float32 gradients (swinunet
    at its factory's 224^2)."""
    rank, name = key.split(":")
    cfg = ModelConfig()
    cfg.dtype = "bfloat16"
    cfg.feature_chns = (4, 8, 16, 16, 32)
    cfg.n_filters_3d = 2
    if rank == "2d":
        model = net_factory(name, 1, 2, cfg, device="cpu")
        side = 224 if name == "swinunet" else 32
        x = torch.randn(2, 1, side, side)
    else:
        model = net_factory_3d(name, 1, 2, "train", cfg, device="cpu")
        x = torch.randn(2, 1, 16, 16, 16)
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for train in (False, True):
        model.train(train)
        out = model(x, stats={}) if train else model(x)
        outs = out if isinstance(out, (tuple, list)) else [out]
        flat = [o for t in outs for o in (t if isinstance(t, list) else [t])]
        assert flat and all(o.dtype == torch.bfloat16 for o in flat), key
    sum(o.float().sum() for o in flat).backward()
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in model.parameters())


# ---------------------------------------------------------------------------
# the 2D DualDecoder
# ---------------------------------------------------------------------------

def _dualdecoder_pair(decoder_type, key="dualdecoder"):
    """chap_tpu's ``key`` model (DualDecoder, also behind ``acalnet``) from
    its net_factory in float32 and bf16 over one set of float32 weights,
    and the port's from its net_factory, as (jax models, variables, port
    model)."""
    from chap_tpu.config import ModelConfig as JaxModelConfig
    from test_torch_models import CHNS, DROPOUT
    _, variables = _flax_model(decoder_type)
    jmodels = {}
    for dt, name in ((jnp.float32, "float32"), (BF, "bfloat16")):
        jcfg = JaxModelConfig()
        jcfg.decoder_type, jcfg.feature_chns, jcfg.dropout = decoder_type, CHNS, DROPOUT
        jcfg.dtype = name
        jmodels[dt] = jax_net_factory(key, 1, 4, jcfg)
    cfg = ModelConfig()
    cfg.decoder_type, cfg.feature_chns, cfg.dropout = decoder_type, CHNS, DROPOUT
    port = net_factory(key, 1, 4, cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], decoder_type))
    return jmodels, variables, port


# e_ref measured on these inputs (logits1, logits2): eval 8.6e-5 / 8.3e-5
# for every decoder type (logits of scale 0.01: random running stats);
# train 0.19 / 0.049 (mcnet), 0.19 / 0.14 (same, also acalnet), 0.19 / 0.16
# (plus), at a scale of 2.7-4.1
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key,decoder_type", [("dualdecoder", "mcnet"),
                                              ("dualdecoder", "same"),
                                              ("dualdecoder", "plus"),
                                              ("acalnet", "same")])
def test_dualdecoder_bf16_matches_chap_tpu(monkeypatch, key, decoder_type, train):
    """Both 2D keys, every decoder type, eval and train mode (encoder
    dropout draws fed to both)."""
    jmodels, variables, port = _dualdecoder_pair(decoder_type, key)
    rs = np.random.RandomState(3)
    x = to_bf16(rs.randn(4, 32, 32, 1).astype(np.float32))
    from test_torch_models import CHNS
    uniforms = [rs.rand(4, 32 >> i, 32 >> i, c).astype(np.float32)
                for i, c in enumerate(CHNS)]
    outs = {}
    for dt in (jnp.float32, BF):
        if train:
            monkeypatch.setattr(flax_stochastic, "random", RandomFeed(uniforms))
            outs[dt], _ = jmodels[dt].apply(variables, jnp.asarray(x, dt), train=True,
                                            mutable=["batch_stats"],
                                            rngs={"dropout": jax.random.PRNGKey(1)})
        else:
            outs[dt] = jmodels[dt].apply(variables, jnp.asarray(x, dt), train=False)
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(port, dt).train(train)
        with torch.no_grad():
            got[dt] = port(_nchw(x).to(dt), drop_u=[_nchw(u) for u in uniforms],
                           stats={})
    for i in range(2):
        assert outs[BF][i].dtype == BF and got[torch.bfloat16][i].dtype == torch.bfloat16
        hold_bf16(f"logits{i + 1}", got[torch.bfloat16][i].permute(0, 2, 3, 1),
                  outs[BF][i], outs[jnp.float32][i],
                  got[torch.float32][i].permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# K1's plain version at bf16 logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 32, 32), (1, 2, 16, 16, 8)])
def test_k1_plain_at_bf16_logits_matches_chap_tpu(shape):
    """K1 upcasts bf16 logits to float32 inside, as chap_tpu's kernel and
    its XLA twin do: float32 losses equal chap_tpu's at float32 precision;
    the gradient comes back in bf16, within one bf16 unit of chap_tpu's
    custom VJP."""
    rs = np.random.RandomState(5)
    logits = to_bf16((rs.randn(*shape) * 2).astype(np.float32))
    labels = rs.randint(0, shape[1], (shape[0],) + shape[2:]).astype(np.int32)
    mask = (rs.rand(*labels.shape) < 0.6).astype(np.float32)
    jlog = jnp.asarray(np.moveaxis(logits, 1, -1), BF)

    def jloss(lg):
        d, c = jax_fused(lg, jnp.asarray(labels), jnp.asarray(mask))
        return 0.7 * d + 1.3 * c, (d, c)

    (_, (jd, jc)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jlog)
    t = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    d, c = region_dice_ce(t, torch.from_numpy(labels), torch.from_numpy(mask))
    assert d.dtype == c.dtype == torch.float32 and jd.dtype == jnp.float32
    np.testing.assert_allclose([float(d), float(c)], [float(jd), float(jc)],
                               rtol=1e-5)
    (0.7 * d + 1.3 * c).backward()
    assert t.grad.dtype == torch.bfloat16 and jgrad.dtype == BF
    np.testing.assert_allclose(np.moveaxis(as_np(t.grad), 1, -1), as_np(jgrad),
                               rtol=ULP, atol=1e-9)


# ---------------------------------------------------------------------------
# the 2D CHAP and supervised steps
# ---------------------------------------------------------------------------

CHNS = (4, 8, 16, 16, 32)
B, LB, HW, C = 8, 4, 32, 4
STARTS = (5, 7)
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")
# chap_tpu's metric dtypes in bf16: K1's losses are float32, the channel-
# dropout CE and the VAT divergence are taken in the logits' dtype
METRIC_DTYPES = {"fp_loss": torch.bfloat16, "vat_loss": torch.bfloat16}


def _configure(cfg, dtype):
    cfg.data.num_classes = C
    cfg.data.batch_size = B
    cfg.data.labeled_bs = LB
    cfg.data.image_size = (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.model.dropout = (0.0,) * 5
    cfg.model.dtype = dtype
    cfg.semi.dropout = True
    cfg.semi.adv_noise = True
    cfg.optim.remat = False
    cfg.optim.fused_passes = False
    return cfg


BATCH_SEEDS = (2, 3, 4)     # the batches a step test runs on


def _step_batch(seed):
    """Phantom slices rounded to bf16 (the pool's dtype) and their labels."""
    from chap_tpu_torch.data.datasets import phantom_batch
    images, labels = phantom_batch(np.random.RandomState(seed), B, HW, C)
    return to_bf16(images), labels


def _step_draws():
    """The step's draws, the same for every batch: chap_tpu traces them into
    its compiled step once."""
    rs = np.random.RandomState(1)
    shapes = perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    perturb = [[rs.rand(*s).astype(np.float32) for s in lvl] for lvl in shapes]
    vat_u = bf16_grid_uniform(rs, (B - LB, 1, HW, HW))
    sim = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in CHNS]
    return perturb, vat_u, sim


def _chap_tpu_chap_step(dtype_name):
    """chap_tpu's 2D CHAP step in ``dtype_name`` (K1 semantics for its mix
    losses), compiled once and run from the same state on each batch of
    BATCH_SEEDS: (initial variables, the outputs, the pseudo-labels around
    its NMS on the first batch)."""
    perturb, vat_u, sim = _step_draws()
    cfg = _configure(JaxConfig(), dtype_name)
    model = jax_net_factory("dualdecoder", 1, C, cfg.model)
    opt = jax_make_optimizer(cfg.optim.base_lr, cfg.optim.max_iterations,
                             cfg.optim.momentum, cfg.optim.weight_decay,
                             cfg.optim.poly_power)

    def fresh_state():       # the step donates its state
        state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                       jnp.zeros((B, HW, HW, 1)), opt,
                                       sim_chns=CHNS)
        return state.replace(sim_scores=tuple(jnp.asarray(s) for s in sim))

    state = fresh_state()
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    mask = np.asarray(generate_mask_nd((HW, HW), STARTS))
    captured = []

    def record(seg, n):
        out = real_nms(seg, n)
        jax.debug.callback(lambda a, b: captured.append((np.asarray(a), np.asarray(b))),
                           seg, out)
        return out

    real_nms = jax_step_chap.largest_cc_batch
    dt = BF if dtype_name == "bfloat16" else jnp.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_chap, "generate_mask_nd", lambda rng, spatial: jnp.asarray(mask))
        mp.setattr(jax_step_chap, "largest_cc_batch", record)
        mp.setattr(jax_step_chap, "mix_loss",
                   functools.partial(jax_mix.mix_loss, fused=True))
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in perturb for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed(
            [np.ascontiguousarray(vat_u.transpose(0, 2, 3, 1))])))
        step = jax_step_chap.build_chap_train_step(model, opt, cfg, use_nms=True)
        outs = []
        for i, seed in enumerate(BATCH_SEEDS):
            images, labels = _step_batch(seed)
            batch = {"image": jnp.asarray(images.transpose(0, 2, 3, 1), dt),
                     "label": jnp.asarray(labels.astype(np.uint8))}
            outs.append(jax.device_get(step(state if i == 0 else fresh_state(),
                                            batch, jax.random.PRNGKey(42))))
    return variables, outs, captured[0]


@pytest.fixture(scope="module")
def chap_tpu_chap_steps():
    return {name: _chap_tpu_chap_step(name) for name in ("float32", "bfloat16")}


def _port_chap_step(variables, dtype_name, seed, capture=None):
    images, labels = _step_batch(seed)
    perturb, vat_u, sim = _step_draws()
    cfg = _configure(Config(), dtype_name)
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]))
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = TrainState(0, model, opt, [torch.from_numpy(s) for s in sim])
    real = step_chap.largest_cc_batch

    def recording(seg, n):
        out = real(seg, n)
        if capture is not None:
            capture.extend([seg.clone(), out.clone()])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_chap, "largest_cc_batch", recording)
        step = step_chap.build_chap_train_step(model, opt, cfg, use_nms=True,
                                               device="cpu")
        draws = {"bcp_starts": list(STARTS),
                 "drop": {n: [None] * 5 for n in ("teacher", "student", "fp", "vat")},
                 "perturb": [[torch.from_numpy(u) for u in lvl] for lvl in perturb],
                 "vat_d": torch.from_numpy(vat_u)}
        batch = {"image": torch.from_numpy(images).to(dt),
                 "label": torch.from_numpy(labels)}
        return step(state, batch, draws=draws)


def _updates(sd_after, sd_before):
    return {k: (sd_after[k].double() - sd_before[k].double())
            for k in sd_before if not k.endswith("num_batches_tracked")}


LEAF_UPDATE_RTOL = 5e-2   # tests/test_torch_step3d.py's float32 bars
UPDATE_RTOL = 2e-2
NOISE_UPDATE = 1e-6


def hold_updates(port_bf, ref_bf, ref_f32, port_f32, before):
    """Parameter and BN-statistics updates (after minus ``before``) held as
    the float32 update check of tests/test_torch_step3d.py holds them, with
    its bars raised by chap_tpu's measured bf16 gap (its bf16 update against
    its float32 one).

    A leaf whose float32 update is rounding noise (at most NOISE_UPDATE: a
    conv bias in front of a norm, which gets no gradient; chap_tpu's bf16
    step moves it by its bf16-summed gradient) is held apart: within 2x
    chap_tpu's gap on it plus NOISE_UPDATE. Over the other leaves, r is
    chap_tpu's gap of all parameters relative to the update's norm (0.26-1.5
    in these tests: after one step from random weights bf16 noise is most of
    an update, and it sits in the conv kernels, not in the biases); each
    leaf is within 2x its own gap, plus 2 r of its norm (a short leaf's own
    gap is one draw), plus the float32 bar (5% of its norm), of chap_tpu's
    bf16 update; all parameters' within 2x chap_tpu's gap plus 2%.

    Where r is near 1 those distances cannot tell a missing update from a
    right one, so the update is also held along chap_tpu's float32 step
    u32: p = <u, u32> / |u32|^2 is the part of that step an update carries
    (1 for u32 itself, 0 for no update, negative for a reversed one), and
    the port's p is within 2 |1 - p_ref| + 2% of chap_tpu's bf16 p_ref
    (bf16 noise is nearly orthogonal to the step, so |1 - p_ref| is 0.05-0.25
    where r is 0.26-1.5). An unchanged state and a sign-flipped update fail
    here (tests/test_torch_bf16_step3d.py::test_update_check_fails_a_wrong_
    update). Last, all parameters' update is at least 0.1 x chap_tpu's gap
    from the port's float32 update. Returns r, the port's error over all
    parameters relative to the norm, p and p_ref."""
    u = {name: _updates(sd, before)
         for name, sd in (("pb", port_bf), ("rb", ref_bf), ("rf", ref_f32),
                          ("pf", port_f32))}
    gap = {k: (u["rb"][k] - u["rf"][k]).norm().item() for k in u["rb"]}
    norm = {k: u["rf"][k].norm().item() for k in u["rb"]}
    err = {k: (u["pb"][k] - u["rb"][k]).norm().item() for k in u["rb"]}
    own = {k: (u["pb"][k] - u["pf"][k]).norm().item() for k in u["rb"]}
    for k in (k for k in gap if norm[k] <= NOISE_UPDATE):
        assert err[k] <= 2 * gap[k] + NOISE_UPDATE, (
            f"{k}: update off by {err[k]:.3e} where chap_tpu's float32 update "
            f"is rounding noise; chap_tpu's bf16 gap {gap[k]:.3e} on it")
    params = [k for k in gap if norm[k] > NOISE_UPDATE
              and not k.endswith(("running_mean", "running_var"))]
    total = {name: sum(v[k] ** 2 for k in params) ** 0.5
             for name, v in (("gap", gap), ("norm", norm), ("err", err),
                             ("own", own))}
    r = total["gap"] / total["norm"]
    for k in (k for k in gap if norm[k] > NOISE_UPDATE):
        assert err[k] <= 2 * gap[k] + (2 * r + LEAF_UPDATE_RTOL) * norm[k], (
            f"{k}: update off by {err[k]:.3e}; chap_tpu's bf16 gap {gap[k]:.3e} "
            f"on it and {r:.3f} of all, the update's norm {norm[k]:.3e}")
    assert total["err"] <= 2 * total["gap"] + UPDATE_RTOL * total["norm"], (
        f"parameters' update off by {total['err']:.3e}; chap_tpu's gap "
        f"{total['gap']:.3e}, the update's norm {total['norm']:.3e}")
    flat = {name: torch.cat([v[k].flatten() for k in params]) for name, v in u.items()}
    step = float(flat["rf"] @ flat["rf"])
    p = float(flat["pb"] @ flat["rf"]) / step
    p_ref = float(flat["rb"] @ flat["rf"]) / step
    assert abs(p - p_ref) <= 2 * abs(1 - p_ref) + UPDATE_RTOL, (
        f"parameters' update carries {p:.3f} of chap_tpu's float32 step, "
        f"chap_tpu's bf16 update {p_ref:.3f}")
    assert total["own"] >= 0.1 * total["gap"], (
        f"update only {total['own']:.3e} from float32, gap {total['gap']:.3e}")
    return {"r": r, "err": total["err"] / total["norm"], "p": p, "p_ref": p_ref}


# measured here: the metrics' e_ref 0.040 (losses up to 7.1; the port 0.052
# from chap_tpu's bf16); pseudo-labels before / after the NMS: chap_tpu's
# bf16 and float32 maps agree on 98.4% / 96.8% of pixels, the port's bf16
# and chap_tpu's bf16 on 99.3% / 98.5%; updates: r 0.37 (chap_tpu's bf16
# gap over the leaves above rounding), the port 0.32 from chap_tpu's bf16,
# p 0.95 against p_ref 0.92; GradSim e_ref 0.060
def test_chap_step_2d_bf16_matches_chap_tpu(chap_tpu_chap_steps):
    """One bf16 CHAP step (teacher, NMS, BCP, mix losses, channel dropout,
    VAT, GradSim, SGD) on each batch of BATCH_SEEDS: the metrics; on the
    first batch the parameters and BN stats, GradSim scores and
    pseudo-labels."""
    _, wants32, cap32 = chap_tpu_chap_steps["float32"]
    variables, wants, cap = chap_tpu_chap_steps["bfloat16"]
    pseudo = []
    gots = [_port_chap_step(variables, "bfloat16", seed, pseudo if i == 0 else None)
            for i, seed in enumerate(BATCH_SEEDS)]
    owns = [_port_chap_step(variables, "float32", seed) for seed in BATCH_SEEDS]
    for k in METRICS:
        assert gots[0].metrics[k].dtype == METRIC_DTYPES.get(k, torch.float32), k
        assert wants[0].metrics[k].dtype == (BF if k in METRIC_DTYPES
                                             else jnp.float32), k
    hold_bf16("metrics", *(stacked(r.metrics[k] for r in runs for k in METRICS)
                           for runs in (gots, wants, wants32, owns)))
    got, want, want32, own = gots[0], wants[0], wants32[0], owns[0]
    for i in range(2):       # the teacher's argmax maps before and after NMS
        hold_maps(f"pseudo-labels {i}", pseudo[i].numpy(), cap[i], cap32[i])
    before = state_dict_from_flax(variables["params"], variables["batch_stats"])
    sd = lambda s: state_dict_from_flax(s.params, s.batch_stats)
    hold_updates(got.state.model.state_dict(), sd(want.state), sd(want32.state),
                 own.state.model.state_dict(), before)
    assert all(g.dtype == torch.float32 for g in got.state.sim_scores)
    hold_bf16("GradSim scores", *(stacked(r.state.sim_scores)
                                  for r in (got, want, want32, own)), atol=1e-3)


def _supervised_case(dtype_name):
    """chap_tpu's 2D supervised step (K1 losses) and its inputs."""
    cfg = _configure(JaxConfig(), dtype_name)
    model = jax_net_factory("dualdecoder", 1, C, cfg.model)
    opt = jax_make_optimizer(cfg.optim.base_lr, cfg.optim.max_iterations,
                             cfg.optim.momentum, cfg.optim.weight_decay,
                             cfg.optim.poly_power)
    def fresh_state():       # the step donates its state
        return jax_create_train_state(model, jax.random.PRNGKey(0),
                                      jnp.zeros((B, HW, HW, 1)), opt, sim_chns=())

    state = fresh_state()
    dt = BF if dtype_name == "bfloat16" else jnp.float32
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_supervised, "dice_ce_supervised",
                   functools.partial(jax_dice_ce_supervised, fused=True))
        step = jax_step_supervised.build_supervised_train_step(model, opt, cfg)
        for i, seed in enumerate(BATCH_SEEDS):
            images, labels = _step_batch(seed)
            outs.append(jax.device_get(step(state if i == 0 else fresh_state(), {
                "image": jnp.asarray(images.transpose(0, 2, 3, 1), dt),
                "label": jnp.asarray(labels.astype(np.uint8))},
                jax.random.PRNGKey(3))))
    return variables, outs


# measured here: the loss's e_ref 8.5e-4 (losses of 2.4); updates: r 0.26,
# the port 0.25 from chap_tpu's bf16, p 0.99 against p_ref 0.95
def test_supervised_step_2d_bf16_matches_chap_tpu():
    """The dual-decoder supervised step (K1, one region a decoder) in bf16:
    the loss (float32) on each batch of BATCH_SEEDS, and on the first the
    parameters and BN stats."""
    variables, wants32 = _supervised_case("float32")
    _, wants = _supervised_case("bfloat16")
    runs = {}
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        cfg = _configure(Config(), name)
        runs[name] = []
        for seed in BATCH_SEEDS:
            images, labels = _step_batch(seed)
            model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
            model.load_state_dict(state_dict_from_flax(variables["params"],
                                                       variables["batch_stats"]))
            opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                                 cfg.optim.weight_decay)
            step = build_supervised_train_step(model, opt, cfg, device="cpu")
            runs[name].append(step(TrainState(0, model, opt, []),
                                   {"image": torch.from_numpy(images).to(dt),
                                    "label": torch.from_numpy(labels)},
                                   draws={"drop": [None] * 5}))
    gots, owns = runs["bfloat16"], runs["float32"]
    assert gots[0].metrics["loss"].dtype == torch.float32
    hold_bf16("loss", *(stacked(r.metrics["loss"] for r in rs)
                        for rs in (gots, wants, wants32, owns)))
    got, own, want, want32 = gots[0], owns[0], wants[0], wants32[0]
    sd = lambda s: state_dict_from_flax(s.params, s.batch_stats)
    hold_updates(got.state.model.state_dict(), sd(want.state), sd(want32.state),
                 own.state.model.state_dict(),
                 state_dict_from_flax(variables["params"], variables["batch_stats"]))


# ---------------------------------------------------------------------------
# the 2D eval
# ---------------------------------------------------------------------------

# chap_tpu's bf16 label maps agree with its float32 maps on 99.90% (model1)
# and 96.97% (logit_ensemble) of pixels here; the port's bf16 maps with
# chap_tpu's bf16 on 100%
@pytest.mark.parametrize("model_type", ["model1", "logit_ensemble"])
def test_eval2d_bf16_matches_chap_tpu(model_type):
    """Slice-wise prediction with a bf16 DualDecoder: softmax and argmax in
    the logits' dtype, as chap_tpu's."""
    jmodels, variables, port = _dualdecoder_pair("mcnet")
    ds = ZoomedVolumes()
    maps = {}
    for dt, tdt in ((jnp.float32, torch.float32), (BF, torch.bfloat16)):
        j_predict = jax_make_predictor(jmodels[dt], model_type)
        predict = make_predictor(set_compute_dtype(port, tdt), model_type,
                                 device="cpu")
        maps[tdt] = [(jax_predict_volume(j_predict, variables, ds[i]["image"], (32, 32)),
                      predict_volume(predict, ds[i]["image"], (32, 32)))
                     for i in range(len(ds))]
    for (want, got), (want32, _) in zip(maps[torch.bfloat16], maps[torch.float32]):
        hold_maps(model_type, got, want, want32)


# ---------------------------------------------------------------------------
# draws, data and refusals
# ---------------------------------------------------------------------------

def test_working_uniform_gives_what_jax_bf16_uniform_can():
    """A float32 draw taken into bf16 lands on JAX's bf16 uniform grid
    (multiples of 2^-7 below 1), never on 1.0, and covers the same values
    as jax.random.uniform(..., dtype=bf16)."""
    u = torch.tensor([0.0, 0.3, 0.99999994, 1 - 2 ** -8, 0.5], dtype=torch.float32)
    got = working_uniform(u, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  [0.0, 38 / 128, 127 / 128, 127 / 128, 0.5])
    jax_u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (100000,),
                                          dtype=BF).astype(jnp.float32))
    port_u = working_uniform(torch.rand(100000, generator=torch.Generator().manual_seed(0)),
                             torch.bfloat16).float().numpy()
    assert set(np.unique(jax_u)) == set(np.unique(port_u)) == {k / 128 for k in range(128)}
    assert working_uniform(u, torch.float32) is not None
    assert torch.equal(working_uniform(u, torch.float32), u)


def test_compact_batch_in_bf16():
    """The host loader's batches in bf16 (rounded to nearest, as chap_tpu's
    ml_dtypes cast), labels uint8."""
    rs = np.random.RandomState(0)
    batch = {"image": rs.rand(4, 1, 8, 8), "label": rs.randint(0, 4, (4, 8, 8))}
    out = list(prefetch_to_device(iter([batch]), "cpu", transform=functools.partial(
        compact_batch, compute_dtype=torch.bfloat16)))[0]
    assert out["image"].dtype == torch.bfloat16 and out["label"].dtype == torch.uint8
    np.testing.assert_array_equal(out["image"].float().numpy(),
                                  to_bf16(batch["image"].astype(np.float32)))


@pytest.mark.parametrize("trainer", ["ablation", "acal"])
def test_ablation_and_acal_refuse_bf16(tmp_path, monkeypatch, trainer):
    """The ablation step and the ACAL trainer no longer refuse bf16 (their
    bf16 steps are held to chap_tpu's in tests/test_torch_bf16_share.py):
    each builds its model computing in bf16 and hands its step a bf16
    batch, for one step of the trainer."""
    from chap_tpu_torch.config import update_values
    from test_trainer_e2e import tiny_cfg as jax_tiny_cfg
    import dataclasses

    cfg = update_values(dataclasses.asdict(jax_tiny_cfg(tmp_path)), Config())
    cfg.model.dtype = "bfloat16"
    cfg.data.image_size = (32, 32)
    cfg.run.log_every = cfg.eval.eval_every = 1
    seen = []
    module, name = ((trainer_2d, "build_ablation_train_step") if trainer == "ablation"
                    else (trainer_share, "build_share_joint_step"))
    real = getattr(module, name)

    def wrap_build(model, *args, **kw):
        step = real(model, *args, **kw)

        def wrapped(state, batch, gen=None):
            seen.append((model.compute_dtype, batch["image"].dtype))
            return step(state, batch, gen)
        return wrapped
    monkeypatch.setattr(module, name, wrap_build)
    if trainer == "ablation":
        result = trainer_2d.train(cfg, str(tmp_path), mode="ablation",
                                  max_steps=1, device="cpu")
    else:
        cfg.model.name, cfg.model.decoder_type = "acalnet", "same"
        cfg.semi.mb_patch_size = 8
        result = trainer_share.train(cfg, str(tmp_path), max_steps=1,
                                     device="cpu")
    assert result["steps"] == 1
    assert seen == [(torch.bfloat16, torch.bfloat16)]
