"""One full 3D CHAP step of the port against chap_tpu's
build_chap_train_step(..., level_paths=VNET_LEVEL_PATHS), and the 3D cps and
supervised steps against chap_tpu's trainer_3d step functions, from the same
weights with every random draw fed to both (CPU): nf 4, patch 32x32x16,
batch 4 = 2 labeled + 2 unlabeled, 2 classes, chap_tpu's s2d stem on (its
default). Not 16^3: there the bottleneck is 1x1x1, and a train-mode
BatchNorm over the 2 rows of a pass maps any two values to -1 and +1, so the
gradient of every weight in front of it is rounding noise (the port's and
chap_tpu's updates of block_four_dw then differed by 2x their size); at
32x32x16 it normalises 8 values a channel. chap_tpu's draws are replaced in this test only: its BCP mask is
fixed, and its VNet, perturbation and VAT modules get a ``jax`` whose
``random`` returns the test's numpy uniforms, moved to channel-last.

Tolerances. chap_tpu's own step is less exact than the port's here: against
the port's step run in float64, the port's float32 parameters after the
update are within 1e-5, chap_tpu's within 2.1e-5 at XLA's default
optimisation level and 1.8e-4 under this suite's ``--xla_backend_
optimization_level=0``; its vat_loss is 0.5% / 0.22% off the float64 value,
the port's 0.03% (Flax's one-pass batch variance, E[x^2] - E[x]^2, over the
8 values a bottleneck channel holds). So parameters are held to chap_tpu at
3e-4 absolute and vat_loss at rtol 5e-3; everything else at rtol 2e-3.

The values after the update alone cannot show the update: at lr 0.01 most
leaves move by less than that bar. So each leaf's update (after minus
before) is also held to chap_tpu's, relative to that update's norm. Under
opt-level 0, chap_tpu's update of a leaf is up to 2.7% off the float64
update (a BN scale of block_one), and all parameters' updates together are
0.79% off; the port's float32 updates are as far from chap_tpu's (2.7% and
0.79% for the CHAP step, 2.3% and 0.40% for cps, 1.8% and 0.44% for
supervised). The bars are 5% a leaf and 2% for the parameters together; an
update at half the learning rate is 50% off, a missing one 100%
(``test_update_check_catches_planted_faults``). A conv bias in front of a
BatchNorm has no gradient: its update is rounding noise under 1e-7 in both
packages, and is held to 1e-6 absolute instead.
``test_chap_step_3d_float32_matches_float64`` holds the port to its own
float64 step tightly."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.models.vnet3d as jax_vnet3d
import chap_tpu.train.step_chap as jax_step_chap
from chap_tpu.config import Config as JaxConfig
from chap_tpu.models import net_factory_3d as jax_net_factory_3d
from chap_tpu.semi.gradsim import VNET_LEVEL_PATHS as JAX_VNET_LEVEL_PATHS
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu.train.trainer_3d import build_cps3d_train_step as jax_cps
from chap_tpu.train.trainer_3d import build_supervised3d_train_step as jax_supervised
import chap_tpu_torch.train.step_chap as step_chap
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.models.vnet3d import dropout_shapes
from chap_tpu_torch.semi.bcp import generate_mask_nd
from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.trainer_3d import (build_cps3d_train_step,
                                             build_supervised3d_train_step)
from test_torch_models import JaxFeed, RandomFeed
from test_torch_models3d import jax_dropout_feed, ndhwc

torch.set_num_threads(1)

NF, B, LB, C = 4, 4, 2, 2
PATCH = (32, 32, 16)
CHNS = tuple(NF * m for m in (1, 2, 4, 8, 16))
STARTS = (3, 2, 4)
RTOL = 2e-3
VAT_RTOL = 5e-3       # chap_tpu's vat_loss is 2.2e-3 off a float64 step
PARAM_ATOL = 3e-4     # chap_tpu's parameters are 1.8e-4 off a float64 step
LEAF_UPDATE_RTOL = 5e-2   # chap_tpu's update of a leaf: 2.7% off float64
UPDATE_RTOL = 2e-2        # all parameters' updates: 0.79% off float64
NOISE_UPDATE = 1e-6       # the norm below which an update is rounding noise
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")


def _configure(cfg):
    cfg.data.num_classes = C
    cfg.data.batch_size = B
    cfg.data.labeled_bs = LB
    cfg.data.patch_size_3d = PATCH
    cfg.model.n_filters_3d = NF
    cfg.semi.dropout = True
    cfg.semi.adv_noise = True
    cfg.optim.remat = False
    cfg.optim.fused_passes = False      # chap_tpu's 3D trainer forces it
    return cfg


def _batch(seed):
    """Two-class cuboid phantoms [B, 1, X, Y, Z] and labels [B, X, Y, Z]."""
    rs = np.random.RandomState(seed)
    label = np.zeros((B, *PATCH), np.int32)
    for i in range(B):
        lo = rs.randint(2, 6, 3)
        hi = lo + rs.randint(6, 10, 3)
        label[i, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
    image = (label / 2.0 + rs.normal(0, 0.3, label.shape)).astype(np.float32)
    return image[:, None], label


def _draw_u(rs, shape):
    return rs.rand(*shape).astype(np.float32)


def _inputs():
    rs = np.random.RandomState(2)
    images, labels = _batch(7)
    passes = ("teacher", "student", "fp", "vat")
    drop = {p: [_draw_u(rs, s) for s in dropout_shapes(B - LB, NF, PATCH, 2)]
            for p in passes}
    shapes = perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    pert = [[_draw_u(rs, s) for s in lvl] for lvl in shapes]
    vat_u = _draw_u(rs, (B - LB, 1, *PATCH))
    sim = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in CHNS]
    return images, labels, drop, pert, vat_u, sim


def _jax_state(cfg, sim_chns=CHNS):
    model = jax_net_factory_3d("dualdecoder", 1, C, mode="train", cfg=cfg.model)
    opt = jax_make_optimizer(cfg.optim.base_lr, cfg.optim.max_iterations,
                             cfg.optim.momentum, cfg.optim.weight_decay,
                             cfg.optim.poly_power)
    state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                   jnp.zeros((B, *PATCH, 1)), opt, sim_chns=sim_chns)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    return model, opt, state, variables


def _port_model(cfg, variables, dtype=torch.float32):
    model = net_factory_3d("dualdecoder", 1, C, "train", cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family="dualdecoder3d"))
    model = model.to(dtype)
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    return model, opt


def _check_state(port_model, want_state, atol):
    after = state_dict_from_flax(want_state.params, want_state.batch_stats,
                                 family="dualdecoder3d")
    got = port_model.state_dict()
    for key, value in after.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=RTOL,
                                       atol=atol, err_msg=key)


def _check_update(before, port_model, want_state):
    """Each leaf's update (after minus ``before``, a port state dict) against
    chap_tpu's, relative to the update's norm; the parameters' updates
    together at UPDATE_RTOL."""
    after = state_dict_from_flax(want_state.params, want_state.batch_stats,
                                 family="dualdecoder3d")
    got = port_model.state_dict()
    err2 = norm2 = 0.0
    for key, value in after.items():
        if key.endswith("num_batches_tracked"):
            continue
        want_d = (value - before[key]).double()
        err = ((got[key] - before[key]).double() - want_d).norm().item()
        norm = want_d.norm().item()
        if norm > NOISE_UPDATE:
            assert err <= LEAF_UPDATE_RTOL * norm, (
                f"{key}: update off by {err:.3e}, its norm {norm:.3e}")
        else:
            assert err <= NOISE_UPDATE, f"{key}: update off by {err:.3e}"
        if not key.endswith(("running_mean", "running_var")):
            err2, norm2 = err2 + err ** 2, norm2 + norm ** 2
    assert err2 ** 0.5 <= UPDATE_RTOL * norm2 ** 0.5, (
        f"parameters' update off by {err2 ** 0.5:.3e}, its norm {norm2 ** 0.5:.3e}")


def _before(variables):
    return state_dict_from_flax(variables["params"], variables["batch_stats"],
                                family="dualdecoder3d")


@pytest.fixture(scope="module")
def chap_tpu_step():
    """chap_tpu's 3D CHAP step once for the module (one XLA compile): its
    initial variables, the outputs, and the pseudo-labels around its NMS."""
    images, labels, drop, pert, vat_u, sim = _inputs()
    cfg = _configure(JaxConfig())
    model, opt, state, variables = _jax_state(cfg)
    state = state.replace(sim_scores=tuple(jnp.asarray(s) for s in sim))
    mask = np.asarray(generate_mask_nd(PATCH, STARTS))
    # the VNet's bernoulli draws in trace order: teacher, student, channel
    # dropout, then VAT's power-iteration and final passes (one key, so the
    # same draws twice)
    feed = []
    for name in ("teacher", "student", "fp", "vat", "vat"):
        feed += jax_dropout_feed(drop[name], cfg.model.s2d_stem)
    captured = []

    def record(seg, n):
        out = real_nms(seg, n)
        jax.debug.callback(lambda a, b: captured.append((np.asarray(a), np.asarray(b))),
                           seg, out)
        return out

    real_nms = jax_step_chap.largest_cc_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_chap, "generate_mask_nd", lambda rng, spatial: jnp.asarray(mask))
        mp.setattr(jax_step_chap, "largest_cc_batch", record)
        mp.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(feed)))
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in pert for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed([ndhwc(vat_u)])))
        step = jax_step_chap.build_chap_train_step(
            model, opt, cfg, use_nms=True, level_paths=JAX_VNET_LEVEL_PATHS)
        batch = {"image": jnp.asarray(ndhwc(images)),
                 "label": jnp.asarray(labels.astype(np.uint8))}
        out = jax.device_get(step(state, batch, jax.random.PRNGKey(42)))
    return variables, out, captured


def _port_step(variables, capture=None, monkeypatch=None, dtype=torch.float32,
               lr_scale=1.0):
    images, labels, drop, pert, vat_u, sim = _inputs()
    cfg = _configure(Config())
    cfg.optim.base_lr *= lr_scale
    model, opt = _port_model(cfg, variables, dtype)
    f = lambda u: torch.from_numpy(u).to(dtype)
    state = TrainState(0, model, opt, [f(s) for s in sim])
    if capture is not None:
        real = step_chap.largest_cc_batch

        def recording(seg, n):
            capture.append(seg.clone())
            out = real(seg, n)
            capture.append(out.clone())
            return out
        monkeypatch.setattr(step_chap, "largest_cc_batch", recording)
    step = step_chap.build_chap_train_step(model, opt, cfg, use_nms=True,
                                           level_paths=VNET_LEVEL_PATHS,
                                           device="cpu")
    draws = {"bcp_starts": list(STARTS),
             "drop": {k: [f(u) for u in v] for k, v in drop.items()},
             "perturb": [[f(u) for u in lvl] for lvl in pert],
             "vat_d": f(vat_u)}
    batch = {"image": f(images), "label": torch.from_numpy(labels)}
    return step(state, batch, draws=copy.copy(draws))


def test_chap_step_3d_matches_chap_tpu(chap_tpu_step, monkeypatch):
    """Metrics, pseudo-labels around the 3D largest-CC (exact), parameters
    and BN stats after the update and each leaf's update, GradSim scores."""
    variables, want, captured = chap_tpu_step
    pseudo = []
    got = _port_step(variables, capture=pseudo, monkeypatch=monkeypatch)
    for k in METRICS:
        np.testing.assert_allclose(float(got.metrics[k]), float(want.metrics[k]),
                                   rtol=VAT_RTOL if k == "vat_loss" else RTOL,
                                   atol=1e-6, err_msg=k)
    assert len(captured) == 1 and len(pseudo) == 2
    assert pseudo[0].shape == (4 * (B - LB) // 2, *PATCH)
    np.testing.assert_array_equal(pseudo[0].numpy(), captured[0][0])
    np.testing.assert_array_equal(pseudo[1].numpy(), captured[0][1])
    _check_state(got.state.model, want.state, atol=PARAM_ATOL)
    _check_update(_before(variables), got.state.model, want.state)
    for g, w in zip(got.state.sim_scores, want.state.sim_scores):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-3)
    assert got.state.step == int(want.state.step) == 1


@pytest.mark.parametrize("fault", ["no_step", "half_lr"])
def test_update_check_catches_planted_faults(chap_tpu_step, monkeypatch, fault):
    """The update check fails a port step whose optimizer does not step, or
    steps at half the learning rate, though the metrics (computed before
    the update) still agree."""
    variables, want, _ = chap_tpu_step
    if fault == "no_step":
        monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    got = _port_step(variables, lr_scale=0.5 if fault == "half_lr" else 1.0)
    np.testing.assert_allclose(float(got.metrics["loss"]), float(want.metrics["loss"]),
                               rtol=RTOL)
    with pytest.raises(AssertionError, match="update off by"):
        _check_update(_before(variables), got.state.model, want.state)


def test_chap_step_3d_float32_matches_float64(chap_tpu_step):
    """The port's float32 step against the same step in float64: metrics at
    rtol 1e-3, parameters and BN stats at 3e-5 absolute."""
    variables = chap_tpu_step[0]
    single = _port_step(variables)
    double = _port_step(variables, dtype=torch.float64)
    for k in METRICS:
        np.testing.assert_allclose(float(single.metrics[k]), float(double.metrics[k]),
                                   rtol=1e-3, atol=1e-7, err_msg=k)
    got, want = single.state.model.state_dict(), double.state.model.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].double().numpy(), value.numpy(),
                                   atol=3e-5, rtol=0, err_msg=key)


def test_draw_shapes_3d():
    """The step's own draws at 3D: the VNet's bottleneck and two decoder
    outputs per pass, perturbation at the VNet's widths, a 3D VAT draw."""
    cfg = _configure(Config())
    draws = step_chap.draw_step_uniforms(cfg, (B, 1, *PATCH),
                                         torch.Generator().manual_seed(0), "cpu")
    want = dropout_shapes(B - LB, NF, PATCH, 2)
    for name in ("teacher", "student", "fp", "vat"):
        assert [tuple(u.shape) for u in draws["drop"][name]] == want
    # the perturbation takes the second half of the unlabeled rows
    b_u = (B - LB) - (B - LB) // 2
    assert [tuple(u.shape) for u in draws["perturb"][4]] == [(b_u, 16 * NF)] * 2
    assert tuple(draws["vat_d"].shape) == (B - LB, 1, *PATCH)
    assert len(draws["bcp_starts"]) == 3


@pytest.mark.parametrize("kind", ["cps", "supervised"])
def test_cps_and_supervised_steps_match_chap_tpu(monkeypatch, kind):
    """trainer_3d's cps and supervised steps (dual-decoder model, dropout
    draws fed): metrics, parameters and BN stats after one update."""
    images, labels = _batch(11)
    rs = np.random.RandomState(12)
    drop_u = [_draw_u(rs, s) for s in dropout_shapes(B, NF, PATCH, 2)]
    jcfg = _configure(JaxConfig())
    model, opt, state, variables = _jax_state(jcfg, sim_chns=())
    monkeypatch.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(
        jax_dropout_feed(drop_u, jcfg.model.s2d_stem))))
    build = jax_cps if kind == "cps" else jax_supervised
    want = jax.device_get(build(model, opt, jcfg)(state, {
        "image": jnp.asarray(ndhwc(images)),
        "label": jnp.asarray(labels.astype(np.uint8))}, jax.random.PRNGKey(1)))

    cfg = update_values(dataclasses.asdict(jcfg), Config())
    port, popt = _port_model(cfg, variables)
    pstate = TrainState(0, port, popt, [])
    build = build_cps3d_train_step if kind == "cps" else build_supervised3d_train_step
    got = build(port, popt, cfg, device="cpu")(
        pstate, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels.astype(np.uint8))},
        draws={"drop": [torch.from_numpy(u) for u in drop_u]})
    assert set(got.metrics) == set(want.metrics)
    for k in want.metrics:
        np.testing.assert_allclose(float(got.metrics[k]), float(want.metrics[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    _check_state(port, want.state, atol=1e-4)
    _check_update(_before(variables), port, want.state)
    assert got.state.step == int(want.state.step) == 1
