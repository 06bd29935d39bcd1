"""One full CHAP step of the port against chap_tpu's build_chap_train_step
(sequential mode), from the same weights with every random draw fed to both
(CPU). chap_tpu's draws are replaced in this test only: its BCP mask is
fixed, and its channel-perturbation and VAT modules get a ``jax`` whose
``random`` returns the test's numpy uniforms."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.train.step_chap as jax_step_chap
from chap_tpu.config import Config as JaxConfig
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
import chap_tpu_torch.train.step_chap as step_chap
from chap_tpu_torch.config import Config
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.semi.bcp import generate_mask_nd
from chap_tpu_torch.train.state import TrainState, make_optimizer
from test_torch_models import JaxFeed, RandomFeed

torch.set_num_threads(1)

CHNS = (4, 8, 16, 16, 32)
B, LB, HW, C = 8, 4, 32, 4
STARTS = (5, 7)
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")


def _configure(cfg):
    cfg.data.num_classes = C
    cfg.data.batch_size = B
    cfg.data.labeled_bs = LB
    cfg.data.image_size = (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.model.dropout = (0.0,) * 5
    cfg.semi.dropout = True
    cfg.semi.adv_noise = True
    cfg.optim.remat = False
    cfg.optim.fused_passes = False
    return cfg


# The step's gradients jump at LeakyReLU's kink: an activation within float32
# rounding of 0 takes slope 1 in one framework and 0.01 in the other, and the
# GradSim cosines (abs 1e-3) feel it. With seed 0 one of ~10^5 activations
# does (max score error 1.4e-3, while chap_tpu agrees with the port run in
# float64 to 1e-6); these inputs stay clear of the kink (max error 6e-7).
SEED = 2


def _inputs():
    rs = np.random.RandomState(SEED)
    images, labels = phantom_batch(rs, B, HW, C)
    shapes = perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    perturb = [[rs.rand(*s).astype(np.float32) for s in lvl] for lvl in shapes]
    vat_u = rs.rand(B - LB, 1, HW, HW).astype(np.float32)
    sim = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in CHNS]
    return images, labels, perturb, vat_u, sim


def _draws(perturb, vat_u):
    return {"bcp_starts": list(STARTS),
            "drop": {name: [None] * 5 for name in ("teacher", "student", "fp", "vat")},
            "perturb": [[torch.from_numpy(u) for u in lvl] for lvl in perturb],
            "vat_d": torch.from_numpy(vat_u)}


def _port_step(variables, images, labels, draws, sim, remat=False,
               capture=None, monkeypatch=None):
    cfg = _configure(Config())
    cfg.optim.remat = remat
    model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]))
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = TrainState(0, model, opt, [torch.from_numpy(s) for s in sim])
    if capture is not None:
        real = step_chap.largest_cc_batch

        def recording(seg, n):
            capture.append(seg.clone())
            out = real(seg, n)
            capture.append(out.clone())
            return out
        monkeypatch.setattr(step_chap, "largest_cc_batch", recording)
    step = step_chap.build_chap_train_step(model, opt, cfg, use_nms=True,
                                           device="cpu")
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    return step(state, batch, draws=copy.copy(draws))


@pytest.fixture(scope="module")
def chap_tpu_step():
    """chap_tpu's step once for the module (one XLA compile): its initial
    variables, the outputs, and the pseudo-labels around its NMS."""
    images, labels, perturb, vat_u, sim = _inputs()
    cfg = _configure(JaxConfig())
    model = jax_net_factory("dualdecoder", 1, C, cfg.model)
    opt = jax_make_optimizer(cfg.optim.base_lr, cfg.optim.max_iterations,
                             cfg.optim.momentum, cfg.optim.weight_decay,
                             cfg.optim.poly_power)
    state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                   jnp.zeros((B, HW, HW, 1)), opt, sim_chns=CHNS)
    state = state.replace(sim_scores=tuple(jnp.asarray(s) for s in sim))
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
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_chap, "generate_mask_nd", lambda rng, spatial: jnp.asarray(mask))
        mp.setattr(jax_step_chap, "largest_cc_batch", record)
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in perturb for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed(
            [np.ascontiguousarray(vat_u.transpose(0, 2, 3, 1))])))
        step = jax_step_chap.build_chap_train_step(model, opt, cfg, use_nms=True)
        batch = {"image": jnp.asarray(images.transpose(0, 2, 3, 1)),
                 "label": jnp.asarray(labels.astype(np.uint8))}
        out = jax.device_get(step(state, batch, jax.random.PRNGKey(42)))
    return variables, out, captured


def test_chap_step_matches_chap_tpu(chap_tpu_step, monkeypatch):
    variables, want, captured = chap_tpu_step
    images, labels, perturb, vat_u, sim = _inputs()
    pseudo = []
    got = _port_step(variables, images, labels, _draws(perturb, vat_u), sim,
                     capture=pseudo, monkeypatch=monkeypatch)
    for k in METRICS:
        np.testing.assert_allclose(float(got.metrics[k]), float(want.metrics[k]),
                                   rtol=2e-3, atol=1e-6, err_msg=k)
    # pseudo-labels before and after the largest-CC cleanup: exact
    assert len(captured) == 1 and len(pseudo) == 2
    np.testing.assert_array_equal(pseudo[0].numpy(), captured[0][0])
    np.testing.assert_array_equal(pseudo[1].numpy(), captured[0][1])
    # parameters and BN running stats after the SGD update
    after = state_dict_from_flax(want.state.params, want.state.batch_stats)
    port = got.state.model.state_dict()
    for key, value in after.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(port[key].numpy(), value.numpy(), atol=1e-4,
                                   rtol=0, err_msg=key)
    for g, w in zip(got.state.sim_scores, want.state.sim_scores):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)
    assert got.state.step == int(want.state.step) == 1


def test_remat_matches_plain_passes(chap_tpu_step):
    """optim.remat (torch.utils.checkpoint around each pass) re-runs the
    forwards in the backward; the step must not change, BN stats included."""
    variables = chap_tpu_step[0]
    images, labels, perturb, vat_u, sim = _inputs()
    draws = _draws(perturb, vat_u)
    plain = _port_step(variables, images, labels, draws, sim, remat=False)
    remat = _port_step(variables, images, labels, draws, sim, remat=True)
    for k in METRICS:
        np.testing.assert_allclose(float(remat.metrics[k]), float(plain.metrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    a, b = plain.state.model.state_dict(), remat.state.model.state_dict()
    for key in a:
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for g, w in zip(remat.state.sim_scores, plain.state.sim_scores):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_gradsim_cadence_and_draws_from_generator():
    """gradsim_every=2 leaves the scores alone off cadence, and a step with
    no draws passed makes them from its generator, reproducibly."""
    cfg = _configure(Config())
    cfg.semi.gradsim_every = 2
    cfg.model.dropout = (0.05, 0.1, 0.2, 0.3, 0.5)
    images, labels, _, _, sim = _inputs()
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
        opt = make_optimizer(model, cfg.optim.base_lr)
        state = TrainState(0, model, opt, [torch.from_numpy(s) for s in sim])
        step = step_chap.build_chap_train_step(model, opt, cfg, device="cpu")
        gen = torch.Generator().manual_seed(3)
        s0 = step(state, batch, gen).state.sim_scores
        out = step(state, batch, gen)
        for a, b in zip(out.state.sim_scores, s0):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not all(np.allclose(a.numpy(), b) for a, b in zip(s0, sim))
        runs.append({k: float(v) for k, v in out.metrics.items()})
    assert runs[0] == runs[1]
