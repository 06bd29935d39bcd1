"""The port's ablation step against chap_tpu's build_ablation_train_step
(CPU), with the channel-dropout pass and VAT off and on, from the same
weights with every random draw fed to both (chap_tpu's perturbation and VAT
modules get a ``jax`` whose ``random`` returns the test's numpy uniforms, in
this test only; encoder dropout 0); and trainer_2d's ``ablation`` mode end to
end with its disagreement.csv."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu_torch.train.trainer_2d as t2d
from chap_tpu.config import Config as JaxConfig
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu.train.step_ablation import build_ablation_train_step as jax_ablation
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.step_ablation import (build_ablation_train_step,
                                                draw_ablation_uniforms)
from test_torch_models import JaxFeed, RandomFeed
from test_trainer_e2e import tiny_cfg as jax_tiny_cfg

torch.set_num_threads(1)

CHNS = (4, 8, 16, 16, 32)
B, LB, HW, C = 8, 4, 32, 4
METRICS = ("loss", "sup_loss", "fp_loss", "vat_loss", "disagreement_ratio",
           "consistency_weight")
# the ROADMAP's parity bar (rtol 2e-3); parameters also get an absolute
# 1e-5, 1% of a typical update (lr 0.01 x gradient), for weights near 0
PARAM_ATOL = 1e-5


def _configure(cfg, dropout, adv_noise):
    cfg.data.num_classes = C
    cfg.data.batch_size = B
    cfg.data.labeled_bs = LB
    cfg.data.image_size = (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.model.dropout = (0.0,) * 5
    cfg.semi.dropout = dropout
    cfg.semi.adv_noise = adv_noise
    cfg.semi.consistency = 0.5
    return cfg


def _inputs():
    rs = np.random.RandomState(3)
    images, labels = phantom_batch(rs, B, HW, C)
    shapes = perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    perturb = [[rs.rand(*s).astype(np.float32) for s in lvl] for lvl in shapes]
    vat_u = rs.rand(B - LB, 1, HW, HW).astype(np.float32)
    return images, labels, perturb, vat_u


@pytest.mark.parametrize("dropout,adv_noise", [(False, False), (True, False),
                                               (True, True)])
def test_ablation_step_matches_chap_tpu(monkeypatch, dropout, adv_noise):
    images, labels, perturb, vat_u = _inputs()
    jcfg = _configure(JaxConfig(), dropout, adv_noise)
    model = jax_net_factory("dualdecoder", 1, C, jcfg.model)
    opt = jax_make_optimizer(jcfg.optim.base_lr, jcfg.optim.max_iterations,
                             jcfg.optim.momentum, jcfg.optim.weight_decay,
                             jcfg.optim.poly_power)
    state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                   jnp.zeros((B, HW, HW, 1)), opt, sim_chns=CHNS)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    monkeypatch.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
        [u for lvl in perturb for u in lvl])))
    monkeypatch.setattr(jax_vat, "jax", JaxFeed(RandomFeed(
        [np.ascontiguousarray(vat_u.transpose(0, 2, 3, 1))])))
    step = jax_ablation(model, opt, jcfg)
    want = jax.device_get(step(state, {
        "image": jnp.asarray(images.transpose(0, 2, 3, 1)),
        "label": jnp.asarray(labels.astype(np.uint8))}, jax.random.PRNGKey(1)))

    cfg = _configure(Config(), dropout, adv_noise)
    port = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"]))
    popt = make_optimizer(port, cfg.optim.base_lr, cfg.optim.momentum,
                          cfg.optim.weight_decay)
    sim = [torch.zeros(c) for c in CHNS]
    pstate = TrainState(0, port, popt, sim)
    draws = {"drop": {k: [None] * 5 for k in ("main", "fp", "vat")},
             "perturb": [[torch.from_numpy(u) for u in lvl] for lvl in perturb],
             "vat_d": torch.from_numpy(vat_u)}
    got = build_ablation_train_step(port, popt, cfg, device="cpu")(
        pstate, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels.astype(np.uint8))}, draws=draws)
    assert set(got.metrics) == set(want.metrics) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(got.metrics[k]), float(want.metrics[k]),
                                   rtol=2e-3, atol=1e-6, err_msg=k)
    assert (float(got.metrics["fp_loss"]) > 0) == dropout
    assert (float(got.metrics["vat_loss"]) > 0) == adv_noise
    after = state_dict_from_flax(want.state.params, want.state.batch_stats)
    ours = got.state.model.state_dict()
    for key, value in after.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(ours[key].numpy(), value.numpy(), rtol=2e-3,
                                       atol=PARAM_ATOL, err_msg=key)
    assert got.state.step == int(want.state.step) == 1
    for s in got.state.sim_scores:      # read, never updated
        assert not s.any()


def test_ablation_draws_follow_the_config():
    cfg = _configure(Config(), True, True)
    draws = draw_ablation_uniforms(cfg, (B, 1, HW, HW),
                                   torch.Generator().manual_seed(0), "cpu")
    assert [len(draws["drop"][k]) for k in ("main", "fp", "vat")] == [5, 5, 5]
    assert all(d is None for k in draws["drop"] for d in draws["drop"][k])
    assert [[tuple(u.shape) for u in lvl] for lvl in draws["perturb"]] == \
        perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    assert draws["vat_d"].shape == (B - LB, 1, HW, HW)
    cfg.model.dropout = (0.05, 0.1, 0.2, 0.3, 0.5)
    cfg.semi.dropout = cfg.semi.adv_noise = False
    draws = draw_ablation_uniforms(cfg, (B, 1, HW, HW),
                                   torch.Generator().manual_seed(0), "cpu")
    assert set(draws) == {"drop"}
    assert draws["drop"]["main"][4].shape == (B, 32, HW >> 4, HW >> 4)
    assert draws["drop"]["fp"][0].shape == (B - LB, 4, HW, HW)


def test_ablation_trainer_writes_disagreement_csv(tmp_path):
    cfg = update_values(dataclasses.asdict(jax_tiny_cfg(tmp_path)), Config())
    cfg.semi.dropout = cfg.semi.adv_noise = True
    cfg.optim.max_iterations = cfg.eval.eval_every = 8
    cfg.run.log_every = 2
    result = t2d.train(cfg, str(tmp_path), mode="ablation", device="cpu")
    assert result["steps"] == 8 and result["best_dice"] >= 0
    with open(os.path.join(tmp_path, "disagreement.csv")) as f:
        rows = [line.strip().split(",") for line in f]
    assert rows[0] == ["iteration", "ratio"]
    assert [int(r[0]) for r in rows[1:]] == [2, 4, 6, 8]
    assert all(0.0 <= float(r[1]) <= 1.0 for r in rows[1:])
    assert os.path.isfile(tmp_path / "checkpoints" / "best" / "state.pt")
