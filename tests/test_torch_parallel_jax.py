"""The port's CHAP step at W = 2 gloo ranks (chap_tpu_torch/parallel/dist.py)
against chap_tpu's CHAP step on a 2-device CPU mesh (parallel/mesh.py, built
as tests/test_parallel.py builds it), from the same Flax weights (carried by
``state_dict_from_flax``) with the same draws fed to both, as
tests/test_torch_step.py holds the one-process step; the same bars.
tests/test_torch_parallel4.py holds W = 4 (one pair-stream unit a rank) to a
4-device mesh with the functions here.

chap_tpu's mesh step is one GSPMD program over the global batch; the port's
ranks each take their rows of it (``rank_rows``) and sum every statistic
over the ranks. The port's ranks run in processes spawned by
``dist.spawn_ranks`` (tests/torch_dist_cases.py).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.train.step_chap as jax_step_chap
import torch_dist_cases as cases
from chap_tpu.config import Config as JaxConfig
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.parallel.mesh import batch_sharding, build_mesh, replicate
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu_torch.config import Config
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi.bcp import generate_mask_nd
from test_torch_models import JaxFeed, RandomFeed
from test_torch_step import (B, C, CHNS, HW, METRICS, STARTS, _configure, _draws,
                             _inputs)

torch.set_num_threads(1)

W = 2


def chap_tpu_inputs():
    """(chap_tpu's model, optimizer and train state, the port's case
    running the same step from the same weights and draws on a rank's
    rows)."""
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
    port_cfg = _configure(Config())
    init = state_dict_from_flax(variables["params"], variables["batch_stats"])
    batches = [{"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}]
    spec = ("chap_tpu", "run_steps", (port_cfg, init,
                                      [torch.from_numpy(s) for s in sim], batches,
                                      [_draws(perturb, vat_u)]))
    return (cfg, model, opt, state), spec


def chap_tpu_mesh_step(built, world):
    """chap_tpu's CHAP step on a ``world``-device CPU mesh, its draws fed
    as tests/test_torch_step.py feeds them."""
    cfg, model, opt, state = built
    images, labels, perturb, vat_u, _ = _inputs()
    mask = np.asarray(generate_mask_nd((HW, HW), STARTS))
    mesh = build_mesh(num_devices=world)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_chap, "generate_mask_nd",
                   lambda rng, spatial: jnp.asarray(mask))
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in perturb for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed(
            [np.ascontiguousarray(vat_u.transpose(0, 2, 3, 1))])))
        step = jax_step_chap.build_chap_train_step(model, opt, cfg, use_nms=True)
        batch = {
            "image": jax.device_put(jnp.asarray(images.transpose(0, 2, 3, 1)),
                                    batch_sharding(mesh, 4)),
            "label": jax.device_put(jnp.asarray(labels.astype(np.uint8)),
                                    batch_sharding(mesh, 3))}
        return jax.device_get(step(replicate(mesh, state), batch,
                                   jax.random.PRNGKey(42)))


def hold_to_chap_tpu(want, ranks):
    """Every rank's step against chap_tpu's mesh step, at
    tests/test_torch_step.py's bars."""
    after = state_dict_from_flax(want.state.params, want.state.batch_stats)
    for got in ranks:
        got = got["chap_tpu"]
        for k in METRICS:
            np.testing.assert_allclose(got["metrics"][0][k], float(want.metrics[k]),
                                       rtol=2e-3, atol=1e-6, err_msg=k)
        # parameters and BN running stats after the SGD update
        for key, value in after.items():
            if key.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(),
                                       atol=1e-4, rtol=0, err_msg=key)
        for g, w in zip(got["sim"], want.state.sim_scores):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)
    assert int(want.state.step) == 1


@pytest.fixture(scope="module")
def steps():
    """(chap_tpu's step on a 2-device mesh, the port's two ranks' results)."""
    built, spec = chap_tpu_inputs()
    # the port's ranks run while chap_tpu compiles its step
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(dist.spawn_ranks, cases.run_cases, W, ([spec],),
                        timeout=300)
    pool.shutdown(wait=False)
    return chap_tpu_mesh_step(built, W), ranks.result()


def test_chap_step_at_two_ranks_matches_chap_tpu_on_a_two_device_mesh(steps):
    hold_to_chap_tpu(*steps)
