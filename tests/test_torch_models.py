"""The port's DualDecoder, weight carrier and channel perturbation, held
against chap_tpu on the same numpy-seeded inputs and weights (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.perturb as jax_perturb
from chap_tpu.convert.torch_import import convert_state_dict
from chap_tpu.models.unet2d import DualDecoder as JaxDualDecoder
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.models import perturb
from chap_tpu_torch.models.layers import BN_MOMENTUM
from chap_tpu_torch.models.unet2d import DualDecoder

torch.set_num_threads(1)

CHNS = (4, 8, 16, 16, 32)
DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


class RandomFeed:
    """Stands in for ``jax.random`` in one chap_tpu module: split / fold_in
    are the real ones, bernoulli / uniform return the test's numpy uniforms
    in call order (JAX's bernoulli(key, p) is uniform(key) < p)."""

    split = staticmethod(jax.random.split)
    fold_in = staticmethod(jax.random.fold_in)

    def __init__(self, uniforms):
        self.queue = list(uniforms)

    def _next(self, shape):
        u = self.queue.pop(0)
        assert u.size == int(np.prod(shape)), (u.shape, shape)
        return jnp.asarray(u).reshape(shape)

    def bernoulli(self, key, p=0.5, shape=None):
        return self._next(jnp.shape(p) if shape is None else shape) < p

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return self._next(shape).astype(dtype) * (maxval - minval) + minval


class JaxFeed:
    """A ``jax`` module whose ``random`` is a RandomFeed."""

    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


def _flax_model(decoder_type, dropout=DROPOUT, seed=0, hw=32):
    model = JaxDualDecoder(num_classes=4, decoder_type=decoder_type,
                           feature_chns=CHNS, dropout=dropout)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, hw, hw, 1)))
    variables = jax.device_get(variables)
    rs = np.random.RandomState(seed + 1)
    # non-trivial running stats, so eval mode tests the buffers too
    stats = jax.tree.map(lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
                         if a.ndim else a, variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def _port_model(variables, decoder_type, dropout=DROPOUT):
    model = DualDecoder(1, 4, decoder_type, CHNS, dropout)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], decoder_type))
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("decoder_type", ["mcnet", "same", "plus"])
def test_dualdecoder_eval_forward(decoder_type):
    jmodel, variables = _flax_model(decoder_type)
    x = np.random.RandomState(3).randn(2, 32, 32, 1).astype(np.float32)
    j1, j2 = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = _port_model(variables, decoder_type).eval()
    with torch.no_grad():
        t1, t2 = model(_nchw(x))
    for j, t in ((j1, t1), (j2, t2)):
        np.testing.assert_allclose(t.numpy(), np.transpose(np.asarray(j), (0, 3, 1, 2)),
                                   atol=5e-4, rtol=0)


def test_dualdecoder_train_forward_and_bn_stats(monkeypatch):
    """Train mode with encoder dropout on (draws fed to both), batch-stat
    normalisation, and the running stats after one pass (Flax momentum and
    biased variance)."""
    jmodel, variables = _flax_model("mcnet")
    rs = np.random.RandomState(4)
    x = rs.randn(4, 32, 32, 1).astype(np.float32)
    # one dropout draw per encoder level, NHWC, in call order
    shapes = [(4, 32 >> i, 32 >> i, c) for i, c in enumerate(CHNS)]
    uniforms = [rs.rand(*s).astype(np.float32) for s in shapes]
    import flax.linen.stochastic as stochastic
    monkeypatch.setattr(stochastic, "random", RandomFeed(uniforms))
    (j1, j2), upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(1)})
    model = _port_model(variables, "mcnet").train()
    stats = {}
    with torch.no_grad():
        t1, t2 = model(_nchw(x), drop_u=[_nchw(u) for u in uniforms], stats=stats)
    for j, t in ((j1, t1), (j2, t2)):
        np.testing.assert_allclose(t.numpy(), np.transpose(np.asarray(j), (0, 3, 1, 2)),
                                   atol=5e-4, rtol=0)
    want = state_dict_from_flax(variables["params"], jax.device_get(upd["batch_stats"]))
    buffers = dict(model.named_buffers())
    for key, (mean, var) in stats.items():
        for name, batch in (("running_mean", mean), ("running_var", var)):
            new = BN_MOMENTUM * buffers[f"{key}.{name}"] + (1 - BN_MOMENTUM) * batch
            np.testing.assert_allclose(new.numpy(), want[f"{key}.{name}"].numpy(),
                                       atol=5e-4, rtol=0, err_msg=f"{key}.{name}")
    # the forward itself never touches the buffers
    for key, value in state_dict_from_flax(variables["params"],
                                           variables["batch_stats"]).items():
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value.numpy())


@pytest.mark.parametrize("decoder_type", ["mcnet", "same"])
def test_state_dict_round_trip(decoder_type):
    """state_dict_from_flax then chap_tpu's convert_state_dict gives the
    original Flax trees back exactly."""
    _, variables = _flax_model(decoder_type)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              decoder_type)
    back = convert_state_dict("dualdecoder", sd, variables,
                              decoder_type=decoder_type)
    for name in ("params", "batch_stats"):
        la, ta = jax.tree.flatten(variables[name])
        lb, tb = jax.tree.flatten(back[name])
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the port's module names are exactly the converter's keys
    model = DualDecoder(1, 4, decoder_type, CHNS)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("scores_kind", ["none", "zeros", "ramp"])
@pytest.mark.parametrize("comp_drop", [False, True])
def test_perform_dropout_matches_chap_tpu(monkeypatch, scores_kind, comp_drop):
    rs = np.random.RandomState(5)
    b = 6
    feats = [rs.randn(b, 8 >> (i // 2), 8 >> (i // 2), c).astype(np.float32)
             for i, c in enumerate(CHNS)]
    level = (0, 1, 3, 4)
    if scores_kind == "none":
        scores = None
    elif scores_kind == "zeros":
        scores = [np.zeros(c, np.float32) for c in CHNS]
    else:
        scores = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in CHNS]
    has = [scores is not None] * len(CHNS)
    shapes = perturb.perturb_draw_shapes(b, CHNS, level, has, comp_drop)
    draws = [[np.asarray(rs.rand(*s), np.float32) for s in lvl] for lvl in shapes]
    flat = [u for lvl in draws for u in lvl]
    monkeypatch.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(flat)))
    j1, j2 = jax_perturb.perform_dropout(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats], level,
        None if scores is None else [jnp.asarray(s) for s in scores], comp_drop)
    t1, t2 = perturb.perform_dropout(
        [_nchw(f) for f in feats], level,
        None if scores is None else [torch.from_numpy(s) for s in scores],
        comp_drop, draws=[[torch.from_numpy(u) for u in lvl] for lvl in draws])
    for ja, ta in zip(list(j1) + list(j2), t1 + t2):
        np.testing.assert_allclose(ta.numpy(), np.transpose(np.asarray(ja), (0, 3, 1, 2)),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("comp", [False, True])
def test_drop_masks_exact(monkeypatch, comp):
    """The masks themselves (score path), bit for bit."""
    rs = np.random.RandomState(6)
    probs = rs.rand(3, 8).astype(np.float32)
    draws = ([np.asarray(rs.rand(), np.float32)] if comp else []) + [
        rs.rand(3, 8).astype(np.float32), rs.rand(3, 8).astype(np.float32)]
    monkeypatch.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(draws)))
    jm1, jm2 = jax_perturb._drop_based_on_prob(jax.random.PRNGKey(0),
                                               jnp.asarray(probs), comp)
    tm1, tm2 = perturb._drop_based_on_prob(
        torch.from_numpy(probs), comp, [torch.as_tensor(u) for u in draws])
    np.testing.assert_array_equal(tm1.reshape(3, 8).numpy(), np.asarray(jm1).reshape(3, 8))
    np.testing.assert_array_equal(tm2.reshape(3, 8).numpy(), np.asarray(jm2).reshape(3, 8))
