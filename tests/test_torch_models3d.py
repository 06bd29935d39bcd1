"""The port's VNet family, its upsampling and its weight carrier, held
against chap_tpu's on the same numpy-seeded inputs, weights and dropout /
perturbation draws (CPU), with chap_tpu's s2d stem on and off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.perturb as jax_perturb
import chap_tpu.models.vnet3d as jax_vnet3d
from chap_tpu.config import ModelConfig as JaxModelConfig
from chap_tpu.convert.torch_import import convert_state_dict
from chap_tpu.models import net_factory_3d as jax_net_factory_3d
from chap_tpu.models.layers import upsample2x_nearest as jax_nearest
from chap_tpu.models.layers import upsample2x_trilinear as jax_trilinear
from chap_tpu.ops.s2d import space_to_depth_3d
from chap_tpu_torch.config import ModelConfig
from chap_tpu_torch.convert.from_jax import (_conv_weight, _deconv_weight,
                                             state_dict_from_flax)
from chap_tpu_torch.models import perturb, vnet3d
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.models.layers import (BN_MOMENTUM, upsample2x_nearest,
                                          upsample2x_trilinear)
from test_torch_models import JaxFeed, RandomFeed

torch.set_num_threads(1)

NF = 4
ATOL = 5e-4          # the port's fp32 forward bar against chap_tpu


def assert_close(got, want, err_msg=""):
    """|got - want| <= 5e-4 x max(1, peak |want|), for train-mode passes
    (eval mode holds 5e-4 absolute). A random-init VNet in train mode gives logits up to ~30 at these shapes, and fp32 alone moves
    them by up to 1e-3: the port's own fp32 and fp64 forwards differ by
    0.8e-3 on a peak of 15.4 (16^3, batch 4), chap_tpu's fp32 and the port's
    fp64 by 1.1e-3. So the bar is 5e-4 of the output's scale, which is the
    absolute bar for outputs of magnitude <= 1."""
    want = np.asarray(want)
    tol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=err_msg)


FAMILY = {"vnet": "vnet", "dualdecoder": "dualdecoder3d"}


def ndhwc(x):
    """Port layout [B, C, X, Y, Z] -> chap_tpu's [B, X, Y, Z, C]."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), 1, -1))


def ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def jax_dropout_feed(drop_u, s2d_stem):
    """The port's drop_u [x5, decoder outputs ...] (NCDHW numpy) as the
    uniforms chap_tpu's bernoulli calls consume, in order. Under the s2d
    stem the transpose-conv decoder applies its output dropout in
    space-to-depth layout, so that draw is relaid the same way."""
    out = [ndhwc(drop_u[0])]
    decoders = drop_u[1:]
    for i, u in enumerate(decoders):
        u = ndhwc(u)
        transpose_conv = i == len(decoders) - 1
        if s2d_stem and transpose_conv:
            u = np.asarray(space_to_depth_3d(jnp.asarray(u)))
        out.append(u)
    return out


def flax_model(name, s2d_stem, spatial, seed=0, mode="train"):
    cfg = JaxModelConfig()
    cfg.n_filters_3d = NF
    cfg.s2d_stem = s2d_stem
    model = jax_net_factory_3d(name, 1, 2, mode=mode, cfg=cfg)
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                          jnp.zeros((2, *spatial, 1))))
    rs = np.random.RandomState(seed + 1)
    # non-trivial running stats, so eval mode tests the buffers too
    stats = jax.tree.map(lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def port_model(name, variables, mode="train"):
    cfg = ModelConfig()
    cfg.n_filters_3d = NF
    model = net_factory_3d(name, 1, 2, mode=mode, cfg=cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family=FAMILY[name]))
    return model


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("spatial", [(1, 1, 1), (2, 2, 1), (8, 8, 4), (16, 16, 8)])
def test_upsampling_matches_chap_tpu(spatial):
    """align_corners trilinear, with chap_tpu's scale 2.0 on axes of size 1,
    and nearest, up to 32 x 32 x 16."""
    x = np.random.RandomState(0).randn(2, *spatial, 3).astype(np.float32)
    want = np.asarray(jax_trilinear(jnp.asarray(x)))
    got = upsample2x_trilinear(ncdhw(x)).numpy()
    np.testing.assert_allclose(ndhwc(got), want, atol=1e-5, rtol=0)
    want = np.asarray(jax_nearest(jnp.asarray(x), (1, 2, 3)))
    np.testing.assert_array_equal(ndhwc(upsample2x_nearest(ncdhw(x)).numpy()), want)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_upblock_modes_match_chap_tpu(mode):
    """UpBlock3d's deconv, trilinear and nearest modes, with BatchNorm, train
    and eval, from a 1x1x1 and a 4x4x2 input."""
    for spatial in ((1, 1, 1), (4, 4, 2)):
        block = jax_vnet3d.UpBlock3d(6, "batchnorm", mode)
        x = np.random.RandomState(mode).randn(3, *spatial, 8).astype(np.float32)
        v = jax.device_get(block.init(jax.random.PRNGKey(mode), jnp.asarray(x),
                                      train=False))
        port = vnet3d.UpBlock3d(8, 6, "batchnorm", mode)
        conv_name = "ConvTranspose_0" if mode == 0 else "Conv_0"
        conv = v["params"][conv_name]
        weight = (_deconv_weight if mode == 0 else _conv_weight)(
            np.asarray(conv["kernel"]))
        conv_mod, bn = (port.conv[0], port.conv[1]) if mode == 0 else (
            port.conv[1], port.conv[2])
        with torch.no_grad():
            conv_mod.weight.copy_(torch.from_numpy(weight.copy()))
            conv_mod.bias.copy_(torch.from_numpy(np.asarray(conv["bias"])))
            bn.weight.copy_(torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["scale"])))
            bn.bias.copy_(torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["bias"])))
        for train in (False, True):
            want = block.apply(v, jnp.asarray(x), train=train,
                               mutable=["batch_stats"] if train else False)
            want = np.asarray(want[0] if train else want)
            port.train(train)
            with torch.no_grad():
                got = port(ncdhw(x), {} if train else None).numpy()
            np.testing.assert_allclose(ndhwc(got), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s2d_stem", [True, False])
@pytest.mark.parametrize("name", ["vnet", "dualdecoder"])
@pytest.mark.parametrize("spatial", [(16, 16, 16), (32, 32, 16)])
def test_vnet_eval_forward_matches_chap_tpu(name, s2d_stem, spatial):
    """Eval mode (running stats, no dropout); 16^3 has a 1x1x1 bottleneck
    and 32x32x16 a 2x2x1 one."""
    jmodel, variables = flax_model(name, s2d_stem, spatial, mode="test")
    x = np.random.RandomState(3).randn(2, *spatial, 1).astype(np.float32)
    want = _outputs(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = port_model(name, variables, mode="test").eval()
    with torch.no_grad():
        got = _outputs(model(ncdhw(x)))
    assert len(got) == len(want) == (2 if name == "dualdecoder" else 1)
    for j, t in zip(want, got):
        np.testing.assert_allclose(ndhwc(t.numpy()), np.asarray(j), atol=ATOL, rtol=0)


def _drop_draws(rs, name, rows, spatial):
    decoders = 2 if name == "dualdecoder" else 1
    return [rs.rand(*s).astype(np.float32)
            for s in vnet3d.dropout_shapes(rows, NF, spatial, decoders)]


@pytest.mark.parametrize("s2d_stem", [True, False])
@pytest.mark.parametrize("name", ["vnet", "dualdecoder"])
def test_vnet_train_forward_and_bn_stats(monkeypatch, name, s2d_stem):
    """Train mode with the bottleneck and decoder-output dropout fed to both,
    batch-stat normalisation, and the running stats after one pass (Flax
    momentum, biased variance); the forward leaves the buffers alone."""
    spatial = (16, 16, 16)
    jmodel, variables = flax_model(name, s2d_stem, spatial)
    rs = np.random.RandomState(4)
    x = rs.randn(4, *spatial, 1).astype(np.float32)
    drop_u = _drop_draws(rs, name, 4, spatial)
    monkeypatch.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(
        jax_dropout_feed(drop_u, s2d_stem))))
    out, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
    model = port_model(name, variables).train()
    stats = {}
    with torch.no_grad():
        got = _outputs(model(ncdhw(x), drop_u=[torch.from_numpy(u) for u in drop_u],
                             stats=stats))
    for j, t in zip(_outputs(out), got):
        assert_close(ndhwc(t.numpy()), j)
    want = state_dict_from_flax(variables["params"], jax.device_get(upd["batch_stats"]),
                                family=FAMILY[name])
    buffers = dict(model.named_buffers())
    assert len(stats) == sum(k.endswith("running_mean") for k in buffers) > 0
    for key, (mean, var) in stats.items():
        for part, batch in (("running_mean", mean), ("running_var", var)):
            new = BN_MOMENTUM * buffers[f"{key}.{part}"] + (1 - BN_MOMENTUM) * batch
            assert_close(new.numpy(), want[f"{key}.{part}"].numpy(),
                         err_msg=f"{key}.{part}")
    before = state_dict_from_flax(variables["params"], variables["batch_stats"],
                                  family=FAMILY[name])
    for key, value in before.items():
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value.numpy())


@pytest.mark.parametrize("s2d_stem", [True, False])
@pytest.mark.parametrize("comp_drop", [False, True])
def test_dualdecoder3d_perturbed_forward(monkeypatch, s2d_stem, comp_drop):
    """The channel-perturbed forward (every level, GradSim scores) with the
    perturbation and dropout draws fed to both; under chap_tpu's s2d stem
    the full-resolution skip is perturbed through its phase view."""
    spatial = (16, 16, 16)
    jmodel, variables = flax_model("dualdecoder", s2d_stem, spatial)
    rs = np.random.RandomState(5)
    x = rs.randn(4, *spatial, 1).astype(np.float32)
    chns = tuple(NF * m for m in (1, 2, 4, 8, 16))
    scores = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in chns]
    shapes = perturb.perturb_draw_shapes(4, chns, (0, 1, 2, 3, 4), [True] * 5,
                                         comp_drop)
    pdraws = [[np.asarray(rs.rand(*s), np.float32) for s in lvl] for lvl in shapes]
    drop_u = _drop_draws(rs, "dualdecoder", 4, spatial)
    monkeypatch.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(
        jax_dropout_feed(drop_u, s2d_stem))))
    monkeypatch.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
        [u for lvl in pdraws for u in lvl])))
    (j1, j2), _ = jmodel.apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1), "perturb": jax.random.PRNGKey(2)},
        dropout_level=(0, 1, 2, 3, 4), scores=[jnp.asarray(s) for s in scores],
        comp_dropout=comp_drop)
    model = port_model("dualdecoder", variables).train()
    with torch.no_grad():
        t1, t2 = model(ncdhw(x), drop_u=[torch.from_numpy(u) for u in drop_u],
                       dropout_level=(0, 1, 2, 3, 4),
                       scores=[torch.from_numpy(s) for s in scores],
                       comp_dropout=comp_drop,
                       perturb_draws=[[torch.from_numpy(u) for u in lvl]
                                      for lvl in pdraws], stats={})
    for j, t in ((j1, t1), (j2, t2)):
        assert_close(ndhwc(t.numpy()), j)


@pytest.mark.parametrize("name", ["vnet", "dualdecoder"])
def test_state_dict_round_trip_3d(name):
    """state_dict_from_flax then chap_tpu's convert_state_dict gives the
    original Flax trees back exactly, and the port's module names are the
    converter's keys."""
    _, variables = flax_model(name, True, (16, 16, 16))
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              family=FAMILY[name])
    back = convert_state_dict(FAMILY[name], sd, variables)
    for part in ("params", "batch_stats"):
        la, ta = jax.tree.flatten(variables[part])
        lb, tb = jax.tree.flatten(back[part])
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(port_model(name, variables).state_dict()) == set(sd)


def test_factory_3d_keys_and_dtype():
    cfg = ModelConfig()
    cfg.n_filters_3d = 2
    assert net_factory_3d("vnet", 1, 2, "test", cfg, device="cpu").num_decoders == 1
    assert net_factory_3d("unet_3D", 1, 2, "test", cfg, device="cpu").num_decoders == 1
    with pytest.raises(ValueError, match="unknown 3D net_type"):
        net_factory_3d("unet_2D", 1, 2, "test", cfg, device="cpu")
