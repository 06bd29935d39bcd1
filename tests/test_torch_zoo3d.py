"""The port's 3D model zoo (unet_3D, attention_unet, unet_3D_dv_semi,
voxresnet, vnet_ds, resvnet), VNet's groupnorm / instancenorm, the
jax.image.resize 'linear' the zoo resizes with, the grid-attention gates and
the weight carrier, held against chap_tpu on the same numpy-seeded inputs,
weights and dropout draws (CPU). Models are built directly at small widths
(feature_scale 16, 8 VoxResNet channels, n_filters 4) on 48 x 32 x 16
patches, whose 3 x 2 x 1 bottleneck is not a power of two."""
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.resvnet as jax_resvnet
import chap_tpu.models.vnet3d as jax_vnet3d
from chap_tpu.convert.torch_import import convert_state_dict
from chap_tpu.models import net_factory_3d as jax_net_factory_3d
from chap_tpu.models.attention3d import AttentionUNet3D as JaxAttentionUNet3D
from chap_tpu.models.attention3d import GridAttentionBlock3D as JaxGrid
from chap_tpu.models.attention3d import GridAttentionBlockTORR as JaxTORR
from chap_tpu.models.resvnet import ResVNet as JaxResVNet
from chap_tpu.models.unet3d import UNet3D as JaxUNet3D
from chap_tpu.models.unet3d_dv import UNet3DDvSemi as JaxUNet3DDvSemi
from chap_tpu.models.vnet3d import VNet as JaxVNet
from chap_tpu.models.vnet3d import VNetDS as JaxVNetDS
from chap_tpu.models.voxresnet import VoxResNet as JaxVoxResNet
from chap_tpu_torch.config import ModelConfig
from chap_tpu_torch.convert.from_jax import (_conv_weight, FAMILIES_3D,
                                             state_dict_from_flax)
from chap_tpu_torch.models.attention3d import (AttentionUNet3D,
                                               GridAttentionBlock3D,
                                               GridAttentionBlockTORR,
                                               TORR_MODES)
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.models.layers import BN_MOMENTUM, resize_linear
from chap_tpu_torch.models.resvnet import ResVNet
from chap_tpu_torch.models.unet3d import UNet3D
from chap_tpu_torch.models.unet3d_dv import UNet3DDvSemi
from chap_tpu_torch.models.vnet3d import VNet, VNetDS, _norm
from chap_tpu_torch.models.voxresnet import VoxResNet
from test_torch_models import JaxFeed, RandomFeed
from test_torch_models3d import ncdhw, ndhwc

torch.set_num_threads(1)

ATOL = 5e-4            # the port's fp32 forward bar against chap_tpu
SPATIAL = (48, 32, 16)
NF = 4
KEYS = ("unet_3D", "attention_unet", "unet_3D_dv_semi", "voxresnet",
        "vnet_ds", "resvnet")

# key -> (chap_tpu module, port module, which chap_tpu code draws the dropout)
ZOO = {
    "unet_3D": (lambda: JaxUNet3D(num_classes=2, feature_scale=16),
                lambda: UNet3D(1, 2, feature_scale=16), "flax"),
    "attention_unet": (lambda: JaxAttentionUNet3D(num_classes=2, feature_scale=16),
                       lambda: AttentionUNet3D(1, 2, feature_scale=16), None),
    "unet_3D_dv_semi": (lambda: JaxUNet3DDvSemi(num_classes=2, feature_scale=16),
                        lambda: UNet3DDvSemi(1, 2, feature_scale=16), "flax"),
    "voxresnet": (lambda: JaxVoxResNet(num_classes=2, feature_chns=8),
                  lambda: VoxResNet(1, 2, feature_chns=8), None),
    "vnet_ds": (lambda: JaxVNetDS(num_classes=2, n_filters=NF,
                                  normalization="batchnorm", has_dropout=True),
                lambda: VNetDS(1, 2, NF, "batchnorm", has_dropout=True), "vnet"),
    "resvnet": (lambda: JaxResVNet(num_classes=2, n_filters=NF, has_dropout=True),
                lambda: ResVNet(1, 2, NF, has_dropout=True), "resvnet"),
}


def flatten(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flatten(o)]
    return [out]


def init_flax(model, spatial, seed=0, rows=2):
    v = jax.device_get(model.init({"params": jax.random.PRNGKey(seed)},
                                  jnp.zeros((rows, *spatial, 1)), train=False))
    rs = np.random.RandomState(seed + 1)
    # non-trivial running stats, so eval mode tests the buffers too
    stats = jax.tree.map(lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v.get("batch_stats", {}))
    return {"params": v["params"], "batch_stats": stats}


def zoo_pair(key, seed=0):
    jmake, pmake, feed = ZOO[key]
    jmodel = jmake()
    variables = init_flax(jmodel, SPATIAL, seed)
    port = pmake()
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family=key))
    return jmodel, variables, port, feed


def patch_jax_dropout(monkeypatch, feed, drop_u):
    """chap_tpu's dropout bernoulli draws return the test's uniforms
    (NDHWC), in the order the model makes them."""
    uniforms = [ndhwc(u) for u in drop_u]
    if feed == "flax":
        monkeypatch.setattr(flax_stochastic, "random", RandomFeed(uniforms))
    elif feed == "vnet":
        monkeypatch.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(uniforms)))
    elif feed == "resvnet":
        monkeypatch.setattr(jax_resvnet, "jax", JaxFeed(RandomFeed(uniforms)))


def check_folded_stats(port, stats, want_sd):
    """The port's batch statistics folded with Flax's momentum equal
    chap_tpu's updated running stats; the forward left the buffers alone."""
    buffers = dict(port.named_buffers())
    assert len(stats) == sum(k.endswith("running_mean") for k in buffers) > 0
    for key, (mean, var) in stats.items():
        for part, batch in (("running_mean", mean), ("running_var", var)):
            new = BN_MOMENTUM * buffers[f"{key}.{part}"] + (1 - BN_MOMENTUM) * batch
            np.testing.assert_allclose(new.numpy(), want_sd[f"{key}.{part}"].numpy(),
                                       atol=ATOL, rtol=0, err_msg=f"{key}.{part}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", KEYS)
def test_zoo_forward_matches_chap_tpu(monkeypatch, key, train):
    """Every output (vnet_ds's side heads and resvnet's x6 included) in eval
    mode (running stats) and train mode (batch statistics, dropout fed to
    both); in train mode the new running stats of attention_unet's gates
    and vnet_ds's BatchNorms too."""
    jmodel, variables, port, feed = zoo_pair(key)
    rs = np.random.RandomState(7)
    x = rs.randn(2, *SPATIAL, 1).astype(np.float32)
    if not train:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
        port.eval()
        with torch.no_grad():
            got = port(ncdhw(x))
    else:
        drop_u = [rs.rand(*s).astype(np.float32)
                  for s in port.dropout_shapes(2, SPATIAL)]
        assert len(drop_u) == {"flax": 2, "vnet": 2, "resvnet": 1, None: 0}[feed]
        patch_jax_dropout(monkeypatch, feed, drop_u)
        want, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        port.train()
        stats = {}
        with torch.no_grad():
            got = port(ncdhw(x), drop_u=[torch.from_numpy(u) for u in drop_u],
                       stats=stats)
    want, got = flatten(want), flatten(got)
    assert len(got) == len(want) == {"unet_3D_dv_semi": 4, "vnet_ds": 5,
                                     "resvnet": 2}.get(key, 1)
    for i, (t, j) in enumerate(zip(got, want)):
        assert ndhwc(t.numpy()).shape == np.shape(j)
        np.testing.assert_allclose(ndhwc(t.numpy()), np.asarray(j), atol=ATOL,
                                   rtol=0, err_msg=f"{key} output {i}")
    if train and key in ("attention_unet", "vnet_ds"):
        check_folded_stats(port, stats, state_dict_from_flax(
            variables["params"], jax.device_get(upd["batch_stats"]), family=key))
    elif train:
        assert stats == {} and not jax.tree.leaves(upd)


def test_dropout_draws_reach_the_output(monkeypatch):
    """The fed draws matter: unet_3D's train-mode logits move when one
    dropout draw changes, in both packages alike."""
    jmodel, variables, port, feed = zoo_pair("unet_3D")
    rs = np.random.RandomState(8)
    x = rs.randn(2, *SPATIAL, 1).astype(np.float32)
    drop_u = [rs.rand(*s).astype(np.float32) for s in port.dropout_shapes(2, SPATIAL)]
    outs = []
    for u1 in (drop_u[1], 1.0 - drop_u[1]):
        patch_jax_dropout(monkeypatch, feed, [drop_u[0], u1])
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(1)})
        with torch.no_grad():
            got = port.train()(ncdhw(x), drop_u=[torch.from_numpy(drop_u[0]),
                                                 torch.from_numpy(u1)])
        np.testing.assert_allclose(ndhwc(got.numpy()), np.asarray(want), atol=ATOL)
        outs.append(got)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["groupnorm", "instancenorm"])
def test_vnet_norms_match_chap_tpu(monkeypatch, norm, train):
    """VNet with chap_tpu's Flax GroupNorm (16 groups, n_filters 16) and
    affine-free instancenorm (n_filters 4), chap_tpu's s2d stem on, from
    the same weights (random GroupNorm scales and biases) and draws."""
    nf = 16 if norm == "groupnorm" else NF
    spatial = (16, 16, 16)
    jmodel = JaxVNet(num_classes=2, n_filters=nf, normalization=norm,
                     has_dropout=True)
    variables = init_flax(jmodel, spatial)
    rs = np.random.RandomState(9)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if "GroupNorm" in jax.tree_util.keystr(p) else a),
        variables["params"])
    port = VNet(1, 2, nf, norm, has_dropout=True)
    port.load_state_dict(state_dict_from_flax(variables["params"], {},
                                              family="vnet", normalization=norm))
    assert not list(port.buffers())
    x = rs.randn(2, *spatial, 1).astype(np.float32)
    drop_u = [rs.rand(*s).astype(np.float32) for s in port.dropout_shapes(2, spatial)]
    # the transpose-conv decoder drops its output in s2d layout under the stem
    from test_torch_models3d import jax_dropout_feed
    monkeypatch.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(
        [np.asarray(u) for u in jax_dropout_feed(drop_u, True)])))
    want = jmodel.apply(variables, jnp.asarray(x), train=train,
                        rngs={"dropout": jax.random.PRNGKey(1)})
    port.train(train)
    with torch.no_grad():
        got = port(ncdhw(x), drop_u=[torch.from_numpy(u) for u in drop_u], stats={})
    np.testing.assert_allclose(ndhwc(got.numpy()), np.asarray(want), atol=ATOL, rtol=0)


def _flax_norm(norm):
    import flax.linen as nn
    if norm == "groupnorm":
        return nn.GroupNorm(num_groups=16)
    return nn.GroupNorm(num_groups=None, group_size=1, use_bias=False,
                        use_scale=False)


def _f64_norm(x, groups, eps):
    """[B, C, ...] float64, two-pass variance."""
    g = x.astype(np.float64).reshape(x.shape[0], groups, -1)
    y = (g - g.mean(-1, keepdims=True)) / np.sqrt(g.var(-1, keepdims=True) + eps)
    return y.reshape(x.shape)


@pytest.mark.parametrize("norm", ["groupnorm", "instancenorm"])
def test_norm_epsilon_and_variance(norm):
    """Flax's epsilon 1e-6 and its one-pass variance.

    Centred input of variance 9e-4: the eps of 1e-5 torch would default to
    moves the output by 1.5e-2; the port holds chap_tpu at 5e-4.

    Input of mean 10, std 0.1: Flax's E[x^2] - E[x]^2 cancels in float32
    and chap_tpu's output is 3e-2 off the float64 value; torch's two-pass
    group_norm in the port is within 2e-5 of it. So the port is held to
    float64 at 5e-5 (eps 1e-5 would be 2e-3 off), and to chap_tpu at
    chap_tpu's own distance from float64 plus 5e-4: the bar follows the
    reference's error, as for VNet's BatchNorm (tests/test_torch_step3d.py)."""
    groups = 16 if norm == "groupnorm" else 32
    rs = np.random.RandomState(10)
    layer = _norm(norm, 32)
    for mean, std in ((0.0, 0.03), (10.0, 0.1)):
        x = (mean + std * rs.randn(2, 32, 6, 5, 7)).astype(np.float32)
        xj = jnp.asarray(np.moveaxis(x, 1, -1))
        jmod = _flax_norm(norm)
        want = np.moveaxis(np.asarray(jmod.apply(jmod.init(jax.random.PRNGKey(0), xj),
                                                 xj)), -1, 1)
        got = layer(torch.from_numpy(x)).detach().numpy()
        exact = _f64_norm(x, groups, 1e-6)
        assert np.abs(_f64_norm(x, groups, 1e-5) - exact).max() > 1e-3
        np.testing.assert_allclose(got, exact, atol=5e-5, rtol=0)
        ref_err = float(np.abs(want - exact).max())
        if mean == 0.0:
            assert ref_err < 1e-5
        else:
            assert ref_err > 1e-2, "the input no longer shows the one-pass variance"
        np.testing.assert_allclose(got, want, atol=ATOL + ref_err, rtol=0)


@pytest.mark.parametrize("shapes", [
    ((5, 7, 3), (7, 5, 3)), ((4, 4, 4), (8, 8, 8)), ((12, 12, 12), (96, 96, 96)),
    ((6, 9, 5), (4, 3, 11)), ((3, 3, 3), (1, 2, 3)), ((5, 6), (13, 4))])
def test_resize_linear_matches_jax_image_resize(shapes):
    """Up, down (JAX's antialiased kernel) and mixed, at sizes that are not
    powers of two, in 3D and 2D."""
    src, dst = shapes
    x = np.random.RandomState(11).randn(2, 3, *src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + dst, "linear"))
    got = resize_linear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def _carry_gate(port, v, names=("theta", "phi", "psi")):
    """Flax gate params -> the port's gate (convs, W conv, W BatchNorm)."""
    p = v["params"]
    with torch.no_grad():
        for n in names:
            if n in p:
                conv = getattr(port, n)
                conv.weight.copy_(torch.from_numpy(_conv_weight(np.asarray(p[n]["kernel"])).copy()))
                if "bias" in p[n]:
                    conv.bias.copy_(torch.from_numpy(np.array(p[n]["bias"])))
        if "W" in p:
            conv = port.W[0] if isinstance(port.W, torch.nn.Sequential) else port.W
            conv.weight.copy_(torch.from_numpy(_conv_weight(np.asarray(p["W"]["kernel"])).copy()))
            conv.bias.copy_(torch.from_numpy(np.array(p["W"]["bias"])))
        if "BatchNorm_0" in p:
            bn = port.W[1]
            bn.weight.copy_(torch.from_numpy(np.asarray(p["BatchNorm_0"]["scale"]) + 0.3))
            bn.bias.copy_(torch.from_numpy(np.asarray(p["BatchNorm_0"]["bias"]) + 0.1))
            p["BatchNorm_0"] = {"scale": np.asarray(p["BatchNorm_0"]["scale"]) + 0.3,
                                "bias": np.asarray(p["BatchNorm_0"]["bias"]) + 0.1}


@pytest.mark.parametrize("mode", ["concatenation", "concatenation_debug",
                                  "concatenation_residual"])
def test_grid_attention_gate_at_odd_sizes(mode):
    """GridAttentionBlock3D in train mode on a 10 x 6 x 14 skip gated by a
    3 x 5 x 4 signal: phi(g) is resized onto the 5 x 3 x 7 grid (up on two
    axes, down on one) and the gate back up onto the skip."""
    rs = np.random.RandomState(12)
    x = rs.randn(2, 10, 6, 14, 6).astype(np.float32)
    g = rs.randn(2, 3, 5, 4, 5).astype(np.float32)
    block = JaxGrid(4, mode=mode)
    v = jax.device_get(block.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.asarray(g), train=False))
    v = {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}
    port = GridAttentionBlock3D(6, 5, 4, mode=mode)
    _carry_gate(port, v)
    (wy, gate), _ = block.apply(v, jnp.asarray(x), jnp.asarray(g), train=True,
                                mutable=["batch_stats"])
    port.W[1].stats_key = "W.1"
    with torch.no_grad():
        got_wy, got_gate = port.train()(ncdhw(x), ncdhw(g), {})
    np.testing.assert_allclose(ndhwc(got_gate.numpy()), np.asarray(gate),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ndhwc(got_wy.numpy()), np.asarray(wy), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("mode", TORR_MODES)
def test_torr_gate_modes_match_chap_tpu(mode, dims):
    """GridAttentionBlockTORR's five gate normalisations in 2D and 3D, with
    sub-sampling 2 (phi strided like theta) on odd sizes, psi's bias at its
    mode's initial value, and W + BatchNorm in train mode."""
    rs = np.random.RandomState(13)
    sx = (9, 6, 7)[:dims]
    sg = (4, 5, 3)[:dims]
    x = rs.randn(2, *sx, 4).astype(np.float32)
    g = rs.randn(2, *sg, 3).astype(np.float32)
    if mode == "concatenation_mean":   # a positive psi keeps the sum away from 0
        x, g = np.abs(x), np.abs(g)
    block = JaxTORR(5, mode=mode, sub_sample_factor=(2, 2, 2))
    v = jax.device_get(block.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                  jnp.asarray(g), train=False))
    v = {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}
    port = GridAttentionBlockTORR(4, 3, 5, dims=dims, mode=mode,
                                  sub_sample_factor=(2, 2, 2))
    np.testing.assert_array_equal(port.psi.bias.detach().numpy(),
                                  np.asarray(v["params"]["psi"]["bias"]))
    _carry_gate(port, v)
    (wy, gate), _ = block.apply(v, jnp.asarray(x), jnp.asarray(g), train=True,
                                mutable=["batch_stats"])
    to_port = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    with torch.no_grad():
        got_wy, got_gate = port.train()(to_port(x), to_port(g), {})
    back = lambda t: np.moveaxis(t.numpy(), 1, -1)
    np.testing.assert_allclose(back(got_gate), np.asarray(gate), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(back(got_wy), np.asarray(wy), atol=ATOL, rtol=0)


def test_torr_refuses_plain_concatenation():
    with pytest.raises(ValueError, match="unsupported TORR mode"):
        GridAttentionBlockTORR(4, 3, 5, mode="concatenation")


@pytest.mark.parametrize("family", ["vnet_ds", "unet_3D"])
def test_state_dict_round_trip_zoo(family):
    """state_dict_from_flax, then chap_tpu's convert_state_dict, gives the
    Flax trees back exactly; the port's module names are the converter's
    keys."""
    jmake = {"vnet_ds": lambda: JaxVNetDS(num_classes=2, n_filters=NF,
                                          normalization="batchnorm"),
             "unet_3D": lambda: JaxUNet3D(num_classes=2, feature_scale=16)}[family]
    variables = init_flax(jmake(), (32, 32, 16))
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              family=family)
    back = convert_state_dict(family, sd, variables)
    for part in ("params", "batch_stats"):
        la, ta = jax.tree.flatten(variables[part])
        lb, tb = jax.tree.flatten(back.get(part, {}))
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    port = ZOO[family][1]()
    assert set(port.state_dict()) == set(sd)


@pytest.mark.parametrize("key", ["unet_3D", "attention_unet", "voxresnet", "vnet",
                                 "vnet_ds", "dualdecoder", "resvnet",
                                 "unet_3D_dv_semi"])
def test_factory_3d_builds_every_chap_tpu_key(key):
    """net_factory_3d builds each key of chap_tpu's factory with its
    constructor arguments: the carried state dict of chap_tpu's model (at
    its own widths) has the port model's keys and shapes, parameter for
    parameter."""
    jmodel = jax_net_factory_3d(key, 1, 2, mode="train")
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 32, 32, 32, 1)),
                                                train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    family = {"dualdecoder": "dualdecoder3d"}.get(key, key)
    assert family in FAMILIES_3D
    sd = state_dict_from_flax(zeros["params"], zeros.get("batch_stats", {}),
                              family=family,
                              normalization="instancenorm" if key == "resvnet"
                              else "batchnorm")
    port = net_factory_3d(key, 1, 2, "train", ModelConfig(), device="cpu")
    want = port.state_dict()
    assert set(want) == set(sd)
    for name, value in sd.items():
        assert tuple(want[name].shape) == tuple(value.shape), name
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert n_flax == sum(p.numel() for p in port.parameters())


def test_factory_3d_refuses_unknown_keys_and_bf16():
    cfg = ModelConfig()
    with pytest.raises(ValueError, match="unknown 3D net_type"):
        net_factory_3d("unet_2D", 1, 2, "test", cfg, device="cpu")
