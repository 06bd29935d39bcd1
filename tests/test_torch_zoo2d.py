"""The port's 2D model zoo (every net_factory key), its weight carrier, the
single-decoder supervised step, the ds / adv / polyp predictors,
fmeasure_calu and cli.test_2d on a zoo snapshot, held against chap_tpu on
the same numpy-seeded inputs, weights and random draws (CPU).

Models are built directly at small widths: the UNet family at feature_chns
(4, 8, 16, 16, 32), PNet at 8 filters, DSNet's projection at 16, SwinUNet
at img_size 64 (embed_dim 12, depths (2, 2, 2), window 4, so the shifted
windows engage at 16^2 and 8^2); ResUNet, ENet and EfficientUNet-b0 have
fixed widths and run at them. Every draw chap_tpu makes inside a module
(Flax's nn.Dropout, ``make_rng`` in enet.py, unet2d.py and perturb.py) is
fed the test's uniforms through ``jax.random`` stand-ins (RandomFeed), so
the train-mode passes are held to chap_tpu with the same masks."""
import dataclasses
import functools
import json
import os

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.enet as jax_enet
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.models.unet2d as jax_unet2d
from chap_tpu.config import Config as JaxConfig
from chap_tpu.convert.torch_import import (convert_efficientnet_pretrained,
                                           convert_state_dict)
from chap_tpu.eval import eval2d as jax_eval2d
from chap_tpu.metrics.fmeasure import fmeasure_calu as jax_fmeasure_calu
from chap_tpu.models import factory as jax_factory
from chap_tpu.models.dsnet import DSNet as JaxDSNet
from chap_tpu.models.efficientunet import EffiUNet as JaxEffiUNet
from chap_tpu.models.enet import ENet as JaxENet
from chap_tpu.models.pnet import PNet2D as JaxPNet2D
from chap_tpu.models.resunet2d import ResUNet2d as JaxResUNet2d
from chap_tpu.models.swin_unet import SwinUNet as JaxSwinUNet
from chap_tpu.models.unet2d import UNet as JaxUNet
from chap_tpu.models.unet2d import UNetCCT as JaxUNetCCT
from chap_tpu.models.unet2d import UNetPlus as JaxUNetPlus
from chap_tpu.models.unet2d import UNetURPC as JaxUNetURPC
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu.train.step_supervised import \
    build_supervised_train_step as jax_supervised
from chap_tpu_torch.cli import test_2d as cli_test
from chap_tpu_torch.cli import train_2d as cli_train
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import (FAMILIES_2D, _deconv_weight,
                                             state_dict_from_flax)
from chap_tpu_torch.data.datasets import SyntheticVolumeDataset, phantom_batch
from chap_tpu_torch.eval import eval2d
from chap_tpu_torch.metrics.fmeasure import fmeasure_calu
from chap_tpu_torch.models.dsnet import DSNet
from chap_tpu_torch.models.efficientunet import EffiUNet, tf_same_pad
from chap_tpu_torch.models.enet import ENet
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.layers import set_compute_dtype
from chap_tpu_torch.models.pnet import PNet2D
from chap_tpu_torch.models.resunet2d import ResUNet2d
from chap_tpu_torch.models.swin_unet import SwinUNet
from chap_tpu_torch.models.unet2d import UNet, UNetCCT, UNetPlus, UNetURPC
from chap_tpu_torch.train import trainer_2d
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.step_supervised import build_supervised_train_step
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_models import JaxFeed, RandomFeed
from test_torch_trainer_zoo3d import (LEAF_UPDATE_RTOL, NOISE_UPDATE, PARAM_ATOL,
                                      RTOL, UPDATE_RTOL)
from test_torch_zoo3d import check_folded_stats

torch.set_num_threads(1)

ATOL = 5e-4          # the port's fp32 forward bar against chap_tpu
CHNS = (4, 8, 16, 16, 32)
SWIN = dict(img_size=64, embed_dim=12, depths=(2, 2, 2), num_heads=(2, 4, 8),
            window_size=4)

# key -> (chap_tpu module, port module, input side)
ZOO = {
    "unet": (lambda: JaxUNet(4, feature_chns=CHNS),
             lambda: UNet(1, 4, CHNS), 32),
    "unetp": (lambda: JaxUNetPlus(4, feature_chns=CHNS),
              lambda: UNetPlus(1, 4, CHNS), 32),
    "unet_cct": (lambda: JaxUNetCCT(4, feature_chns=CHNS),
                 lambda: UNetCCT(1, 4, CHNS), 32),
    "unet_urpc": (lambda: JaxUNetURPC(4, feature_chns=CHNS),
                  lambda: UNetURPC(1, 4, CHNS), 32),
    "resunet": (lambda: JaxResUNet2d(4), lambda: ResUNet2d(1, 4), 32),
    "dual_student": (lambda: JaxDSNet(4, project_dim=16),
                     lambda: DSNet(1, 4, project_dim=16), 32),
    "swinunet": (lambda: JaxSwinUNet(4, **SWIN), lambda: SwinUNet(1, 4, **SWIN), 64),
    "enet": (lambda: JaxENet(4), lambda: ENet(1, 4), 32),
    "pnet": (lambda: JaxPNet2D(4, num_filters=8), lambda: PNet2D(1, 4, 8), 32),
    "efficient_unet": (lambda: JaxEffiUNet(4), lambda: EffiUNet(1, 4), 64),
}
OUTPUTS = {"unet_cct": 4, "unet_urpc": 4, "dual_student": 2}
TRAIN_OUTPUTS = {"unetp": 2, "unet_cct": 4, "unet_urpc": 4, "dual_student": 3}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def flatten(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def init_flax(model, hw, seed=0):
    """chap_tpu's variables, initialised in train mode (DSNet's attention
    and projector are set-up modules only its train pass reaches), with
    non-trivial running stats so eval mode tests the buffers too."""
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1),
            "perturb": jax.random.PRNGKey(2)}
    v = jax.device_get(model.init(rngs, jnp.zeros((2, hw, hw, 1)), train=True))
    rs = np.random.RandomState(seed + 1)
    stats = jax.tree.map(lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v.get("batch_stats", {}))
    return {"params": v["params"], "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def flax_pair(key):
    """chap_tpu's model and variables of a key, made once (Flax's init is
    most of a small test's time); the tests do not change them."""
    jmake, _, hw = ZOO[key]
    jmodel = jmake()
    return jmodel, init_flax(jmodel, hw)


def zoo_pair(key):
    """(chap_tpu's model, its variables, the port's model carrying them,
    the input side)."""
    jmodel, variables = flax_pair(key)
    _, pmake, hw = ZOO[key]
    port = pmake()
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family=key))
    return jmodel, variables, port, hw


def make_draws(port, rows, hw, rs):
    """The port's uniforms for one train pass: (drop_u, perturb_u)."""
    drop = [np.asarray(rs.rand(*s), np.float32)
            for s in port.dropout_shapes(rows, (hw, hw))]
    pert = ([np.asarray(rs.rand(*s), np.float32)
             for s in port.perturb_shapes(rows, (hw, hw))]
            if hasattr(port, "perturb_shapes") else [])
    return drop, pert


def chap_tpu_feeds(key, drop, pert):
    """The feeds that give chap_tpu the port's draws: {chap_tpu module:
    uniforms in its call order, in its layout}."""
    n = len(CHNS)
    if key == "enet":
        feeds = {jax_enet: [u.transpose(0, 2, 3, 1) for u in drop]}
    elif key == "dual_student":     # the students' NCHW draws, the tokens' as they are
        feeds = {flax_stochastic: [nhwc(u) for u in drop[:10]] + drop[10:]}
    else:
        feeds = {flax_stochastic: [nhwc(u) for u in drop]}
    if key == "unet_cct":           # noise x 5, fraction x 5 | dropout x 5
        feeds[jax_perturb] = ([u.transpose(1, 2, 0) for u in pert[:n]]
                              + pert[2 * n:])
        feeds[jax_unet2d] = [nhwc(u) for u in pert[n:2 * n]]
    elif key == "unet_urpc":        # dropout | fraction, noise
        feeds[jax_unet2d] = [nhwc(pert[0])]
        feeds[jax_perturb] = [pert[1], pert[2].transpose(1, 2, 0)]
    return feeds


def draws(port, key, rows, hw, rs):
    drop, pert = make_draws(port, rows, hw, rs)
    return drop, pert, chap_tpu_feeds(key, drop, pert)


def feed_chap_tpu(monkeypatch, feeds):
    for module, uniforms in feeds.items():
        if module is flax_stochastic:
            monkeypatch.setattr(flax_stochastic, "random", RandomFeed(uniforms))
        else:
            monkeypatch.setattr(module, "jax", JaxFeed(RandomFeed(uniforms)))


def port_kwargs(drop, pert):
    kw = {"drop_u": [torch.from_numpy(u) for u in drop]}
    if pert:
        kw["perturb_u"] = [torch.from_numpy(u) for u in pert]
    return kw


def assert_outputs(got, want, key, what):
    got, want = flatten(got), flatten(want)
    assert len(got) == len(want), (key, what, len(got), len(want))
    for i, (t, j) in enumerate(zip(got, want)):
        t = t.detach().numpy()
        j = np.asarray(j)
        if t.ndim == 4:
            t = nhwc(t)
        assert t.shape == j.shape, (key, what, i, t.shape, j.shape)
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0,
                                   err_msg=f"{key} {what} output {i}")


# ---------------------------------------------------------------------------
# the factory and the forwards
# ---------------------------------------------------------------------------

def test_factory_builds_every_chap_tpu_key():
    """The port's net_factory takes exactly chap_tpu's 2D keys with its
    constructor arguments (the output count and shape at 64^2, 224^2 for
    swinunet); an unknown key raises and lists them; model.dtype=bfloat16
    builds enet (as every key: tests/test_torch_bf16.py) and it gives bf16
    logits over float32 parameters."""
    keys = ("unet", "unetp", "dualdecoder", "acalnet", "unet_cct", "unet_urpc",
            "resunet", "dual_student", "swinunet", "enet", "pnet",
            "efficient_unet")
    jcfg = JaxConfig()
    for key in keys:
        jax_factory.net_factory(key, 1, 4, jcfg.model)     # chap_tpu has it
        model = net_factory(key, 1, 4, device="cpu").eval()
        hw = 224 if key == "swinunet" else 64
        with torch.no_grad():
            out = flatten(model(torch.zeros(1, 1, hw, hw)))
        assert len(out) == {"dualdecoder": 2, "acalnet": 2}.get(key, OUTPUTS.get(key, 1))
        assert all(o.shape == (1, 4, hw, hw) for o in out)
    with pytest.raises(ValueError, match="efficient_unet"):
        net_factory("unet_2dbcp", 1, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown 2D net_type"):
        jax_factory.net_factory("unet_2dbcp", 1, 4, jcfg.model)
    cfg = Config()
    cfg.model.dtype = "bfloat16"
    enet = net_factory("enet", 1, 4, cfg.model, device="cpu").eval()
    with torch.no_grad():
        logits = enet(torch.zeros(1, 1, 64, 64))
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 4, 64, 64)
    assert all(p.dtype == torch.float32 for p in enet.parameters())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", list(ZOO))
def test_zoo_forward_matches_chap_tpu(monkeypatch, key, train):
    """Every output in eval mode (running stats) and in train mode (batch
    statistics, every draw fed to both); in train mode the new running
    statistics too. CCT perturbs in eval mode as well, so it is fed there
    too."""
    jmodel, variables, port, hw = zoo_pair(key)
    rs = np.random.RandomState(7)
    x = rs.randn(2, hw, hw, 1).astype(np.float32)
    drop, pert, feeds = draws(port, key, 2, hw, rs)
    rngs = {"dropout": jax.random.PRNGKey(3), "perturb": jax.random.PRNGKey(4)}
    if not train:       # CCT's perturbations alone
        feeds = {m: u for m, u in feeds.items()
                 if key == "unet_cct" and m is not flax_stochastic}
    feed_chap_tpu(monkeypatch, feeds)
    if not train:
        want = jmodel.apply(variables, jnp.asarray(x), train=False, rngs=rngs)
        kw = port_kwargs(drop, pert) if feeds else {}
        kw.pop("drop_u", None)
        port.eval()
        with torch.no_grad():
            got = port(nchw(x), **kw)
        assert len(flatten(got)) == OUTPUTS.get(key, 1)
    else:
        want, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"], rngs=rngs)
        port.train()
        stats = {}
        with torch.no_grad():
            got = port(nchw(x), stats=stats, **port_kwargs(drop, pert))
        assert len(flatten(got)) == TRAIN_OUTPUTS.get(key, 1)
    assert_outputs(got, want, key, "train" if train else "eval")
    for module in feeds:
        feed = flax_stochastic.random if module is flax_stochastic else module.jax.random
        assert not feed.queue, f"{key}: chap_tpu left fed draws of {module.__name__}"
    if train and stats:
        check_folded_stats(port, stats, state_dict_from_flax(
            variables["params"], jax.device_get(upd["batch_stats"]), family=key))
    elif train:
        assert key == "swinunet" and not jax.tree.leaves(upd)


# the UNet family's keys but the DualDecoder's (which tests/test_torch_bf16.py
# holds; the other keys: tests/test_torch_bf16_zoo2d.py) and chap_tpu's
# module of each
BF16_ZOO = {"unet": JaxUNet, "unetp": JaxUNetPlus, "unet_cct": JaxUNetCCT,
            "unet_urpc": JaxUNetURPC}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", list(BF16_ZOO))
def test_unet_family_bf16_matches_chap_tpu(monkeypatch, key, train):
    """model.dtype=bfloat16 on the UNet family: every output, in eval and
    in train mode (every draw fed to both; CCT perturbs in eval mode too),
    against chap_tpu's module in bf16 over the same float32 weights, within
    tests/test_torch_bf16.py's bar (twice chap_tpu's own bf16-against-
    float32 gap, and visibly not float32). The perturbation uniforms lie on
    bf16's grid, which chap_tpu's bf16 ``jax.random.uniform`` draws on."""
    from test_torch_bf16 import BF, bf16_grid_uniform, hold_bf16, to_bf16
    _, variables = flax_pair(key)
    _, _, port, hw = zoo_pair(key)
    rs = np.random.RandomState(9)
    x = to_bf16(rs.randn(2, hw, hw, 1).astype(np.float32))
    drop, pert = make_draws(port, 2, hw, rs)
    pert = [np.asarray(bf16_grid_uniform(rs, np.shape(u)), np.float32) for u in pert]
    feeds = chap_tpu_feeds(key, drop, pert)
    kw = port_kwargs(drop, pert)
    if not train:       # CCT's perturbations alone
        feeds = {m: u for m, u in feeds.items()
                 if key == "unet_cct" and m is not flax_stochastic}
        kw = {"perturb_u": kw["perturb_u"]} if feeds else {}
    rngs = {"dropout": jax.random.PRNGKey(3), "perturb": jax.random.PRNGKey(4)}
    want = {}
    for dt in (jnp.float32, BF):
        feed_chap_tpu(monkeypatch, feeds)
        jmodel = BF16_ZOO[key](4, feature_chns=CHNS, dtype=dt)
        out = jmodel.apply(variables, jnp.asarray(x, dt), train=train, rngs=rngs,
                           mutable=["batch_stats"] if train else False)
        want[dt] = flatten(out[0] if train else out)
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(port, dt).train(train)
        with torch.no_grad():
            got[dt] = flatten(port(nchw(x).to(dt), **kw, **({"stats": {}} if train else {})))
    assert len(got[torch.bfloat16]) == len(want[BF]) == (TRAIN_OUTPUTS if train
                                                         else OUTPUTS).get(key, 1)
    for i, (t, j) in enumerate(zip(got[torch.bfloat16], want[BF])):
        assert t.dtype == torch.bfloat16 and j.dtype == BF, (key, i)
        hold_bf16(f"{key} output {i}", t.permute(0, 2, 3, 1), j,
                  want[jnp.float32][i], got[torch.float32][i].permute(0, 2, 3, 1))


def test_feature_dropout_threshold_is_float32_in_bf16(monkeypatch):
    """chap_tpu's feature_dropout compares bf16 attention with a float32
    threshold (its fraction is a float32 draw): at fraction 0.72 a pixel of
    attention 0.71875, which is 0.72 rounded to bf16, is kept, where a bf16
    threshold would drop it."""
    from chap_tpu_torch.models.perturb import feature_dropout
    x = np.array([1.0, 0.71875], np.float32).reshape(1, 1, 2, 1)
    u = np.float32(0.1)
    monkeypatch.setattr(jax_perturb, "jax", JaxFeed(RandomFeed([np.asarray(u)])))
    want = jax_perturb.feature_dropout(jax.random.PRNGKey(0),
                                       jnp.asarray(x, jnp.bfloat16))
    got = feature_dropout(torch.from_numpy(x.transpose(0, 3, 1, 2)).bfloat16(),
                          torch.tensor(u))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), np.asarray(want, np.float32))
    assert float(got[0, 0, 0, 1]) == 0.71875 and float(got[0, 0, 0, 0]) == 0.0


@pytest.mark.parametrize("key", ["enet", "pnet", "unet_cct"])
def test_fed_draws_reach_the_output(monkeypatch, key):
    """The draws matter: flipping every uniform moves the train-mode output
    in both packages alike (ENet's spatial dropout, PNet's two dropouts,
    CCT's perturbations)."""
    jmodel, variables, port, hw = zoo_pair(key)
    rs = np.random.RandomState(8)
    x = rs.randn(2, hw, hw, 1).astype(np.float32)
    outs = []
    drop, pert = make_draws(port, 2, hw, rs)
    for flip in (False, True):
        d = [np.asarray(1.0 - u if flip else u, np.float32) for u in drop]
        p = [np.asarray(1.0 - u if flip else u, np.float32) for u in pert]
        feed_chap_tpu(monkeypatch, chap_tpu_feeds(key, d, p))
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(3),
                                     "perturb": jax.random.PRNGKey(4)})
        with torch.no_grad():
            got = port.train()(nchw(x), **port_kwargs(d, p))
        assert_outputs(got, want, key, f"flip={flip}")
        outs.append(flatten(got)[-1])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2


def test_enet_head_matches_flax_same_transposed_conv():
    """ENet's 3x3 stride-2 head: Flax's ConvTranspose 'SAME' pads the
    dilated input (2, 1); the port's padding 0 then the last row and column
    dropped gives the same map, odd sizes too."""
    import flax.linen as fnn
    rs = np.random.RandomState(9)
    for h, w in ((8, 8), (5, 7)):
        x = rs.randn(2, h, w, 3).astype(np.float32)
        layer = fnn.ConvTranspose(4, (3, 3), strides=(2, 2))
        v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(layer.apply(v, jnp.asarray(x)))
        port = torch.nn.ConvTranspose2d(3, 4, 3, 2, padding=0)
        port.load_state_dict({
            "weight": torch.from_numpy(np.ascontiguousarray(
                _deconv_weight(np.asarray(v["params"]["kernel"])))),
            "bias": torch.from_numpy(np.array(v["params"]["bias"]))})
        with torch.no_grad():
            got = port(nchw(x))[:, :, :2 * h, :2 * w]
        np.testing.assert_allclose(nhwc(got.numpy()), want, atol=1e-5, rtol=0)


def test_tf_same_padding_is_flax_same():
    """TF-SAME: a stride-2 conv pads (0, 1) for k = 3 and (1, 2) for k = 5 on
    an even side, more before on none; the port's padded conv equals
    Flax's padding='SAME' conv on even and odd sides."""
    import flax.linen as fnn
    rs = np.random.RandomState(10)
    for k in (3, 5):
        for side in (16, 15):
            x = rs.randn(1, side, side, 2).astype(np.float32)
            layer = fnn.Conv(3, (k, k), strides=2, padding="SAME", use_bias=False)
            v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
            want = np.asarray(layer.apply(v, jnp.asarray(x)))
            w = torch.from_numpy(np.ascontiguousarray(
                np.transpose(np.asarray(v["params"]["kernel"]), (3, 2, 0, 1))))
            got = torch.nn.functional.conv2d(tf_same_pad(nchw(x), k, 2), w, stride=2)
            np.testing.assert_allclose(nhwc(got.numpy()), want, atol=1e-5)


def test_swinunet_takes_its_img_size_only():
    """The token grid is fixed at construction (chap_tpu's reshape,
    swin_unet.py:303): another input size raises."""
    port = SwinUNet(1, 4, **SWIN).eval()
    with pytest.raises(ValueError, match="64"):
        port(torch.zeros(1, 1, 32, 32))


@pytest.mark.parametrize("key", list(FAMILIES_2D))
def test_carrier_names_every_port_tensor(key):
    """state_dict_from_flax fills every parameter and buffer of the port's
    module (strict load), and holds nothing else."""
    _, variables, port, _ = zoo_pair(key)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              family=key)
    assert set(sd) == set(port.state_dict())


@pytest.mark.parametrize("key", ["unet", "unetp", "swinunet"])
def test_round_trip_through_chap_tpu_converter(key):
    """state_dict_from_flax then chap_tpu's convert_state_dict (the torch
    names of its unet / unetp / swinunet families) gives the Flax trees
    back exactly."""
    jmodel, variables, _, _ = zoo_pair(key)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              family=key)
    if key == "swinunet":
        from chap_tpu.convert.torch_import import apply_rules, swinunet_rules
        back = {"params": jax.tree.map(np.zeros_like, variables["params"])}
        apply_rules(swinunet_rules(SWIN["depths"]), sd, back["params"], {})
    else:
        back = convert_state_dict(key, sd, variables)
    for name in variables:
        if not variables[name]:
            continue
        la, ta = jax.tree.flatten(variables[name])
        lb, tb = jax.tree.flatten(back[name])
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_efficientnet_encoder_round_trip():
    """The port's EfficientUNet encoder state, its ``encoder.`` prefix
    dropped, is a lukemelas b0 state dict: chap_tpu's
    convert_efficientnet_pretrained (efficientnet_b0_rules) carries it back
    onto the Flax encoder exactly."""
    _, variables, port, _ = zoo_pair("efficient_unet")
    enc = {k[len("encoder."):]: v for k, v in port.state_dict().items()
           if k.startswith("encoder.") and not k.endswith("num_batches_tracked")}
    blank = jax.tree.map(np.zeros_like, variables)
    back = convert_efficientnet_pretrained(enc, blank, in_chns=1)
    for name in ("params", "batch_stats"):
        la, ta = jax.tree.flatten(variables[name]["encoder"])
        lb, tb = jax.tree.flatten(back[name]["encoder"])
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the single-decoder supervised step
# ---------------------------------------------------------------------------

def check_update(key, before, port, want_state):
    """tests/test_torch_trainer_zoo3d.py's bars on one step: every value
    after it at rtol 2e-3 (1e-4 absolute); each leaf's update within 5% of
    its norm (1e-6 absolute below that), all updates together within 2%.
    ENet's PReLU slopes are held together, as one vector within 5%: a
    slope's gradient is one sum of x * dy over every negative
    pre-activation of its layer, whose terms cancel to a small part of
    their absolute sum, so float32's rounding upstream moves one slope's
    update by up to 35% of it (6e-6 of a slope of 0.25, on the CPU, with
    the loss equal to 1e-6)."""
    after = state_dict_from_flax(want_state.params, want_state.batch_stats,
                                 family=key)
    got = port.state_dict()
    assert set(got) == set(after)
    err2 = norm2 = 0.0
    slopes = []
    for name, value in after.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        want_d = (value - before[name]).double()
        got_d = (got[name] - before[name]).double()
        if ".prelu" in name:
            slopes.append((got_d, want_d))
        else:
            err = (got_d - want_d).norm().item()
            norm = want_d.norm().item()
            bar = LEAF_UPDATE_RTOL * norm if norm > NOISE_UPDATE else NOISE_UPDATE
            assert err <= bar, f"{name}: update off by {err:.3e}, its norm {norm:.3e}"
        if not name.endswith(("running_mean", "running_var")):
            err2 += float(((got_d - want_d) ** 2).sum())
            norm2 += float((want_d ** 2).sum())
    if slopes:
        g, w = (torch.cat([pair[i].reshape(-1) for pair in slopes]) for i in (0, 1))
        assert (g - w).norm() <= LEAF_UPDATE_RTOL * w.norm(), "PReLU slopes"
    assert norm2 > 0
    assert err2 ** 0.5 <= UPDATE_RTOL * norm2 ** 0.5

def _step_cfg(b, hw):
    jcfg = JaxConfig()
    jcfg.model.feature_chns = CHNS
    jcfg.data.num_classes = 4
    jcfg.data.batch_size = b
    jcfg.data.image_size = (hw, hw)
    return jcfg, update_values(dataclasses.asdict(jcfg), Config())


@pytest.mark.parametrize("key", ["unet", "pnet", "enet"])
def test_single_decoder_step_matches_chap_tpu(monkeypatch, key):
    """One step of a model of one output against chap_tpu's dual=False
    step from the same weights and draws: the loss at
    rtol 2e-3, every parameter and BN running statistic after it, and the
    update, with tests/test_torch_trainer_zoo3d.py's bars (rtol 2e-3 on the
    values; each leaf's update within 5% of its norm, all of them together
    within 2%: a BN bias's one-step update is a near-cancelling sum of
    1e-4, which float32's summation order moves by 1e-6)."""
    b = 4
    jmodel, _, port, hw = zoo_pair(key)
    jcfg, cfg = _step_cfg(b, hw)
    opt = jax_make_optimizer(jcfg.optim.base_lr, jcfg.optim.max_iterations,
                             jcfg.optim.momentum, jcfg.optim.weight_decay,
                             jcfg.optim.poly_power)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(0),
                                   jnp.zeros((b, hw, hw, 1)), opt)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family=key))
    rs = np.random.RandomState(11)
    images, labels = phantom_batch(rs, b, hw, 4)
    drop, _, feeds = draws(port, key, b, hw, rs)
    feed_chap_tpu(monkeypatch, feeds)
    want = jax.device_get(jax_supervised(jmodel, opt, jcfg, dual=False)(
        state, {"image": jnp.asarray(images.transpose(0, 2, 3, 1)),
                "label": jnp.asarray(labels.astype(np.uint8))},
        jax.random.PRNGKey(1)))
    popt = make_optimizer(port, cfg.optim.base_lr, cfg.optim.momentum,
                          cfg.optim.weight_decay)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = build_supervised_train_step(port, popt, cfg, device="cpu")(
        create_train_state(port, popt),
        {"image": torch.from_numpy(images),
         "label": torch.from_numpy(labels.astype(np.uint8))},
        draws={"drop": [torch.from_numpy(u) for u in drop]})
    np.testing.assert_allclose(float(got.metrics["loss"]),
                               float(want.metrics["loss"]), rtol=2e-3)
    check_update(key, before, port, want.state)
    assert got.state.step == int(want.state.step) == 1


def test_single_decoder_step_launches_and_draws(monkeypatch):
    """One K1 loss a step (R = 1), and the draws made at the model's own
    dropout_shapes when none are given."""
    from chap_tpu_torch.losses import dice as port_dice
    calls = []
    real = port_dice.dice_ce_supervised
    monkeypatch.setattr("chap_tpu_torch.train.step_supervised.dice_ce_supervised",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    _, cfg = _step_cfg(2, 32)
    port = PNet2D(1, 4, 8)
    opt = make_optimizer(port, 0.01)
    images, labels = phantom_batch(np.random.RandomState(12), 2, 32, 4)
    out = build_supervised_train_step(port, opt, cfg, device="cpu")(
        create_train_state(port, opt), {"image": torch.from_numpy(images),
                                        "label": torch.from_numpy(labels)},
        torch.Generator().manual_seed(0))
    assert calls == [(2, 4, 32, 32)] and np.isfinite(float(out.metrics["loss"]))


@pytest.mark.parametrize("key", ["unetp", "unet_cct", "unet_urpc",
                                 "dual_student", "dualdecoder"])
def test_single_decoder_step_refuses_several_outputs(monkeypatch, key):
    """A model other than the DualDecoder whose train pass returns more than
    logits is refused by its class name before any update (chap_tpu's
    dual=False step fails on it); the DualDecoder trains as the dual step,
    one K1 loss on each of its two outputs."""
    from chap_tpu_torch.losses import dice as port_dice
    calls = []
    real = port_dice.dice_ce_supervised
    monkeypatch.setattr("chap_tpu_torch.train.step_supervised.dice_ce_supervised",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    _, cfg = _step_cfg(2, 32)
    model = net_factory(key, 1, 4, cfg.model, device="cpu")
    opt = make_optimizer(model, 0.01)
    state = create_train_state(model, opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    images, labels = phantom_batch(np.random.RandomState(13), 2, 32, 4)
    step = build_supervised_train_step(model, opt, cfg, device="cpu")
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    if key == "dualdecoder":
        out = step(state, batch, torch.Generator().manual_seed(0))
        assert calls == [(2, 4, 32, 32)] * 2 and out.state.step == 1
        return
    with pytest.raises(ValueError, match=type(model).__name__):
        step(state, batch, torch.Generator().manual_seed(0))
    assert calls == [] and state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_chap_tpu_single_step_fails_on_unetp():
    """What the refusal replicates: chap_tpu's dual=False step on UNetPlus
    hands its (logits, features) tuple to the loss."""
    jcfg, _ = _step_cfg(2, 32)
    jmodel = JaxUNetPlus(4, feature_chns=CHNS)
    opt = jax_make_optimizer(0.01, 10)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(0),
                                   jnp.zeros((2, 32, 32, 1)), opt)
    with pytest.raises(TypeError):
        jax_supervised(jmodel, opt, jcfg, dual=False)(
            state, {"image": jnp.zeros((2, 32, 32, 1)),
                    "label": jnp.zeros((2, 32, 32), jnp.uint8)},
            jax.random.PRNGKey(1))


@pytest.mark.parametrize("mode", ["supervised", "chap", "ablation"])
def test_trainer_refuses_models_of_one_output(tmp_path, mode):
    """trainer_2d and cli.train_2d train the DualDecoder only, as chap_tpu's
    trainer (its supervised mode builds dual=True, trainer_2d.py:82); the
    CLI refuses before it makes a run dir."""
    cfg = Config()
    cfg.model.name = "unet"
    with pytest.raises(ValueError, match="'unet'"):
        trainer_2d.train(cfg, str(tmp_path), mode=mode, device="cpu")
    root = tmp_path / "runs"
    with pytest.raises(ValueError, match="'enet'"):
        cli_train.main(["--device", "cpu", "--dataset", "synthetic", "--model",
                        "enet", "--mode", mode, f"run.snapshot_root={root}"])
    assert not root.exists()


# ---------------------------------------------------------------------------
# the predictors, fmeasure and cli.test_2d
# ---------------------------------------------------------------------------

class _Fed(torch.nn.Module):
    """A port model whose forward takes fixed perturbation draws, so its
    predictor sees chap_tpu's CCT perturbations."""

    def __init__(self, model, perturb_u):
        super().__init__()
        self.model, self.perturb_u = model, perturb_u

    def forward(self, x):
        return self.model(x, perturb_u=self.perturb_u)


class _JaxFed:
    """chap_tpu's model with its 'perturb' rng given: chap_tpu's
    make_predictor passes none, and UNetCCT's forward asks for one even in
    eval mode (unet2d.py:215), so chap_tpu's predictor cannot run it
    unaided."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, x, train):
        return self.model.apply(variables, x, train=train,
                                rngs={"perturb": jax.random.PRNGKey(5)})


def test_chap_tpu_predictor_needs_a_perturb_rng_for_cct():
    jmodel, variables, _, hw = zoo_pair("unet_cct")
    with pytest.raises(Exception, match="perturb"):
        jax_eval2d.make_predictor(jmodel, "logit_ensemble")(
            variables, jnp.zeros((1, hw, hw, 1)))


@pytest.mark.parametrize("case", ["cct_logit_ensemble", "cct_prob_ensemble",
                                  "urpc_model2", "dsnet_logit_ensemble",
                                  "ds_urpc", "ds_unet", "ds_dsnet"])
def test_predictors_match_chap_tpu(monkeypatch, case):
    """make_predictor's ensembles over outputs 0 and 1 (CCT's main map and
    first perturbed aux map, URPC's main and first deep-supervision map,
    DSNet's two students) and make_ds_predictor's output 0, against
    chap_tpu's on the same weights (and CCT's perturbations): >= 99.9% of
    label pixels agree, as tests/test_torch_eval.py holds."""
    net, kind = case.split("_", 1)
    key = {"cct": "unet_cct", "urpc": "unet_urpc", "dsnet": "dual_student",
           "unet": "unet"}[kind.split("_")[0] if net == "ds" else net]
    jmodel, variables, port, hw = zoo_pair(key)
    rs = np.random.RandomState(13)
    x = rs.randn(6, hw, hw, 1).astype(np.float32)
    jm = jmodel
    if key == "unet_cct":
        _, pert, feeds = draws(port, key, 6, hw, rs)
        # the eval forward draws as chap_tpu's jit traces it: once
        feed_chap_tpu(monkeypatch, {m: u for m, u in feeds.items()
                                    if m is not flax_stochastic})
        port = _Fed(port, [torch.from_numpy(u) for u in pert])
        jm = _JaxFed(jmodel)
    if net == "ds":
        predict = eval2d.make_ds_predictor(port, device="cpu")
        j_predict = jax_eval2d.make_ds_predictor(jm)
    else:
        predict = eval2d.make_predictor(port, kind, device="cpu")
        j_predict = jax_eval2d.make_predictor(jm, kind)
    got = predict(nchw(x)).numpy()
    want = np.asarray(j_predict(variables, jnp.asarray(x)))
    assert got.dtype == want.dtype == np.int8
    agree = float(np.mean(got == want))
    assert agree >= 0.999, f"{case}: {agree:.5f}"
    assert len(np.unique(got)) > 1


@pytest.fixture(scope="module")
def dual_models():
    from test_torch_models import _flax_model, _port_model
    jmodel, variables = _flax_model("mcnet", hw=32)
    return jmodel, variables, _port_model(variables, "mcnet")


@pytest.mark.parametrize("decoder", ["model1", "model2"])
def test_adv_predictor_and_slice_eval_match_chap_tpu(dual_models, decoder):
    """make_adv_predictor (the encoder, then one decoder) and test_single_adv
    over a synthetic volume against chap_tpu's."""
    jmodel, variables, port = dual_models
    vol = SyntheticVolumeDataset((6, 32, 32), 4, length=1)[0]
    x = np.asarray(vol["image"], np.float32)[..., None]
    got = eval2d.make_adv_predictor(port, decoder, device="cpu")(nchw(x)).numpy()
    want = np.asarray(jax_eval2d.make_adv_predictor(jmodel, decoder)(
        variables, jnp.asarray(x)))
    assert float(np.mean(got == want)) >= 0.999
    mine = eval2d.test_single_adv(vol["image"], vol["label"], port, 4, (32, 32),
                                  decoder, device="cpu")
    theirs = jax_eval2d.test_single_adv(vol["image"], vol["label"], jmodel,
                                        variables, 4, (32, 32), decoder)
    np.testing.assert_allclose(np.array(mine), np.array(theirs), rtol=1e-6)
    with pytest.raises(ValueError, match="model3"):
        eval2d.make_adv_predictor(port, "model3", device="cpu")


@pytest.mark.parametrize("channels", [None, 3])
def test_polyp_evals_match_chap_tpu(dual_models, channels):
    """The whole-image binary Dice of test_single_adv_polyp and
    test_single_volume_polyp against chap_tpu's, on a [H, W] image and on
    an [H, W, C] one (taken as channels, as chap_tpu takes it)."""
    jmodel, variables, port = dual_models
    rs = np.random.RandomState(14)
    image = rs.rand(32, 32).astype(np.float32)
    label = (rs.rand(32, 32) > 0.5).astype(np.uint8)
    if channels:
        image = np.repeat(image[..., None], channels, axis=-1)
        from test_torch_models import _flax_model
        jmodel, variables = _flax_model("mcnet", hw=32)
        variables = jax.device_get(jmodel.init(jax.random.PRNGKey(3),
                                               jnp.zeros((1, 32, 32, 3))))
        from chap_tpu_torch.models.unet2d import DualDecoder
        port = DualDecoder(3, 4, "mcnet", (4, 8, 16, 16, 32))
        port.load_state_dict(state_dict_from_flax(variables["params"],
                                                  variables["batch_stats"]))
    mine = eval2d.test_single_adv_polyp(image, label, port, "model2", device="cpu")
    theirs = jax_eval2d.test_single_adv_polyp(image, label, jmodel, variables,
                                              "model2")
    assert mine == pytest.approx(theirs, abs=2e-3)
    predict = eval2d.make_predictor(port, "logit_ensemble", device="cpu")
    j_predict = jax_eval2d.make_predictor(jmodel, "logit_ensemble")
    mine = eval2d.test_single_volume_polyp(image, label, predict)
    theirs = jax_eval2d.test_single_volume_polyp(image, label, j_predict, variables)
    assert mine == pytest.approx(theirs, abs=2e-3)


@pytest.mark.parametrize("case", ["overlap", "exact", "disjoint", "empty_pred",
                                  "empty_gt", "all"])
def test_fmeasure_matches_chap_tpu(case):
    """fmeasure_calu's six figures equal chap_tpu's, tp = 0 (all zeros)
    included."""
    rs = np.random.RandomState(15)
    gt = (rs.rand(16, 16) > 0.6).astype(np.uint8)
    pred = {"overlap": (rs.rand(16, 16) > 0.5).astype(np.int8),
            "exact": gt.astype(np.int8), "disjoint": (1 - gt).astype(np.int8),
            "empty_pred": np.zeros((16, 16), np.int8),
            "empty_gt": (rs.rand(16, 16) > 0.5).astype(np.int8),
            "all": np.ones((16, 16), np.int8)}[case]
    if case == "empty_gt":
        gt = np.zeros_like(gt)
    mine, theirs = fmeasure_calu(pred, gt), jax_fmeasure_calu(pred, gt)
    assert mine == theirs
    if case in ("disjoint", "empty_pred", "empty_gt"):
        assert mine == (0.0,) * 6


@pytest.mark.parametrize("key", ["pnet", "unet_cct"])
def test_cli_test_2d_evaluates_a_zoo_snapshot(tmp_path, key):
    """cli.test_2d restores a snapshot of a zoo key (its config.json names
    the model; no GradSim scores assumed) and evaluates it: per-class
    (dice, hd95, asd, jc), performance.txt appended. CCT, of four outputs,
    under each ensemble of outputs 0 and 1."""
    cfg = Config()
    cfg.model.name = key
    cfg.model.feature_chns = CHNS
    cfg.data.dataset = "synthetic"
    cfg.data.image_size = (32, 32)
    torch.manual_seed(0)
    model = net_factory(key, 1, 4, cfg.model, device="cpu")
    state = create_train_state(model, make_optimizer(model, 0.01))
    CheckpointManager(str(tmp_path)).save_best(state)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    kinds = ["logit_ensemble", "model2"] if key == "unet_cct" else ["model1"]
    for kind in kinds:
        mean = cli_test.main(["--snapshot", str(tmp_path), "--device", "cpu",
                              "--model_type", kind])
        assert mean.shape == (3, 4) and np.isfinite(mean[:, 0]).all()
    lines = open(os.path.join(tmp_path, "performance.txt")).read().splitlines()
    assert [line.split(":")[0] for line in lines] == [f"best {k}" for k in kinds]
