"""The port's models that no factory key reaches (models/{blocks, resnet,
grl, discriminator, extras, gan_legacy, transformer_decoder}.py), the
EfficientNet b0-b7 encoders and mask_selection, held against chap_tpu on
the same numpy-seeded inputs and weights (CPU).

Each model is built at chap_tpu's test widths (tests/test_models_zoo2.py,
test_models_zoo3.py, test_gan_legacy.py, test_transformer_decoder_v1.py),
chap_tpu's variables initialised in train mode (so every head and
BatchNorm exists) with non-trivial running statistics, and carried into
the port by state_dict_from_flax (a strict load). Forwards at 5e-4 in
eval and in train mode (train mode: batch statistics, their folded running
statistics, fed dropout draws); gradients at rtol 2e-3.

The bottleneck ResNets in train mode (F64_TRAIN) are held in float64,
chap_tpu's module at dtype float64 under jax.enable_x64: in float32 both
packages drift from float64 in the deep stages (resnet50 at 4 x 64^2: c4
and c5 6.6e-4 / 1.5e-3 off float64 in chap_tpu, 8.2e-4 / 1.7e-3 in the
port; batch statistics over the 16 rows a c5 channel holds), so their
float32 gap to each other, 2e-3, says nothing of the port. Their eval-mode
forwards are held in float32. The float32 train-mode cases run at sizes
where the last stage's BatchNorm normalises 8 values a channel (at 2, a
train-mode BatchNorm maps any two values to -1 and +1)."""
import functools

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.blocks as jblocks
import chap_tpu.models.discriminator as jdisc
import chap_tpu.models.extras as jextras
import chap_tpu.models.gan_legacy as jgan
import chap_tpu.models.grl as jgrl
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.models.resnet as jresnet
import chap_tpu.models.transformer_decoder as jtd
from chap_tpu.models.efficientunet import EffiUNet as JaxEffiUNet
from chap_tpu.models.efficientunet import get_encoder as jax_get_encoder
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.models import (blocks, discriminator, extras, gan_legacy,
                                   grl, resnet, transformer_decoder)
from chap_tpu_torch.models.efficientunet import EffiUNet, get_encoder
from chap_tpu_torch.models.perturb import filter_dropout_channel, mask_selection
from test_torch_models import JaxFeed, RandomFeed
from test_torch_zoo3d import check_folded_stats

torch.set_num_threads(1)

ATOL = 5e-4          # the port's fp32 forward bar against chap_tpu
GRAD_RTOL = 2e-3     # losses and gradients
CHNS = (4, 8, 16, 16, 32)


def cf(x):
    """Channels-last numpy -> channels-first torch."""
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def cl(t):
    """Channels-first torch -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


# name -> (chap_tpu module, port module, chap_tpu inputs (numpy, channels
# last), carrier family and options, whether it takes train=, outputs
# channels-last in chap_tpu)
def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = {
    "sqex": (lambda: jblocks.SqEx(), lambda: blocks.SqEx(32),
             lambda: [_r(1, 4, 4, 4, 32)], ("sqex", {}), False, True),
    "seblock3d": (lambda: jblocks.SEBlock3d(), lambda: blocks.SEBlock3d(32),
                  lambda: [_r(1, 4, 4, 4, 32)], ("seblock3d", {}), False, True),
    "scse": (lambda: jblocks.SCSEModule(), lambda: blocks.SCSEModule(32),
             lambda: [_r(1, 8, 8, 32)], ("scse", {}), False, True),
    "conv2d_relu": (lambda: jblocks.Conv2dReLU(16), lambda: blocks.Conv2dReLU(32, 16),
                    lambda: [_r(2, 8, 8, 32)], ("conv2d_relu", {}), True, True),
    "resnet18": (lambda: jresnet.resnet18(), lambda: resnet.resnet18(),
                 lambda: [_r(2, 32, 32, 1)], ("resnet", {}), True, True),
    "resnet50": (lambda: jresnet.resnet50(), lambda: resnet.resnet50(),
                 lambda: [_r(2, 32, 32, 1)], ("resnet", {}), True, True),
    "resnext101_32x8d": (lambda: jresnet.resnext101_32x8d(),
                         lambda: resnet.resnext101_32x8d(),
                         lambda: [_r(2, 32, 32, 1)], ("resnet", {}), True, True),
    "resnet18_d": (lambda: jresnet.resnet18_d(), lambda: resnet.resnet18_d(),
                   lambda: [_r(2, 64, 64, 1)], ("resnet", {}), True, True),
    "resnet50_d": (lambda: jresnet.resnet50_d(), lambda: resnet.resnet50_d(),
                   lambda: [_r(2, 32, 32, 1)], ("resnet", {}), True, True),
    "resnet18_3d": (lambda: jresnet.resnet18(), lambda: resnet.resnet18(ndim=3),
                    lambda: [_r(2, 32, 32, 32, 1)], ("resnet", {}), True, True),
    "resnet50_16s_3d": (lambda: jresnet.resnet50_16s(),
                        lambda: resnet.resnet50_16s(ndim=3),
                        lambda: [_r(2, 16, 16, 16, 1)],
                        ("resnet", {"layer4_dilation": 2}), True, True),
    "fc3d_discriminator": (lambda: jdisc.FC3DDiscriminator(num_classes=2),
                           lambda: discriminator.FC3DDiscriminator(2),
                           lambda: [_r(2, 32, 32, 16, 2), _r(2, 32, 32, 16, 1, seed=1)],
                           ("fc3d_discriminator", {}), False, False),
    "fc_discriminator": (lambda: jdisc.FCDiscriminator(num_classes=4),
                         lambda: discriminator.FCDiscriminator(4),
                         lambda: [_r(2, 64, 64, 4)], ("fc_discriminator", {}),
                         False, True),
    "unet_2dbcp": (lambda: jextras.UNet2dBCP(4, feature_chns=CHNS),
                   lambda: extras.UNet2dBCP(1, 4, CHNS),
                   lambda: [_r(2, 32, 32, 1)], ("unet_2dbcp", {}), True, True),
    "unet_tsne": (lambda: jextras.UNetTsne(4), lambda: extras.UNetTsne(1, 4),
                  lambda: [_r(2, 32, 32, 1)], ("unet_tsne", {}), True, True),
    "net_d": (lambda: jextras.NetD(512), lambda: extras.NetD(512),
              lambda: [_r(2, 4, 8, 8)], ("net_d", {}), False, False),
    "tiny_unet3d": (lambda: jextras.TinyUNet3D(2), lambda: extras.TinyUNet3D(1, 2),
                    lambda: [_r(2, 16, 16, 16, 1)], ("tiny_unet3d", {}), True, True),
    "resnet_generator": (lambda: jgan.ResnetGenerator(output_nc=3, ngf=8, n_blocks=2),
                         lambda: gan_legacy.ResnetGenerator(3, 3, ngf=8, n_blocks=2),
                         lambda: [_r(1, 32, 32, 3)], ("resnet_generator", {}),
                         True, True),
    "resnet_generator_in_dropout": (
        lambda: jgan.ResnetGenerator(output_nc=3, ngf=8, n_blocks=2,
                                     norm="instancenorm", use_dropout=True),
        lambda: gan_legacy.ResnetGenerator(3, 3, ngf=8, n_blocks=2,
                                           norm="instancenorm", use_dropout=True),
        lambda: [_r(2, 32, 32, 3)], ("resnet_generator", {"use_dropout": True}),
        True, True),
    "unet_generator": (lambda: jgan.UnetGenerator(output_nc=3, num_downs=5, ngf=8),
                       lambda: gan_legacy.UnetGenerator(3, 3, num_downs=5, ngf=8),
                       lambda: [_r(2, 32, 32, 3)], ("unet_generator", {}), True, True),
    "unet_generator_in_dropout": (
        lambda: jgan.UnetGenerator(output_nc=3, num_downs=7, ngf=4,
                                   norm="instancenorm", use_dropout=True),
        lambda: gan_legacy.UnetGenerator(3, 3, num_downs=7, ngf=4,
                                         norm="instancenorm", use_dropout=True),
        lambda: [_r(2, 128, 128, 3)], ("unet_generator", {}), True, True),
    "nlayer_discriminator": (lambda: jgan.NLayerDiscriminator(ndf=8, n_layers=3),
                             lambda: gan_legacy.NLayerDiscriminator(3, ndf=8, n_layers=3),
                             lambda: [_r(2, 64, 64, 3)], ("nlayer_discriminator", {}),
                             True, True),
    "nlayer_discriminator_sigmoid": (
        lambda: jgan.NLayerDiscriminator(ndf=8, n_layers=3, norm="instancenorm",
                                         use_sigmoid=True),
        lambda: gan_legacy.NLayerDiscriminator(3, ndf=8, n_layers=3,
                                               norm="instancenorm", use_sigmoid=True),
        lambda: [_r(2, 64, 64, 3)], ("nlayer_discriminator", {}), True, True),
    "mask_decoder": (lambda: jtd.MaskTransformerDecoder(num_queries=4, hidden_dim=32,
                                                        num_layers=4, num_heads=4),
                     lambda: transformer_decoder.MaskTransformerDecoder(
                         (16, 8), num_queries=4, hidden_dim=32, num_layers=4,
                         num_heads=4),
                     lambda: [[_r(2, 8, 8, 16), _r(2, 16, 16, 8, seed=1)]],
                     ("mask_decoder", {}), "features", False),
    "mask_decoder_v1": (lambda: jtd.MaskTransformerDecoderV1(
        num_queries=4, num_classes=3, hidden_dim=32, num_layers=3, num_heads=4),
        lambda: transformer_decoder.MaskTransformerDecoderV1(
            (16, 8, 8), 8, num_queries=4, num_classes=3, hidden_dim=32,
            num_layers=3, num_heads=4),
        lambda: [[_r(2, 4, 4, 16), _r(2, 8, 8, 8, seed=1), _r(2, 16, 16, 8, seed=2)],
                 _r(2, 32, 32, 8, seed=3)],
        ("mask_decoder", {}), "features", False),
    "kmax_decoder": (lambda: jtd.KMaxTransformerDecoder(num_queries=4, hidden_dim=32,
                                                        num_layers=2, num_heads=4),
                     lambda: transformer_decoder.KMaxTransformerDecoder(
                         (16,), num_queries=4, hidden_dim=32, num_layers=2,
                         num_heads=4),
                     lambda: [[_r(2, 8, 8, 16)]], ("kmax_decoder", {}), "features",
                     False),
    "effiunet_b3": (lambda: JaxEffiUNet(4, encoder_name="efficientnet-b3"),
                    lambda: EffiUNet(1, 4, encoder_name="efficientnet-b3"),
                    lambda: [_r(2, 64, 64, 1)], ("efficient_unet", {}), True, True),
}


F64_TRAIN = ("resnet50", "resnext101_32x8d", "resnet50_d", "resnet50_16s_3d")


def jax_inputs(case, inputs):
    """chap_tpu's positional inputs (the decoders take a list of maps)."""
    return [[jnp.asarray(f) for f in x] if isinstance(x, list) else jnp.asarray(x)
            for x in inputs]


def port_inputs(inputs):
    return [[cf(f) for f in x] if isinstance(x, list) else cf(x) for x in inputs]


def _kwargs(takes_train, train):
    return {"train": train} if takes_train is True else (
        {"train": False} if takes_train == "features" else {})


def seeded_variables(shapes, seed: int = 0) -> dict:
    """chap_tpu variables of the given shapes (jax.eval_shape of its init,
    so Flax's eager initialisers need not run), filled from a numpy seed:
    kernels normal over the square root of their fan-in, scales near 1,
    other parameters (biases, queries, embeddings) small normals, running
    statistics uniform in [0.5, 1.5] (non-trivial, so eval mode tests the
    buffers)."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree.map(lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         shapes.get("batch_stats", {}))
    return {"params": params, "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def flax_case(name):
    """chap_tpu's model and its seeded variables (a train-mode init's
    shapes, so every head and BatchNorm exists), made once."""
    jmake, _, make_inputs, _, takes_train, _ = CASES[name]
    model = jmake()
    inputs = jax_inputs(name, make_inputs())
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    kw = {"train": True} if takes_train is True else _kwargs(takes_train, False)
    shapes = jax.eval_shape(lambda: model.init(rngs, *inputs, **kw))
    shapes = {k: dict(v) for k, v in shapes.items()}
    if name == "unet_tsne":         # the heads exist once a call reaches them
        for method, width in (("forward_projection_head", 16),
                              ("forward_prediction_head", 32)):
            head = jax.eval_shape(lambda m=method, w=width: model.init(
                rngs, jnp.zeros((3, w)), method=getattr(model, m)))
            shapes["params"].update(head["params"])
    return model, seeded_variables(shapes)


def case_pair(name):
    model, variables = flax_case(name)
    _, pmake, make_inputs, (family, opts), _, _ = CASES[name]
    port = pmake()
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"],
                                              family=family, **opts))
    return model, variables, port, make_inputs()


def dropout_feed(port, inputs, rs):
    """The port's dropout uniforms and chap_tpu's (channels last)."""
    if not hasattr(port, "dropout_shapes"):
        return None, []
    x = inputs[0]
    shapes = port.dropout_shapes(x.shape[0], x.shape[1:-1])
    drop = [rs.rand(*s).astype(np.float32) for s in shapes]
    return [torch.from_numpy(u) for u in drop], [np.moveaxis(u, 1, -1) for u in drop]


def compare(got, want, name, channels_last):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (t, j) in enumerate(zip(got, want)):
        j = np.asarray(j)
        t = cl(t) if channels_last and t.dim() >= 4 else t.detach().numpy()
        assert t.shape == j.shape, (name, i, t.shape, j.shape)
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0, err_msg=f"{name} output {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_carrier_names_every_port_tensor(name):
    """state_dict_from_flax fills every parameter and buffer of the port's
    model (the strict load of case_pair) and nothing else."""
    _, variables, port, _ = case_pair(name)
    family, opts = CASES[name][3]
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              family=family, **opts)
    assert set(sd) == set(port.state_dict())


@pytest.mark.parametrize("name,train", [(n, False) for n in CASES] + [
    (n, True) for n in CASES if CASES[n][4] is True],
    ids=lambda v: {False: "eval", True: "train"}.get(v, v))
def test_library_forward_matches_chap_tpu(monkeypatch, name, train):
    """Every output in eval mode (running statistics) and in train mode
    (batch statistics, the dropouts fed to both, the new running
    statistics folded from the port's reported ones)."""
    jmodel, variables, port, inputs = case_pair(name)
    takes_train, channels_last = CASES[name][4], CASES[name][5]
    jin, pin = jax_inputs(name, inputs), port_inputs(inputs)
    if name == "net_d":             # flattened whole: the same layout
        pin = [torch.from_numpy(inputs[0])]
    rs = np.random.RandomState(5)
    kw = {}
    if not train:
        want = jmodel.apply(variables, *jin, **_kwargs(takes_train, False))
        port.eval()
    else:
        drop, fed = dropout_feed(port, inputs, rs)
        if drop:
            kw["drop_u"] = drop
            monkeypatch.setattr(flax_stochastic, "random", RandomFeed(fed))
        rngs = {"dropout": jax.random.PRNGKey(3)}
        if name in F64_TRAIN:
            with jax.enable_x64(True):
                want, upd = jmodel.clone(dtype=jnp.float64).apply(
                    jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables),
                    *(jnp.asarray(x, jnp.float64) for x in jin), train=True,
                    mutable=["batch_stats"], rngs=rngs)
                want = jax.device_get(want)
                upd = jax.device_get(upd)
            port.double()
            pin = [x.double() for x in pin]
        else:
            want, upd = jmodel.apply(variables, *jin, train=True,
                                     mutable=["batch_stats"], rngs=rngs)
        port.train()
        if any(p.endswith("running_mean") for p, _ in port.named_buffers()):
            kw["stats"] = {}
    with torch.no_grad():
        got = port(*pin, **kw)
    compare(got, want, name, channels_last)
    if train and kw.get("stats"):
        family, opts = CASES[name][3]
        check_folded_stats(port, kw["stats"], state_dict_from_flax(
            variables["params"], jax.tree.map(np.asarray, upd["batch_stats"]),
            family=family, **opts))


def test_unet_tsne_heads_match_chap_tpu():
    """The projection and prediction heads on channel-last vectors."""
    jmodel, variables, port, _ = case_pair("unet_tsne")
    f = _r(5, 16, seed=4)
    for method, x in (("forward_projection_head", f),
                      ("forward_prediction_head", _r(5, 32, seed=5))):
        want = jmodel.apply(variables, jnp.asarray(x), method=getattr(jmodel, method))
        with torch.no_grad():
            got = getattr(port, method)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_decoder_v1_refuses_too_few_levels():
    """V1 reads level i at layer i (mask2former...py:635): fewer levels
    than layers raise, at construction and in forward."""
    with pytest.raises(ValueError, match="levels"):
        transformer_decoder.MaskTransformerDecoderV1((8, 8), 8, num_layers=4)
    dec = transformer_decoder.MaskTransformerDecoderV1((8, 8), 8, num_layers=2)
    with pytest.raises(ValueError, match="levels"):
        dec([torch.zeros(1, 8, 4, 4)], torch.zeros(1, 8, 8, 8))


def _grads_equal(got: dict, want: dict, name: str):
    assert set(got) == set(want), name
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(want[k].abs().max()) + 1e-7,
                                   err_msg=f"{name} {k}")


def test_kmax_gradient_matches_jax_grad():
    """KMax's straight-through assignment: the parameter gradients of a
    weighted sum of every layer's seg map equal jax.grad of chap_tpu's
    (forward the one-hot, backward the softmax's), and reach the queries
    through the soft assignment."""
    jmodel, variables, port, inputs = case_pair("kmax_decoder")
    w = [_r(2, 4, 8, 8, seed=10 + i) for i in range(2)]

    def loss(params):
        segs = jmodel.apply({"params": params}, jax_inputs("kmax", inputs)[0],
                            train=False)
        return sum(jnp.sum(s * jnp.asarray(wi)) for s, wi in zip(segs, w))

    jg = jax.device_get(jax.grad(loss)(variables["params"]))
    want = state_dict_from_flax(jg, {}, family="kmax_decoder")
    port.zero_grad()
    segs = port(port_inputs(inputs)[0])
    sum((s * torch.from_numpy(wi)).sum() for s, wi in zip(segs, w)).backward()
    # the last layer's self-attention and FFN reach no output: zero grads
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in port.named_parameters()}
    assert float(got["query_feat.weight"].abs().max()) > 0
    _grads_equal(got, want, "kmax")


def test_gradient_reverse_matches_chap_tpu():
    """GRL inside a small net: the input's and the weights' gradients equal
    jax.grad of chap_tpu's; coeff gets none; the warm-start schedule."""
    rs = np.random.RandomState(3)
    x, a, b = (rs.randn(*s).astype(np.float32) for s in ((4, 6), (6, 5), (5, 3)))
    coeff = 0.7

    def f(x, a, b):
        return jnp.sum(jnp.tanh(jgrl.gradient_reverse(jnp.tanh(x @ a),
                                                      jnp.float32(coeff)) @ b) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (x, a, b)))
    tx, ta, tb = (torch.tensor(v, requires_grad=True) for v in (x, a, b))
    tc = torch.tensor(coeff, requires_grad=True)
    y = grl.gradient_reverse(torch.tanh(tx @ ta), tc)
    (torch.tanh(y @ tb) ** 2).sum().backward()
    for got, w in zip((tx, ta, tb), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=1e-6)
    assert tc.grad is None
    # the reversal itself: -coeff times the gradient without it
    z = torch.tensor(x, requires_grad=True)
    (grl.gradient_reverse(z, coeff) ** 2).sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), -coeff * 2 * x, rtol=1e-6)
    for step in (0, 250, 500, 1000, 4000):
        np.testing.assert_allclose(
            grl.warm_start_coeff(step, alpha=10.0, max_iters=1000),
            float(jgrl.warm_start_coeff(step, alpha=10.0, max_iters=1000)),
            rtol=GRAD_RTOL, atol=1e-7)
    assert grl.warm_start_coeff(0) == 0.0


def test_gan_loss_matches_chap_tpu():
    """GANLoss: lsgan (MSE) and vanilla (BCE with chap_tpu's clip) against
    the real and the fake target, values and gradients."""
    rs = np.random.RandomState(4)
    pred = rs.rand(2, 8, 8, 1).astype(np.float32)
    pred[0, 0, 0, 0], pred[1, 0, 0, 0] = 0.0, 1.0      # the clip's edges
    for lsgan in (True, False):
        for real in (True, False):
            crit_j = jgan.GANLoss(use_lsgan=lsgan, target_real_label=0.9)
            crit_t = gan_legacy.GANLoss(use_lsgan=lsgan, target_real_label=0.9)
            want, g_want = jax.value_and_grad(lambda p: crit_j(p, real))(
                jnp.asarray(pred))
            p = torch.tensor(pred, requires_grad=True)
            got = crit_t(p, real)
            got.backward()
            np.testing.assert_allclose(float(got.detach()), float(want),
                                       rtol=GRAD_RTOL)
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_want),
                                       rtol=GRAD_RTOL, atol=1e-7)


def test_get_encoder_channels():
    """Compound scaling: b0, b2 and b3's pyramids (efficient_encoder.py:
    129,147,156), in both packages; the block counts per stage the same;
    an unknown name raises."""
    for name, want in [("efficientnet-b0", (32, 24, 40, 112, 320)),
                       ("efficientnet-b2", (32, 24, 48, 120, 352)),
                       ("efficientnet-b3", (40, 32, 48, 136, 384))]:
        enc = get_encoder(name)
        assert tuple(enc.out_channels) == want, name
        with torch.no_grad():
            feats = enc.eval()(torch.zeros(1, 3, 64, 64))
        assert tuple(f.shape[1] for f in feats) == want, name
        jenc = jax_get_encoder(name)
        jfeats, v = jax.eval_shape(lambda: jenc.init_with_output(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
        assert tuple(f.shape[-1] for f in jfeats) == want, name
        blocks_j = sorted(k for k in v["params"] if k.startswith("stage"))
        assert len(blocks_j) == len(enc._blocks), name
    with pytest.raises(KeyError):
        get_encoder("efficientnet-b9")


def test_mask_selection_matches_chap_tpu(monkeypatch):
    """mask_selection, given chap_tpu's uniforms: the WRS keep-masks of
    [B, C] and [C] scores equal chap_tpu's exactly, at several percents;
    the top-k path (wrs=False) too; filter_dropout_channel is it."""
    rs = np.random.RandomState(6)
    for shape in ((3, 16), (16,)):
        scores = rs.rand(*shape).astype(np.float32)
        for percent in (0.05, 0.25, 0.5, 0.999):
            u = rs.rand(*shape).astype(np.float32)
            monkeypatch.setattr(jax_perturb, "jax", JaxFeed(RandomFeed([u])))
            want = jax_perturb.mask_selection(jax.random.PRNGKey(0),
                                              jnp.asarray(scores), percent, wrs=True)
            got = mask_selection(torch.from_numpy(scores), percent, True,
                                 u=torch.from_numpy(u))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want_k = jax_perturb.mask_selection(jax.random.PRNGKey(0),
                                                jnp.asarray(scores), percent, wrs=False)
            np.testing.assert_array_equal(
                mask_selection(torch.from_numpy(scores), percent, False).numpy(),
                np.asarray(want_k))
            np.testing.assert_array_equal(
                filter_dropout_channel(torch.from_numpy(scores), percent, True,
                                       u=torch.from_numpy(u)).numpy(),
                got.numpy())


def test_mask_selection_edges():
    """chap_tpu's rules (tests/test_models_zoo3.py:110-140): the top-2 of 8
    dropped strictly above the threshold; drop_num 0 drops nothing;
    percent near 1 keeps one channel (the C - 1 clamp); percent >= 1
    raises; WRS prefers high scores, from a generator."""
    scores = torch.tensor([0.1, 0.9, 0.5, 0.8, 0.2, 0.3, 0.7, 0.4])
    np.testing.assert_array_equal(mask_selection(scores, 0.25, wrs=False).numpy(),
                                  [1, 0, 1, 0, 1, 1, 1, 1])
    ramp = torch.arange(8.0)
    assert torch.equal(mask_selection(ramp, 0.05, wrs=False), torch.ones(8))
    assert float(mask_selection(ramp, 0.999, wrs=False).sum()) == 1.0
    with pytest.raises(ValueError, match="percent"):
        mask_selection(ramp, 1.0)
    gen = torch.Generator().manual_seed(0)
    high = torch.cat([torch.full((8,), 0.05), torch.ones(8)])
    dropped_high = sum(float((1 - mask_selection(high, 0.25, generator=gen))[8:].sum())
                       for _ in range(64))
    assert dropped_high / 64 > 3.0
