"""bf16 compute for the library models no factory key reaches
(models/{blocks, resnet, discriminator, extras, gan_legacy,
transformer_decoder}.py and the EfficientNet encoders), held against
chap_tpu's modules at ``dtype=bfloat16`` on the CPU.

Each model of tests/test_torch_library.py's CASES, with its seeded float32
weights, runs with ``set_compute_dtype(model, torch.bfloat16)`` in eval and
in train mode (the dropouts fed to both) against chap_tpu's module cloned
to ``dtype=bfloat16`` and applied jitted without XLA's excess precision
(``rounding_jit``: bit-equal to its eager apply, which was most of a
test's time), on inputs of bf16 values held as float32 in both packages,
so the places where a float32 input meets a bf16 layer promote alike
(SqEx's gate times its float32 input is float32 in both; V1's mask einsum of
the bf16 query embedding and float32 mask features is float32). The bar is
tests/test_torch_bf16.py's: chap_tpu's output dtype; within twice chap_tpu's
own bf16-against-float32 gap (e_ref) of its bf16 and float32 outputs; at
least 0.1 e_ref from the port's own float32. Train mode holds the folded
BatchNorm running statistics of all layers together too. The gradients of
the GRL pair, KMax, the GAN pair and TinyUNet3D (chip_smoke.py's phase 25
pairs) are held as one vector each, and UNetTsne's heads, which chap_tpu
builds without a dtype, stay float32 under bf16."""
import functools

import flax.linen as fnn
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chap_tpu.models.extras as jextras
import chap_tpu.models.gan_legacy as jgan
import chap_tpu.models.grl as jgrl
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.models import extras, gan_legacy, grl
from chap_tpu_torch.models.layers import (BN_MOMENTUM, _CastConv,
                                          set_compute_dtype)
from test_torch_bf16 import BF, as_np, hold_bf16, stacked, to_bf16
from test_torch_bf16_zoo2d import rounding_jit
from test_torch_library import (CASES, CHNS, _kwargs, case_pair, dropout_feed,
                                jax_inputs, leaves, port_inputs,
                                seeded_variables)
from test_torch_models import RandomFeed

torch.set_num_threads(1)

DTYPES = ((jnp.float32, torch.float32), (BF, torch.bfloat16))


def jit_apply(jmodel, dtype, variables, *inputs, **kw):
    """chap_tpu's module at ``dtype`` under a fresh rounding_jit (traced
    anew, so fed dropout draws are taken at this call)."""
    model = jmodel.clone(dtype=dtype)
    return jax.device_get(rounding_jit(lambda v, *a: model.apply(v, *a, **kw),
                                       variables, *inputs))


def bf16_inputs(name):
    """The case's inputs rounded to bf16 values (float32 arrays)."""
    return [[to_bf16(f) for f in x] if isinstance(x, list) else to_bf16(x)
            for x in CASES[name][2]()]


def running_after(port, stats):
    buffers = dict(port.named_buffers())
    return {f"{key}.{part}": BN_MOMENTUM * buffers[f"{key}.{part}"]
            + (1 - BN_MOMENTUM) * batch
            for key, (mean, var) in stats.items()
            for part, batch in (("running_mean", mean), ("running_var", var))}


@pytest.mark.parametrize("name,train", [(n, False) for n in CASES] + [
    (n, True) for n in CASES if CASES[n][4] is True],
    ids=lambda v: {False: "eval", True: "train"}.get(v, v))
def test_library_bf16_matches_chap_tpu(monkeypatch, name, train):
    """Every output of each library model in bf16, eval and train mode,
    by the bar; in train mode the running statistics too."""
    jmodel, variables, port, _ = case_pair(name)
    inputs = bf16_inputs(name)
    takes_train, channels_last = CASES[name][4], CASES[name][5]
    jin = jax_inputs(name, inputs)
    pin = [torch.from_numpy(inputs[0])] if name == "net_d" else port_inputs(inputs)
    kw, jkw = {}, _kwargs(takes_train, train)
    fed = []
    if train:
        drop, fed = dropout_feed(port, inputs, np.random.RandomState(5))
        if drop:
            kw["drop_u"] = drop
        jkw.update(mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(3)})
    want, upd = {}, {}
    for jdt, _ in DTYPES:
        if fed:
            monkeypatch.setattr(flax_stochastic, "random", RandomFeed(fed))
        out = jit_apply(jmodel, jdt, variables, *jin, **jkw)
        want[jdt], upd[jdt] = (out if train else (out, None))
    got, stats = {}, {}
    has_stats = train and any(p.endswith("running_mean")
                              for p, _ in port.named_buffers())
    for jdt, dt in DTYPES:
        set_compute_dtype(port, dt).train(train)
        stats[dt] = {}
        with torch.no_grad():
            got[dt] = port(*pin, **kw, **({"stats": stats[dt]} if has_stats else {}))
    outs = {dt: leaves(got[dt]) for _, dt in DTYPES}
    refs = {jdt: leaves(want[jdt]) for jdt, _ in DTYPES}
    assert len(outs[torch.bfloat16]) == len(refs[BF]), name

    def port_np(t):         # chap_tpu's layout
        a = as_np(t)
        return np.moveaxis(a, 1, -1) if channels_last and a.ndim >= 4 else a

    for i, (t, j) in enumerate(zip(outs[torch.bfloat16], refs[BF])):
        assert str(t.dtype)[6:] == str(j.dtype), (name, i, t.dtype, j.dtype)
        hold_bf16(f"{name} output {i} (train={train})", port_np(t), j,
                  refs[jnp.float32][i], port_np(outs[torch.float32][i]))
    if has_stats:
        family, opts = CASES[name][3]
        new = {dt: running_after(port, stats[dt]) for _, dt in DTYPES}
        names = sorted(new[torch.float32])
        ref = {jdt: state_dict_from_flax(variables["params"], upd[jdt]["batch_stats"],
                                         family=family, **opts) for jdt, _ in DTYPES}
        hold_bf16(f"{name} running statistics",
                  stacked(new[torch.bfloat16][k] for k in names),
                  stacked(ref[BF][k] for k in names),
                  stacked(ref[jnp.float32][k] for k in names),
                  stacked(new[torch.float32][k] for k in names))


def test_unet_tsne_heads_stay_float32_in_bf16():
    """chap_tpu's UNetTsne heads are nn.Dense(32) without a dtype
    (extras.py:31-32): under dtype=bfloat16 they compute in float32 over
    their float32 kernels, so a bf16 feature vector gives float32 vectors.
    The port's heads do not follow set_compute_dtype: float32 out, equal to
    chap_tpu's at float32 precision; the backbone's logits are bf16."""
    jmodel, variables, port, _ = case_pair("unet_tsne")
    set_compute_dtype(port, torch.bfloat16)
    bf_model = jmodel.clone(dtype=BF)
    rs = np.random.RandomState(4)
    for method, width in (("forward_projection_head", 16),
                          ("forward_prediction_head", 32)):
        f = to_bf16(rs.randn(5, width).astype(np.float32))
        want = bf_model.apply(variables, jnp.asarray(f, BF),
                              method=getattr(bf_model, method))
        with torch.no_grad():
            got = getattr(port, method)(torch.from_numpy(f).bfloat16())
        assert want.dtype == jnp.float32 and got.dtype == torch.float32, method
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=method)
    with torch.no_grad():
        logits, feats = port.eval()(torch.zeros(1, 1, 32, 32))
    assert logits.dtype == feats.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# gradients, as one vector each (chip_smoke.py's phase 25 pairs)
# ---------------------------------------------------------------------------

def _seeded(jmodel, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *(jnp.asarray(x) for x in inputs), **kw))
    return seeded_variables({k: dict(v) for k, v in shapes.items()}, seed=seed)


def _grl_case():
    """A small UNet's decoder features, pooled to 8 x 8, through the GRL
    (coefficient 0.5) into NetD; BCE against 'real'. Train mode, every
    dropout unit kept."""
    x = to_bf16(np.random.RandomState(11).randn(2, 32, 32, 1).astype(np.float32))
    junet, jnetd = jextras.UNet2dBCP(4, feature_chns=CHNS), jextras.NetD(512)
    vu = _seeded(junet, x, train=True)
    vd = _seeded(jnetd, np.zeros((2, 8, 8, 4), np.float32), seed=1)

    def jloss(params, dt):
        feeds = RandomFeed([np.zeros(s, np.float32) for s in _unet_drop_shapes(x)])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax_stochastic, "random", feeds)
            (_, feats), _ = junet.clone(dtype=dt).apply(
                {"params": params["unet"], "batch_stats": vu["batch_stats"]},
                jnp.asarray(x), train=True, with_feats=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
        h = jgrl.gradient_reverse(fnn.avg_pool(feats, (4, 4), strides=(4, 4)), 0.5)
        return jgan.gan_loss(jnetd.clone(dtype=dt).apply(
            {"params": params["netd"]}, h), True, use_lsgan=False)

    def port_loss(dt):
        unet = extras.UNet2dBCP(1, 4, CHNS)
        unet.load_state_dict(state_dict_from_flax(vu["params"], vu["batch_stats"],
                                                  family="unet_2dbcp"))
        netd = extras.NetD(512)
        netd.load_state_dict(state_dict_from_flax(vd["params"], {}, family="net_d"))
        modules = {"unet": set_compute_dtype(unet, dt).train(),
                   "netd": set_compute_dtype(netd, dt)}
        xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
        keep = [torch.zeros(s) for s in unet.dropout_shapes(2, (32, 32))]
        _, feats = unet(xt, drop_u=keep, stats={}, with_feats=True)
        h = grl.gradient_reverse(F.avg_pool2d(feats, 4), 0.5)
        loss = gan_legacy.gan_loss(netd(h.permute(0, 2, 3, 1)), True, use_lsgan=False)
        return loss, modules

    families = {"unet": ("unet_2dbcp", vu["batch_stats"]), "netd": ("net_d", {})}
    return ({"unet": vu["params"], "netd": vd["params"]}, jloss, port_loss, families)


def _unet_drop_shapes(x):
    return [np.moveaxis(np.zeros(s), 1, -1).shape for s in
            extras.UNet2dBCP(1, 4, CHNS).dropout_shapes(x.shape[0], x.shape[1:3])]


def _gan_case():
    """ResnetGenerator under NLayerDiscriminator in train mode: the lsgan
    losses of the generated images as real and the input as fake."""
    x = to_bf16(np.random.RandomState(12).randn(2, 32, 32, 3).astype(np.float32))
    jg = jgan.ResnetGenerator(output_nc=3, ngf=8, n_blocks=2)
    jd = jgan.NLayerDiscriminator(ndf=8, n_layers=3)
    vg, vd = _seeded(jg, x, train=True), _seeded(jd, x, train=True, seed=1)

    def jloss(params, dt):
        g, d = jg.clone(dtype=dt), jd.clone(dtype=dt)

        def disc(img):
            return d.apply({"params": params["d"], "batch_stats": vd["batch_stats"]},
                           img, train=True, mutable=["batch_stats"])[0]
        fake, _ = g.apply({"params": params["g"], "batch_stats": vg["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return (jgan.gan_loss(disc(fake), True)
                + jgan.gan_loss(disc(jnp.asarray(x)), False))

    def port_loss(dt):
        g = gan_legacy.ResnetGenerator(3, 3, ngf=8, n_blocks=2)
        g.load_state_dict(state_dict_from_flax(vg["params"], vg["batch_stats"],
                                               family="resnet_generator"))
        d = gan_legacy.NLayerDiscriminator(3, ndf=8, n_layers=3)
        d.load_state_dict(state_dict_from_flax(vd["params"], vd["batch_stats"],
                                               family="nlayer_discriminator"))
        modules = {"g": set_compute_dtype(g, dt).train(),
                   "d": set_compute_dtype(d, dt).train()}
        xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
        loss = (gan_legacy.gan_loss(d(g(xt, stats={}), stats={}), True)
                + gan_legacy.gan_loss(d(xt, stats={}), False))
        return loss, modules

    families = {"g": ("resnet_generator", vg["batch_stats"]),
                "d": ("nlayer_discriminator", vd["batch_stats"])}
    return {"g": vg["params"], "d": vd["params"]}, jloss, port_loss, families


def _kmax_case():
    """KMax's straight-through assignment: a weighted sum of every layer's
    seg map."""
    jmodel, variables, _, inputs = case_pair("kmax_decoder")
    feats = [to_bf16(f) for f in inputs[0]]
    w = [np.random.RandomState(10 + i).randn(2, 4, 8, 8).astype(np.float32)
         for i in range(2)]

    def jloss(params, dt):
        segs = jmodel.clone(dtype=dt).apply({"params": params["kmax"]},
                                            [jnp.asarray(f) for f in feats])
        return sum(jnp.sum(s.astype(jnp.float32) * wi) for s, wi in zip(segs, w))

    def port_loss(dt):
        _, _, port, _ = case_pair("kmax_decoder")
        segs = set_compute_dtype(port, dt)([torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(f, -1, 1))) for f in feats])
        return (sum((s.float() * torch.from_numpy(wi)).sum() for s, wi in zip(segs, w)),
                {"kmax": port})

    return ({"kmax": variables["params"]}, jloss, port_loss,
            {"kmax": ("kmax_decoder", {})})


def _tiny_case():
    """TinyUNet3D in train mode: CE of the logits (taken in float32) plus the
    multiscale softmax maps' foreground squared."""
    jmodel, variables, _, _ = case_pair("tiny_unet3d")
    x = to_bf16(np.random.RandomState(13).randn(2, 16, 16, 16, 1).astype(np.float32))
    lab = np.random.RandomState(14).randint(0, 2, (2, 16, 16, 16))

    def jloss(params, dt):
        (logits, maps), _ = jmodel.clone(dtype=dt).apply(
            {"params": params["tiny"], "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        ce = -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(lab)[..., None], -1))
        return ce + sum(jnp.mean(p[..., 1].astype(jnp.float32) ** 2) for p in maps)

    def port_loss(dt):
        _, _, port, _ = case_pair("tiny_unet3d")
        logits, maps = set_compute_dtype(port, dt).train()(
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), stats={})
        return (F.cross_entropy(logits.float(), torch.from_numpy(lab))
                + sum((p[:, 1].float() ** 2).mean() for p in maps)), {"tiny": port}

    return ({"tiny": variables["params"]}, jloss, port_loss,
            {"tiny": ("tiny_unet3d", variables["batch_stats"])})


GRAD_CASES = {"grl": _grl_case, "kmax": _kmax_case, "gan_pair": _gan_case,
              "tiny_unet3d": _tiny_case}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_library_bf16_gradients_match_chap_tpu(case):
    """The parameter gradients of a loss through the GRL pair, KMax, the GAN
    pair and TinyUNet3D in bf16 against jax.grad of chap_tpu's bf16
    modules; the gradients are float32 in both. The gradients of every
    parameter but the biases of the convolutions and dense layers are one
    vector, held by the bar; the biases' are another. A bias's gradient is
    the sum of its
    layer's bf16 output cotangent over every position, which XLA on the
    CPU sums in bf16 (ROADMAP §3: TinyUNet3D's head bias gets 0.03 where
    its float32 gradient is 0.20, a conv bias in front of a BatchNorm 2.8e-2
    where float32's is a cancelled 3e-7), and the port in float32, as the
    card does; so they are held within twice chap_tpu's own gap of its
    bf16 and float32 gradients, and not to the bar's "visibly not
    float32"."""
    params, jloss, port_loss, families = GRAD_CASES[case]()
    want = {}
    for jdt, _ in DTYPES:
        grads = jax.device_get(rounding_jit(
            jax.grad(functools.partial(jloss, dt=jdt)), params))
        want[jdt] = {part: state_dict_from_flax(grads[part], stats, family=fam)
                     for part, (fam, stats) in families.items()}
    got = {}
    for _, dt in DTYPES:
        loss, modules = port_loss(dt)
        loss.backward()
        biases = {(part, f"{n}.bias") for part, m in modules.items()
                  for n, mod in m.named_modules()
                  if isinstance(mod, _CastConv) and mod.bias is not None}
        got[dt] = {part: {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                          for k, p in m.named_parameters()}
                   for part, m in modules.items()}
    names = [(part, k) for part in families for k in sorted(got[torch.float32][part])]
    assert all(got[torch.bfloat16][p][k].dtype == torch.float32 for p, k in names)
    assert np.abs(stacked(want[jnp.float32][p][k] for p, k in names)).max() > 0
    port_b, ref_b, ref_32 = (stacked(src[p][k] for p, k in sorted(biases))
                             for src in (got[torch.bfloat16], want[BF],
                                         want[jnp.float32]))
    gap = np.abs(ref_b - ref_32).max()
    for what, err in (("bf16", np.abs(port_b - ref_b).max()),
                      ("float32", np.abs(port_b - ref_32).max())):
        assert err <= 2 * gap + 1e-6, (
            f"{case} biases' gradients {err:.3g} from chap_tpu's {what}, whose own "
            f"bf16 gap is {gap:.3g}")
    held = [n for n in names if n not in biases]
    hold_bf16(f"{case} gradients",
              *(stacked(src[p][k] for p, k in held)
                for src in (got[torch.bfloat16], want[BF], want[jnp.float32],
                            got[torch.float32])))
