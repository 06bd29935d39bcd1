"""bf16 compute (``model.dtype=bfloat16``) for the layers of the 2D zoo
beyond the UNet family and for the six keys built from them (resunet,
dual_student, swinunet, enet, pnet, efficient_unet), held against chap_tpu's
bf16 modules on the CPU.

The bar is tests/test_torch_bf16.py's (its module docstring): the port's
output has chap_tpu's dtype; it lies within twice chap_tpu's own
bf16-against-float32 gap (e_ref, measured in each test on its inputs) of
chap_tpu's bf16 and of its float32; and it lies at least 0.1 e_ref from the
port's own float32, so a layer that quietly ran in float32 fails.

The layers of models/layers.py (Linear, LayerNorm, PReLU,
MultiHeadDotProductAttention) and the three attention flavours of the zoo
and the library are held to their Flax counterparts one by one: the output
within one bf16 unit of Flax's at the output's scale (the same arithmetic,
rounded where Flax rounds), and the gradients of input and parameters by
the bar above. The six keys are built at tests/test_torch_zoo2d.py's small
widths and carry chap_tpu's float32 weights (state_dict_from_flax), seeded
from numpy over the shapes of chap_tpu's init (jax.eval_shape; Flax's eager
init and eager bf16 apply were most of a minute a key), and chap_tpu's
module and step run jitted without XLA's excess precision
(``rounding_jit``); every draw chap_tpu makes is fed the test's uniforms
(at trace time: each call traces anew). The bf16 single-decoder
step of SwinUNet is held to chap_tpu's ``dual=False`` step in bf16 as
tests/test_torch_bf16.py holds the dual-decoder step: the loss as one
vector over BATCH_SEEDS, the update by ``hold_updates`` (STEP_KEY says why
not ENet)."""
import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chap_tpu.losses.dice as jax_dice
import chap_tpu.models.swin_unet as jax_swin
import chap_tpu.train.step_supervised as jax_step_supervised
from chap_tpu.models.dsnet import MyCrossAttention as JaxCrossAttention
from chap_tpu.models.swin_unet import WindowAttention as JaxWindowAttention
from chap_tpu.models.swin_unet import _shift_attn_mask
from chap_tpu.train.state import TrainState as JaxTrainState
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu_torch.config import ModelConfig
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models import layers
from chap_tpu_torch.models.dsnet import MyCrossAttention
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.layers import (LayerNorm, Linear,
                                          MultiHeadDotProductAttention, PReLU,
                                          set_compute_dtype)
from chap_tpu_torch.models.swin_unet import WindowAttention
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.step_supervised import build_supervised_train_step
from test_torch_bf16 import (BATCH_SEEDS, BF, ULP, as_np, hold_bf16,
                             hold_updates, stacked, to_bf16)
from test_torch_library import seeded_variables
from test_torch_zoo2d import (OUTPUTS, TRAIN_OUTPUTS, ZOO, _step_cfg, draws,
                              feed_chap_tpu, flatten, nchw, port_kwargs)

torch.set_num_threads(1)

KEYS = ("resunet", "dual_student", "swinunet", "enet", "pnet", "efficient_unet")


def within_a_unit(got, want, name):
    """The port's bf16 output within one bf16 unit of Flax's at the
    output's scale: the same arithmetic, rounded where Flax rounds (a
    contraction's summation order moves a small value by a unit of the
    large ones)."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP * np.abs(want).max(),
                               err_msg=name)


def flax_grads(fn, variables, x):
    """d sum(fn(v, x) * g) / d(x, params) of a Flax layer in float32 and
    bf16 compute (fn(dtype) -> apply), for one cotangent g."""
    out = {}
    for dt in (jnp.float32, BF):
        y, vjp = jax.vjp(lambda v, a: fn(dt)(v, a), variables, jnp.asarray(x))
        g = np.random.RandomState(3).randn(*y.shape).astype(np.float32)
        dv, dx = vjp(jnp.asarray(g, y.dtype))
        out[dt] = (y, dx, dv, g)
    return out


def port_grads(module, x, g):
    """The port's (output, d/dx, {param: grad}) in float32 and bf16 compute
    for the cotangent g."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(module, dt)
        module.zero_grad()
        xt = torch.from_numpy(x).requires_grad_()
        y = module(xt.to(dt))
        (y.float() * torch.from_numpy(g)).sum().backward()
        out[dt] = (y, xt.grad.clone(), {k: p.grad.clone()
                                        for k, p in module.named_parameters()})
    return out


# name: (Flax layer of a compute dtype, port layer, input shape, the Flax
# parameter of each port parameter: (path, transform))
def _dense_case(dt):
    return fnn.Dense(24, dtype=dt)


LAYER_CASES = {
    "dense": (_dense_case, lambda: Linear(16, 24), (3, 10, 16),
              {"weight": (("kernel",), lambda a: a.T), "bias": (("bias",), None)}),
    "layer_norm_1e-5": (lambda dt: fnn.LayerNorm(epsilon=1e-5, dtype=dt),
                        lambda: LayerNorm(16, eps=1e-5), (3, 10, 16),
                        {"weight": (("scale",), None), "bias": (("bias",), None)}),
    "layer_norm_1e-6": (lambda dt: fnn.LayerNorm(dtype=dt),
                        lambda: LayerNorm(16, eps=1e-6), (3, 10, 16),
                        {"weight": (("scale",), None), "bias": (("bias",), None)}),
    "prelu": (lambda dt: fnn.PReLU(), lambda: PReLU(), (3, 10, 16),
              {"weight": (("negative_slope",), lambda a: a.reshape(1))}),
}


def _carry(port, variables, mapping):
    params = variables["params"]
    with torch.no_grad():
        for name, (path, fn) in mapping.items():
            a = np.asarray(functools.reduce(lambda d, k: d[k], path, params))
            getattr(port, name).copy_(torch.from_numpy(
                np.ascontiguousarray(fn(a) if fn else a)))


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layers_compute_as_flax_in_bf16(case):
    """Dense, LayerNorm (both epsilons) and PReLU in bf16 over float32
    parameters: the output bf16 and within one bf16 unit of Flax's; the
    input's and every parameter's gradient by the bar, the parameters'
    float32 (PReLU's slope too: Flax casts it to the input's dtype). The
    inputs are bf16 values with a mean, where Flax's one-pass float32
    variance and the port's two-pass one part at float32 precision, below
    the bf16 unit that LayerNorm's output is held to."""
    make_flax, make_port, shape, mapping = LAYER_CASES[case]
    rs = np.random.RandomState(0)
    x = to_bf16((rs.randn(*shape) * 2.0 + 1.0).astype(np.float32))
    variables = jax.device_get(make_flax(jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(np.float32),
        variables)
    want = flax_grads(lambda dt: (lambda v, a: make_flax(dt).apply(
        v, a.astype(BF) if dt == BF else a)), variables, x)
    port = make_port()
    _carry(port, variables, mapping)
    got = port_grads(port, x, want[BF][3])
    y, dx, dparams = got[torch.bfloat16]
    assert y.dtype == torch.bfloat16 and want[BF][0].dtype == BF
    within_a_unit(y, want[BF][0], f"{case} output")
    hold_bf16(f"{case} input gradient", dx, want[BF][1], want[jnp.float32][1],
              got[torch.float32][1])
    for name, (path, fn) in mapping.items():
        assert dparams[name].dtype == torch.float32, name
        pick = lambda dv: np.asarray(functools.reduce(lambda d, k: d[k], path,
                                                      dv["params"]), np.float32)
        tr = lambda a: np.ascontiguousarray(fn(a) if fn else a)
        hold_bf16(f"{case} {name} gradient", dparams[name],
                  tr(pick(want[BF][2])), tr(pick(want[jnp.float32][2])),
                  got[torch.float32][2][name])


def test_gelu_is_flax_tanh_gelu_in_bf16():
    """Swin's MLP: F.gelu(approximate='tanh') of a bf16 input is bf16 and
    within one bf16 unit of Flax's nn.gelu (the tanh form in the input's
    dtype)."""
    x = to_bf16(np.random.RandomState(1).randn(4, 64).astype(np.float32) * 3)
    got = F.gelu(torch.from_numpy(x).bfloat16(), approximate="tanh")
    want = fnn.gelu(jnp.asarray(x, BF))
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    within_a_unit(got, want, "gelu")


def test_multi_head_attention_is_flax_in_bf16():
    """transformer_decoder.py's self-attention: Flax's
    MultiHeadDotProductAttention(dtype=bf16) divides the bf16 query by
    sqrt(head_dim) rounded to bf16 (2.453125 for 6, not 2.4494897) and takes
    its softmax in bf16: the port's module over nn.MultiheadAttention's
    parameters is within one bf16 unit of it, its gradients by the bar. The
    bf16 divisor matters: the same attention with the exact float32 scale
    lands farther from Flax's than the port does."""
    dim, heads = 24, 4
    rs = np.random.RandomState(2)
    q = to_bf16(rs.randn(2, 6, dim).astype(np.float32))
    v = to_bf16(rs.randn(2, 6, dim).astype(np.float32))
    jmod = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=dim)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(q),
                                         jnp.asarray(q), jnp.asarray(v)))
    port = MultiHeadDotProductAttention(dim, heads)
    p = variables["params"]
    with torch.no_grad():
        port.in_proj_weight.copy_(torch.from_numpy(np.concatenate(
            [np.asarray(p[n]["kernel"]).reshape(dim, dim).T for n in
             ("query", "key", "value")])))
        port.in_proj_bias.copy_(torch.from_numpy(np.concatenate(
            [np.asarray(p[n]["bias"]).reshape(dim) for n in ("query", "key", "value")])))
        port.out_proj.weight.copy_(torch.from_numpy(
            np.asarray(p["out"]["kernel"]).reshape(dim, dim).T.copy()))
        port.out_proj.bias.copy_(torch.from_numpy(np.asarray(p["out"]["bias"])))
    want, jgrads = {}, {}
    g = rs.randn(2, 6, dim).astype(np.float32)
    for dt in (jnp.float32, BF):
        fn = lambda a, b: fnn.MultiHeadDotProductAttention(
            num_heads=heads, qkv_features=dim, dtype=dt).apply(variables, a, a, b)
        y, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(v))
        want[dt] = y
        jgrads[dt] = vjp(jnp.asarray(g, y.dtype))
    got, pgrads = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(port, dt)
        qt = torch.from_numpy(q).requires_grad_()
        vt = torch.from_numpy(v).requires_grad_()
        y = port(qt, qt, vt)
        (y.float() * torch.from_numpy(g)).sum().backward()
        got[dt], pgrads[dt] = y, (qt.grad, vt.grad)
    assert got[torch.bfloat16].dtype == torch.bfloat16 and want[BF].dtype == BF
    within_a_unit(got[torch.bfloat16], want[BF], "attention output")
    for i, name in enumerate(("query", "value")):
        hold_bf16(f"attention d/d{name}", pgrads[torch.bfloat16][i], jgrads[BF][i],
                  jgrads[jnp.float32][i], pgrads[torch.float32][i])
    # the same attention divided by the float32 sqrt(6)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "scale_in", lambda dtype, value: value)
        exact = port(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v))
    ref = as_np(want[BF])
    assert (np.abs(as_np(exact) - ref).sum()
            > np.abs(as_np(got[torch.bfloat16]) - ref).sum())


def _carry_dense(jparams, port_linear):
    with torch.no_grad():
        port_linear.weight.copy_(torch.from_numpy(np.asarray(jparams["kernel"]).T.copy()))
        if port_linear.bias is not None:
            port_linear.bias.copy_(torch.from_numpy(np.asarray(jparams["bias"])))


def test_swin_window_attention_promotes_to_float32(monkeypatch):
    """chap_tpu's WindowAttention (swin_unet.py:57-78) in bf16 adds the
    float32 relative-position bias and shift mask to the bf16 scores, so
    its softmax and the product with the bf16 values are float32 and only
    ``proj`` casts back: the port's softmax sees float32 scores, and its
    output is bf16 within one bf16 unit of chap_tpu's; the gradient of the
    input by the bar."""
    dim, ws, heads, nw = 16, 4, 2, 4
    n = ws * ws
    rs = np.random.RandomState(4)
    x = to_bf16(rs.randn(2 * nw, n, dim).astype(np.float32))
    mask = np.asarray(_shift_attn_mask(8, 8, ws, 2))
    jmod = JaxWindowAttention(dim, ws, heads)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                         mask, train=False))
    p = variables["params"]
    port = WindowAttention(dim, ws, heads)
    _carry_dense(p["qkv"], port.qkv)
    _carry_dense(p["proj"], port.proj)
    with torch.no_grad():
        port.relative_position_bias_table.copy_(torch.from_numpy(
            np.asarray(p["relative_position_bias_table"]) * 50))
    variables["params"]["relative_position_bias_table"] = np.asarray(
        p["relative_position_bias_table"]) * 50
    g = rs.randn(2 * nw, n, dim).astype(np.float32)
    want, jgrad = {}, {}
    for dt in (jnp.float32, BF):
        fn = lambda a: JaxWindowAttention(dim, ws, heads, dt).apply(
            variables, a, mask, train=False)
        y, vjp = jax.vjp(fn, jnp.asarray(x, dt))
        want[dt], jgrad[dt] = y, vjp(jnp.asarray(g, y.dtype))[0]
    softmax_dtypes = []
    real = torch.softmax
    monkeypatch.setattr(torch, "softmax", lambda t, dim: softmax_dtypes.append(
        t.dtype) or real(t, dim))
    mask_t = torch.from_numpy(mask)
    got, grad = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(port, dt)
        xt = torch.from_numpy(x).to(dt).requires_grad_()
        y = port(xt, mask_t)
        (y.float() * torch.from_numpy(g)).sum().backward()
        got[dt], grad[dt] = y, xt.grad
    assert softmax_dtypes == [torch.float32, torch.float32]
    assert got[torch.bfloat16].dtype == torch.bfloat16 and want[BF].dtype == BF
    within_a_unit(got[torch.bfloat16], want[BF], "window attention")
    hold_bf16("window attention input gradient", grad[torch.bfloat16], jgrad[BF],
              jgrad[jnp.float32], grad[torch.float32])


def test_dsnet_cross_attention_in_bf16(monkeypatch):
    """chap_tpu's MyCrossAttention (dsnet.py:56-69) in bf16: bf16 scores and
    softmax (rounded step by step), the residual with the float32 proxy
    queries float32 until the feed-forward's Dense casts back, the
    LayerNorm's output bf16: the updated queries and the head-mean
    attention, bf16, by the bar in eval and in train mode (the four
    dropouts fed to both)."""
    import flax.linen.stochastic as flax_stochastic
    from test_torch_models import RandomFeed
    dim, n_q, tokens = 16, 8, 12
    rs = np.random.RandomState(5)
    parts = rs.rand(n_q, dim).astype(np.float32)
    feat = to_bf16(rs.randn(2, tokens, dim).astype(np.float32))
    jmod = JaxCrossAttention(dim, 2)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(parts),
                                         jnp.asarray(feat), train=False))
    port = MyCrossAttention(dim, 2)
    p = variables["params"]
    for name in ("q_fc", "k_fc", "v_fc", "proj"):
        _carry_dense(p[name], getattr(port, name))
    _carry_dense(p["FFN_0"]["Dense_0"], port.ffn.fc1)
    _carry_dense(p["FFN_0"]["Dense_1"], port.ffn.fc2)
    with torch.no_grad():
        port.norm.weight.copy_(torch.from_numpy(np.asarray(p["LayerNorm_0"]["scale"])))
        port.norm.bias.copy_(torch.from_numpy(np.asarray(p["LayerNorm_0"]["bias"])))
    for train in (False, True):
        drop = [rs.rand(*s).astype(np.float32)
                for s in port.dropout_shapes(2, n_q, tokens)]
        want = {}
        for dt in (jnp.float32, BF):
            monkeypatch.setattr(flax_stochastic, "random", RandomFeed(list(drop)))
            want[dt] = JaxCrossAttention(dim, 2, dt).apply(
                variables, jnp.asarray(parts), jnp.asarray(feat, dt), train=train,
                rngs={"dropout": jax.random.PRNGKey(1)})
        got = {}
        for dt in (torch.float32, torch.bfloat16):
            set_compute_dtype(port, dt).train(train)
            with torch.no_grad():
                got[dt] = port(torch.from_numpy(parts), torch.from_numpy(feat).to(dt),
                               [torch.from_numpy(u) for u in drop] if train else None)
        for i, what in enumerate(("queries", "attention")):
            assert got[torch.bfloat16][i].dtype == torch.bfloat16, what
            assert want[BF][i].dtype == BF, what
            hold_bf16(f"cross-attention {what} (train={train})",
                      got[torch.bfloat16][i], want[BF][i], want[jnp.float32][i],
                      got[torch.float32][i])


# ---------------------------------------------------------------------------
# the six keys
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def chap_tpu_pair(key):
    """chap_tpu's module of a key (tests/test_torch_zoo2d.py's widths) and
    variables of its train-mode init's shapes, seeded from numpy with
    non-trivial running statistics; made once."""
    jmake, _, hw = ZOO[key]
    jmodel = jmake()
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "perturb": jax.random.PRNGKey(2)}
    with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask):
        shapes = jax.eval_shape(lambda: jmodel.init(
            rngs, jnp.zeros((2, hw, hw, 1)), train=True))
    return jmodel, seeded_variables({k: dict(v) for k, v in shapes.items()})


def zoo_pair(key):
    """(chap_tpu's module, its variables, the port's module carrying them,
    the input side)."""
    jmodel, variables = chap_tpu_pair(key)
    _, pmake, hw = ZOO[key]
    port = pmake()
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family=key))
    return jmodel, variables, port, hw


_real_mask = jax_swin._shift_attn_mask


def eager_mask(*args):
    """chap_tpu's SwinUNet window masks (numpy of a jnp window partition)
    made eagerly inside a trace, as outside one."""
    with jax.ensure_compile_time_eval():
        return _real_mask(*args)


def rounding_jit(fn, *args):
    """fn(*args) compiled by XLA without excess precision, so every op
    rounds to its dtype as eager JAX and the port do (bit-equal to the
    eager call). XLA's default lets a CPU fusion keep float32 between ops:
    a bf16 conv's output that feeds a BatchNorm is never rounded, and
    chap_tpu's bf16 ResNet-50 stem lands 0.82e-3 RMS from its float32
    instead of eager's 1.31e-3."""
    if not hasattr(fn, "lower"):
        fn = jax.jit(fn)
    return fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def jit_apply(jmodel, dtype, variables, x, **kw):
    """chap_tpu's module in ``dtype`` applied under a fresh rounding_jit
    (traced anew, so fed draws are taken at this call)."""
    model = jmodel.clone(dtype=dtype)
    with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask):
        return jax.device_get(rounding_jit(lambda v, a: model.apply(v, a, **kw),
                                           variables, jnp.asarray(x, dtype)))

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", KEYS)
def test_zoo_bf16_matches_chap_tpu(monkeypatch, key, train):
    """model.dtype=bfloat16 on the six keys outside the UNet family: every
    output in eval and in train mode (every draw fed to both) against
    chap_tpu's module in bf16 over the same float32 weights, by the bar;
    in train mode the new BatchNorm running statistics of all layers
    together too (float32 in both)."""
    jmodel, variables, port, hw = zoo_pair(key)
    rs = np.random.RandomState(9)
    x = to_bf16(rs.randn(2, hw, hw, 1).astype(np.float32))
    drop, pert, feeds = draws(port, key, 2, hw, rs)
    kw = port_kwargs(drop, pert) if train else {}
    rngs = {"dropout": jax.random.PRNGKey(3), "perturb": jax.random.PRNGKey(4)}
    want, upd = {}, {}
    for dt in (jnp.float32, BF):
        if train:
            feed_chap_tpu(monkeypatch, feeds)
        out = jit_apply(jmodel, dt, variables, x, train=train, rngs=rngs,
                        mutable=["batch_stats"] if train else False)
        want[dt] = flatten(out[0] if train else out)
        if train:
            upd[dt] = out[1]["batch_stats"]
    got, stats = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(port, dt).train(train)
        stats[dt] = {}
        with torch.no_grad():
            got[dt] = flatten(port(nchw(x).to(dt), **kw,
                                   **({"stats": stats[dt]} if train else {})))
    assert len(got[torch.bfloat16]) == len(want[BF]) == (
        TRAIN_OUTPUTS if train else OUTPUTS).get(key, 1)
    for i, (t, j) in enumerate(zip(got[torch.bfloat16], want[BF])):
        assert t.dtype == torch.bfloat16 and j.dtype == BF, (key, i)
        perm = (lambda a: a.permute(0, 2, 3, 1)) if t.dim() == 4 else (lambda a: a)
        hold_bf16(f"{key} output {i}", perm(t), j, want[jnp.float32][i],
                  perm(got[torch.float32][i]))
    if train and upd[BF]:
        new = {}
        for dt in (torch.float32, torch.bfloat16):
            assert all(t.dtype == torch.float32 for pair in stats[dt].values()
                       for t in pair)
            new[dt] = running_after(port, stats[dt])
        names = sorted(new[torch.float32])
        ref = {dt: state_dict_from_flax(variables["params"], upd[dt], family=key)
               for dt in upd}
        hold_bf16(f"{key} running statistics", stacked(new[torch.bfloat16][k]
                                                       for k in names),
                  stacked(ref[BF][k] for k in names),
                  stacked(ref[jnp.float32][k] for k in names),
                  stacked(new[torch.float32][k] for k in names))


def running_after(port, stats):
    """The running statistics after folding a pass's batch statistics with
    Flax's momentum, by state-dict name."""
    buffers = dict(port.named_buffers())
    out = {}
    for key, (mean, var) in stats.items():
        for part, batch in (("running_mean", mean), ("running_var", var)):
            out[f"{key}.{part}"] = (layers.BN_MOMENTUM * buffers[f"{key}.{part}"]
                                    + (1 - layers.BN_MOMENTUM) * batch)
    return out


def test_factory_keys_compute_in_bf16():
    """net_factory builds the six keys with model.dtype=bfloat16 at their
    factory widths: every compute module set to bf16 but the ones chap_tpu
    keeps in float32 (none in these six), float32 parameters."""
    cfg = ModelConfig()
    cfg.dtype = "bfloat16"
    for key in KEYS:
        model = net_factory(key, 1, 4, cfg, device="cpu")
        mods = [m for m in model.modules() if isinstance(m, layers._ComputeDtype)]
        assert mods and all(m.compute_dtype == torch.bfloat16 for m in mods), key
        assert all(p.dtype == torch.float32 for p in model.parameters()), key


# ---------------------------------------------------------------------------
# the bf16 single-decoder step (SwinUNet)
# ---------------------------------------------------------------------------

# SwinUNet, not ENet: ENet's train-mode pass at these sizes is bf16 noise
# in chap_tpu itself (its bf16 logits 0.33 RMS and 3.9 at most from its
# float32 ones, at 0.65 RMS; the port's 0.35 and 5.0; eval mode 2e-4 RMS in
# both), so a loss vector of three draws holds noise against noise. The
# step's parts are one: K1 with one region, the SGD update, and here the
# Dense, LayerNorm and window attention in bf16; ENet's PReLU slope
# gradient is held above (test_layers_compute_as_flax_in_bf16[prelu]).
STEP_KEY = "swinunet"
STEP_B = 4


def _step_batch(seed, hw):
    images, labels = phantom_batch(np.random.RandomState(seed), STEP_B, hw, 4)
    return to_bf16(images), labels


def _jax_step_runs(dtype_name):
    """chap_tpu's dual=False supervised step (K1 losses, as on its TPU) of
    STEP_KEY in ``dtype_name``, run from the same state on each batch of
    BATCH_SEEDS: (initial variables, the outputs)."""
    jmodel, variables = chap_tpu_pair(STEP_KEY)
    hw = ZOO[STEP_KEY][2]
    jcfg, _ = _step_cfg(STEP_B, hw)
    jcfg.model.dtype = dtype_name
    dt = BF if dtype_name == "bfloat16" else jnp.float32
    opt = jax_make_optimizer(jcfg.optim.base_lr, jcfg.optim.max_iterations,
                             jcfg.optim.momentum, jcfg.optim.weight_decay,
                             jcfg.optim.poly_power)

    def fresh_state():       # the step donates its state
        params = jax.tree.map(jnp.asarray, variables["params"])
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(jnp.asarray,
                                                      variables["batch_stats"]),
                             opt_state=opt.init(params))

    outs = []
    with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask), \
            mock.patch.object(jax_step_supervised, "dice_ce_supervised",
                              functools.partial(jax_dice.dice_ce_supervised,
                                                fused=True)):
        step = jax_step_supervised.build_supervised_train_step(
            jmodel.clone(dtype=dt), opt, jcfg, dual=False)
        for seed in BATCH_SEEDS:
            images, labels = _step_batch(seed, hw)
            outs.append(jax.device_get(rounding_jit(step, fresh_state(), {
                "image": jnp.asarray(images.transpose(0, 2, 3, 1), dt),
                "label": jnp.asarray(labels.astype(np.uint8))},
                jax.random.PRNGKey(1))))
    return variables, outs


# measured here: the loss's e_ref and the update's r; the test prints them
# (-s)
def test_single_decoder_step_bf16_matches_chap_tpu():
    """The bf16 single-decoder supervised step of SwinUNet (K1 with one
    region; Dense, LayerNorm and window attention in bf16) against
    chap_tpu's dual=False step in bf16 from the same weights: the loss
    (float32) as one vector over BATCH_SEEDS, and on the first batch the
    parameters' update by hold_updates."""
    variables, wants = _jax_step_runs("bfloat16")
    _, wants32 = _jax_step_runs("float32")
    hw = ZOO[STEP_KEY][2]
    ports = {}
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        _, cfg = _step_cfg(STEP_B, hw)
        cfg.model.dtype = name
        ports[name] = []
        for seed in BATCH_SEEDS:
            images, labels = _step_batch(seed, hw)
            model = set_compute_dtype(zoo_pair(STEP_KEY)[2], dt)
            opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                                 cfg.optim.weight_decay)
            step = build_supervised_train_step(model, opt, cfg, device="cpu")
            ports[name].append(step(
                TrainState(0, model, opt, []),
                {"image": torch.from_numpy(images).to(dt),
                 "label": torch.from_numpy(labels)}, draws={"drop": []}))
    gots, owns = ports["bfloat16"], ports["float32"]
    assert gots[0].metrics["loss"].dtype == torch.float32
    e_ref, d_ref = hold_bf16("loss", *(stacked(r.metrics["loss"] for r in rs)
                                       for rs in (gots, wants, wants32, owns)))
    sd = lambda s: state_dict_from_flax(s.params, s.batch_stats, family=STEP_KEY)
    held = hold_updates(gots[0].state.model.state_dict(), sd(wants[0].state),
                        sd(wants32[0].state), owns[0].state.model.state_dict(),
                        state_dict_from_flax(variables["params"],
                                             variables["batch_stats"],
                                             family=STEP_KEY))
    print(f"{STEP_KEY} bf16 step: loss e_ref {e_ref:.3g}, port {d_ref:.3g}; {held}")
