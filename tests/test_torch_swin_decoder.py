"""The port's SwinDecoder (chap_tpu_torch/models/swin_unet.py) against
chap_tpu's (chap_tpu/models/swin_unet.py:194-279) on the CPU.

chap_tpu's own test size (tests/test_swin_decoder.py): img 32, embed_dim 8,
heads (1, 2, 2, 4, 4), window 4 (so the stages at grids 8 and 16 shift
their windows and the stages at 2 and 4 take one window), projection 16,
over a 5-level pyramid of (16, 32, 64, 128, 256) channels drawn from a
numpy seed. chap_tpu's variables are seeded from numpy over the shapes of
its train-mode init with the projector head (jax.eval_shape; the window
masks made eagerly) and carried into the port by state_dict_from_flax (a
strict load). Forwards at 5e-4, the projector head's BatchNorm in train
mode by its folded running statistics, the parameter gradients of a
dice + CE loss at rtol 2e-3, and bf16 by tests/test_torch_bf16.py's bar
against chap_tpu's module jitted without excess precision
(tests/test_torch_bf16_zoo2d.py's ``rounding_jit``)."""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.swin_unet as jax_swin
from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.models.layers import set_compute_dtype
from chap_tpu_torch.models.swin_unet import SwinDecoder
from test_torch_bf16 import BF, hold_bf16, stacked, to_bf16
from test_torch_bf16_zoo2d import eager_mask, rounding_jit, running_after
from test_torch_library import seeded_variables
from test_torch_zoo3d import check_folded_stats

torch.set_num_threads(1)

ATOL = 5e-4          # the port's fp32 forward bar against chap_tpu
GRAD_RTOL = 2e-3     # losses and gradients
CHANS = (16, 32, 64, 128, 256)
SIDE, B, CLASSES, PROJ = 32, 2, 4, 16
KW = dict(num_classes=CLASSES, img_size=SIDE, embed_dim=8,
          num_heads=(1, 2, 2, 4, 4), window_size=4, projection_dim=PROJ)


def pyramid(seed=0):
    """The 5 levels, channels last (chap_tpu's layout), float32 numpy."""
    rs = np.random.RandomState(seed)
    return [rs.randn(B, SIDE >> i, SIDE >> i, c).astype(np.float32)
            for i, c in enumerate(CHANS)]


def nchw(levels, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 1))).to(dtype)
            for f in levels]


def nhwc(t):
    return t.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def chap_tpu_decoder():
    """chap_tpu's module and seeded variables of its train-mode init with
    the projector head (every parameter and the BatchNorm exist); made once."""
    jmodel = jax_swin.SwinDecoder(**KW)
    feats = [jnp.zeros(f.shape) for f in pyramid()]
    with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask):
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, feats, train=True,
            with_features=True))
    return jmodel, seeded_variables({k: dict(v) for k, v in shapes.items()})


def decoder_pair():
    jmodel, variables = chap_tpu_decoder()
    port = SwinDecoder(CHANS, **KW)
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family="swin_decoder"))
    return jmodel, variables, port


def jax_apply(jmodel, variables, levels, dtype=jnp.float32, **kw):
    """chap_tpu's module in ``dtype`` under rounding_jit (the window masks
    made eagerly inside the trace)."""
    model = jmodel.clone(dtype=dtype)
    with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask):
        return jax.device_get(rounding_jit(
            lambda v, f: model.apply(v, f, **kw), variables,
            [jnp.asarray(f, dtype) for f in levels]))


def test_carrier_names_every_port_tensor():
    """state_dict_from_flax fills every parameter and buffer of the port's
    SwinDecoder (the strict load of decoder_pair) and nothing else; a tree
    without the projector head carries everything but the head."""
    _, variables, port = decoder_pair()
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              family="swin_decoder")
    assert set(sd) == set(port.state_dict())
    headless = {k: v for k, v in variables["params"].items()
                if k not in ("proj1", "proj_bn", "proj2")}
    sd = state_dict_from_flax(headless, {}, family="swin_decoder")
    assert set(sd) == {k for k in port.state_dict()
                       if not k.startswith(("proj1.", "proj_bn.", "proj2."))}


@pytest.mark.parametrize("train,with_features", [(False, False), (False, True),
                                                  (True, True)],
                         ids=["eval", "eval-features", "train-features"])
def test_forward_matches_chap_tpu(train, with_features):
    """The logits at 5e-4 in eval mode; with the projector head the
    projection too, in eval mode (running statistics) and in train mode
    (batch statistics, folded into the running ones as chap_tpu's updated
    batch_stats)."""
    jmodel, variables, port = decoder_pair()
    levels = pyramid(1)
    out = jax_apply(jmodel, variables, levels, train=train,
                    with_features=with_features,
                    mutable=["batch_stats"] if train else False)
    want = out[0] if train else out
    port.train(train)
    stats = {}
    with torch.no_grad():
        got = port(nchw(levels), with_features=with_features, stats=stats)
    got, want = ((got, want) if with_features else ((got,), (want,)))
    assert len(got) == len(want) == (2 if with_features else 1)
    for i, (t, j) in enumerate(zip(got, want)):
        assert t.shape == (B, (CLASSES, PROJ)[i], SIDE, SIDE)
        np.testing.assert_allclose(nhwc(t).numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0, err_msg=f"output {i}")
    if train:
        check_folded_stats(port, stats, state_dict_from_flax(
            variables["params"], out[1]["batch_stats"], family="swin_decoder"))
    else:
        assert stats == {}


def test_gradients_match_chap_tpu():
    """The parameter gradients of dice_ce_supervised on the logits plus the
    projection's mean, in train mode, equal jax.grad of chap_tpu's at rtol
    2e-3, and so does the loss (proj1's bias, whose gradient is 0 but for
    rounding, is held near 0 in both)."""
    jmodel, variables, port = decoder_pair()
    levels = pyramid(2)
    labels = np.random.RandomState(3).randint(0, CLASSES, (B, SIDE, SIDE))

    def loss(params):
        (logits, proj), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            [jnp.asarray(f) for f in levels], train=True, with_features=True,
            mutable=["batch_stats"])
        return (jax_dice_ce(logits, jnp.asarray(labels, jnp.int32), CLASSES)
                + jnp.mean(proj))

    with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask):
        j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = state_dict_from_flax(jax.device_get(j_grads), variables["batch_stats"],
                                family="swin_decoder")
    port.train()
    logits, proj = port(nchw(levels), with_features=True, stats={})
    p_loss = (dice_ce_supervised(logits, torch.from_numpy(labels), CLASSES)
              + proj.mean())
    p_loss.backward()
    np.testing.assert_allclose(float(p_loss.detach()), float(j_loss), rtol=GRAD_RTOL)
    got = dict(port.named_parameters())
    assert set(got) <= set(want)
    # proj1's bias feeds a train-mode BatchNorm, which subtracts it again:
    # its gradient is 0 in exact arithmetic and rounding noise in both
    scale = float(want["proj1.weight"].abs().max())
    for g in (got["proj1.bias"].grad, want["proj1.bias"]):
        assert float(g.abs().max()) <= 1e-3 * scale
    for k, p in got.items():
        if k == "proj1.bias":
            continue
        w = want[k].numpy()
        assert p.grad is not None, k
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(w).max()) + 1e-7,
                                   err_msg=k)


def test_wrong_pyramid_raises():
    """Three levels of five raise ValueError in both packages; a pyramid
    of another size than img_size's raises in the port."""
    jmodel, variables, port = decoder_pair()
    levels = pyramid()
    with pytest.raises(ValueError, match="pyramid levels"):
        port(nchw(levels[:3]))
    with pytest.raises(ValueError):
        with mock.patch.object(jax_swin, "_shift_attn_mask", eager_mask):
            jmodel.apply(variables, [jnp.asarray(f) for f in levels[:3]])
    with pytest.raises(ValueError, match="img_size"):
        port([torch.nn.functional.avg_pool2d(f, 2) for f in nchw(levels)])
    with pytest.raises(ValueError, match="channel counts"):
        SwinDecoder(CHANS[:4], **KW)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_matches_chap_tpu(train):
    """model.dtype=bfloat16: the logits and the projection against
    chap_tpu's bf16 module over the same float32 weights, by the bar of
    tests/test_torch_bf16.py; in train mode the projector BatchNorm's new
    running statistics too (float32 in both)."""
    jmodel, variables, port = decoder_pair()
    levels = [to_bf16(f) for f in pyramid(4)]
    want, upd = {}, {}
    for dt in (jnp.float32, BF):
        out = jax_apply(jmodel, variables, levels, dt, train=train,
                        with_features=True,
                        mutable=["batch_stats"] if train else False)
        want[dt] = out[0] if train else out
        if train:
            upd[dt] = out[1]["batch_stats"]
    got, stats = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        set_compute_dtype(port, dt).train(train)
        stats[dt] = {}
        with torch.no_grad():
            got[dt] = port(nchw(levels, dt), with_features=True, stats=stats[dt])
    for i, name in enumerate(("logits", "projection")):
        t, j = got[torch.bfloat16][i], want[BF][i]
        assert t.dtype == torch.bfloat16 and j.dtype == BF, name
        hold_bf16(name, nhwc(t), j, want[jnp.float32][i],
                  nhwc(got[torch.float32][i]))
    if train:
        new = {dt: running_after(port, stats[dt]) for dt in stats}
        assert all(t.dtype == torch.float32 for pair in stats[torch.bfloat16].values()
                   for t in pair)
        ref = {dt: state_dict_from_flax(variables["params"], upd[dt],
                                        family="swin_decoder") for dt in upd}
        names = sorted(new[torch.float32])
        hold_bf16("running statistics", stacked(new[torch.bfloat16][k] for k in names),
                  stacked(ref[BF][k] for k in names),
                  stacked(ref[jnp.float32][k] for k in names),
                  stacked(new[torch.float32][k] for k in names))
