"""bf16 compute in the port's 3D models, their BatchNorm statistics, the
sliding-window engine and K3's plain version, against chap_tpu's bf16 on the
CPU, with the bar of tests/test_torch_bf16.py (dtype; within 2 e_ref of
chap_tpu's bf16 and float32, where e_ref is chap_tpu's own bf16-vs-float32
gap on the same inputs; at least 0.1 e_ref from the port's float32; label
maps agreeing at least as well as chap_tpu's bf16 with its float32, less 0.5
points). Models at the small widths of tests/test_torch_zoo3d.py (feature
scale 16, 8 VoxResNet channels, n_filters 4) on 48 x 32 x 16 patches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.models.vnet3d as jax_vnet3d
from chap_tpu.eval.sliding_window import SlidingWindowEngine as JaxEngine
from chap_tpu.models.vnet3d import DualDecoder3d as JaxDualDecoder3d
from chap_tpu.models.vnet3d import VNet as JaxVNet
import chap_tpu_torch.eval.sliding_window as sw
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.models.layers import set_compute_dtype
from chap_tpu_torch.models.vnet3d import DualDecoder3d, VNet
from test_torch_bf16 import BF, hold_bf16, hold_maps, stacked, to_bf16
from test_torch_models import JaxFeed, RandomFeed
from test_torch_models3d import jax_dropout_feed, ncdhw, ndhwc
from test_torch_zoo3d import (NF, SPATIAL, ZOO, JaxAttentionUNet3D,
                              JaxResVNet, JaxUNet3D, JaxUNet3DDvSemi,
                              JaxVNetDS, JaxVoxResNet, flatten, init_flax,
                              patch_jax_dropout, zoo_pair)

torch.set_num_threads(1)

# key -> chap_tpu module in a dtype (the zoo's at its test widths)
JAX_MODELS = {
    "unet_3D": lambda dt: JaxUNet3D(num_classes=2, feature_scale=16, dtype=dt),
    "attention_unet": lambda dt: JaxAttentionUNet3D(num_classes=2, feature_scale=16,
                                                    dtype=dt),
    "unet_3D_dv_semi": lambda dt: JaxUNet3DDvSemi(num_classes=2, feature_scale=16,
                                                  dtype=dt),
    "voxresnet": lambda dt: JaxVoxResNet(num_classes=2, feature_chns=8, dtype=dt),
    "vnet_ds": lambda dt: JaxVNetDS(num_classes=2, n_filters=NF,
                                    normalization="batchnorm", has_dropout=True,
                                    dtype=dt),
    "resvnet": lambda dt: JaxResVNet(num_classes=2, n_filters=NF, has_dropout=True,
                                     dtype=dt),
    "vnet": lambda dt: JaxVNet(num_classes=2, n_filters=NF, normalization="batchnorm",
                               has_dropout=True, dtype=dt),
    "dualdecoder": lambda dt: JaxDualDecoder3d(num_classes=2, n_filters=NF,
                                               normalization="batchnorm",
                                               has_dropout=True, dtype=dt),
    "vnet_groupnorm": lambda dt: JaxVNet(num_classes=2, n_filters=16,
                                         normalization="groupnorm",
                                         has_dropout=True, dtype=dt),
    "vnet_instancenorm": lambda dt: JaxVNet(num_classes=2, n_filters=NF,
                                            normalization="instancenorm",
                                            has_dropout=True, dtype=dt),
}
# the VNet keys chap_tpu builds with its s2d stem (its default), whose
# transpose-conv decoder drops its output in space-to-depth layout
S2D_FEED = ("vnet", "dualdecoder", "vnet_groupnorm", "vnet_instancenorm")


def model_pair(key):
    """(chap_tpu's variables, the port's model) from one set of float32
    weights; non-trivial running stats, and random GroupNorm scales."""
    if key in ZOO:
        _, variables, port, _ = zoo_pair(key)
        return variables, port
    variables = init_flax(JAX_MODELS[key](jnp.float32), SPATIAL)
    if key == "dualdecoder":
        port = DualDecoder3d(1, 2, NF, "batchnorm", has_dropout=True)
        family, norm = "dualdecoder3d", "batchnorm"
    else:
        norm = key.split("_")[1] if "_" in key else "batchnorm"
        nf = 16 if norm == "groupnorm" else NF
        port = VNet(1, 2, nf, norm, has_dropout=True)
        family = "vnet"
        rs = np.random.RandomState(9)
        variables["params"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
                          if "GroupNorm" in jax.tree_util.keystr(p) else a),
            variables["params"])
    port.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family=family,
        normalization=norm))
    return variables, port


def feed_dropout(monkeypatch, key, drop_u):
    if key in S2D_FEED:
        monkeypatch.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(
            [np.asarray(u) for u in jax_dropout_feed(drop_u, True)])))
    else:
        patch_jax_dropout(monkeypatch, ZOO[key][2], drop_u)


def run_both(monkeypatch, key, train, x, drop_u, variables, port):
    """chap_tpu's and the port's outputs (flattened) and the port's batch
    statistics, in float32 and bf16: {dtype name: (jax outs, jax updated
    batch_stats, port outs, port stats)}."""
    runs = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", BF, torch.bfloat16)):
        jmodel = JAX_MODELS[key](jdt)
        upd = None
        if train:
            feed_dropout(monkeypatch, key, drop_u)
            want, upd = jmodel.apply(variables, jnp.asarray(x, jdt), train=True,
                                     mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(1)})
            monkeypatch.undo()
        else:
            want = jmodel.apply(variables, jnp.asarray(x, jdt), train=False)
        set_compute_dtype(port, tdt).train(train)
        stats = {}
        with torch.no_grad():
            got = port(ncdhw(x).to(tdt), drop_u=[torch.from_numpy(u) for u in drop_u],
                       stats=stats)
        runs[name] = (flatten(want), upd, flatten(got), stats)
    return runs


# e_ref measured on these inputs, eval / train, of the first output (logits
# of scale 0.4-16): unet_3D 0.22 / 0.46, attention_unet 0.33 / 0.30,
# unet_3D_dv_semi 0.33 / 0.43, voxresnet 0.22 / 0.22, vnet_ds 0.0038 /
# 0.50, resvnet 0.11 / 0.21, vnet 0.0038 / 0.50, dualdecoder 0.009 / 2.0,
# vnet_groupnorm 0.030 / 0.050, vnet_instancenorm 0.38 / 0.68
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", sorted(JAX_MODELS))
def test_3d_forward_bf16_matches_chap_tpu(monkeypatch, key, train):
    """Every net_factory_3d model (VNet also with groupnorm and
    instancenorm) in eval and train mode, every output: bf16, within the
    bar."""
    variables, port = model_pair(key)
    rs = np.random.RandomState(7)
    spatial = (16, 16, 16) if key == "vnet_groupnorm" else SPATIAL
    x = to_bf16(rs.randn(2, *spatial, 1).astype(np.float32))
    drop_u = [rs.rand(*s).astype(np.float32) for s in port.dropout_shapes(2, spatial)]
    runs = run_both(monkeypatch, key, train, x, drop_u, variables, port)
    want32, _, got32, _ = runs["float32"]
    want, _, got, _ = runs["bfloat16"]
    assert len(got) == len(want) >= 1
    for i, (g, w, w32, g32) in enumerate(zip(got, want, want32, got32)):
        assert w.dtype == BF and g.dtype == torch.bfloat16, (key, i)
        hold_bf16(f"{key} output {i}", ndhwc(g.float().numpy()), w, w32,
                  ndhwc(g32.numpy()))


# e_ref of the running means / variances after one pass, all layers:
# 1.7e-3 / 3.0e-3 (vnet, vnet_ds, dualdecoder), 1.8e-4 / 1.8e-3
# (attention_unet), at a scale of 1.4
@pytest.mark.parametrize("key", ["vnet", "vnet_ds", "dualdecoder", "attention_unet"])
def test_3d_bn_batch_statistics_bf16(monkeypatch, key):
    """A bf16 train-mode pass reports float32 batch statistics, as Flax's
    BatchNorm(dtype=bf16) keeps: the first BatchNorm's (its input is the
    same bf16 convolution in both) equal chap_tpu's to 1e-4 relative
    (statistics taken in bf16 would be off by up to 2^-9 = 2e-3), every
    layer's within the bar (all layers' means as one tensor, and their
    variances)."""
    variables, port = model_pair(key)
    rs = np.random.RandomState(8)
    x = to_bf16(rs.randn(2, *SPATIAL, 1).astype(np.float32))
    drop_u = [rs.rand(*s).astype(np.float32) for s in port.dropout_shapes(2, SPATIAL)]
    runs = run_both(monkeypatch, key, True, x, drop_u, variables, port)
    family = {"dualdecoder": "dualdecoder3d"}.get(key, key)

    def folded(stats):
        buffers = dict(port.named_buffers())
        return {f"{k}.{part}": 0.9 * buffers[f"{k}.{part}"] + 0.1 * v
                for k, (m, var) in stats.items()
                for part, v in (("running_mean", m), ("running_var", var))}

    want = {n: state_dict_from_flax(variables["params"], jax.device_get(r[1]["batch_stats"]),
                                    family=family) for n, r in runs.items()}
    got = {n: folded(r[3]) for n, r in runs.items()}
    assert all(s.dtype == torch.float32 for pair in runs["bfloat16"][3].values()
               for s in pair)
    first = min(got["bfloat16"], key=lambda k: list(dict(port.named_buffers())).index(k))
    np.testing.assert_allclose(got["bfloat16"][first].numpy(),
                               want["bfloat16"][first].numpy(), rtol=1e-4, atol=1e-7)
    for part in ("running_mean", "running_var"):
        keys = [k for k in got["bfloat16"] if k.endswith(part)]
        hold_bf16(part, *(stacked(d[k] for k in keys) for d in (
            got["bfloat16"], want["bfloat16"], want["float32"], got["float32"])))


# ---------------------------------------------------------------------------
# K3's plain version and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("outputs", [1, 2])
def test_k3_plain_at_bf16_logits(outputs):
    """The plain version at bf16 logits: the two outputs' mean is their sum
    rounded to bf16 and halved (chap_tpu's bf16 (out[0] + out[1]) / 2.0),
    the softmax and the sums float32; equal to a direct loop doing the
    same."""
    rs = np.random.RandomState(3)
    shape, patch = (20, 18, 12), (8, 8, 8)
    starts = sw.compute_grid(shape, patch, 6, 4)
    l1 = torch.from_numpy(rs.randn(len(starts), 2, *patch).astype(np.float32) * 3
                          ).bfloat16()
    l2 = None if outputs == 1 else torch.from_numpy(
        rs.randn(len(starts), 2, *patch).astype(np.float32) * 3).bfloat16()
    score, cnt = torch.zeros(2, *shape), torch.zeros(shape)
    sw.sw_accumulate(l1, l2, starts, score, cnt)
    mean = l1 if l2 is None else (l1 + l2) / 2.0
    assert mean.dtype == torch.bfloat16
    out = mean.double().numpy()
    e = np.exp(out - out.max(1, keepdims=True))
    probs = e / e.sum(1, keepdims=True)
    want_s, want_c = np.zeros((2,) + shape), np.zeros(shape)
    for i, st in enumerate(starts):
        sl = tuple(slice(int(st[d]), int(st[d]) + patch[d]) for d in range(3))
        want_s[(slice(None),) + sl] += probs[i]
        want_c[sl] += 1
    np.testing.assert_allclose(score.numpy(), want_s, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), want_c)
    if l2 is not None:
        # the mean really is rounded in bf16, not taken in float32
        assert not torch.equal((l1 + l2).float() / 2, ((l1.float() + l2.float()) / 2))


# label maps: chap_tpu's bf16 and float32 maps agree on 99.98%
# (dualdecoder) and 99.14-99.17% (unet_3D) of voxels here, the port's bf16
# and chap_tpu's bf16 on 100% and 99.95%
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["dualdecoder", "unet_3D"])
def test_engine_bf16_matches_chap_tpu(key, compute):
    """SlidingWindowEngine with a bf16 model (the engine's default float32
    patches, and compute_dtype=bfloat16 patches) against chap_tpu's engine
    with the same bf16 model and compute dtype; K3's plain version takes
    the bf16 logits."""
    variables, port = model_pair(key)
    rs = np.random.RandomState(4)
    shape = (56, 40, 24)
    label = np.zeros(shape, np.int32)
    label[10:40, 8:30, 4:20] = 1
    image = (label + rs.normal(0, 0.4, shape)).astype(np.float32)
    jdt = BF if compute == "bfloat16" else jnp.float32
    maps = {}
    for name, dt, tdt in (("float32", jnp.float32, torch.float32),
                          ("bfloat16", BF, torch.bfloat16)):
        jmodel = JAX_MODELS[key](dt)
        want = JaxEngine(jmodel, SPATIAL, sw_batch=4, compute_dtype=jdt,
                         pack_binary=False).predict(variables, image, 16, 8, 2)
        engine = sw.SlidingWindowEngine(
            set_compute_dtype(port, tdt), SPATIAL, sw_batch=4,
            compute_dtype=torch.bfloat16 if compute == "bfloat16" else torch.float32,
            device="cpu")
        maps[name] = (want, engine.predict(image, 16, 8, 2))
    want, got = maps["bfloat16"]
    want32 = maps["float32"][0]
    assert 0.01 < float(np.mean(want == 1)) < 0.99
    hold_maps(f"{key} {compute}", got, want, want32)


def test_engine_casts_the_volume_to_its_compute_dtype(monkeypatch):
    """compute_dtype=bfloat16: the patches reach the model in bf16, rounded
    from the float32 volume; the default hands it float32 patches."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x):
            seen.append(x)
            return torch.cat([x, -x], dim=1)

    image = np.random.RandomState(0).rand(8, 8, 8).astype(np.float32) * 3
    for dt in (torch.bfloat16, torch.float32):
        sw.SlidingWindowEngine(Probe(), (8, 8, 8), compute_dtype=dt,
                               device="cpu").predict(image, 8, 8, 2)
    assert seen[0].dtype == torch.bfloat16 and seen[1].dtype == torch.float32
    np.testing.assert_array_equal(seen[0][0, 0].float().numpy(), to_bf16(image))
    with pytest.raises(ValueError, match="not float32 or bfloat16"):
        sw.SlidingWindowEngine(Probe(), (8, 8, 8), compute_dtype=torch.float16,
                               device="cpu")


@pytest.mark.parametrize("dtypes", [(torch.float16, None),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)],
                         ids=["float16", "bf16_f32", "f32_bf16"])
def test_k3_wrapper_refuses_other_and_mixed_logits(dtypes):
    """The K3 wrapper takes float32 or bf16 logits, both outputs alike (the
    bf16 ones through ``chap_sw_accumulate_bf16``); float16 and mixed pairs
    are refused before anything reaches the card, and nothing is ever
    upconverted to reach the float32 kernel."""
    starts = np.zeros((2, 3), np.int32)
    l1 = torch.zeros(2, 2, 4, 4, 4, dtype=dtypes[0])
    l2 = None if dtypes[1] is None else torch.zeros(2, 2, 4, 4, 4, dtype=dtypes[1])
    with pytest.raises(ValueError, match="float32 or bfloat16 logits"):
        sw.sw_accumulate_kernel(l1, l2, starts, torch.zeros(2, 8, 8, 8),
                                torch.zeros(8, 8, 8))
    assert sw._ENTRY == {torch.float32: "chap_sw_accumulate",
                         torch.bfloat16: "chap_sw_accumulate_bf16"}
    assert sw.sw_accumulate_kernel.launches == 0
