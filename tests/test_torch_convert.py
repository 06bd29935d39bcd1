"""Reference .pth import (convert/from_pth.py, cli/convert_torch.py) against
chap_tpu's converter (chap_tpu/convert/torch_import.py) on the CPU.

For each family of chap_tpu's ``_FAMILIES`` a reference-named state dict
is made from chap_tpu's seeded variables (state_dict_from_flax's names are
the reference's: tests/test_torch_zoo2d.py and test_torch_models.py hold
the round trip through convert_state_dict), written as a .pth behind a
``module.`` prefix and a ``{"state_dict": ...}`` wrapper. chap_tpu's
convert_state_dict takes it into its factory's model; the port's
cli.convert_torch writes a snapshot that cli.test_2d / cli.test_3d's
restore path loads; both forwards agree at 5e-4. Models at the factories'
full widths (2D feature_chns 16-256, swinunet at 224^2 with embed 96, 3D
n_filters_3d 16, unet_3D feature_scale 4), one small input each.

Three families chap_tpu's own CLI cannot convert (dualdecoder3d, vnet_ds,
swinunet: ROADMAP §3) are converted here through chap_tpu's library
(convert_state_dict with the right factory key), which can. The ImageNet
ingest (EfficientNet with patch_first_conv, the Swin surgery) runs on
synthetic state dicts, as tests/test_pretrained_ingest.py and
test_swin_parity.py do."""
import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chap_tpu.config import Config as JaxConfig
from chap_tpu.convert.torch_import import (convert_efficientnet_pretrained as
                                           jax_convert_efficientnet,
                                           convert_state_dict,
                                           convert_swin_pretrained as jax_convert_swin)
import chap_tpu.models.swin_unet as jax_swin
from chap_tpu.models import factory as jax_factory
from chap_tpu.models.efficientunet import EffiUNet as JaxEffiUNet
from chap_tpu.models.swin_unet import SwinUNet as JaxSwinUNet
from chap_tpu_torch.cli import convert_torch as cli_convert
from chap_tpu_torch.cli import test_2d as cli_test_2d
from chap_tpu_torch.cli import test_3d as cli_test_3d
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.convert.from_pth import (convert_efficientnet_pretrained,
                                             convert_swin_pretrained,
                                             load_reference_state_dict,
                                             swin_encoder_surgery)
from chap_tpu_torch.models.efficientunet import EffiUNet
from chap_tpu_torch.models.factory import net_factory, net_factory_3d
from chap_tpu_torch.models.swin_unet import SwinUNet
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_library import seeded_variables

torch.set_num_threads(1)

ATOL = 5e-4
# family -> (chap_tpu factory key, dimension, input side, classes); the
# carrier's family for the same names
FAMILIES = {"dualdecoder": ("dualdecoder", 2, 64, 4),
            "unet": ("unet", 2, 64, 4), "unetp": ("unetp", 2, 64, 4),
            "swinunet": ("swinunet", 2, 224, 4),
            "vnet": ("vnet", 3, 32, 2), "vnet_ds": ("vnet_ds", 3, 32, 2),
            "dualdecoder3d": ("dualdecoder", 3, 32, 2),
            "unet_3D": ("unet_3D", 3, 32, 2)}


def cf(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def cl(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def leaves(out):
    return [o for x in out for o in leaves(x)] if isinstance(out, (tuple, list)) else [out]


@functools.lru_cache(maxsize=None)
def chap_model(family):
    """chap_tpu's factory model of a family and its seeded variables."""
    key, dim, side, classes = FAMILIES[family]
    jcfg = JaxConfig()
    if dim == 2:
        model = jax_factory.net_factory(key, 1, classes, jcfg.model)
        x = jnp.zeros((1, side, side, 1))
    else:
        model = jax_factory.net_factory_3d(key, 1, classes, mode="test", cfg=jcfg.model)
        x = jnp.zeros((1, side, side, side if key == "unet_3D" else 16, 1))
    shapes = swin_safe_eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                                      train=False))
    return model, seeded_variables(shapes, seed=3), x.shape


def swin_safe_eval_shape(fn):
    """jax.eval_shape of ``fn``, chap_tpu's SwinUNet window masks (numpy
    of a jnp window partition) computed eagerly, as outside a trace."""
    real = jax_swin._shift_attn_mask

    def eager(*args):
        with jax.ensure_compile_time_eval():
            return real(*args)

    with mock.patch.object(jax_swin, "_shift_attn_mask", eager):
        shapes = jax.eval_shape(fn)
    return {k: dict(v) for k, v in shapes.items()}


def reference_state_dict(family):
    """The reference's names and tensors of chap_tpu's seeded weights."""
    _, variables, _ = chap_model(family)
    return state_dict_from_flax(variables["params"], variables["batch_stats"],
                                family=family)


def write_pth(sd, path):
    """A training script's checkpoint: DataParallel names in a wrapper."""
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return path


def chap_forward(family, sd, x):
    model, variables, _ = chap_model(family)
    converted = convert_state_dict(family, {k: v.numpy() for k, v in sd.items()},
                                   variables)
    return leaves(model.apply(converted, jnp.asarray(x), train=False))


def port_restore(family, snap):
    key, dim, _, classes = FAMILIES[family]
    if dim == 2:
        cfg, model = cli_test_2d.restore(snap, "best", "cpu")
        assert cfg.model.name == key
        return model
    with open(os.path.join(snap, "config.json")) as f:
        assert json.load(f)["model"]["name_3d"] == key
    return cli_test_3d.restore(snap, key, classes, "best", "cpu")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_torch_snapshot_matches_chap_tpu(tmp_path, family):
    """A .pth of each family through cli.convert_torch, restored as the
    test CLIs restore it, gives chap_tpu's forward of the same checkpoint
    at 5e-4; the snapshot's config names the factory key (swinunet at
    224^2), its best slot carries step 0 and zero GradSim scores where the
    2D CHAP model has them."""
    sd = reference_state_dict(family)
    pth = write_pth(sd, str(tmp_path / f"{family}.pth"))
    snap = str(tmp_path / "snap")
    classes = FAMILIES[family][3]
    cli_convert.main(["--pth", pth, "--model", family, "--out", snap,
                      "--num_classes", str(classes), "--device", "cpu"])
    model = port_restore(family, snap).eval()
    _, _, shape = chap_model(family)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = chap_forward(family, sd, x)
    with torch.no_grad():
        got = leaves(model(cf(x)))
    assert len(got) == len(want)
    for i, (t, j) in enumerate(zip(got, want)):
        np.testing.assert_allclose(cl(t), np.asarray(j), atol=ATOL, rtol=0,
                                   err_msg=f"{family} output {i}")
    payload = torch.load(os.path.join(snap, "checkpoints", "best", "state.pt"),
                         weights_only=True)
    assert payload["step"] == 0
    if family == "dualdecoder":
        assert [float(s.abs().sum()) for s in payload["sim_scores"]] == [0.0] * 5
    else:
        assert payload["sim_scores"] == []
    if family == "swinunet":
        with open(os.path.join(snap, "config.json")) as f:
            assert json.load(f)["data"]["image_size"] == [224, 224]


@pytest.mark.parametrize("family", ["dualdecoder", "dualdecoder3d"])
def test_stray_and_missing_keys_are_refused(tmp_path, family):
    """Strict: a key the model does not take is refused by both
    converters; a missing one too; num_batches_tracked, Swin's buffers
    and the wrapper are not."""
    sd = reference_state_dict(family)
    _, variables, _ = chap_model(family)
    key, dim, _, classes = FAMILIES[family]
    model = (net_factory(key, 1, classes, device="cpu") if dim == 2 else
             net_factory_3d(key, 1, classes, mode="test", device="cpu"))
    stray = {**sd, "stray.weight": torch.zeros(3)}
    with pytest.raises(ValueError, match="not consumed"):
        convert_state_dict(family, {k: v.numpy() for k, v in stray.items()}, variables)
    with pytest.raises(ValueError, match="not consumed"):
        load_reference_state_dict(model, stray, family)
    with pytest.raises(ValueError, match="not consumed"):
        cli_convert.main(["--pth", write_pth(stray, str(tmp_path / "s.pth")),
                          "--model", family, "--out", str(tmp_path / "o"),
                          "--num_classes", str(classes), "--device", "cpu"])
    missing = {k: v for k, v in sd.items() if not k.endswith("out_conv.bias")}
    with pytest.raises(KeyError):
        load_reference_state_dict(model, missing, family)
    quiet = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    quiet["x.relative_position_index"] = torch.zeros(2)
    load_reference_state_dict(model, {"state_dict": quiet}, family)
    with pytest.raises(ValueError, match="no converter"):
        cli_convert.convert("x.pth", "resunet", str(tmp_path / "r"), device="cpu")


@pytest.mark.parametrize("family", ["dualdecoder", "vnet"])
def test_port_snapshot_is_read_by_chap_tpu_converter(tmp_path, family):
    """No export entry point is needed: a port checkpoint slot's model
    state dict carries the reference's names, so chap_tpu's
    convert_state_dict reads it (strict) and gives the port's forward."""
    key, dim, _, classes = FAMILIES[family]
    torch.manual_seed(4)
    model = (net_factory(key, 1, classes, device="cpu") if dim == 2 else
             net_factory_3d(key, 1, classes, mode="test", device="cpu"))
    CheckpointManager(str(tmp_path)).save_best(
        create_train_state(model, make_optimizer(model, 0.01)))
    payload = torch.load(tmp_path / "checkpoints" / "best" / "state.pt",
                         weights_only=True)
    _, _, shape = chap_model(family)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = chap_forward(family, payload["model"], x)
    with torch.no_grad():
        got = leaves(model.eval()(cf(x)))
    for t, j in zip(got, want):
        np.testing.assert_allclose(cl(t), np.asarray(j), atol=ATOL, rtol=0)


def _b0_checkpoint(rs):
    """A lukemelas b0 checkpoint: the port encoder's names (chap_tpu's
    efficientnet_b0_rules spell the same) with small random values, plus
    classifier keys the encoder ignores."""
    enc = EffiUNet(1, 4).encoder
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        shape = (v.shape[0], 3) + tuple(v.shape[2:]) if k == "_conv_stem.weight" else v.shape
        a = (rs.rand(*shape).astype(np.float32) - 0.5) * 0.2
        sd[k] = torch.from_numpy(a + 1.0 if k.endswith("running_var") else a)
    sd["_conv_head.weight"] = torch.zeros(1280, 320, 1, 1)
    sd["_fc.weight"] = torch.zeros(1000, 1280)
    return sd


@pytest.mark.parametrize("in_chns", [1, 2, 3])
def test_efficientnet_pretrained_ingest(in_chns):
    """patch_first_conv for 1, 2 and 3 channels, then the EffiUNet's
    forward against chap_tpu's convert_efficientnet_pretrained on the same
    checkpoint (the decoder from the same seeded weights); 5 channels and
    a checkpoint short of an encoder key are refused."""
    rs = np.random.RandomState(in_chns)
    sd = _b0_checkpoint(rs)
    jmodel = JaxEffiUNet(4)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, in_chns)),
                                                train=False))
    variables = seeded_variables({k: dict(v) for k, v in shapes.items()}, seed=6)
    want_v = jax_convert_efficientnet({k: v.numpy() for k, v in sd.items()}, variables,
                                      in_chns=in_chns)
    port = EffiUNet(in_chns, 4)
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"],
                                              family="efficient_unet"))
    convert_efficientnet_pretrained(sd, port, in_chns=in_chns)
    stem = sd["_conv_stem.weight"]
    want_stem = {1: stem.sum(1, keepdim=True), 2: stem[:, :2] * 1.5, 3: stem}[in_chns]
    torch.testing.assert_close(port.encoder._conv_stem.weight.data, want_stem)
    x = rs.randn(2, 64, 64, in_chns).astype(np.float32)
    want = jmodel.apply(want_v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.eval()(cf(x))
    np.testing.assert_allclose(cl(got), np.asarray(want), atol=ATOL, rtol=0)
    if in_chns == 1:
        with pytest.raises(ValueError, match="in_chns"):
            convert_efficientnet_pretrained(sd, EffiUNet(5, 4), in_chns=5)
        short = {k: v for k, v in sd.items() if k != "_blocks.15._se_reduce.weight"}
        with pytest.raises(KeyError):
            convert_efficientnet_pretrained(short, EffiUNet(1, 4), in_chns=1)


SWIN = dict(img_size=32, embed_dim=24, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
            window_size=4)


def test_swin_pretrained_ingest():
    """An encoder-only {'model': ...} checkpoint: the port's lenient load
    with the load_from mirror gives exactly chap_tpu's
    convert_swin_pretrained tree (encoder stages loaded, each mirrored
    decoder stage whose shapes fit, the rest, the output head among them,
    as before); a checkpoint of no encoder key is refused by both."""
    jmodel = JaxSwinUNet(3, **SWIN)
    variables = seeded_variables(swin_safe_eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)), seed=7)
    fresh = state_dict_from_flax(variables["params"], {}, family="swinunet")
    rs = np.random.RandomState(8)
    enc = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
           for k, v in fresh.items() if k.startswith(("layers.", "patch_embed.", "norm."))}
    want = jax_convert_swin({"model": {k: v.numpy() for k, v in enc.items()}},
                            variables, depths=SWIN["depths"])
    port = SwinUNet(3, 3, **SWIN)
    port.load_state_dict(fresh)
    convert_swin_pretrained({"model": enc}, port)
    want_sd = state_dict_from_flax(want["params"], {}, family="swinunet")
    got = port.state_dict()
    for k, v in want_sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    full = swin_encoder_surgery(enc)
    assert torch.equal(got["layers_up.3.blocks.0.attn.qkv.weight"],
                       full["layers_up.3.blocks.0.attn.qkv.weight"])
    assert torch.equal(got["layers_up.3.blocks.0.attn.qkv.weight"],
                       enc["layers.0.blocks.0.attn.qkv.weight"])
    assert torch.equal(got["output.weight"], fresh["output.weight"])
    assert not torch.equal(got["layers_up.1.blocks.0.attn.qkv.weight"],
                           fresh["layers_up.1.blocks.0.attn.qkv.weight"])
    with pytest.raises(ValueError, match="encoder"):
        convert_swin_pretrained({"model": {"head.weight": torch.zeros(2)}}, port)
    with pytest.raises(ValueError, match="encoder"):
        jax_convert_swin({"model": {"head.weight": np.zeros(2)}}, variables,
                         depths=SWIN["depths"])
