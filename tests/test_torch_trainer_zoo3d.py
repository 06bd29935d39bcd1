"""The 3D zoo through the port's supervised trainer and sliding-window eval
(CPU): one supervised step of unet_3D, attention_unet, voxresnet and
unet_3D_dv_semi against chap_tpu's build_supervised3d_train_step from the
same weights and dropout draws, the refusal of vnet_ds and resvnet (on which
chap_tpu's step fails), unet_3D_dv_semi's sliding-window eval against
chap_tpu's, and the BraTS protocol end to end through cli.train_3d (with
--resume) and cli.test_3d.

Bars: the loss at rtol 2e-3; the parameters and BatchNorm running stats
after the update at 1e-4 absolute (rtol 2e-3); each leaf's update (after
minus before) within 5% of its norm and all parameters' updates together
within 2%, as tests/test_torch_step3d.py holds the VNet steps (at lr 0.01 an
update is smaller than the absolute bar, so the values alone cannot show
it)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.eval.sliding_window as jax_sw
from chap_tpu.config import Config as JaxConfig
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu.train.trainer_3d import build_supervised3d_train_step as jax_supervised
import chap_tpu_torch.cli.test_3d as cli_test3d
import chap_tpu_torch.cli.train_3d as cli_train3d
import chap_tpu_torch.eval.sliding_window as sw
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import SyntheticVolumeDataset
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.trainer_3d import build_supervised3d_train_step
from test_torch_models3d import ndhwc
from test_torch_step3d import _batch
from test_torch_zoo3d import ZOO, init_flax, patch_jax_dropout

torch.set_num_threads(1)

B, C = 4, 2
PATCH = (32, 32, 16)
RTOL = 2e-3
PARAM_ATOL = 1e-4
LEAF_UPDATE_RTOL = 5e-2
UPDATE_RTOL = 2e-2
NOISE_UPDATE = 1e-6


def _cfg(cls):
    cfg = cls()
    cfg.data.num_classes = C
    cfg.data.batch_size = B
    cfg.data.patch_size_3d = PATCH
    return cfg


def _pair(key):
    jmake, pmake, feed = ZOO[key]
    jcfg = _cfg(JaxConfig)
    jmodel = jmake()
    opt = jax_make_optimizer(jcfg.optim.base_lr, jcfg.optim.max_iterations,
                             jcfg.optim.momentum, jcfg.optim.weight_decay,
                             jcfg.optim.poly_power)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(0),
                                   jnp.zeros((B, *PATCH, 1)), opt)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    cfg = update_values(dataclasses.asdict(jcfg), Config())
    port = pmake()
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"], family=key))
    popt = make_optimizer(port, cfg.optim.base_lr, cfg.optim.momentum,
                          cfg.optim.weight_decay)
    return jmodel, opt, state, variables, jcfg, port, popt, cfg, feed


def _check_update(key, before, port, want_state):
    after = state_dict_from_flax(want_state.params, want_state.batch_stats,
                                 family=key)
    got = port.state_dict()
    assert set(got) == set(after)
    err2 = norm2 = 0.0
    for name, value in after.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        want_d = (value - before[name]).double()
        err = ((got[name] - before[name]).double() - want_d).norm().item()
        norm = want_d.norm().item()
        if norm > NOISE_UPDATE:
            assert err <= LEAF_UPDATE_RTOL * norm, (
                f"{name}: update off by {err:.3e}, its norm {norm:.3e}")
        else:
            assert err <= NOISE_UPDATE, f"{name}: update off by {err:.3e}"
        if not name.endswith(("running_mean", "running_var")):
            err2, norm2 = err2 + err ** 2, norm2 + norm ** 2
    assert norm2 > 0
    assert err2 ** 0.5 <= UPDATE_RTOL * norm2 ** 0.5


@pytest.mark.parametrize("key", ["unet_3D", "attention_unet", "voxresnet",
                                 "unet_3D_dv_semi"])
def test_supervised_step_matches_chap_tpu(monkeypatch, key):
    """Loss, parameters, BatchNorm stats (attention_unet's gates) and the
    update after one step; unet_3D_dv_semi averages its four outputs'
    losses."""
    jmodel, opt, state, variables, jcfg, port, popt, cfg, feed = _pair(key)
    images, labels = _batch(21)
    rs = np.random.RandomState(22)
    drop_u = [rs.rand(*s).astype(np.float32) for s in port.dropout_shapes(B, PATCH)]
    patch_jax_dropout(monkeypatch, feed, drop_u)
    want = jax.device_get(jax_supervised(jmodel, opt, jcfg)(state, {
        "image": jnp.asarray(ndhwc(images)),
        "label": jnp.asarray(labels.astype(np.uint8))}, jax.random.PRNGKey(1)))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    pstate = TrainState(0, port, popt, [])
    got = build_supervised3d_train_step(port, popt, cfg, device="cpu")(
        pstate, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels.astype(np.uint8))},
        draws={"drop": [torch.from_numpy(u) for u in drop_u]})
    assert set(got.metrics) == set(want.metrics) == {"loss", "sup_loss"}
    for k in want.metrics:
        np.testing.assert_allclose(float(got.metrics[k]), float(want.metrics[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    _check_update(key, before, port, want.state)
    assert got.state.step == int(want.state.step) == 1


def test_supervised_step_draws_at_the_models_own_shapes():
    """Without draws, the step draws unet_3D's two dropout uniforms (center,
    up_concat1) and voxresnet's none, and trains."""
    images, labels = _batch(23)
    for key, n in (("unet_3D", 2), ("voxresnet", 0)):
        port = ZOO[key][1]()
        assert len(port.dropout_shapes(B, PATCH)) == n
        opt = make_optimizer(port, 0.01)
        out = build_supervised3d_train_step(port, opt, _cfg(Config), device="cpu")(
            TrainState(0, port, opt, []),
            {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)},
            generator=torch.Generator().manual_seed(0))
        assert np.isfinite(float(out.metrics["loss"])) and out.state.step == 1


@pytest.mark.parametrize("key,error", [("vnet_ds", TypeError),
                                       ("resvnet", ValueError)])
def test_supervised_step_refuses_vnet_ds_and_resvnet(monkeypatch, key, error):
    """Their second output is no segmentation: chap_tpu's step fails on it,
    and the port's refuses the model with a named error."""
    jmodel, opt, state, variables, jcfg, port, popt, cfg, feed = _pair(key)
    images, labels = _batch(24)
    patch_jax_dropout(monkeypatch, feed, [np.random.RandomState(0).rand(*s).astype(
        np.float32) for s in port.dropout_shapes(B, PATCH)])
    with pytest.raises(error):
        jax_supervised(jmodel, opt, jcfg)(state, {
            "image": jnp.asarray(ndhwc(images)),
            "label": jnp.asarray(labels.astype(np.uint8))}, jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match=f"key '{key}' cannot train"):
        build_supervised3d_train_step(port, popt, cfg, device="cpu")


def test_dv_semi_sliding_window_matches_chap_tpu():
    """unet_3D_dv_semi's eval averages dsv1 and dsv2 only, as chap_tpu's
    engine does: the label map of a 40 x 36 x 20 volume (8 patches, two
    batches of 4) agrees with chap_tpu's on >= 99.9% of voxels, and
    test_all_case's metrics agree; a one-patch volume is exactly the argmax
    of (dsv1 + dsv2) / 2."""
    jmake, pmake, _ = ZOO["unet_3D_dv_semi"]
    jmodel = jmake()
    variables = init_flax(jmodel, PATCH, seed=5)
    port = pmake()
    port.load_state_dict(state_dict_from_flax(variables["params"], {},
                                              family="unet_3D_dv_semi"))
    rs = np.random.RandomState(25)
    image = rs.randn(40, 36, 20).astype(np.float32)
    want = jax_sw.SlidingWindowEngine(jmodel, PATCH, sw_batch=4).predict(
        variables, image, 8, 4, C)
    got = sw.SlidingWindowEngine(port, PATCH, sw_batch=4, device="cpu").predict(
        image, 8, 4, C)
    assert 0 < got.mean() < 1, "a one-class prediction would test little"
    assert float(np.mean(got == want)) >= 0.999

    case = {"image": image, "label": (image > 0.3).astype(np.int32), "case": "c0"}
    np.testing.assert_allclose(
        sw.test_all_case(port, [case], C, PATCH, 8, 4, sw_batch=4, device="cpu"),
        jax_sw.test_all_case(jmodel, variables, [case], C, PATCH, 8, 4, sw_batch=4),
        rtol=1e-2, atol=1e-2)

    one = image[:32, :32, :16]
    with torch.no_grad():
        outs = port.eval()(torch.from_numpy(one)[None, None])
    direct = ((outs[0] + outs[1]) / 2).argmax(1)[0].numpy()
    np.testing.assert_array_equal(
        sw.SlidingWindowEngine(port, PATCH, device="cpu").predict(one, 8, 4, C),
        direct)


def test_brats_protocol_through_the_clis(tmp_path, monkeypatch):
    """cli.train_3d --cfg configs/brats_supervised.yml --method supervised
    (unet_3D, float32 by override) on synthetic volumes at a 32^3 patch,
    --resume, then cli.test_3d --model unet_3D on the latest weights. The
    test CLI's synthetic cases and patch are shrunk for the CPU."""
    argv = ["--device", "cpu", "--cfg", "configs/brats_supervised.yml",
            "--method", "supervised", "--model", "unet_3D", "--dataset",
            "synthetic", "--labeled_num", "4", "model.dtype=float32",
            "data.patch_size_3d=[32,32,32]", f"run.snapshot_root={tmp_path}",
            "run.log_every=1", "data.num_workers=1"]
    first = cli_train3d.main(argv + ["--max_iterations", "2"])
    save_dir = first["save_dir"]
    assert first["steps"] == 2 and save_dir.endswith(os.path.join(
        "synthetic", "brats_supervised_4_labeled", "unet_3D", "run_0"))
    resumed = cli_train3d.main(argv + ["--max_iterations", "3", "--resume"])
    assert resumed["steps"] == 3 and resumed["save_dir"] == save_dir

    monkeypatch.setitem(cli_test3d.PROTOCOLS, "LA", dict(
        patch=(32, 32, 32), stride_xy=16, stride_z=16, model="vnet"))
    monkeypatch.setattr(cli_test3d, "SyntheticVolumeDataset",
                        lambda shape, n, length: SyntheticVolumeDataset(
                            (40, 40, 40), n, length=length))
    metrics = cli_test3d.main(["--dataset", "synthetic", "--snapshot", save_dir,
                               "--ckpt", "latest", "--model", "unet_3D",
                               "--device", "cpu"])
    assert metrics.shape == (1, 4) and np.isfinite(metrics[:, 0]).all()
