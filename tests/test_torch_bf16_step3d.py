"""bf16 3D train steps and the 3D trainer on the CPU: one CHAP step of the
DualDecoder3d against chap_tpu's build_chap_train_step, the cps step, and
unet_3D's supervised step, each run by chap_tpu in bf16 and in float32 and
by the port in both, from the same weights, draws and bf16 batches; then
``cli.train_3d --cfg configs/la_chap.yml`` as written (bf16) with
``--resume`` and ``cli.test_3d``.

The bar is tests/test_torch_bf16.py's: the metrics (one vector over the
step run on the batches of ``BATCH_SEEDS``) and the GradSim scores within 2
e_ref of chap_tpu's bf16 and float32 and at least 0.1 e_ref from the port's
float32, where e_ref is chap_tpu's own bf16-vs-float32 gap; pseudo-labels
agreeing at least as well as chap_tpu's bf16 maps with its float32 ones,
less 0.5 points; parameter updates as tests/test_torch_step3d.py holds them,
each bar raised by 2x chap_tpu's bf16 gap (hold_updates). Sizes as
tests/test_torch_step3d.py: nf 4, patch 32x32x16, batch 2 + 2."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.mix as jax_mix
import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.models.vnet3d as jax_vnet3d
import chap_tpu.train.step_chap as jax_step_chap
import chap_tpu.train.trainer_3d as jax_trainer_3d
from chap_tpu.config import Config as JaxConfig
from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce_supervised
from chap_tpu.models import net_factory_3d as jax_net_factory_3d
from chap_tpu.semi.gradsim import VNET_LEVEL_PATHS as JAX_VNET_LEVEL_PATHS
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
import chap_tpu_torch.cli.test_3d as cli_test3d
import chap_tpu_torch.cli.train_3d as cli_train3d
import chap_tpu_torch.train.step_chap as step_chap
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import SyntheticVolumeDataset
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.models.vnet3d import dropout_shapes
from chap_tpu_torch.semi.bcp import generate_mask_nd
from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.trainer_3d import (build_cps3d_train_step,
                                             build_supervised3d_train_step)
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_bf16 import (BF, METRIC_DTYPES, bf16_grid_uniform, hold_bf16,
                             hold_maps, hold_updates, stacked, to_bf16)
from test_torch_models import JaxFeed, RandomFeed
from test_torch_models3d import jax_dropout_feed, ndhwc
from test_torch_step3d import (B, C, CHNS, LB, METRICS, NF, PATCH, STARTS,
                               _batch, _configure, _jax_state)
from test_torch_zoo3d import ZOO, patch_jax_dropout

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (BF, torch.bfloat16)}
BATCH_SEEDS = (7, 8)


def _inputs(seed=BATCH_SEEDS[0]):
    """A bf16 batch (the pool's dtype) and the step's draws, the same for
    every batch (chap_tpu traces them into its compiled step once); the VAT
    draw on chap_tpu's bf16 uniform grid."""
    rs = np.random.RandomState(2)
    images, labels = _batch(seed)
    images = to_bf16(images)
    drop = {p: [rs.rand(*s).astype(np.float32)
                for s in dropout_shapes(B - LB, NF, PATCH, 2)]
            for p in ("teacher", "student", "fp", "vat")}
    shapes = perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    pert = [[rs.rand(*s).astype(np.float32) for s in lvl] for lvl in shapes]
    vat_u = bf16_grid_uniform(rs, (B - LB, 1, *PATCH))
    sim = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in CHNS]
    return images, labels, drop, pert, vat_u, sim


def _cfg(cls, dtype_name):
    cfg = _configure(cls())
    cfg.model.dtype = dtype_name
    return cfg


def _chap_tpu_chap_step(dtype_name):
    """chap_tpu's 3D CHAP step in ``dtype_name`` (K1 for its mix losses),
    compiled once and run from the same state on each batch of
    BATCH_SEEDS: (initial variables, the outputs, the pseudo-labels around
    its NMS on the first batch)."""
    images, labels, drop, pert, vat_u, sim = _inputs()
    cfg = _cfg(JaxConfig, dtype_name)

    def fresh_state():       # the step donates its state
        model, opt, state, variables = _jax_state(cfg)
        return (model, opt, state.replace(sim_scores=tuple(
            jnp.asarray(s) for s in sim)), variables)

    model, opt, state, variables = fresh_state()
    mask = np.asarray(generate_mask_nd(PATCH, STARTS))
    feed = []
    for name in ("teacher", "student", "fp", "vat", "vat"):
        feed += jax_dropout_feed(drop[name], cfg.model.s2d_stem)
    captured = []

    def record(seg, n):
        out = real_nms(seg, n)
        jax.debug.callback(lambda a, b: captured.append((np.asarray(a), np.asarray(b))),
                           seg, out)
        return out

    real_nms = jax_step_chap.largest_cc_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_chap, "generate_mask_nd", lambda rng, spatial: jnp.asarray(mask))
        mp.setattr(jax_step_chap, "largest_cc_batch", record)
        mp.setattr(jax_step_chap, "mix_loss",
                   functools.partial(jax_mix.mix_loss, fused=True))
        mp.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(feed)))
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in pert for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed([ndhwc(vat_u)])))
        step = jax_step_chap.build_chap_train_step(
            model, opt, cfg, use_nms=True, level_paths=JAX_VNET_LEVEL_PATHS)
        outs = []
        for i, seed in enumerate(BATCH_SEEDS):
            images, labels = _inputs(seed)[:2]
            batch = {"image": jnp.asarray(ndhwc(images), DTYPES[dtype_name][0]),
                     "label": jnp.asarray(labels.astype(np.uint8))}
            outs.append(jax.device_get(step(state if i == 0 else fresh_state()[2],
                                            batch, jax.random.PRNGKey(42))))
    return variables, outs, captured[0]


def _port_model(cfg, variables):
    model = net_factory_3d("dualdecoder", 1, C, "train", cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], family="dualdecoder3d"))
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    return model, opt


def _port_chap_step(variables, dtype_name, seed, capture=None):
    images, labels, drop, pert, vat_u, sim = _inputs(seed)
    cfg = _cfg(Config, dtype_name)
    dt = DTYPES[dtype_name][1]
    model, opt = _port_model(cfg, variables)
    state = TrainState(0, model, opt, [torch.from_numpy(s) for s in sim])
    real = step_chap.largest_cc_batch

    def recording(seg, n):
        out = real(seg, n)
        if capture is not None:
            capture.extend([seg.clone(), out.clone()])
        return out

    f = torch.from_numpy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_chap, "largest_cc_batch", recording)
        step = step_chap.build_chap_train_step(model, opt, cfg, use_nms=True,
                                               level_paths=VNET_LEVEL_PATHS,
                                               device="cpu")
        draws = {"bcp_starts": list(STARTS),
                 "drop": {k: [f(u) for u in v] for k, v in drop.items()},
                 "perturb": [[f(u) for u in lvl] for lvl in pert],
                 "vat_d": f(vat_u)}
        return step(state, {"image": f(images).to(dt), "label": f(labels)},
                    draws=draws)


def _sd(state, family="dualdecoder3d"):
    return state_dict_from_flax(state.params, state.batch_stats, family=family)


@functools.lru_cache(maxsize=None)
def _chap_runs():
    """chap_tpu's 3D CHAP step and the port's, each in bf16 and float32 on
    every batch of BATCH_SEEDS, from the same weights and draws (run once a
    process: the update check's controls reuse them)."""
    refs = {name: _chap_tpu_chap_step(name) for name in DTYPES}
    variables = refs["bfloat16"][0]
    pseudo = []
    gots = [_port_chap_step(variables, "bfloat16", seed, pseudo if i == 0 else None)
            for i, seed in enumerate(BATCH_SEEDS)]
    owns = [_port_chap_step(variables, "float32", seed) for seed in BATCH_SEEDS]
    return {"variables": variables, "family": "dualdecoder3d", "gots": gots,
            "owns": owns, "wants": refs["bfloat16"][1], "wants32": refs["float32"][1],
            "pseudo": pseudo, "cap": refs["bfloat16"][2], "cap32": refs["float32"][2]}


def _update_sets(runs):
    """The state dicts that hold_updates compares, after the first batch's
    step: the port's bf16, chap_tpu's bf16 and float32, the port's float32,
    and the weights before it."""
    variables, family = runs["variables"], runs["family"]
    return (runs["gots"][0].state.model.state_dict(),
            _sd(runs["wants"][0].state, family), _sd(runs["wants32"][0].state, family),
            runs["owns"][0].state.model.state_dict(),
            state_dict_from_flax(variables["params"], variables["batch_stats"],
                                 family=family))


# measured here: the metrics' e_ref 0.068 (losses up to 5.0; the port 0.039
# from chap_tpu's bf16); pseudo-labels before / after the NMS: chap_tpu's
# bf16 and float32 maps agree on 98.7% / 98.6% of voxels, the port's bf16
# and chap_tpu's bf16 on 99.35% / 99.33%; updates: r 0.81 over the leaves
# above rounding (0.81 over all: the gap is in the conv kernels; the port's
# own bf16 gap is 0.76), the port 0.57 from chap_tpu's bf16, p 0.76 against
# p_ref 0.89; GradSim e_ref 0.20 (scores of 0.55)
def test_chap_step_3d_bf16_matches_chap_tpu():
    """One bf16 3D CHAP step on each batch of BATCH_SEEDS: the metrics (K1's
    float32, the channel-dropout CE and VAT in bf16, as chap_tpu's); on the
    first batch the pseudo-labels around the 26-connected largest-CC, the
    parameters and BN stats after the update, the GradSim scores."""
    runs = _chap_runs()
    gots, owns, wants, wants32 = (runs[k] for k in ("gots", "owns", "wants", "wants32"))
    for k in METRICS:
        assert gots[0].metrics[k].dtype == METRIC_DTYPES.get(k, torch.float32), k
    hold_bf16("metrics", *(stacked(r.metrics[k] for r in rs for k in METRICS)
                           for rs in (gots, wants, wants32, owns)))
    got, want, want32, own = gots[0], wants[0], wants32[0], owns[0]
    for i in range(2):
        hold_maps(f"pseudo-labels {i}", runs["pseudo"][i].numpy(), runs["cap"][i],
                  runs["cap32"][i])
    hold_updates(*_update_sets(runs))
    assert all(g.dtype == torch.float32 for g in got.state.sim_scores)
    hold_bf16("GradSim scores", *(stacked(r.state.sim_scores)
                                  for r in (got, want, want32, own)), atol=1e-3)


def _step_pair(kind, dtype_name, drop_u, batches):
    """chap_tpu's cps or supervised step (DualDecoder3d, or unet_3D for
    ``supervised_unet``) in ``dtype_name``, with K1 for its losses, compiled
    once and run from the same state on each of ``batches``: (its initial
    variables, its outputs, the state-dict family)."""
    jdt = DTYPES[dtype_name][0]
    jcfg = _cfg(JaxConfig, dtype_name)
    if kind == "supervised_unet":
        jcfg.model.name_3d = "unet_3D"
    family = "unet_3D" if kind == "supervised_unet" else "dualdecoder3d"
    model = jax_net_factory_3d("unet_3D" if family == "unet_3D" else "dualdecoder",
                               1, C, mode="train", cfg=jcfg.model)
    opt = jax_make_optimizer(jcfg.optim.base_lr, jcfg.optim.max_iterations,
                             jcfg.optim.momentum, jcfg.optim.weight_decay,
                             jcfg.optim.poly_power)

    def fresh_state():       # the step donates its state
        return jax_create_train_state(model, jax.random.PRNGKey(0),
                                      jnp.zeros((B, *PATCH, 1)), opt)

    state = fresh_state()
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    with pytest.MonkeyPatch.context() as mp:
        if family == "unet_3D":
            patch_jax_dropout(mp, ZOO["unet_3D"][2], drop_u)
        else:
            mp.setattr(jax_vnet3d, "jax", JaxFeed(RandomFeed(
                jax_dropout_feed(drop_u, jcfg.model.s2d_stem))))
        mp.setattr(jax_trainer_3d, "dice_ce_supervised",
                   functools.partial(jax_dice_ce_supervised, fused=True))
        build = (jax_trainer_3d.build_cps3d_train_step if kind == "cps"
                 else jax_trainer_3d.build_supervised3d_train_step)
        step = build(model, opt, jcfg)
        wants = [jax.device_get(step(state if i == 0 else fresh_state(), {
            "image": jnp.asarray(ndhwc(images), jdt),
            "label": jnp.asarray(labels.astype(np.uint8))}, jax.random.PRNGKey(1)))
            for i, (images, labels) in enumerate(batches)]
    return variables, wants, family


@functools.lru_cache(maxsize=None)
def _pair_runs(kind):
    """chap_tpu's and the port's bf16 and float32 cps step of the
    DualDecoder3d (``cps``) or supervised step of unet_3D
    (``supervised_unet``) on two bf16 batches, from the same weights and
    draws (run once a process: the update check's controls reuse them)."""
    batches = [(to_bf16(images), labels)
               for images, labels in (_batch(seed) for seed in (11, 13))]
    rs = np.random.RandomState(12)
    cfg0 = _cfg(Config, "float32")
    cfg0.model.name_3d = "unet_3D" if kind == "supervised_unet" else "dualdecoder"
    probe = net_factory_3d(cfg0.model.name_3d, 1, C, "train", cfg0.model, device="cpu")
    drop_u = [rs.rand(*s).astype(np.float32) for s in probe.dropout_shapes(B, PATCH)]
    refs = {name: _step_pair(kind, name, drop_u, batches) for name in DTYPES}
    variables, _, family = refs["bfloat16"]
    runs = {}
    for name, (_, tdt) in DTYPES.items():
        cfg = update_values(dataclasses.asdict(_cfg(JaxConfig, name)), Config())
        cfg.model.name_3d = cfg0.model.name_3d
        runs[name] = []
        for images, labels in batches:
            port = net_factory_3d(cfg.model.name_3d, 1, C, "train", cfg.model,
                                  device="cpu")
            port.load_state_dict(state_dict_from_flax(
                variables["params"], variables["batch_stats"], family=family))
            popt = make_optimizer(port, cfg.optim.base_lr, cfg.optim.momentum,
                                  cfg.optim.weight_decay)
            build = (build_cps3d_train_step if kind == "cps"
                     else build_supervised3d_train_step)
            runs[name].append(build(port, popt, cfg, device="cpu")(
                TrainState(0, port, popt, []),
                {"image": torch.from_numpy(images).to(tdt),
                 "label": torch.from_numpy(labels.astype(np.uint8))},
                draws={"drop": [torch.from_numpy(u) for u in drop_u]}))
    return {"variables": variables, "family": family, "gots": runs["bfloat16"],
            "owns": runs["float32"], "wants": refs["bfloat16"][1],
            "wants32": refs["float32"][1]}


# measured here: cps metrics' e_ref 7.1e-3 (losses of 2.4), updates: r 0.69
# over the leaves above rounding (the port's own bf16 gap 0.64), the port
# 0.57 from chap_tpu's bf16, p 0.73 against p_ref 0.79; unet_3D supervised
# loss e_ref 8.9e-4 (0.65), updates: r 1.50 (the port's own 0.32), the port
# 1.47 from chap_tpu's bf16, p 0.95 against p_ref 0.75. unet_3D's r is
# chap_tpu's: its bf16 update of the full-resolution decoder's kernels is
# 4.5x their float32 update and at cosine -0.10 to it (ROADMAP.md §3)
@pytest.mark.parametrize("kind", ["cps", "supervised_unet"])
def test_cps_and_unet_supervised_steps_bf16_match_chap_tpu(kind):
    """The bf16 cps step of the DualDecoder3d and the bf16 supervised step
    of unet_3D (the BraTS model) on two batches: the metrics, and on the
    first the parameters and BN stats."""
    runs = _pair_runs(kind)
    gots, owns, wants, wants32 = (runs[k] for k in ("gots", "owns", "wants", "wants32"))
    assert set(gots[0].metrics) == set(wants[0].metrics)
    names = sorted(wants[0].metrics)
    # K1's losses are float32; cps's cross-pseudo CE is taken in the logits'
    # dtype, as chap_tpu's
    for k in names:
        assert str(gots[0].metrics[k].dtype) == f"torch.{wants[0].metrics[k].dtype}", k
    hold_bf16("metrics", *(stacked(r.metrics[k] for r in rs for k in names)
                           for rs in (gots, wants, wants32, owns)))
    hold_updates(*_update_sets(runs))


@pytest.mark.parametrize("fault", ["unchanged", "sign_flipped"])
@pytest.mark.parametrize("kind", ["chap", "cps", "supervised_unet"])
def test_update_check_fails_a_wrong_update(kind, fault):
    """hold_updates fails a port whose bf16 step leaves the parameters as
    they were, or moves them by the reverse of its update, on each of the
    three 3D steps above, though their distance bars are near 1 x the
    update's norm (r 0.69-1.50): the update held along chap_tpu's float32
    step reads 0 or -0.73 to -0.95 there. The BN statistics keep the port's
    update, so the parameters alone must show the fault."""
    runs = _chap_runs() if kind == "chap" else _pair_runs(kind)
    port_bf, ref_bf, ref_f32, port_f32, before = _update_sets(runs)
    stats = ("running_mean", "running_var", "num_batches_tracked")
    wrong = {k: v if k.endswith(stats) else
             before[k] if fault == "unchanged" else 2 * before[k] - v
             for k, v in port_bf.items()}
    with pytest.raises(AssertionError, match="update"):
        hold_updates(wrong, ref_bf, ref_f32, port_f32, before)


def test_la_config_as_written_through_the_clis(tmp_path, monkeypatch):
    """cli.train_3d --cfg configs/la_chap.yml with no dtype override (bf16)
    on synthetic volumes at a 32 x 32 x 16 patch and nf 2: 2 steps, a resume
    to 3, then cli.test_3d on the latest slot. The checkpoints hold float32
    parameters, and the restored model computes in bf16."""
    argv = ["--device", "cpu", "--cfg", "configs/la_chap.yml", "--dataset",
            "synthetic", "--labeled_num", "4", "data.patch_size_3d=[32,32,16]",
            "model.n_filters_3d=2", f"run.snapshot_root={tmp_path}",
            "run.log_every=1", "data.num_workers=1"]
    first = cli_train3d.main(argv + ["--max_iterations", "2"])
    save_dir = first["save_dir"]
    with open(os.path.join(save_dir, "config.json")) as f:
        assert json.load(f)["model"]["dtype"] == "bfloat16"
    resumed = cli_train3d.main(argv + ["--max_iterations", "3", "--resume"])
    assert resumed["steps"] == 3 and resumed["save_dir"] == save_dir
    cfg = Config()
    cfg.model.dtype, cfg.model.n_filters_3d = "bfloat16", 2
    model = net_factory_3d("dualdecoder", 1, 2, "train", cfg.model, device="cpu")
    state = TrainState(0, model, make_optimizer(model, 0.01), [])
    CheckpointManager(save_dir).restore_latest(state)
    assert state.step == 3
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    records = [json.loads(line) for line in open(os.path.join(save_dir,
                                                              "metrics.jsonl"))]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()

    monkeypatch.setitem(cli_test3d.PROTOCOLS, "LA", dict(
        patch=(32, 32, 16), stride_xy=16, stride_z=8, model="dualdecoder"))
    monkeypatch.setattr(cli_test3d, "SyntheticVolumeDataset",
                        lambda shape, n, length: SyntheticVolumeDataset(
                            (24, 40, 40), n, length=length))
    metrics = cli_test3d.main(["--dataset", "synthetic", "--snapshot", save_dir,
                               "--ckpt", "latest", "--device", "cpu"])
    assert metrics.shape == (1, 4) and np.isfinite(metrics[:, 0]).all()
