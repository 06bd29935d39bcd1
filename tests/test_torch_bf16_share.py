"""bf16 compute (``model.dtype=bfloat16``) in the port's ACAL steps and
ablation step against chap_tpu's bf16 steps, on the CPU, with the bars of
tests/test_torch_bf16.py (its module docstring): ``hold_bf16`` on the
metrics of each step over the batches of BATCH_SEEDS as one vector (and on
the joint step's knowledge maps), ``hold_updates`` on the parameter and BN
statistics update of the first batch. Each step runs from the initial
weights (carried by ``state_dict_from_flax``), encoder dropout 0; chap_tpu's
supervised losses run with ``fused=True`` (K1's semantics, float32
statistics over upcast logits), as in tests/test_torch_bf16.py.

Then the memory bank in bf16: fed a bf16 knowledge map it picks chap_tpu's
windows with chap_tpu's scores (numpy's bf16 arithmetic), and the ACAL
trainer in bf16 hands the bank its bf16 maps and the replay steps a batch in
the batch's dtype."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import chap_tpu.train.step_ablation as jax_step_ablation
import chap_tpu.train.step_share as jax_step_share
from chap_tpu.config import Config as JaxConfig
from chap_tpu.losses.dice import dice_ce_supervised as jax_dice_ce_supervised
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.semi.memory_bank import ImageMemoryBank as JaxBank
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.semi.memory_bank import ImageMemoryBank
from chap_tpu_torch.train import trainer_share
from chap_tpu_torch.train.state import TrainState, make_optimizer
from chap_tpu_torch.train.step_ablation import build_ablation_train_step
from chap_tpu_torch.train.step_share import (build_acal_steps,
                                             build_share_joint_step,
                                             create_share_state)
from test_torch_bf16 import (BF, bf16_grid_uniform, hold_bf16, hold_updates,
                             stacked, to_bf16)
from test_torch_models import JaxFeed, RandomFeed
from test_trainer_e2e import tiny_cfg as jax_tiny_cfg

torch.set_num_threads(1)

CHNS = (4, 8, 16, 16, 32)
B, LB, HW, C = 8, 4, 32, 4
BATCH_SEEDS = (2, 3, 4)
SHARE_METRICS = {"joint": ("loss", "model1_loss", "model2_loss"),
                 "max": ("dis_loss", "acal_f_loss"), "min": ("dis_loss_g",)}
ABLATION_METRICS = ("loss", "sup_loss", "fp_loss", "vat_loss",
                    "disagreement_ratio", "consistency_weight")
TORCH_DTYPE = {np.dtype(jnp.float32): torch.float32, np.dtype(BF): torch.bfloat16}


def _configure(cfg, dtype, adv="mse"):
    cfg.data.num_classes = C
    cfg.data.batch_size = B
    cfg.data.labeled_bs = LB
    cfg.data.image_size = (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.model.dropout = (0.0,) * 5
    cfg.model.decoder_type = "same"
    cfg.model.dtype = dtype
    cfg.optim.max_iterations = 10
    cfg.semi.consistency = 0.5
    cfg.semi.adv_losstype = adv
    cfg.semi.dropout = cfg.semi.adv_noise = True
    cfg.optim.remat = False
    cfg.optim.fused_passes = False
    return cfg


def _batch(seed):
    """Phantom slices rounded to bf16 (the batch's dtype) and their labels."""
    images, labels = phantom_batch(np.random.RandomState(seed), B, HW, C)
    return to_bf16(images), labels


def _replay_mask():
    mask = np.zeros((B - LB, HW, HW), np.float32)
    mask[:, 8:24, 4:20] = 1.0
    mask[1] = 0.0
    mask[1, 0:16, 16:32] = 1.0
    return mask


def _sd(state, family="acalnet"):
    return state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats), "same",
                                family=family)


def _chap_tpu_share(kind, dtype_name, adv):
    """chap_tpu's ``kind`` step (joint | max | min) in ``dtype_name`` from
    its initial state on each batch of BATCH_SEEDS: (initial state dict,
    [(state dict after, metrics, knowledge or None)])."""
    cfg = _configure(JaxConfig(), dtype_name, adv)
    model = jax_net_factory("acalnet", 1, C, cfg.model)
    dt = BF if dtype_name == "bfloat16" else jnp.float32
    mask = jnp.asarray(_replay_mask())

    def fresh():
        return jax_step_share.create_share_state(
            model, jax.random.PRNGKey(0), jnp.zeros((B, HW, HW, 1)), cfg)[0]
    init = _sd(fresh())
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_share, "dice_ce_supervised",
                   functools.partial(jax_dice_ce_supervised, fused=True))
        opt_g, opt_f = jax_step_share.make_group_optimizers(cfg)
        joint = jax_step_share.build_share_joint_step(model, opt_g, opt_f, cfg)
        dec, enc = jax_step_share.build_acal_steps(model, opt_g, opt_f, cfg)
        for seed in BATCH_SEEDS:
            images, labels = _batch(seed)
            image = jnp.asarray(images.transpose(0, 2, 3, 1), dt)
            label = jnp.asarray(labels.astype(np.int32))
            knowledge = None
            if kind == "joint":
                state, m, knowledge = joint(fresh(), {"image": image, "label": label},
                                            jax.random.PRNGKey(1))
            elif kind == "max":
                state, m = dec(fresh(), image, label, mask, jax.random.PRNGKey(2))
            else:
                state, m = enc(fresh(), image, mask, jax.random.PRNGKey(3))
            outs.append((_sd(state), jax.device_get(m),
                         None if knowledge is None else np.asarray(knowledge)))
    return init, outs


def _port_share(kind, dtype_name, adv, init):
    cfg = _configure(Config(), dtype_name, adv)
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    mask = torch.from_numpy(_replay_mask())
    none = {"drop": [None] * 5}
    outs = []
    for seed in BATCH_SEEDS:
        images, labels = _batch(seed)
        model = net_factory("acalnet", 1, C, cfg.model, device="cpu")
        model.load_state_dict(init)
        state = create_share_state(model, cfg)
        joint = build_share_joint_step(model, state.optimizer_g,
                                       state.optimizer_f, cfg, device="cpu")
        dec, enc = build_acal_steps(model, state.optimizer_g, state.optimizer_f,
                                    cfg, device="cpu")
        image = torch.from_numpy(images).to(dt)
        label = torch.from_numpy(labels)
        knowledge = None
        if kind == "joint":
            state, m, knowledge = joint(state, {"image": image, "label": label},
                                        draws=none)
        elif kind == "max":
            state, m = dec(state, image, label, mask, draws=none)
        else:
            state, m = enc(state, image, mask, draws=none)
        outs.append(({k: v.clone() for k, v in model.state_dict().items()}, m,
                     knowledge))
    return outs


# measured here: the metrics' e_ref 1.8e-3-2.2e-3 (the port 0.46e-3-0.76e-3
# from chap_tpu's bf16); the joint step's knowledge maps e_ref 3.88 (a
# flipped argmax pseudo-label moves a pixel's CE by units), the port 2.88;
# updates: r 0.22-0.36, the port 0.18-0.23 from chap_tpu's bf16, p
# 0.947-0.995 against p_ref 0.949-0.975
@pytest.mark.parametrize("kind,adv", [("joint", "mse"), ("max", "mse"),
                                      ("min", "mse"), ("max", "softdice"),
                                      ("min", "softdice")])
def test_acal_step_bf16_matches_chap_tpu(kind, adv):
    """One ACAL step in bf16 on each batch: its metrics (with chap_tpu's
    dtypes) and, for the joint step, the bf16 knowledge maps, as vectors
    over the batches; the update of the first batch."""
    init, wants32 = _chap_tpu_share(kind, "float32", adv)
    _, wants = _chap_tpu_share(kind, "bfloat16", adv)
    gots = _port_share(kind, "bfloat16", adv, init)
    owns = _port_share(kind, "float32", adv, init)
    keys = SHARE_METRICS[kind]
    for k in keys:
        assert gots[0][1][k].dtype == TORCH_DTYPE[np.asarray(wants[0][1][k]).dtype], k
    hold_bf16(f"{kind} metrics", *(stacked(r[1][k] for r in runs for k in keys)
                                   for runs in (gots, wants, wants32, owns)))
    if kind == "joint":
        assert gots[0][2].dtype == torch.bfloat16
        assert wants[0][2].dtype == np.dtype(BF)
        hold_bf16("knowledge", *(stacked(r[2] for r in runs)
                                 for runs in (gots, wants, wants32, owns)))
    hold_updates(gots[0][0], wants[0][0], wants32[0][0], owns[0][0], init)


def _ablation_draws():
    rs = np.random.RandomState(1)
    shapes = perturb_draw_shapes(B - LB, CHNS, (0, 1, 2, 3, 4), [True] * 5, False)
    perturb = [[rs.rand(*s).astype(np.float32) for s in lvl] for lvl in shapes]
    vat_u = bf16_grid_uniform(rs, (B - LB, 1, HW, HW))
    sim = [np.linspace(-0.5, 0.5, c).astype(np.float32) for c in CHNS]
    return perturb, vat_u, sim


def _chap_tpu_ablation(dtype_name):
    perturb, vat_u, sim = _ablation_draws()
    cfg = _configure(JaxConfig(), dtype_name, "kl")
    model = jax_net_factory("dualdecoder", 1, C, cfg.model)
    opt = jax_make_optimizer(cfg.optim.base_lr, cfg.optim.max_iterations,
                             cfg.optim.momentum, cfg.optim.weight_decay,
                             cfg.optim.poly_power)

    def fresh():        # the step donates its state
        state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                       jnp.zeros((B, HW, HW, 1)), opt,
                                       sim_chns=CHNS)
        return state.replace(sim_scores=tuple(jnp.asarray(s) for s in sim))
    init = _sd(fresh(), "dualdecoder")
    dt = BF if dtype_name == "bfloat16" else jnp.float32
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step_ablation, "dice_ce_supervised",
                   functools.partial(jax_dice_ce_supervised, fused=True))
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in perturb for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed(
            [np.ascontiguousarray(vat_u.transpose(0, 2, 3, 1))])))
        step = jax_step_ablation.build_ablation_train_step(model, opt, cfg)
        for seed in BATCH_SEEDS:
            images, labels = _batch(seed)
            out = jax.device_get(step(fresh(), {
                "image": jnp.asarray(images.transpose(0, 2, 3, 1), dt),
                "label": jnp.asarray(labels.astype(np.uint8))},
                jax.random.PRNGKey(4)))
            outs.append((_sd(out.state, "dualdecoder"), out.metrics))
    return init, outs


def _port_ablation(dtype_name, init):
    perturb, vat_u, sim = _ablation_draws()
    cfg = _configure(Config(), dtype_name, "kl")
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    outs = []
    for seed in BATCH_SEEDS:
        images, labels = _batch(seed)
        model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
        model.load_state_dict(init)
        opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                             cfg.optim.weight_decay)
        step = build_ablation_train_step(model, opt, cfg, device="cpu")
        draws = {"drop": {k: [None] * 5 for k in ("main", "fp", "vat")},
                 "perturb": [[torch.from_numpy(u) for u in lvl] for lvl in perturb],
                 "vat_d": torch.from_numpy(vat_u)}
        out = step(TrainState(0, model, opt, [torch.from_numpy(s) for s in sim]),
                   {"image": torch.from_numpy(images).to(dt),
                    "label": torch.from_numpy(labels)}, draws=draws)
        outs.append(({k: v.clone() for k, v in model.state_dict().items()},
                     out.metrics))
    return outs


# measured here: the metrics' e_ref 0.037 (the channel-dropout CE and the
# VAT divergence in bf16), the port 0.031 from chap_tpu's bf16; updates: r
# 0.23, the port 0.18, p 0.947 against p_ref 0.949
def test_ablation_step_bf16_matches_chap_tpu():
    """The ablation step in bf16 (channel dropout with GradSim scores and
    VAT on) on each batch: the metrics as one vector, with chap_tpu's
    dtypes (the channel-dropout CE and the VAT divergence in bf16), and the
    update of the first batch."""
    init, wants32 = _chap_tpu_ablation("float32")
    _, wants = _chap_tpu_ablation("bfloat16")
    gots = _port_ablation("bfloat16", init)
    owns = _port_ablation("float32", init)
    for k in ABLATION_METRICS:
        assert gots[0][1][k].dtype == TORCH_DTYPE[np.asarray(wants[0][1][k]).dtype], k
    assert gots[0][1]["vat_loss"].dtype == torch.bfloat16
    hold_bf16("ablation metrics", *(stacked(r[1][k] for r in runs
                                            for k in ABLATION_METRICS)
                                    for runs in (gots, wants, wants32, owns)))
    hold_updates(gots[0][0], wants[0][0], wants32[0][0], owns[0][0], init)


def test_bank_in_bf16_picks_chap_tpus_patches():
    """Fed the same bf16 knowledge maps (and bf16 images), the port's bank
    stores chap_tpu's windows, scores and images, bit for bit, and draws
    the same replay batches; its scores are the bf16 sums, not the float32
    ones of the same values."""
    rs = np.random.RandomState(7)
    ours = ImageMemoryBank(capacity=6, image_size=(HW, HW), patch_size=8, seed=2)
    ref = JaxBank(capacity=6, image_size=(HW, HW), patch_size=8, seed=2)
    f32 = ImageMemoryBank(capacity=6, image_size=(HW, HW), patch_size=8, seed=2)
    for i in range(3):
        images = rs.rand(4, HW, HW).astype(ml_dtypes.bfloat16)
        # knowledge maps of the joint step's range, with a plateau that
        # bf16 rounds into ties
        knowledge = (rs.rand(4, HW, HW) * (1 + 3 * i)).astype(np.float32)
        knowledge[:, 10:20, 10:20] = 2.0 + 0.001 * rs.rand(4, 10, 10)
        knowledge = knowledge.astype(ml_dtypes.bfloat16)
        ref.add(images[..., None], knowledge, 3)
        as_f32 = knowledge.astype(np.float32)
        ours.add(torch.from_numpy(images.astype(np.float32)).bfloat16()[:, None],
                 torch.from_numpy(as_f32).bfloat16(), 3)
        f32.add(images.astype(np.float32)[:, None], as_f32, 3)
    assert ours._scores == ref._scores
    for a, b in ((ours._masks, ref._masks), (ours._images, ref._images)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for n in (2, 4):
        a, b = ours.get_samples(n), ref.get_samples(n)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_array_equal(a["image"][:, 0], b["image"][..., 0])
    assert ours._scores != f32._scores


def test_acal_trainer_in_bf16_keeps_the_batch_dtype(tmp_path, monkeypatch):
    """trainer_share.train at model.dtype=bfloat16: the joint step gets a
    bf16 batch and returns a bf16 knowledge map, which the bank ranks as
    bf16; the replay steps get [labeled ; replayed] in bf16 (the bank's
    float32 images cast to the batch dtype, not the batch promoted to
    float32) with a float32 mask; the metrics are finite."""
    cfg = update_values(dataclasses.asdict(jax_tiny_cfg(tmp_path)), Config())
    cfg.model.name, cfg.model.decoder_type, cfg.model.dtype = ("acalnet", "same",
                                                               "bfloat16")
    cfg.data.image_size = (32, 32)
    cfg.data.num_workers = 1
    cfg.semi.acal, cfg.semi.acal_start_iter, cfg.semi.mb_patch_size = True, 1, 8
    cfg.semi.adv_losstype = "mse"
    cfg.optim.max_iterations = cfg.eval.eval_every = cfg.run.log_every = 3
    seen = {"joint": [], "replay": [], "bank": []}
    real_joint, real_acal = trainer_share.build_share_joint_step, trainer_share.build_acal_steps

    def wrap_joint(*a, **kw):
        step = real_joint(*a, **kw)

        def wrapped(state, batch, gen=None):
            out = step(state, batch, gen)
            seen["joint"].append((batch["image"].dtype, out[2].dtype))
            return out
        return wrapped

    def wrap_acal(*a, **kw):
        dec, enc = real_acal(*a, **kw)

        def wrapped_dec(state, image, label, mask, gen=None, rows=None):
            seen["replay"].append((image.dtype, mask.dtype, image.shape[0]))
            return dec(state, image, label, mask, gen, rows=rows)
        return wrapped_dec, enc

    class Bank(ImageMemoryBank):
        def add(self, images, knowledge, n):
            seen["bank"].append((images.dtype, knowledge.dtype))
            return super().add(images, knowledge, n)

    monkeypatch.setattr(trainer_share, "build_share_joint_step", wrap_joint)
    monkeypatch.setattr(trainer_share, "build_acal_steps", wrap_acal)
    monkeypatch.setattr(trainer_share, "ImageMemoryBank", Bank)
    result = trainer_share.train(cfg, str(tmp_path), device="cpu")
    assert result["steps"] == 3
    assert seen["joint"] == [(torch.bfloat16, torch.bfloat16)] * 3
    assert seen["bank"] == [(torch.bfloat16, torch.bfloat16)] * 3
    assert seen["replay"] == [(torch.bfloat16, torch.float32, 8)] * 2
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert all(np.isfinite(r["dis_loss"]) for r in records if "dis_loss" in r)
