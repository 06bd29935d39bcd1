"""The port's trainer around the step (CPU): the supervised step against
chap_tpu's, the step's draws, the checkpoint roundtrip, the 2D trainer end to
end (chap, resume, supervised, best-slot gating, the host batch path against
chap_tpu's loader) and both CLIs."""
import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen.stochastic as stochastic
import chap_tpu_torch.train.trainer_2d as t2d
from chap_tpu.config import Config as JaxConfig
from chap_tpu.data.datasets import build_datasets as jax_build_datasets
from chap_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from chap_tpu.data.sampler import TwoStreamBatchSampler as JaxSampler
from chap_tpu.data.transforms import RandomGenerator as JaxRandomGenerator
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu.train.step_supervised import build_supervised_train_step as jax_supervised
from chap_tpu_torch.cli import test_2d as cli_test
from chap_tpu_torch.cli import train_2d as cli_train
from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from chap_tpu_torch.train.step_chap import StepOutput, draw_step_uniforms
from chap_tpu_torch.train.step_supervised import (build_supervised_train_step,
                                                  draw_supervised_uniforms)
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from chap_tpu_torch.utils.launch import init_save_folder
from test_torch_models import RandomFeed
from test_trainer_e2e import tiny_cfg as jax_tiny_cfg

torch.set_num_threads(1)

CHNS = (4, 8, 16, 16, 32)


def tiny_cfg(tmp_path):
    """tests/test_trainer_e2e.py's tiny_cfg, as the port's Config."""
    return update_values(dataclasses.asdict(jax_tiny_cfg(tmp_path)), Config())


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _tensors(v)


# ---------------------------------------------------------------------------
# the step's random draws
# ---------------------------------------------------------------------------

def _draw_cfg():
    cfg = Config()
    cfg.model.feature_chns = CHNS
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.semi.dropout = cfg.semi.adv_noise = True
    return cfg


def test_draws_without_a_generator_never_land_on_the_cpu(monkeypatch):
    """With no generator, every draw is made on the step's device with that
    device's default generator (here the meta device stands in for the card:
    a draw made on the CPU and copied over would show in the record)."""
    calls = []

    def recording(real):
        def fn(*args, **kwargs):
            calls.append(torch.device(kwargs.get("device") or "cpu"))
            return real(*args, **kwargs)
        return fn
    monkeypatch.setattr(torch, "rand", recording(torch.rand))
    monkeypatch.setattr(torch, "randint", recording(torch.randint))
    cfg = _draw_cfg()
    for draw in (draw_step_uniforms, draw_supervised_uniforms):
        calls.clear()
        draws = draw(cfg, (8, 1, 32, 32), None, "meta")
        leaves = list(_tensors(draws))
        assert len(calls) >= len(leaves) > 0
        assert set(calls) == {torch.device("meta")}, draw.__name__
        assert all(t.device.type == "meta" for t in leaves)


def test_draws_on_the_cpu_are_unchanged():
    """No generator on the CPU: the global generator's stream, as before."""
    cfg = _draw_cfg()
    torch.manual_seed(0)
    a = list(_tensors(draw_step_uniforms(cfg, (8, 1, 32, 32), None, "cpu")))
    b = list(_tensors(draw_step_uniforms(cfg, (8, 1, 32, 32),
                                         torch.Generator().manual_seed(0), "cpu")))
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.device.type == "cpu"
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the supervised step against chap_tpu's
# ---------------------------------------------------------------------------

def test_supervised_step_matches_chap_tpu(monkeypatch):
    b, hw, c = 4, 32, 4
    jcfg = JaxConfig()
    jcfg.model.feature_chns = CHNS
    jcfg.data.num_classes = c
    model = jax_net_factory("dualdecoder", 1, c, jcfg.model)
    opt = jax_make_optimizer(jcfg.optim.base_lr, jcfg.optim.max_iterations,
                             jcfg.optim.momentum, jcfg.optim.weight_decay,
                             jcfg.optim.poly_power)
    state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                   jnp.zeros((b, hw, hw, 1)), opt, sim_chns=CHNS)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    rs = np.random.RandomState(3)
    images, labels = phantom_batch(rs, b, hw, c)
    # one dropout uniform per encoder level, NHWC, in call order
    uniforms = [rs.rand(b, hw >> i, hw >> i, ch).astype(np.float32)
                for i, ch in enumerate(CHNS)]
    monkeypatch.setattr(stochastic, "random", RandomFeed(uniforms))
    step = jax_supervised(model, opt, jcfg, dual=True)
    want = jax.device_get(step(state, {
        "image": jnp.asarray(images.transpose(0, 2, 3, 1)),
        "label": jnp.asarray(labels.astype(np.uint8))}, jax.random.PRNGKey(1)))

    cfg = update_values(dataclasses.asdict(jcfg), Config())
    port = net_factory("dualdecoder", 1, c, cfg.model, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"]))
    popt = make_optimizer(port, cfg.optim.base_lr, cfg.optim.momentum,
                          cfg.optim.weight_decay)
    pstate = create_train_state(port, popt, CHNS)
    got = build_supervised_train_step(port, popt, cfg, device="cpu")(
        pstate, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels.astype(np.uint8))},
        draws={"drop": [torch.from_numpy(np.ascontiguousarray(
            u.transpose(0, 3, 1, 2))) for u in uniforms]})
    np.testing.assert_allclose(float(got.metrics["loss"]), float(want.metrics["loss"]),
                               rtol=2e-3)
    after = state_dict_from_flax(want.state.params, want.state.batch_stats)
    ours = got.state.model.state_dict()
    for key, value in after.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(ours[key].numpy(), value.numpy(), rtol=2e-3,
                                       atol=1e-6, err_msg=key)
    assert got.state.step == int(want.state.step) == 1


# ---------------------------------------------------------------------------
# checkpoints and run dirs
# ---------------------------------------------------------------------------

def _trained_state(seed):
    cfg = _draw_cfg()
    torch.manual_seed(seed)
    model = net_factory("dualdecoder", 1, 4, cfg.model, device="cpu")
    opt = make_optimizer(model, 0.01)
    state = create_train_state(model, opt, CHNS)
    step = build_supervised_train_step(model, opt, cfg, device="cpu")
    images, labels = phantom_batch(np.random.RandomState(seed), 4, 16, 4)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    for _ in range(2):
        step(state, batch, torch.Generator().manual_seed(seed))
    state.sim_scores = [s + 0.5 + i for i, s in enumerate(state.sim_scores)]
    return state


def test_train_state_roundtrip_is_exact(tmp_path):
    state = _trained_state(0)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_latest(state)
    assert ckpt.has("latest") and not ckpt.has("best")
    assert os.path.isdir(tmp_path / "checkpoints" / "latest")
    other = _trained_state(1)
    assert ckpt.restore_latest(other) is other
    assert other.step == state.step == 2
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)    # params, BN
    mom_a = [state.optimizer.state[p]["momentum_buffer"] for p in state.model.parameters()]
    mom_b = [other.optimizer.state[p]["momentum_buffer"] for p in other.model.parameters()]
    assert len(mom_a) == len(mom_b) > 0
    for a, b in zip(mom_a, mom_b):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    for a, b in zip(state.sim_scores, other.sim_scores):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "checkpoints" / "latest"))


def test_meta_sidecar_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.load_meta() == {} and ckpt.restore_latest(None) is None
    ckpt.save_meta({"best_metric": 0.91, "best_iteration": 400})
    assert CheckpointManager(str(tmp_path)).load_meta() == {
        "best_metric": 0.91, "best_iteration": 400}


def test_init_save_folder_reuse_last(tmp_path):
    base = str(tmp_path)
    assert init_save_folder(base, "m").endswith("run_0")
    r1 = init_save_folder(base, "m")
    assert r1.endswith("run_1")
    assert init_save_folder(base, "m", reuse_last=True) == r1
    assert init_save_folder(str(tmp_path / "other"), "m", reuse_last=True).endswith("run_0")


# ---------------------------------------------------------------------------
# the trainer end to end
# ---------------------------------------------------------------------------

def _records(path):
    with open(path / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_chap_trainer_e2e_and_resume(tmp_path):
    cfg = tiny_cfg(tmp_path)
    cfg.semi.dropout = cfg.semi.adv_noise = True
    result = t2d.train(cfg, str(tmp_path), mode="chap", device="cpu")
    assert result["steps"] == 24 and result["best_dice"] >= 0
    for name in ("metrics.jsonl", "val.csv", "checkpoints/meta.json",
                 "checkpoints/latest/state.pt", "checkpoints/best/state.pt"):
        assert os.path.exists(tmp_path / name), name
    evals = [r for r in _records(tmp_path) if "val_mean_dice" in r]
    assert [r["step"] for r in evals] == [12, 24]
    assert all(r["steps_per_sec_since_eval"] > 0 and r["eval_s"] > 0 for r in evals)
    logged = [r for r in _records(tmp_path) if "loss" in r]
    assert [r["step"] for r in logged] == [6, 12, 18, 24]
    assert all(np.isfinite(r["loss"]) and "sim_score_std" in r for r in logged)
    cfg.optim.max_iterations = 30
    assert t2d.train(cfg, str(tmp_path), mode="chap", resume=True,
                     device="cpu")["steps"] == 30
    assert CheckpointManager(str(tmp_path)).restore_latest(
        _trained_state(0)).step == 30 - 30 % cfg.eval.eval_every


def test_supervised_trainer_e2e(tmp_path):
    result = t2d.train(tiny_cfg(tmp_path), str(tmp_path), mode="supervised",
                       device="cpu")
    assert result["steps"] == 24 and result["best_dice"] >= 0
    assert os.path.isdir(tmp_path / "checkpoints" / "best")


def test_resume_preserves_best_checkpoint(tmp_path, monkeypatch):
    """A high eval, then a resumed run with lower evals: the best slot and
    its recorded metric stay (train_ours_2D.py:428-435 gating)."""
    scripted = iter([0.9, 0.3, 0.4])

    def fake_eval(db_val, predictor, num_classes, image_size):
        return np.array([[next(scripted), 1.0]])

    monkeypatch.setattr(t2d, "evaluate_volumes", fake_eval)
    cfg = tiny_cfg(tmp_path)
    cfg.optim.max_iterations = cfg.eval.eval_every = 4
    assert t2d.train(cfg, str(tmp_path), mode="supervised",
                     device="cpu")["best_dice"] == 0.9
    ckpt = CheckpointManager(str(tmp_path))
    best_before = ckpt.load_meta()
    best_file = tmp_path / "checkpoints" / "best" / "state.pt"
    best_bytes = best_file.read_bytes()
    assert best_before["best_metric"] == 0.9
    cfg.optim.max_iterations = 12
    assert t2d.train(cfg, str(tmp_path), mode="supervised", resume=True,
                     device="cpu")["best_dice"] == 0.9
    assert ckpt.load_meta() == best_before
    assert best_file.read_bytes() == best_bytes


def test_host_batches_equal_chap_tpu_loader(tmp_path, monkeypatch):
    """data.device_input=false: the first 3 batches the step receives are
    chap_tpu's TwoStreamBatchSampler + BatchLoader + RandomGenerator batches,
    in NCHW, labels as uint8."""
    seen = []

    def recording_step_factory(model, optimizer, cfg, device=None):
        def step(state, batch, generator=None):
            seen.append({k: v.clone() for k, v in batch.items()})
            state.step += 1
            return StepOutput(state, {"loss": torch.zeros(())})
        return step

    monkeypatch.setattr(t2d, "build_supervised_train_step", recording_step_factory)
    jcfg = jax_tiny_cfg(tmp_path)
    jcfg.data.device_input = False
    jcfg.data.num_workers = 1      # the shared transform sees samples in order
    jcfg.optim.max_iterations = 3
    cfg = update_values(dataclasses.asdict(jcfg), Config())
    t2d.train(cfg, str(tmp_path), mode="supervised", device="cpu")

    transform = JaxRandomGenerator(jcfg.data.image_size, seed=jcfg.run.seed)
    db_train, _ = jax_build_datasets(jcfg.data, transform)
    sampler = JaxSampler(range(68), range(68, len(db_train)), 8, 4, seed=jcfg.run.seed)
    want = list(itertools.islice(iter(JaxBatchLoader(db_train, sampler, 1)), 3))
    assert len(seen) == 3
    for got, ref in zip(seen, want):
        assert got["image"].shape == (8, 1, 64, 64) and got["label"].dtype == torch.uint8
        np.testing.assert_array_equal(got["image"].numpy(),
                                      ref["image"].transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(got["label"].numpy(), ref["label"])


@pytest.mark.parametrize("mode,cfg_change,match", [
    ("ablation", None, "ROADMAP item 13"),
    ("chap", ("parallel", "num_devices", 2), "ROADMAP item 16"),
    ("fixmatch", None, "unknown mode")])
def test_trainer_refuses_what_is_not_ported(tmp_path, mode, cfg_change, match):
    cfg = tiny_cfg(tmp_path)
    if cfg_change:
        setattr(getattr(cfg, cfg_change[0]), cfg_change[1], cfg_change[2])
    with pytest.raises((NotImplementedError, ValueError), match=match):
        t2d.train(cfg, str(tmp_path), mode=mode, device="cpu")


def test_clis_train_resume_and_test(tmp_path):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--exp", "t",
            "--adv_noise", "--dropout", "--labeled_num", "3",
            "--batch_size", "8", "--labeled_bs", "4", "data.image_size=[32,32]",
            "data.synthetic_train_size=80", "data.synthetic_val_volumes=2",
            "eval.eval_every=2", f"run.snapshot_root={tmp_path}",
            "run.log_every=2", "model.feature_chns=[4,8,16,16,32]"]
    first = cli_train.main(argv + ["--max_iterations", "4"])
    save_dir = first["save_dir"]
    assert first["steps"] == 4 and save_dir.endswith(os.path.join(
        "synthetic", "t_3_labeled", "dualdecoder", "run_0"))
    resumed = cli_train.main(argv + ["--max_iterations", "6", "--resume"])
    assert resumed["steps"] == 6 and resumed["save_dir"] == save_dir
    for name in ("config.json", "doc.txt", "log.txt", "val.csv", "metrics.jsonl"):
        assert os.path.exists(os.path.join(save_dir, name)), name
    mean = cli_test.main(["--snapshot", save_dir, "--device", "cpu"])
    assert mean.shape == (3, 4) and np.isfinite(mean).all()
    with open(os.path.join(save_dir, "performance.txt")) as f:
        assert f.read().startswith("best logit_ensemble: [")
