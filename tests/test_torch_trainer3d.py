"""The port's 3D trainer and its CLIs end to end on the CPU (chap with
resume, cps, supervised, the host loader path, the refusals, the logged
fused-passes override), the host batches against chap_tpu's loader, and the
3D entry points' refusal to fall back to the CPU without ``--device``."""
import itertools
import json
import logging
import os

import numpy as np
import pytest
import torch

from chap_tpu.data.datasets import SyntheticVolumeDataset as JaxSyntheticVolumes
from chap_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from chap_tpu.data.sampler import TwoStreamBatchSampler as JaxSampler
from chap_tpu.data.transforms3d import RandomGenerator3D as JaxRandomGenerator3D
from chap_tpu.train.trainer_3d import _PatchDataset as JaxPatchDataset
import chap_tpu_torch.train.trainer_3d as t3d
from chap_tpu_torch.cli import test_3d as cli_test3d
from chap_tpu_torch.cli import train_3d as cli_train3d
from chap_tpu_torch.config import Config
from chap_tpu_torch.train.step_chap import StepOutput
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

PATCH = (16, 16, 16)


def tiny_cfg():
    """2 classes, nf 2, batch 4 = 2 labeled + 2 unlabeled patches of 16^3
    from the synthetic phantoms (no val set), 4 steps."""
    cfg = Config()
    cfg.data.dataset = "synthetic"
    cfg.data.patch_size_3d = PATCH
    cfg.data.num_classes = 2
    cfg.data.batch_size, cfg.data.labeled_bs = 4, 2
    cfg.data.num_workers = 1
    cfg.model.n_filters_3d = 2
    cfg.optim.max_iterations = 4
    cfg.run.log_every = cfg.run.checkpoint_every = 2
    return cfg


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _restored_step(path, nf=2):
    cfg = tiny_cfg()
    cfg.model.n_filters_3d = nf
    model = net_factory_3d("dualdecoder", 1, 2, "train", cfg.model, device="cpu")
    state = create_train_state(model, make_optimizer(model, 0.01),
                               tuple(nf * m for m in (1, 2, 4, 8, 16)))
    return CheckpointManager(str(path)).restore_latest(state).step


def test_chap_trainer_3d_e2e_and_resume(tmp_path):
    cfg = tiny_cfg()
    cfg.semi.dropout = cfg.semi.adv_noise = True
    result = t3d.train(cfg, str(tmp_path), labeled_cases=4, mode="chap", device="cpu")
    assert result == {"best_dice": 0.0, "steps": 4}
    for name in ("metrics.jsonl", "checkpoints/latest/state.pt"):
        assert os.path.exists(tmp_path / name), name
    records = _records(tmp_path)
    logged = [r for r in records if "loss" in r]
    assert [r["step"] for r in logged] == [2, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["vat_loss"]) for r in logged)
    assert any("pool_build_s" in r for r in records)
    assert [r["step"] for r in records if "checkpoint_ms" in r] == [2, 4, 4]
    cfg.optim.max_iterations = 6
    assert t3d.train(cfg, str(tmp_path), labeled_cases=4, mode="chap", resume=True,
                     device="cpu")["steps"] == 6
    assert _restored_step(tmp_path) == 6


@pytest.mark.parametrize("mode", ["cps", "supervised"])
def test_cps_and_supervised_trainer_3d(tmp_path, mode):
    cfg = tiny_cfg()
    cfg.optim.max_iterations = 2
    cfg.model.name_3d = "vnet"
    assert t3d.train(cfg, str(tmp_path), labeled_cases=4, mode=mode,
                     device="cpu")["steps"] == 2
    logged = [r for r in _records(tmp_path) if "loss" in r]
    want = {"loss", "sup_loss"} | ({"cons_loss"} if mode == "cps" else set())
    assert want <= set(logged[0]) and np.isfinite(logged[0]["loss"])


def test_chap_trainer_3d_host_loader(tmp_path):
    cfg = tiny_cfg()
    cfg.semi.dropout = True
    cfg.data.device_input = False
    cfg.optim.max_iterations = 2
    assert t3d.train(cfg, str(tmp_path), labeled_cases=4, mode="chap",
                     device="cpu")["steps"] == 2
    assert not any("pool_build_s" in r for r in _records(tmp_path))


def test_host_batches_equal_chap_tpu_loader(tmp_path, monkeypatch):
    """data.device_input=false: the first 3 batches the step receives are
    chap_tpu's TwoStreamBatchSampler + BatchLoader + RandomGenerator3D
    patches of its synthetic volumes, in NCDHW, labels as uint8."""
    seen = []

    def recording_step_factory(model, optimizer, cfg, device=None):
        def step(state, batch, generator=None):
            seen.append({k: v.clone() for k, v in batch.items()})
            state.step += 1
            return StepOutput(state, {"loss": torch.zeros(())})
        return step

    monkeypatch.setattr(t3d, "build_supervised3d_train_step", recording_step_factory)
    cfg = tiny_cfg()
    cfg.data.device_input = False
    cfg.optim.max_iterations = 3
    t3d.train(cfg, str(tmp_path), labeled_cases=4, mode="supervised", device="cpu")

    synth = JaxSyntheticVolumes((PATCH[2] + 8, PATCH[0] + 16, PATCH[1] + 16), 2,
                                length=12)
    volumes = [{"image": np.transpose(synth[i]["image"], (2, 1, 0)),
                "label": np.transpose(synth[i]["label"], (2, 1, 0))} for i in range(12)]
    epoch_len = max(len(volumes) * 4, cfg.data.batch_size * 4)
    dataset = JaxPatchDataset(volumes, JaxRandomGenerator3D(PATCH, seed=cfg.run.seed),
                              epoch_len)
    labeled = list(range(min(4 * 4, epoch_len // 2)))
    sampler = JaxSampler(labeled, range(len(labeled), epoch_len), 4, 2, seed=cfg.run.seed)
    want = list(itertools.islice(iter(JaxBatchLoader(dataset, sampler, 1)), 3))
    assert len(seen) == 3
    for got, ref in zip(seen, want):
        assert got["image"].shape == (4, 1, *PATCH) and got["label"].dtype == torch.uint8
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.moveaxis(ref["image"], -1, 1))
        np.testing.assert_array_equal(got["label"].numpy(), ref["label"])


def test_fused_passes_override_is_logged_once(tmp_path, caplog):
    """chap_tpu's 3D trainer turns optim.fused_passes off without a word;
    the port's CHAP step says so, once a run."""
    cfg = tiny_cfg()
    cfg.optim.fused_passes = True
    cfg.semi.dropout = True
    cfg.optim.max_iterations = 1
    with caplog.at_level(logging.WARNING):
        t3d.train(cfg, str(tmp_path), labeled_cases=4, mode="chap", device="cpu")
    said = [r for r in caplog.records if "fused_passes" in r.getMessage()]
    assert len(said) == 1 and "3D trainer forces" in said[0].getMessage()
    assert cfg.optim.fused_passes      # the caller's config is left alone


@pytest.mark.parametrize("mode,change,match", [
    ("chap", ("parallel", "num_devices", 2), "ROADMAP item 16"),
    ("fixmatch", None, "unknown 3D trainer mode")])
def test_trainer_3d_refuses_what_is_not_ported(tmp_path, mode, change, match):
    cfg = tiny_cfg()
    if change:
        setattr(getattr(cfg, change[0]), change[1], change[2])
    with pytest.raises((NotImplementedError, ValueError), match=match):
        t3d.train(cfg, str(tmp_path), mode=mode, device="cpu")


def test_clis_3d_train_resume_cps_supervised_and_test(tmp_path):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--exp", "t",
            "--labeled_num", "4", "--batch_size", "4", "--labeled_bs", "2",
            "--num_classes", "2", "data.patch_size_3d=[16,16,16]",
            "model.n_filters_3d=2", f"run.snapshot_root={tmp_path}",
            "run.log_every=1", "data.num_workers=1"]
    first = cli_train3d.main(argv + ["--adv_noise", "--dropout",
                                     "--max_iterations", "2"])
    save_dir = first["save_dir"]
    assert first["steps"] == 2 and save_dir.endswith(os.path.join(
        "synthetic", "t_4_labeled", "dualdecoder3d", "run_0"))
    resumed = cli_train3d.main(argv + ["--adv_noise", "--dropout",
                                       "--max_iterations", "3", "--resume"])
    assert resumed["steps"] == 3 and resumed["save_dir"] == save_dir
    for name in ("config.json", "doc.txt", "log.txt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(save_dir, name)), name
    with open(os.path.join(save_dir, "config.json")) as f:
        saved = json.load(f)
    assert saved["data"]["patch_size_3d"] == [16, 16, 16]
    assert saved["eval"]["stride_xy"] == 32          # --dataset synthetic's protocol
    cps = cli_train3d.main(argv + ["--method", "cps", "--exp", "cps",
                                   "--max_iterations", "1"])
    sup = cli_train3d.main(argv + ["--method", "supervised", "--model", "vnet",
                                   "--exp", "sup", "--max_iterations", "1"])
    assert cps["steps"] == sup["steps"] == 1
    assert sup["save_dir"].endswith(os.path.join("sup_4_labeled", "vnet", "run_0"))
    metrics = cli_test3d.main(["--dataset", "synthetic", "--snapshot", save_dir,
                               "--ckpt", "latest", "--model", "dualdecoder",
                               "--device", "cpu"])
    assert metrics.shape == (1, 4) and np.isfinite(metrics[:, 0]).all()


def test_3d_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    from chap_tpu_torch.data.device_data import build_device_volume_pool
    from chap_tpu_torch.eval.sliding_window import SlidingWindowEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net_factory_3d("dualdecoder", 1, 2, "train", cfg.model)
    model = net_factory_3d("dualdecoder", 1, 2, "train", cfg.model, device="cpu")
    opt = make_optimizer(model, 0.01)
    for build in (t3d.build_cps3d_train_step, t3d.build_supervised3d_train_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(model, opt, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlidingWindowEngine(model, PATCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_device_volume_pool([], PATCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t3d.train(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train3d.main(["--dataset", "synthetic", f"run.snapshot_root={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test3d.main(["--dataset", "synthetic"])
    assert list(tmp_path.iterdir()) == []      # refused before writing a run dir
