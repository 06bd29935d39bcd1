"""The port's config, ramps, import hygiene and device policy (CPU)."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from chap_tpu.config import load_config as jax_load_config
from chap_tpu.utils.ramps import sigmoid_rampup as jax_sigmoid_rampup
from chap_tpu_torch.config import Config, acdc_chap_config, load_config
from chap_tpu_torch.utils.ramps import sigmoid_rampup

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chap_tpu")


def test_acdc_chap_config_in_code_equals_the_yaml():
    """chip_smoke.py builds configs/acdc_chap.yml in code (no YAML parser on
    the card's machine); it must be the file's values, which are also
    chap_tpu's."""
    in_code = dataclasses.asdict(acdc_chap_config())
    path = str(ROOT / "configs" / "acdc_chap.yml")
    assert in_code == dataclasses.asdict(load_config(path))
    assert in_code == dataclasses.asdict(jax_load_config(path))


def test_overrides_parse_like_chap_tpu():
    items = ["semi.topk1=0.2", "data.image_size=[64,64]", "optim.base_lr=1e-3"]
    assert (dataclasses.asdict(load_config(None, items))
            == dataclasses.asdict(jax_load_config(None, items)))


@pytest.mark.parametrize("rampup", [0.0, 50.0, 200.0])
def test_sigmoid_rampup_matches_chap_tpu(rampup):
    for step in (0, 1, 7, 49, 50, 120, 10_000):
        np.testing.assert_allclose(sigmoid_rampup(step // 150, rampup),
                                   float(jax_sigmoid_rampup(step // 150, rampup)),
                                   rtol=1e-6)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_chap_tpu():
    files = sorted((ROOT / "chap_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    scanned = {str(f.relative_to(ROOT / "chap_tpu_torch")) for f in files[:-1]}
    assert {"cli/train_2d.py", "cli/test_2d.py", "train/trainer_2d.py",
            "train/step_supervised.py", "data/device_data.py", "data/pipeline.py",
            "data/sampler.py", "data/transforms.py", "data/datasets.py",
            "eval/eval2d.py", "metrics/surface.py", "metrics/dice.py",
            "utils/checkpoint.py", "utils/launch.py",
            "utils/metrics_writer.py"} <= scanned
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    from chap_tpu_torch.cli import test_2d as cli_test
    from chap_tpu_torch.cli import train_2d as cli_train
    from chap_tpu_torch.config import Config
    from chap_tpu_torch.data.datasets import SyntheticSliceDataset
    from chap_tpu_torch.data.device_data import build_device_pool
    from chap_tpu_torch.device import resolve_device
    from chap_tpu_torch.eval.eval2d import make_predictor
    from chap_tpu_torch.models.factory import net_factory
    from chap_tpu_torch.train.state import make_optimizer
    from chap_tpu_torch.train.step_chap import build_chap_train_step
    from chap_tpu_torch.train.step_supervised import build_supervised_train_step
    from chap_tpu_torch.train.trainer_2d import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net_factory("dualdecoder", 1, 4, cfg.model)
    model = net_factory("dualdecoder", 1, 4, cfg.model, device="cpu")
    for build in (build_chap_train_step, build_supervised_train_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(model, make_optimizer(model, 0.01), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_predictor(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_device_pool(SyntheticSliceDataset(8, 4, 2), (8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--dataset", "synthetic", f"run.snapshot_root={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["--snapshot", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []      # refused before writing a run dir


def test_config_from_flags_needs_no_yaml(monkeypatch):
    """PyYAML is imported only where a file is read or an override parsed:
    with it blocked, the CLI's flags still build a config."""
    import sys

    from chap_tpu_torch.cli.train_2d import build_config, parse_args

    monkeypatch.setitem(sys.modules, "yaml", None)      # import yaml -> ImportError
    cfg = build_config(parse_args(["--dataset", "synthetic", "--labeled_num", "7",
                                   "--adv_noise", "--dropout", "--device", "cpu",
                                   "--max_iterations", "20"]))
    assert (cfg.data.dataset, cfg.data.labeled_num, cfg.optim.max_iterations) == \
        ("synthetic", 7, 20)
    assert cfg.semi.adv_noise and cfg.semi.dropout
    assert dataclasses.asdict(load_config()) == dataclasses.asdict(Config())
    with pytest.raises(ImportError):
        load_config(None, ["eval.eval_every=10"])
