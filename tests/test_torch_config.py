"""The port's config, ramps, import hygiene and device policy (CPU)."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from chap_tpu.config import load_config as jax_load_config
from chap_tpu.utils.ramps import sigmoid_rampup as jax_sigmoid_rampup
from chap_tpu_torch.config import acdc_chap_config, load_config
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
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from chap_tpu_torch.config import Config
    from chap_tpu_torch.device import resolve_device
    from chap_tpu_torch.models.factory import net_factory
    from chap_tpu_torch.train.state import make_optimizer
    from chap_tpu_torch.train.step_chap import build_chap_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net_factory("dualdecoder", 1, 4, cfg.model)
    model = net_factory("dualdecoder", 1, 4, cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_chap_train_step(model, make_optimizer(model, 0.01), cfg)
