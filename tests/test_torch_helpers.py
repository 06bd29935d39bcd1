"""The port's analysis and timing helpers (eval/analysis.py,
utils/timing.py) against chap_tpu's, and the port's independence of JAX:
no module of chap_tpu_torch/ and no line of chip_smoke.py imports jax or
chap_tpu."""
import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chap_tpu.eval.analysis import acc_conf_analysis as jax_acc_conf
from chap_tpu.eval.analysis import save_prediction_nii as jax_save_nii
from chap_tpu.models.unet2d import UNet as JaxUNet
from chap_tpu.utils.timing import param_count as jax_param_count
from chap_tpu_torch.eval.analysis import acc_conf_analysis, save_prediction_nii
from chap_tpu_torch.models.unet2d import UNet
from chap_tpu_torch.utils.timing import benchmark_fwd_bwd, flops_estimate, param_count

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chap_tpu")


def test_acc_conf_rows_match_chap_tpu(tmp_path):
    """Two batches appended: each row's six values and the .npy history
    equal chap_tpu's, from the same softmax maps and labels."""
    rs = np.random.RandomState(0)
    for step in range(2):
        logits = rs.randn(6, 16, 16, 4).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        labels = rs.randint(0, 4, (6, 16, 16))
        got = acc_conf_analysis(probs, labels, 3, str(tmp_path / "port.npy"))
        want = jax_acc_conf(probs, labels, 3, str(tmp_path / "jax.npy"))
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"),
                               np.load(tmp_path / "jax.npy"), rtol=1e-6)
    assert np.load(tmp_path / "port.npy").shape == (2, 6)


def test_save_prediction_nii_is_gated(tmp_path):
    """Without SimpleITK and nibabel it writes nothing and returns False,
    as chap_tpu's; with either, it writes the three files."""
    a = np.zeros((4, 4, 4))
    have = any(importlib.util.find_spec(m) for m in ("SimpleITK", "nibabel"))
    got = save_prediction_nii(a, a, a, str(tmp_path / "port"), "case0")
    assert got == jax_save_nii(a, a, a, str(tmp_path / "jax"), "case0") == have
    assert os.path.isdir(tmp_path / "port") == have


def test_param_count_matches_chap_tpu():
    """The UNet's parameter count in both packages."""
    chns = (4, 8, 16, 16, 32)
    jmodel = JaxUNet(4, feature_chns=chns)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 1))))
    assert param_count(UNet(1, 4, chns)) == jax_param_count(shapes["params"])


def test_flops_estimate_is_the_analytic_count():
    """FlopCounterMode's count: 2 a multiply-add of each convolution and
    matrix product, nothing for the bias or the ReLU."""
    conv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
    lin = torch.nn.Linear(8, 5)
    x = torch.zeros(2, 3, 16, 16)

    def fn(x):
        h = torch.relu(conv(x))                 # [2, 8, 8, 8]
        return lin(h.mean(dim=(2, 3)))
    want = 2 * (2 * 8 * 8 * 8) * 3 * 9 + 2 * 2 * 8 * 5
    assert flops_estimate(fn, x) == want
    assert flops_estimate(lin, torch.zeros(4, 8)) == 2 * 4 * 8 * 5


def test_benchmark_fwd_bwd_on_the_cpu():
    """chap_tpu's harness test (tests/test_models_zoo2.py): positive times
    and the parameter count; the model's mode and gradients are left as
    they were."""
    model = UNet(1, 2, (2, 4, 8, 8, 16))
    stats = benchmark_fwd_bwd(model, torch.zeros(1, 1, 32, 32), num_iters=2)
    assert stats["fwd_ms"] > 0 and stats["fwd_bwd_ms"] > 0
    assert stats["params"] == param_count(model)
    assert model.training and all(p.grad is None for p in model.parameters())


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_chap_tpu():
    """Every module of chap_tpu_torch/ and chip_smoke.py: no import of
    jax, flax, optax or chap_tpu (chap_tpu_torch itself is fine); and every
    module imports in a process that refuses those packages."""
    files = sorted((ROOT / "chap_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    modules = [".".join(f.relative_to(ROOT).with_suffix("").parts) for f in files
               if f.name != "__init__.py" and f.suffix == ".py"]
    script = (
        "import sys, importlib\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]
