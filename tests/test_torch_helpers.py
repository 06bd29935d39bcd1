"""The port's analysis and timing helpers (eval/analysis.py,
utils/timing.py) and its small public functions (semi.nms.get_masks_with_nms,
semi.bcp.generate_mask, train.state.update_ema and param_count,
config.config_to_dict) against chap_tpu's; every public name of chap_tpu
with a twin in the port, or on the list of names left out on purpose; and
the port's independence of JAX: no module of chap_tpu_torch/ and no line of
chip_smoke.py imports jax or chap_tpu."""
import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.semi as jax_semi
from chap_tpu.config import config_to_dict as jax_config_to_dict
from chap_tpu.config import load_config as jax_load_config
from chap_tpu.eval.analysis import acc_conf_analysis as jax_acc_conf
from chap_tpu.eval.analysis import save_prediction_nii as jax_save_nii
from chap_tpu.models.factory import net_factory as jax_net_factory
from chap_tpu.models.unet2d import UNet as JaxUNet
from chap_tpu.semi.bcp import generate_mask as jax_generate_mask
from chap_tpu.semi.nms import get_masks_with_nms as jax_get_masks_with_nms
from chap_tpu.train.state import param_count as jax_state_param_count
from chap_tpu.train.state import update_ema as jax_update_ema
from chap_tpu.utils.timing import param_count as jax_param_count
from chap_tpu_torch import semi
from chap_tpu_torch.config import config_to_dict, load_config
from chap_tpu_torch.eval.analysis import acc_conf_analysis, save_prediction_nii
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.unet2d import UNet
from chap_tpu_torch.semi import nms
from chap_tpu_torch.semi.bcp import patch_size_nd
from chap_tpu_torch.train import state as port_state
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


@pytest.mark.parametrize("use_nms", [True, False], ids=["nms", "argmax"])
def test_get_masks_with_nms_matches_chap_tpu(use_nms):
    """Argmax pseudo-labels of logits (class axis 1 here, last in chap_tpu)
    with and without the largest-CC cleanup, equal to chap_tpu's, int32;
    the CPU reaches K2's plain version, never the kernel."""
    rs = np.random.RandomState(21)
    logits = rs.randn(3, 4, 40, 40).astype(np.float32)
    logits[:, 1, 5:25, 5:25] += 3.0           # a large blob and speckle
    want = np.asarray(jax_get_masks_with_nms(
        jnp.asarray(np.moveaxis(logits, 1, -1)), 4, nms=use_nms))
    launches = nms.ccl_kernel.launches
    got = semi.get_masks_with_nms(torch.from_numpy(logits), 4, nms=use_nms)
    assert got.dtype == torch.int32 and got.shape == (3, 40, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert nms.ccl_kernel.launches == launches
    cleaned = semi.get_masks_with_nms(torch.from_numpy(logits), 4)
    assert use_nms or not torch.equal(got, cleaned)     # the cleanup acts


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_mask_matches_chap_tpu(seed):
    """The 2D wrapper: with the box starts chap_tpu's mask implies (its
    first zero row and column), chap_tpu's mask exactly; drawn from a
    generator, a box of chap_tpu's size."""
    side_x, side_y = 48, 36
    want = np.asarray(jax_generate_mask(jax.random.PRNGKey(seed), side_x, side_y))
    rows, cols = np.nonzero(want == 0)
    got = semi.generate_mask(side_x, side_y, [int(rows.min()), int(cols.min())])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = semi.generate_mask(side_x, side_y,
                               generator=torch.Generator().manual_seed(seed))
    assert int((drawn == 0).sum()) == int((want == 0).sum()) == int(
        np.prod(patch_size_nd((side_x, side_y))))


def test_update_ema_matches_chap_tpu():
    """Five EMA updates of a small UNet's parameters, from step 0 (alpha
    0: the EMA becomes the model) to steps where the decay binds (alpha
    = min(1 - 1 / (step + 1), decay)), equal chap_tpu's over the same
    parameter trees; the BatchNorm running statistics are not touched;
    TrainState carries the EMA model."""
    chns = (4, 8, 16, 16, 32)
    torch.manual_seed(0)
    model, ema = UNet(1, 4, chns), UNet(1, 4, chns)
    ema_buffers = {k: b.clone() for k, b in ema.named_buffers()}
    names = [k for k, _ in model.named_parameters()]

    def tree(m):
        return {k: jnp.asarray(p.detach().numpy()) for k, p in m.named_parameters()}

    want = tree(ema)
    decay = 0.9
    for step in (0, 1, 4, 9, 30):          # alpha 0, 0.5, 0.8, then 0.9, 0.9
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.1 * torch.randn_like(p))
        want = jax_update_ema(want, tree(model), decay, step)
        assert port_state.update_ema(ema, model, decay, step) is ema
        for k, p in ema.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{step} {k}")
        if step == 0:
            assert all(torch.equal(a, b) for a, b in
                       zip(ema.parameters(), model.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(ema.parameters(),
                                                     model.parameters()))
    assert all(torch.equal(b, ema_buffers[k]) for k, b in ema.named_buffers())
    assert len(names) == len(list(ema.parameters()))
    state = port_state.TrainState(step=0, model=model, optimizer=None, ema_model=ema)
    assert state.ema_model is ema and port_state.TrainState(
        step=0, model=model, optimizer=None).ema_model is None


def test_state_param_count_and_config_to_dict_on_acdc_chap():
    """configs/acdc_chap.yml: its config as a dict equals chap_tpu's, and
    train.state.param_count of its DualDecoder equals chap_tpu's."""
    path = str(ROOT / "configs" / "acdc_chap.yml")
    cfg, jcfg = load_config(path), jax_load_config(path)
    assert config_to_dict(cfg) == jax_config_to_dict(jcfg)
    jmodel = jax_net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                             jcfg.model)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, cfg.data.in_chns))))
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device="cpu")
    assert port_state.param_count(model) == jax_state_param_count(shapes["params"]) > 0


# chap_tpu's public names the port has no twin of, on purpose (ROADMAP §1,
# "Not ported on purpose"): JAX machinery, Flax / optax specifics, and names
# the port spells otherwise or inlines
NOT_PORTED = {
    # ops/s2d.py: exact TPU weight relayouts
    "space_to_depth_3d", "depth_to_space_3d", "phase_view", "s2d_conv_kernel",
    "s2d_out_conv_kernel", "zpack_conv_kernel", "zpack_unpack", "s2d_down_kernel",
    "s2d_deconv_kernel", "s2d_pointwise_kernel", "conv3d",
    # utils/jaxcache.py, utils/profiling.py: JAX's compile cache and profiler
    "enable_persistent_cache", "trace", "annotate",
    # parallel/mesh.py: replaced by parallel/dist.py
    "MeshSpec", "build_mesh", "batch_sharding", "replicated_sharding",
    "shard_batch", "replicate", "process_sharded_batch", "ProcessLocalBatchSampler",
    # Flax initialisers, optax masks (step_share.encoder_parameters and
    # decoder_parameters in the port), a JAX type alias, an internal helper
    "kaiming_normal", "xavier_normal", "encoder_mask", "decoder_mask",
    "GradSimState", "level_kernel_grads",
    # convert/torch_import.py and cli/convert_torch.py fill Flax trees from a
    # torch state_dict; the port loads it by name (convert/from_pth.py:
    # read_pth, load_reference_state_dict, efficientnet_rules for b0-b7)
    "apply_rules", "convert_state_dict", "efficientnet_b0_rules", "load_state_dict",
    # inlined or renamed in the port
    "UpBlockPlus", "VDecoderDS", "SqueezeExcite", "FinalPatchExpandX4",
    "vat_divergence",
}


def _public_names(root: pathlib.Path) -> dict:
    """A package's public top-level names: name -> file:line."""
    names = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                found = [node.name]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                found = [t.id for t in targets if isinstance(t, ast.Name)]
            else:
                continue
            for name in found:
                if not name.startswith("_"):
                    names.setdefault(name, f"{path.relative_to(ROOT)}:{node.lineno}")
    return names


def test_every_public_name_of_chap_tpu_has_a_twin():
    """Every public top-level function, class and alias (constants aside)
    of chap_tpu/ is defined at the top level of a chap_tpu_torch/ module,
    but for NOT_PORTED;
    every name there is one of chap_tpu's that the port lacks; and the
    port's semi package re-exports what chap_tpu's does (but the alias)."""
    jax_names = {k: v for k, v in _public_names(ROOT / "chap_tpu").items()
                 if not k.isupper()}
    port = _public_names(ROOT / "chap_tpu_torch")
    missing = {k: v for k, v in jax_names.items()
               if k not in port and k not in NOT_PORTED}
    assert not missing, missing
    assert NOT_PORTED <= set(jax_names) and not NOT_PORTED & set(port)
    reexported = {n for n in dir(jax_semi) if not n.startswith("_")
                  and not isinstance(getattr(jax_semi, n), type(jax_semi))}
    assert reexported - {"GradSimState"} <= set(dir(semi))
