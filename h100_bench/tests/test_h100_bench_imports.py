"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``chap_tpu_torch`` is the port and allowed,
``chap_tpu`` is not), and the plain reference imports nothing of the
port."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "chap_tpu"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 40
    bad = [(str(f.relative_to(BENCH)), full) for f in files
           for top, full in _imports(f) if top in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    bad = [(str(f.relative_to(BENCH)), full) for f in files
           for top, full in _imports(f) if top == "chap_tpu_torch"]
    assert not bad
    # nor does it load the port through another module
    code = ("import sys; import h100_bench.reference.build, "
            "h100_bench.reference.eval.sliding_window, "
            "h100_bench.reference.data.device_data; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'chap_tpu_torch', 'chap_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import h100_bench.harness, "
            "h100_bench.calibrate, chap_tpu_torch.train.step_chap, "
            "chap_tpu_torch.eval.sliding_window, chap_tpu_torch.models.factory; "
            "from h100_bench.harness import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
