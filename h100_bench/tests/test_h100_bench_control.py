"""The control comes out not correct: the plain reference put in the
program's place and computed a precision below the configuration's (bf16
for ACDC's float32, float8 convolution operands for LA's bf16), held to
the cell's own limits against the float32 reference (``pseudo1`` against
the configuration's own precision), at a size a CPU test
run can hold (calibrate.py reads the same at the cells' own sizes on the
card; PERF.md gives those readings)."""
import json
from pathlib import Path

import pytest
import torch

from h100_bench.calibrate import CONTROL
from h100_bench.check import label_share, verdict
from h100_bench.harness import load_cell
from h100_bench.loops import LOOPS

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
# larger than tests/small.py: the control's rounding has to show above the
# cells' limits, which were set at full size
MID = {
    "acdc_chap": {"config": {"data": {"image_size": [64, 64], "batch_size": 8,
                                      "labeled_bs": 4},
                             "model": {"feature_chns": [8, 16, 16, 32, 32]}},
                  "pool": {"items": 32, "labeled": 8}},
    "la_chap": {"config": {"data": {"patch_size_3d": [32, 32, 16]},
                           "model": {"n_filters_3d": 4}},
                "pool": {"items": 6, "labeled": 2, "extent": [40, 40, 24]},
                "traffic": {"volumes": 2, "extent": [48, 48, 24],
                            "check_volumes": 2}},
}


def _cell(name, seed):
    conf, traffic, limits = load_cell(MANIFEST, ROOT, name,
                                      json.loads(json.dumps(MID[name.split(".")[0]])))
    torch.manual_seed(0)
    run = LOOPS[traffic["loop"]](conf, traffic, seed, torch.device("cpu"), False,
                                 ROOT / "build" / "h100_bench")
    run.setup()
    return run, traffic, limits


@pytest.mark.parametrize("seed", [2 ** 32 + 1, 2 ** 32 + 2])
@pytest.mark.parametrize("cell", ["acdc_chap.train", "la_chap.train",
                                  "acdc_chap.supervised"])
def test_the_training_control_is_not_correct(cell, seed):
    run, _, limits = _cell(cell, seed)
    run.release()
    control = run.reference_record(CONTROL[run.cfg.model.dtype])
    numbers, _ = run.numbers(control, limits)
    correct, shown = verdict(numbers, limits)
    assert not correct, shown


@pytest.mark.parametrize("seed", [2 ** 32 + 1, 2 ** 32 + 2])
def test_the_eval_control_is_not_correct(seed):
    run, traffic, limits = _cell("la_chap.eval", seed)
    run.run_volumes(traffic["volumes"])
    run.release()
    vids = run.checked_volumes()
    ref, _ = run.reference_labels(run.cfg.model.dtype, vids)
    control, _ = run.reference_labels(CONTROL[run.cfg.model.dtype], vids)
    correct, shown = verdict(label_share(control, ref), limits)
    assert not correct, shown
