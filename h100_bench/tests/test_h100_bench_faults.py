"""A whole run of each cell on the CPU at small sizes, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath (a step that returns its state unchanged, a step that leaves
its BatchNorm statistics unchanged, half of the batch left out, an answer
altered where it is produced: a label map, or the pseudo-labels of the
largest-CC cleanup), it comes out not correct. The runs on the card are marked ``card``."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench.harness import run_cell
from h100_bench.loops import _half_batch
from h100_bench.tests.small import small

ROOT = Path(__file__).resolve().parents[2]
TRAIN = ["acdc_chap.train", "la_chap.train", "acdc_chap.supervised"]


def _run(cell, seed=2 ** 33 + 7, trace=False):
    torch.manual_seed(0)
    line, _ = run_cell(cell, seed, 0.5, trace, torch.device("cpu"), ROOT,
                       time.perf_counter(), overrides=small(cell))
    return line


@pytest.mark.parametrize("cell", TRAIN + ["la_chap.eval"])
def test_a_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    assert list(line)[-1] == "checks"
    want = {"acdc_chap.train": "train_slices_per_s",
            "la_chap.train": "train_patches_per_s",
            "acdc_chap.supervised": "supervised_slices_per_s",
            "la_chap.eval": "eval_mvox_per_s"}[cell]
    assert set(line["metrics"]) == {want, "setup_s"}


def _broken_step(monkeypatch, fault):
    """Break the port's steps as they are built: ``unchanged`` restores the
    parameters, buffers and optimizer state after each call; ``bn_frozen``
    restores the buffers alone (the BatchNorm running statistics);
    ``half_batch`` feeds the step a batch whose second half of each stream
    repeats the first."""
    from chap_tpu_torch.train import step_chap, step_supervised

    def wrap(builder, mode):
        def build(model, optimizer, cfg, *args, **kw):
            step = builder(model, optimizer, cfg, *args, **kw)

            def broken(state, batch, generator=None, draws=None):
                if fault == "half_batch":
                    batch, draws = _half_batch(batch, draws, mode, cfg.data.labeled_bs)
                    return step(state, batch, generator, draws)
                if fault == "bn_frozen":
                    saved = {k: v.clone() for k, v in model.named_buffers()}
                    out = step(state, batch, generator, draws)
                    with torch.no_grad():
                        for k, v in model.named_buffers():
                            v.copy_(saved[k])
                    return out
                saved = {k: v.clone() for k, v in model.state_dict().items()}
                opt = {k: {n: t.clone() for n, t in s.items()}
                       for k, s in optimizer.state.items()}
                out = step(state, batch, generator, draws)
                model.load_state_dict(saved)
                optimizer.state.clear()
                optimizer.state.update(opt)
                return out
            return broken
        return build
    monkeypatch.setattr(step_chap, "build_chap_train_step",
                        wrap(step_chap.build_chap_train_step, "chap"))
    monkeypatch.setattr(step_supervised, "build_supervised_train_step",
                        wrap(step_supervised.build_supervised_train_step,
                             "supervised"))


@pytest.mark.parametrize("fault", ["unchanged", "bn_frozen", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    _broken_step(monkeypatch, fault)
    line = _run(cell)
    assert not line["correct"], line["checks"]


def _holds(cell, number):
    return number in json.loads((ROOT / "h100_bench" / "limits" / f"{cell}.json")
                                .read_text())


@pytest.mark.parametrize("cell", [c for c in TRAIN if _holds(c, "pseudo1")])
def test_altered_pseudo_labels_are_not_correct(cell, monkeypatch):
    """One pixel in 20 of each map that the CHAP step's largest-CC cleanup
    (K2) returns moved to the next class."""
    from chap_tpu_torch.train import step_chap
    cleanup = step_chap.largest_cc_batch

    def altered(labels, num_classes, *args, **kwargs):
        out = cleanup(labels, num_classes, *args, **kwargs).clone()
        flat = out.view(-1)
        flat[::20] = (flat[::20] + 1) % num_classes
        return out
    monkeypatch.setattr(step_chap, "largest_cc_batch", altered)
    line = _run(cell)
    assert not line["correct"], line["checks"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from chap_tpu_torch.eval import sliding_window
    finalize = sliding_window.SlidingWindowEngine.finalize

    def shifted(self, handle, num_classes, nms=False):
        return np.roll(finalize(self, handle, num_classes, nms), 1, axis=0)
    monkeypatch.setattr(sliding_window.SlidingWindowEngine, "finalize", shifted)
    line = _run("la_chap.eval")
    assert not line["correct"], line["checks"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "acdc_chap.train", "--seed", str(2 ** 31 + 3),
                          "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 2
    assert out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN + ["la_chap.eval"])
def test_a_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell,
                          "--seed", str(2 ** 32 + 11), "--seconds", "3"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
def test_no_program_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "acdc_chap.supervised", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
