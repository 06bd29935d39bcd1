"""The 2D trainer end to end at W = 2 gloo ranks on the CPU, launched as a
user launches it (torchrun), against the same run in one process:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m chap_tpu_torch.cli.train_2d --device cpu ...

12 CHAP steps with an eval every 6, ``--resume`` to 18, then
``cli.test_2d`` on the run dir. The recipe is the CPU end-to-end one of the
README (synthetic slices, batch 8 = 4 labeled + 4 unlabeled) at the CPU
tests' widths (feature_chns 4-32, 32^2), so the two launches stay short.

Marked slow: the two torchrun launches take about 40 s on the CPU (each
starts three Python processes, and a gloo step at W = 2 takes twice the
one-process step); tests/test_torch_parallel.py runs the same CLI at W = 2
in process groups it spawns itself, within the fast tier. Run it with

    python -m pytest tests/test_torch_trainer_dist.py -q

Bars: the logged losses at the step parity bar, rtol 2e-3. The CHAP step
at these widths amplifies float32 summation noise over a run (its VAT
direction and top-k patch mask, its pseudo-label argmax and the dropout
thresholds take discrete choices): one process against itself at one and at
six threads differs by up to 8.4e-4 in the loss within 12 steps on this
CPU. Measured here: 1.2e-5 over the 18 steps. The eval dice within 5e-3: the eval itself gives the same maps at every W
(tests/test_torch_parallel.py), but the two runs' weights differ by that
noise, and a pixel whose two largest logits are within it may take either
class; after 18 steps at these widths many pixels are that close (val dice
0.28), and the measured gap was 1.07e-3 at step 18.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from chap_tpu_torch.cli import test_2d as cli_test
from chap_tpu_torch.cli import train_2d as cli_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(root):
    return ["--device", "cpu", "--dataset", "synthetic", "--exp", "dist",
            "--adv_noise", "--dropout", "--labeled_num", "3",
            "--batch_size", "8", "--labeled_bs", "4", "data.image_size=[32,32]",
            "data.synthetic_train_size=96", "data.synthetic_val_volumes=2",
            "model.feature_chns=[4,8,16,16,32]", "eval.eval_every=6",
            f"run.snapshot_root={root}", "run.log_every=1"]


def _torchrun(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "chap_tpu_torch.cli.train_2d", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(records):
    return {r["step"]: r["loss"] for r in records if "loss" in r}


def _dice(records):
    return {r["step"]: r["val_mean_dice"] for r in records if "val_mean_dice" in r}


@pytest.mark.slow
def test_torchrun_two_ranks_train_resume_and_test_as_one_process(tmp_path):
    one_root, two_root = str(tmp_path / "one"), str(tmp_path / "two")
    one = cli_train.main(_argv(one_root) + ["--max_iterations", "12"])
    cli_train.main(_argv(one_root) + ["--max_iterations", "18", "--resume"])
    _torchrun(_argv(two_root) + ["--max_iterations", "12"])
    said = _torchrun(_argv(two_root) + ["--max_iterations", "18", "--resume"])
    assert "resumed from step 12" in said
    base = os.path.join(two_root, "synthetic", "dist_3_labeled", "dualdecoder")
    # rank 0 alone picked the run dir and wrote in it
    assert os.listdir(base) == ["run_0"]
    run = os.path.join(base, "run_0")
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == \
        ["best", "latest", "meta.json"]
    for name in ("config.json", "config.resume1.json", "log.txt", "val.csv"):
        assert os.path.isfile(os.path.join(run, name)), name
    want, got = _records(one["save_dir"]), _records(run)
    # one record a step and one an eval, written once
    assert [r["step"] for r in got] == [r["step"] for r in want]
    want_loss, got_loss = _losses(want), _losses(got)
    assert sorted(got_loss) == list(range(1, 19))
    np.testing.assert_allclose([got_loss[s] for s in sorted(want_loss)],
                               [want_loss[s] for s in sorted(want_loss)],
                               rtol=2e-3, atol=1e-6)
    assert sorted(_dice(got)) == [6, 12, 18]
    np.testing.assert_allclose([_dice(got)[s] for s in (6, 12, 18)],
                               [_dice(want)[s] for s in (6, 12, 18)], atol=5e-3)
    with open(os.path.join(run, "val.csv")) as f, \
            open(os.path.join(one["save_dir"], "val.csv")) as g:
        got_rows = [line.split(",")[1:] for line in f.read().splitlines()[1:]]
        want_rows = [line.split(",")[1:] for line in g.read().splitlines()[1:]]
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
    np.testing.assert_allclose([float(r[1]) for r in got_rows],
                               [float(r[1]) for r in want_rows], atol=5e-3)
    test_two = cli_test.main(["--snapshot", run, "--device", "cpu"])
    test_one = cli_test.main(["--snapshot", one["save_dir"], "--device", "cpu"])
    assert os.path.isfile(os.path.join(run, "performance.txt"))
    np.testing.assert_allclose(test_two[:, 0], test_one[:, 0], atol=5e-3)
