"""scripts/supervise.py over the port's trainer: chap_tpu_torch.cli.train_2d
on --dataset synthetic on the CPU at 64^2 (feature_chns 4-32), under a
snapshot root inside the checkout (build/, git-ignored) that is emptied
first. The test kills the trainer's process group once, after its first
checkpoint (the latest slot at the first eval); supervise sees the crash,
relaunches the same command with --resume, and the resumed trainer's
metrics.jsonl steps go on from the checkpoint's step instead of starting
again at 1. supervise.py imports no JAX, and the port's trainer writes the
metrics.jsonl keys it reads (``step``). Every subprocess has its own
timeout; the test takes about 40 s (supervise waits 10 s before a
relaunch)."""
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SNAPSHOT_ROOT = ROOT / "build" / "test_torch_supervise"
MAX_ITERATIONS = 8
EVAL_EVERY = 4
TRAINER = [sys.executable, "-m", "chap_tpu_torch.cli.train_2d", "--device", "cpu",
           "--dataset", "synthetic", "--exp", "sup", "--labeled_num", "3",
           "--batch_size", "4", "--labeled_bs", "2",
           "--max_iterations", str(MAX_ITERATIONS), "data.image_size=[64,64]",
           "model.feature_chns=[4,8,16,16,32]", "data.synthetic_train_size=128",
           "data.synthetic_val_volumes=1", f"eval.eval_every={EVAL_EVERY}",
           "run.log_every=1", f"run.snapshot_root={SNAPSHOT_ROOT}"]
RUN_DIR = SNAPSHOT_ROOT / "synthetic" / "sup_3_labeled" / "dualdecoder" / "run_0"


def _wait_for(path: pathlib.Path, proc: subprocess.Popen, timeout: float) -> None:
    deadline = time.time() + timeout
    while not path.exists():
        assert proc.poll() is None, f"supervise ended early: {proc.returncode}"
        assert time.time() < deadline, f"no {path} within {timeout} s"
        time.sleep(0.1)


def _children(pid: int) -> list:
    """The trainer processes supervise has started (not its own ``ps``)."""
    out = subprocess.run(["ps", "-o", "pid=,args=", "--ppid", str(pid)],
                         capture_output=True, text=True, timeout=10).stdout
    return [int(line.split()[0]) for line in out.splitlines()
            if "chap_tpu_torch.cli.train_2d" in line]


def _steps(path: pathlib.Path) -> list:
    return [json.loads(line)["step"] for line in path.read_text().splitlines()
            if line.strip()]


def test_supervise_relaunches_the_port_trainer_with_resume():
    shutil.rmtree(SNAPSHOT_ROOT, ignore_errors=True)
    metrics = RUN_DIR / "metrics.jsonl"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    sup = subprocess.Popen(
        [sys.executable, "scripts/supervise.py", "--watch", str(metrics),
         "--poll-sec", "0.2", "--stall-sec", "120", "--max-restarts", "1",
         "--", *TRAINER],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    trainer = None
    try:
        _wait_for(RUN_DIR / "checkpoints" / "latest" / "state.pt", sup, 120)
        (trainer,) = _children(sup.pid)
        os.killpg(trainer, signal.SIGKILL)         # the trainer's process group
        while _children(sup.pid) == [trainer]:     # reaped by supervise
            time.sleep(0.05)
        first_run = _steps(metrics)
        said, _ = sup.communicate(timeout=180)
    finally:
        for pgid in (trainer, sup.pid):
            if pgid is not None:
                try:
                    os.killpg(pgid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        sup.wait(timeout=30)
    assert sup.returncode == 0, said[-3000:]
    assert "restart trigger: crash" in said and "trainer exited cleanly" in said, said[-3000:]
    launches = [line for line in said.splitlines() if "launching (attempt" in line]
    assert len(launches) == 2 and launches[1].endswith("--resume"), launches
    assert "--resume" not in launches[0]
    resumed = _steps(metrics)[len(first_run):]
    # each run's first record is its start step (the pool's build time)
    assert first_run[:2] == [0, 1] and max(first_run) >= EVAL_EVERY, first_run
    # the resumed run starts at the checkpoint of the first eval, not at 0,
    # and its first step is the one after it
    assert resumed[:2] == [EVAL_EVERY, EVAL_EVERY + 1], (first_run, resumed)
    assert min(resumed) == EVAL_EVERY and resumed[-1] == MAX_ITERATIONS, resumed
    shutil.rmtree(SNAPSHOT_ROOT, ignore_errors=True)
