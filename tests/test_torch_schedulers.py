"""The port's LR schedule family (train/schedulers.py) against chap_tpu's
(chap_tpu/train/schedulers.py) over a range of epochs, the plateau
controller on the same metric sequence, and get_lr_schedule's names."""
import numpy as np
import pytest

import chap_tpu.train.schedulers as jax_sched
from chap_tpu_torch.train import schedulers

RTOL = 2e-3
EPOCHS = range(0, 260)


@pytest.mark.parametrize("policy,opt", [
    ("lambda", dict(niter=100, niter_decay=100)),
    ("lambda", dict(niter=10, niter_decay=5, epoch_count=3)),
    ("step", dict(lr_decay_iters=30)),
    ("step2", dict(lr_decay_iters=7)),
    ("step_warmstart", {}), ("step_warmstart2", {})])
def test_schedule_values_match_chap_tpu(policy, opt):
    """Every epoch's multiplier equals chap_tpu's (rtol 2e-3; they are the
    same formulas, chap_tpu's in float32)."""
    got = schedulers.get_lr_schedule(policy, **opt)
    want = jax_sched.get_lr_schedule(policy, **opt)
    for epoch in EPOCHS:
        np.testing.assert_allclose(got(epoch), float(want(epoch)), rtol=RTOL,
                                   err_msg=f"{policy} epoch {epoch}")
    assert isinstance(got(5), float)


@pytest.mark.parametrize("policy", ["plateau", "plateau2"])
def test_plateau_matches_chap_tpu(policy):
    """The same metric sequence (improvements, a plateau inside the
    threshold, worse values) gives the same scale after every eval."""
    rs = np.random.RandomState(0)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 8), np.full(8, 0.499),
                              0.5 + 0.1 * rs.rand(12), np.linspace(0.4, 0.1, 5)])
    got, want = (mod.get_lr_schedule(policy) for mod in (schedulers, jax_sched))
    scales = [(got.step(float(m)), want.step(float(m))) for m in metrics]
    for i, (a, b) in enumerate(scales):
        assert a == pytest.approx(b, rel=1e-12), (i, scales)
    assert scales[-1][0] < 1.0


def test_plateau_rules():
    """tests/test_schedulers.py's rules: patience, then the factor; an
    improvement must beat best * (1 - threshold)."""
    c = schedulers.ReduceLROnPlateau(factor=0.1, patience=2, threshold=0.01)
    assert c.step(1.0) == 1.0 and c.step(0.5) == 1.0
    c.step(0.5)
    c.step(0.5)
    assert c.step(0.5) == 0.1
    c2 = schedulers.ReduceLROnPlateau(patience=0)
    c2.step(1.0)
    assert c2.step(0.995) == 0.1


def test_unknown_policy_raises():
    with pytest.raises(NotImplementedError):
        schedulers.get_lr_schedule("nope")
