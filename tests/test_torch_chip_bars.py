"""The arithmetic of chip_smoke.py's data-parallel bars (phase 23): each
gap's bar is twice the largest of several control draws, floored at rtol
2e-3; the first step is held apart where both runs kept it; and the bars
reject a wrong update (the negative controls). Plain host arithmetic on
synthetic step records (CPU)."""
import pytest
import torch

import chip_smoke as cs


def steps(params, metrics, sim=()):
    """A dist_steps record as dist_gaps reads it."""
    return {"params": params, "metrics": metrics, "sim": list(sim),
            "counts": [None, None]}


def test_control_bars_take_twice_the_largest_draw():
    draws = [{"metrics": 1e-3, "update": 0.10, "update_max_abs": 9.0},
             {"metrics": 3e-3, "update": 0.05, "update_max_abs": 1.0},
             {"metrics": 2e-3, "update": 0.24, "update_max_abs": 4.0}]
    bars = cs.control_bars(draws)
    assert bars == {"metrics": pytest.approx(6e-3), "update": pytest.approx(0.48)}
    # floored at rtol 2e-3; one draw is twice itself
    assert cs.control_bars([{"metrics": 1e-4, "running": 0.01}]) == {
        "metrics": cs.RTOL, "running": pytest.approx(0.02)}


def test_over_bars_names_the_gaps_above_their_bar():
    bars = {"metrics": 6e-3, "update": 0.48}
    assert cs.over_bars({"metrics": 5e-3, "update": 0.3, "sim": 9.0}, bars) == {}
    assert cs.over_bars({"metrics": 7e-3, "update": 0.3}, bars) == {"metrics": 7e-3}


def _run(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    init = {"w": torch.randn(50, generator=g), "bn.running_mean": torch.zeros(4)}
    params = {"w": init["w"] + scale * 0.01 * torch.randn(50, generator=g),
              "bn.running_mean": torch.full((4,), 0.5)}
    return init, params


def _update(init, params, scale):
    """``params`` with their update from ``init`` scaled (the BN running
    statistics kept)."""
    return {k: v if k.endswith("running_mean") else init[k] + scale * (v - init[k])
            for k, v in params.items()}


def test_first_step_gaps_only_where_both_runs_kept_it():
    """dist_gaps holds the first step alone (FIRST_STEP_KINDS) only where
    both runs kept its state: first_metrics over step 1's metrics,
    first_update and first_running from its state."""
    init, params = _run(2)
    one = steps(params, [{"loss": 1.0}, {"loss": 0.9}])
    one["first_params"] = params
    other = steps(params, [{"loss": 1.0}, {"loss": 0.95}])
    other["first_params"] = _update(init, params, 0.9)
    gap = cs.dist_gaps(other, one, init)
    assert gap["metrics"] == pytest.approx(0.05 / 0.9)
    assert gap["first_metrics"] == 0.0
    assert gap["first_update"] == pytest.approx(0.1, rel=1e-4)
    assert gap["first_running"] == 0.0 and gap["update"] == 0.0
    assert not any(k.startswith("first") for k in cs.dist_gaps(
        steps(params, [{"loss": 1.0}, {"loss": 0.9}]), one, init))
    assert "first_update" in cs.control_bars([gap])


def test_a_scaled_update_fails_bars_from_tight_controls():
    """An update 5% short from the first step (SCALED_GRADIENT) has a
    first-step update gap of 5%; bars from controls of a fraction of that
    reject it, and hold_negative_control passes; bars looser than 5% do
    not, and it raises."""
    init, params = _run(0)
    one = steps(params, [{"loss": 1.0}, {"loss": 0.9}])
    one["first_params"] = _update(init, params, 0.5)
    wrong = dict(one, first_params=_update(init, params, 0.5 * cs.SCALED_GRADIENT),
                 params=_update(init, params, cs.SCALED_GRADIENT))
    gap = cs.dist_gaps(wrong, one, init)
    assert gap["first_update"] == pytest.approx(1 - cs.SCALED_GRADIENT, rel=1e-4)
    assert gap["first_running"] == 0.0 and gap["first_metrics"] == 0.0
    noisy = dict(one, params={k: v + 1e-4 for k, v in params.items()},
                 first_params={k: v + 1e-4 for k, v in one["first_params"].items()})
    tight = cs.control_bars([cs.dist_gaps(noisy, one, init)])
    res = cs.hold_negative_control("la", [("scaled", wrong)], one, init, tight)
    assert "first_update" in res["scaled"]["over"]
    loose = {k: 0.06 for k in tight}
    with pytest.raises(RuntimeError, match="rejected no gap"):
        cs.hold_negative_control("la", [("scaled", wrong)], one, init, loose)


def test_hold_ranks_bar_fails_a_wrong_metric():
    """hold_ranks's test of a rank's gaps: within the bars passes, a metric
    off by more than twice the largest control fails."""
    init, params = _run(1)
    one = steps(params, [{"loss": 1.0}])
    bars = cs.control_bars([{"metrics": 1e-3, "update": 0.0, "running": 0.0}])
    right = steps(params, [{"loss": 1.0 + 1e-3}])
    wrong = steps(params, [{"loss": 1.01}])
    assert cs.over_bars(cs.dist_gaps(right, one, init), bars) == {}
    assert set(cs.over_bars(cs.dist_gaps(wrong, one, init), bars)) == {"metrics"}
