"""Data parallelism of the port (chap_tpu_torch/parallel/dist.py) at W = 2
gloo ranks on the CPU against the one-process port on the global batch.

One spawn of two ranks (``dist.spawn_ranks``) runs every case of this file
(tests/torch_dist_cases.py); the one-process reference is the same function
called here, in a process without a group (W = 1, where every reduction is
the identity). The inputs are global, made from seeds with numpy, and each
rank takes its rows (``rank_rows``).

Bars: float32 summation noise. W = 2 sums each statistic in two halves, and
BatchNorm takes Flax's one-pass variance where the one-process port takes
torch's; measured on the CPU, three CHAP steps differ by at most 2.7e-7
relative in a metric, 1.2e-7 in a parameter and 2.7e-7 in a GradSim score.
The bars below are 1e-5 (metrics, relative) and 1e-5 (parameters, BN
running statistics and scores, absolute at their scale of 0.1-1): a wrong
reduction (a per-rank BN statistic, a gradient scaled by W, a missing
cotangent term) moves them by 1e-2 to 1 (``test_reductions_*`` shows the
last two).
"""
import concurrent.futures
import copy
import os

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from chap_tpu_torch.config import Config
from chap_tpu_torch.data.datasets import SyntheticVolumeDataset, phantom_batch
from chap_tpu_torch.data.device_data import DevicePool, build_device_batch_fn
from chap_tpu_torch.data.sampler import RankBatchSampler, TwoStreamBatchSampler
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.state import bn_running_stats
from chap_tpu_torch.train.step_chap import draw_step_uniforms, shard_step_draws
from chap_tpu_torch.train.step_supervised import draw_supervised_uniforms

torch.set_num_threads(1)

W = 2
C, B, LB, HW = 4, 8, 4, 32
CHNS = (4, 8, 16, 16, 32)
STEPS = 3
RTOL, ATOL = 1e-5, 1e-5


def _cfg(remat=False):
    cfg = Config()
    cfg.data.num_classes, cfg.data.batch_size, cfg.data.labeled_bs = C, B, LB
    cfg.data.image_size = (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.semi.dropout = cfg.semi.adv_noise = True
    cfg.optim.remat = remat
    return cfg


def _sim0():
    return [torch.from_numpy(np.linspace(-0.5, 0.5, c).astype(np.float32))
            for c in CHNS]


def _inputs():
    """Every global input of the cases: (name, function, arguments)."""
    rs = np.random.RandomState(0)
    cfg = _cfg()
    torch.manual_seed(0)
    init = net_factory("dualdecoder", 1, C, cfg.model, device="cpu").state_dict()
    sim = _sim0()
    batches = []
    for i in range(STEPS):
        images, labels = phantom_batch(np.random.RandomState(10 + i), B, HW, C)
        batches.append({"image": torch.from_numpy(images),
                        "label": torch.from_numpy(labels)})
    chap_draws = [draw_step_uniforms(cfg, (B, 1, HW, HW),
                                     torch.Generator().manual_seed(i))
                  for i in range(STEPS)]
    sup_draws = [draw_supervised_uniforms(cfg, (B, 1, HW, HW),
                                          torch.Generator().manual_seed(i))
                 for i in range(STEPS)]
    x = torch.from_numpy(rs.randn(8, 5).astype(np.float32))
    w = torch.from_numpy(rs.randn(8, 5).astype(np.float32))
    bn_x = torch.from_numpy((rs.randn(8, 6, 5, 5) * 2 + 1).astype(np.float32))
    bn_w = torch.from_numpy(rs.randn(8, 6, 5, 5).astype(np.float32))
    bn_p = [torch.from_numpy(rs.uniform(0.5, 1.5, 6).astype(np.float32)),
            torch.from_numpy(rs.randn(6).astype(np.float32))]
    logits = torch.from_numpy(rs.randn(8, C, 16, 16).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, C, (2, 8, 16, 16)))
    mask = torch.from_numpy((rs.rand(8, 16, 16) > 0.4).astype(np.float32))
    coef = torch.from_numpy(rs.uniform(0.5, 2, 4).astype(np.float32))
    volumes = SyntheticVolumeDataset((24, 40, 40), C, length=3, seed=5)
    # eval weights: the init with the BN running stats of one phantom batch,
    # so its label maps are not one class
    model = net_factory("dualdecoder", 1, C, cfg.model, device="cpu")
    model.load_state_dict(init)
    stats = {}
    with torch.no_grad():
        model.train()(batches[0]["image"], stats=stats)
    for key, (mean, var) in bn_running_stats(model).items():
        mean.copy_(stats[key][0])
        var.copy_(stats[key][1])
    evaluated = {k: v.clone() for k, v in model.state_dict().items()}
    return [
        ("reductions", "reductions", (x, w)),
        ("bn_float32", "batch_norm", (bn_x, bn_w, *bn_p, torch.float32)),
        ("bn_bfloat16", "batch_norm", (bn_x, bn_w, *bn_p, torch.bfloat16)),
        ("k1", "k1_plain", (logits, labels[0], mask, labels[1], coef)),
        ("chap", "run_steps", (cfg, init, sim, batches, chap_draws)),
        ("chap_remat", "run_steps", (_cfg(remat=True), init, sim,
                                     batches[:2], chap_draws[:2])),
        ("supervised", "run_steps", (cfg, init, sim, batches, sup_draws,
                                     "supervised")),
        ("eval", "evaluation", (cfg, evaluated, volumes, (32, 32))),
    ]


def _cli(root):
    """cli.train_2d: 2 CHAP steps with an eval every 2, resumed to 4."""
    argv = ["--device", "cpu", "--dataset", "synthetic", "--exp", "dist",
            "--adv_noise", "--dropout", "--labeled_num", "3", "--batch_size",
            str(B), "--labeled_bs", str(LB), f"data.image_size=[{HW},{HW}]",
            "data.synthetic_train_size=96", "data.synthetic_val_volumes=2",
            "model.feature_chns=[4,8,16,16,32]", "eval.eval_every=2",
            f"run.snapshot_root={root}", "run.log_every=1"]
    return ("cli", "train_and_resume", (argv, 2, 4))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(one-process results, [rank 0's, rank 1's]) of every case."""
    tmp = tmp_path_factory.mktemp("runs")
    specs = _inputs()
    # the ranks run while this process computes the one-process results
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(dist.spawn_ranks, cases.run_cases, W, (
        specs + [_cli(tmp / "two"), ("refusals", "refusals", (str(tmp),))],),
        timeout=300)
    pool.shutdown(wait=False)
    one = cases.run_cases(copy.deepcopy(specs) + [_cli(tmp / "one")])
    return one, ranks.result()


def _close(got, want, rtol=0.0, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _rows(x, r, roles=1):
    return dist.shard_rows(x, roles, r, W)


def gathered_rows(parts, roles=1):
    """The global batch from every rank's rows (``parts`` in rank order),
    the inverse of ``dist.shard_rows``: each role's rows, rank after rank."""
    chunks = [p.chunk(roles) for p in parts]
    return torch.cat([chunks[r][role] for role in range(roles)
                      for r in range(len(parts))])


def test_reductions_forward_and_gradient(results):
    one, ranks = results
    want_sum, want_sum_grad = one["reductions"]["sum_replicated"]
    want_mean, want_centred_grad = one["reductions"]["centred_partial"]
    for r, got in enumerate(ranks):
        got = got["reductions"]
        # the right rule: the one-process value and gradient rows
        _close(got["sum_replicated"][0], want_sum, RTOL)
        _close(got["sum_replicated"][1], _rows(want_sum_grad, r), RTOL)
        _close(got["centred_partial"][0], want_mean, RTOL)
        _close(got["centred_partial"][1], _rows(want_centred_grad, r), RTOL)
        # the wrong rule: a replicated consumer's gradient all-reduced again
        # is W times the gradient; a rank-local consumer's statistic without
        # the all-reduced cotangent misses the other rank's term
        _close(got["sum_partial"][1], W * _rows(want_sum_grad, r), RTOL)
        missing = got["centred_replicated"][1] - _rows(want_centred_grad, r)
        assert float(missing.abs().max()) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_statistics_over_every_rank(results, dtype):
    """FlaxBatchNorm at W = 2: output, input gradient, weight / bias
    gradients (summed over the ranks) and the reported statistics of the
    concatenated rows. In bf16 the output and the input gradient are held
    to one bf16 rounding of the one-process values."""
    one, ranks = results
    y, dx, dw, db, mean, var = one[f"bn_{dtype}"]
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    for r, got in enumerate(ranks):
        gy, gdx, _, _, gmean, gvar = got[f"bn_{dtype}"]
        for g, want in ((gy, _rows(y, r)), (gdx, _rows(dx, r))):
            g, want = g.float(), want.float()
            err = (g - want).abs()
            assert float((err - ulp * want.abs()).max()) <= RTOL * float(want.abs().max())
        _close(gmean, mean, RTOL, 1e-6)
        _close(gvar, var, RTOL, 1e-6)
    _close(sum(g[f"bn_{dtype}"][2] for g in ranks), dw, RTOL, 1e-4)
    _close(sum(g[f"bn_{dtype}"][3] for g in ranks), db, RTOL, 1e-4)


def test_k1_region_dice_ce_over_every_rank(results):
    """K1's plain path with its statistics all-reduced between the two
    halves: the four losses of the global batch on every rank, and each
    rank's rows of the logits gradient."""
    one, ranks = results
    losses, grad = one["k1"]
    for r, got in enumerate(ranks):
        _close(got["k1"][0], losses, RTOL, 1e-7)
        _close(got["k1"][1], _rows(grad, r), RTOL, 1e-8)


def _hold_steps(one, ranks, name):
    want = one[name]
    for got in ranks:
        got = got[name]
        for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in w:
                _close(g[k], w[k], RTOL, 1e-6, f"step {step + 1} {k}")
        for k, v in want["state"].items():
            _close(got["state"][k], v, 0.0, ATOL, k)
        for k, (m, v) in want["running"].items():
            _close(got["running"][k][0], m, 0.0, ATOL, k)
            _close(got["running"][k][1], v, 0.0, ATOL, k)
        for g, w in zip(got["sim"], want["sim"]):
            _close(g, w, 0.0, ATOL, "sim_scores")
    # every rank issued the same collectives in the same order
    assert ranks[0][name]["collectives"] == ranks[1][name]["collectives"]
    assert len(ranks[0][name]["collectives"]) > 0
    assert want["collectives"] == []


@pytest.mark.parametrize("name", ["chap", "chap_remat"])
def test_chap_steps_match_one_process(results, name):
    """Three CHAP steps (two with remat) at W = 2 (batch 8, labeled_bs 4,
    so sub_bs 2 and one row of each role a rank), remat off and on: metrics,
    every parameter, the BN running statistics and the GradSim scores."""
    one, ranks = results
    _hold_steps(one, ranks, name)
    # the GradSim scores moved away from their start
    assert any(float((s - w).abs().max()) > 1e-3
               for s, w in zip(one[name]["sim"], _sim0()))


def test_supervised_steps_match_one_process(results):
    one, ranks = results
    _hold_steps(one, ranks, "supervised")


def test_eval2d_is_the_same_at_every_world_size(results):
    """Two ranks deal the volumes' chunks of 16 slices between them and
    assemble the label maps with one all-reduce: the maps and the metrics
    (computed on rank 0, broadcast) are those of one process, exactly."""
    one, ranks = results
    metrics, maps = one["eval"]
    assert any(len(np.unique(m)) > 1 for m in maps)
    for got in ranks:
        np.testing.assert_array_equal(got["eval"][0], metrics)
        for g, w in zip(got["eval"][1], maps):
            np.testing.assert_array_equal(g, w)


def test_cli_trains_and_resumes_at_two_ranks(results):
    """cli.train_2d in the ranks' process group: rank 0 picks the run dir
    and writes every file (one record a step and an eval), both ranks
    return the same result, and the losses are the one-process run's."""
    one, ranks = results
    _, want, want_records = one["cli"]
    (first0, got0, records), (first1, got1, none) = ranks[0]["cli"], ranks[1]["cli"]
    assert first0 == first1 == got0["save_dir"] == got1["save_dir"]
    assert got0 == got1 and got0["steps"] == 4 and none is None
    run = got0["save_dir"]
    assert os.listdir(os.path.dirname(run)) == ["run_0"]
    with open(os.path.join(run, "log.txt")) as f:
        assert "resumed from step 2" in f.read()
    assert [r["step"] for r in records] == [r["step"] for r in want_records]
    for g, w in zip(records, want_records):
        for k in ("loss", "val_mean_dice"):
            if k in w:
                _close(g[k], w[k], RTOL, 1e-6, f"step {w['step']} {k}")
    assert got0["best_dice"] == pytest.approx(want["best_dice"], abs=1e-6)


def test_refusals_at_two_ranks(results):
    said = results[1][0]["refusals"]
    assert results[1][1]["refusals"] == said
    assert "W must divide s = 1" in said["chap_layout"]
    assert "W must divide s = 3" in said["supervised_layout"]
    assert "must equal the world size" in said["num_devices"]
    assert "must divide the world size 2" in said["dcn_axis_size"]
    assert "ROADMAP item 16b" in said["trainer_3d"]
    for name in ("trainer_share", "ablation"):
        assert "ROADMAP item 16c" in said[name]


def test_layout_refuses_what_it_cannot_share():
    """W must divide each role: acdc_chap.yml's sub_bs 6 takes W in
    {1, 2, 3, 6}; four ranks would split 6 pairs."""
    for world in (1, 2, 3, 6):
        rows = [i for r in range(world) for i in dist.rank_rows(24, 4, r, world)]
        assert sorted(rows) == list(range(24))
    for world in (4, 5, 12):
        with pytest.raises(ValueError, match="W must divide s = 6"):
            dist.rank_rows(24, 4, 0, world)


def test_rank_rows_reassemble_the_global_batch_and_draws():
    """The device batch function and the step draws at W = 2: each rank's
    rows, concatenated in role order, are the W = 1 batch and draws."""
    cfg = _cfg()
    images = torch.rand(40, HW, HW, generator=torch.Generator().manual_seed(0))
    pool = DevicePool(images, (images * 4).to(torch.uint8))
    whole = build_device_batch_fn(40, 12, B, LB)(
        pool, torch.Generator().manual_seed(7))
    for roles in (4, 1):
        parts = [build_device_batch_fn(40, 12, B, LB, roles=roles, rank=r,
                                       world=W)(pool, torch.Generator().manual_seed(7))
                 for r in range(W)]
        for k in ("image", "label"):
            assert all(p[k].shape[0] == B // W for p in parts)
            torch.testing.assert_close(
                gathered_rows([p[k] for p in parts], roles), whole[k],
                rtol=0, atol=0)
    draws = draw_step_uniforms(cfg, (B, 1, HW, HW), torch.Generator().manual_seed(3))
    parts = [shard_step_draws(draws, r, W) for r in range(W)]
    assert all(p["bcp_starts"] is draws["bcp_starts"] for p in parts)
    for name, us in draws["drop"].items():
        for i, u in enumerate(us):
            if u is not None:
                torch.testing.assert_close(gathered_rows(
                    [p["drop"][name][i] for p in parts], 2), u, rtol=0, atol=0)
    torch.testing.assert_close(gathered_rows(
        [p["vat_d"] for p in parts], 2), draws["vat_d"], rtol=0, atol=0)
    for lvl, us in enumerate(draws["perturb"]):
        for i, u in enumerate(us):
            torch.testing.assert_close(gathered_rows(
                [p["perturb"][lvl][i] for p in parts], 1), u, rtol=0, atol=0)


def test_rank_batch_sampler_loads_each_ranks_rows():
    """The host loader's sampler: every rank builds the same global sampler
    and keeps its rows of every batch, in role order."""
    def sampler():
        return TwoStreamBatchSampler(range(20), range(20, 60), B, B - LB, seed=3)
    whole = list(sampler())
    for roles in (4, 1):
        parts = [list(RankBatchSampler(sampler(), roles, r, W)) for r in range(W)]
        for i, batch in enumerate(whole):
            got = gathered_rows([torch.tensor(p[i]) for p in parts], roles)
            assert got.tolist() == batch
