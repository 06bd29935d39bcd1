"""Data parallelism of the ACAL trainer and the ablation step
(chap_tpu_torch/parallel/dist.py ``Halves``: each half of the [labeled ;
unlabeled] batch dealt on its own) at W = 2, 3 and 4 gloo ranks on the CPU.

Held against the one-process port on the global batch, as
tests/test_torch_parallel.py holds the CHAP step:
  * the ACAL joint step, decoder max-step and encoder min-step (two
    iterations, the mse and softdice discrepancies, ce and mse consistency)
    and the ablation step (channel dropout and VAT on), each from the same
    weights with the global draws (encoder dropout on, so the draws' rows
    matter), at W = 2 and 4 with batch 8 = 4 + 4; at W = 3 with batch 6 =
    2 + 4, where rank 0 holds no labeled row, and at W = 4 with batch 4 =
    2 + 2, where ranks 0 and 2 hold no row at all;
  * the knowledge maps gathered in global row order on every rank;
  * cli.train_share_2d at W = 2 (data.num_workers=1, replay from iteration
    3, a bank feed every iteration) against W = 1: one run dir, the
    records, every replay draw's masks and images, and the bank itself,
    the same on every rank;
  * cli.train_2d --mode ablation at W = 2 against W = 1: disagreement.csv;
  * every W chap_tpu refuses, refused with its rule.
And at W = 2 against chap_tpu's steps on a 2-device CPU mesh (built as
tests/test_parallel.py builds it) from Flax weights carried by
``state_dict_from_flax`` with the same draws, at the bars of
tests/test_torch_share.py and tests/test_torch_ablation.py.

Bars against one process: float32 summation noise, as
tests/test_torch_parallel.py (metrics 1e-5 relative; parameters, BN running
statistics and the knowledge maps 1e-5 absolute at their scale of 0.1-10).
One spawn of the ranks at each W runs every case of that W while this
process computes the one-process results.
"""
import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chap_tpu.losses.vat as jax_vat
import chap_tpu.models.perturb as jax_perturb
import torch_dist_cases as cases
from chap_tpu.config import Config as JaxConfig
from chap_tpu.models import net_factory as jax_net_factory
from chap_tpu.parallel.mesh import batch_sharding, build_mesh, replicate
from chap_tpu.train.state import create_train_state as jax_create_train_state
from chap_tpu.train.state import make_optimizer as jax_make_optimizer
from chap_tpu.train.step_ablation import build_ablation_train_step as jax_ablation
from chap_tpu_torch.config import Config
from chap_tpu_torch.convert.from_jax import state_dict_from_flax
from chap_tpu_torch.data.datasets import phantom_batch
from chap_tpu_torch.data.device_data import DevicePool, build_device_batch_fn
from chap_tpu_torch.data.sampler import RankBatchSampler, TwoStreamBatchSampler
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.step_ablation import (draw_ablation_uniforms,
                                                shard_ablation_draws)
from chap_tpu_torch.train.step_supervised import draw_supervised_uniforms
from test_torch_ablation import _configure as ablation_configure
from test_torch_ablation import _inputs as ablation_inputs
from test_torch_models import JaxFeed, RandomFeed
from test_torch_parallel import gathered_rows, hold_steps
from test_torch_share import (ACAL_YML, ITER_ATOL, METRIC_RTOL, _batch,
                              _configure, _copy, _counts, _flax_sd,
                              _jax_batch, _jax_steps, _replay_mask)

torch.set_num_threads(1)

C, HW = 4, 32
CHNS = (4, 8, 16, 16, 32)
DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)
ITERATIONS = 2
RTOL, ATOL = 1e-5, 1e-5
SHARE_KEYS = ("loss", "model1_loss", "model2_loss", "dis_loss", "acal_f_loss",
              "dis_loss_g")
# (batch, labeled_bs) of the step cases at each W
LAYOUTS = {2: [(8, 4)], 3: [(6, 2)], 4: [(8, 4), (4, 2)]}


def _cfg(batch, lbs, name="acalnet", adv="mse", consistency="ce"):
    """A small config; ``adv`` is the ACAL discrepancy (mse | softdice) or
    the ablation step's VAT divergence (kl | dice)."""
    cfg = Config()
    cfg.model.name = name
    cfg.data.num_classes, cfg.data.batch_size, cfg.data.labeled_bs = C, batch, lbs
    cfg.data.image_size = (HW, HW)
    cfg.model.feature_chns = CHNS
    cfg.model.dropout = DROPOUT
    cfg.semi.adv_losstype, cfg.semi.consistency_type = adv, consistency
    cfg.semi.consistency = 0.5
    cfg.semi.dropout = cfg.semi.adv_noise = True
    cfg.optim.max_iterations = 10
    cfg.optim.remat = False
    return cfg


def _init(cfg, seed):
    torch.manual_seed(seed)
    return net_factory(cfg.model.name, 1, C, cfg.model, device="cpu").state_dict()


def _batches(batch, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(ITERATIONS):
        images, labels = phantom_batch(rs, batch, HW, C)
        out.append({"image": torch.from_numpy(images),
                    "label": torch.from_numpy(labels)})
    return out


def _masks(n, seed):
    """Replay patch masks [n, HW, HW]: a random 12 x 12 window a row."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(ITERATIONS):
        mask = np.zeros((n, HW, HW), np.float32)
        for i in range(n):
            y, x = rs.randint(0, HW - 12, 2)
            mask[i, y:y + 12, x:x + 12] = 1.0
        out.append(torch.from_numpy(mask))
    return out


def share_case(name, batch, lbs, adv="mse", consistency="ce", seed=0):
    cfg = _cfg(batch, lbs, adv=adv, consistency=consistency)
    gen = torch.Generator().manual_seed(seed)
    draws = [[draw_supervised_uniforms(cfg, (batch, 1, HW, HW), gen)
              for _ in range(3)] for _ in range(ITERATIONS)]
    return (name, "run_share", (cfg, _init(cfg, seed), _batches(batch, seed + 1),
                                _masks(batch - lbs, seed + 2), draws))


def ablation_case(name, batch, lbs, seed=0):
    cfg = _cfg(batch, lbs, name="dualdecoder", adv="kl")
    gen = torch.Generator().manual_seed(seed)
    sim = [torch.from_numpy(np.linspace(-0.5, 0.5, c).astype(np.float32))
           for c in CHNS]
    draws = [draw_ablation_uniforms(cfg, (batch, 1, HW, HW), gen)
             for _ in range(ITERATIONS)]
    return (name, "run_steps", (cfg, _init(cfg, seed), sim,
                                _batches(batch, seed + 1), draws, "ablation"))


def step_cases(world):
    out = []
    for batch, lbs in LAYOUTS[world]:
        tag = f"{batch}_{lbs}"
        out += [share_case(f"share_{tag}", batch, lbs, seed=1),
                ablation_case(f"ablation_{tag}", batch, lbs, seed=2)]
    if world == 2:
        out.append(share_case("share_softdice", 8, 4, adv="softdice",
                              consistency="mse", seed=3))
    return out


def _share_argv(root):
    return ["--device", "cpu", "--cfg", ACAL_YML, "--acal", "--dataset",
            "synthetic", "--batch_size", "8", "--labeled_bs", "4",
            "--max_iterations", "6", "--patch_size", "8", "--exp", "w",
            "semi.acal_start_iter=2", "semi.mb_feed_every=1",
            "data.num_workers=1", f"data.image_size=[{HW},{HW}]",
            "data.synthetic_train_size=80", "data.synthetic_val_volumes=2",
            "eval.eval_every=3", "run.log_every=1",
            "model.feature_chns=[4,8,16,16,32]", f"run.snapshot_root={root}"]


def _ablation_argv(root):
    return ["--device", "cpu", "--dataset", "synthetic", "--exp", "w",
            "--adv_noise", "--dropout", "--labeled_num", "3", "--batch_size",
            "8", "--labeled_bs", "4", "--max_iterations", "4",
            f"data.image_size=[{HW},{HW}]", "data.synthetic_train_size=96",
            "data.synthetic_val_volumes=2", "model.feature_chns=[4,8,16,16,32]",
            "eval.eval_every=2", "run.log_every=1", f"run.snapshot_root={root}"]


# (batch, labeled_bs, semi.acal) that the ranks hand to trainer_share.train
REFUSED = [(6, 3, True), (6, 3, False), (7, 3, False), (12, 4, True),
           (12, 6, True), (8, 4, True)]


def chap_tpu_rule(batch, lbs, acal, world):
    """chap_tpu's trainer_share.py:56-57 and :86-90."""
    ok = batch % world == 0
    if acal:
        ok = ok and lbs % world == 0 and (batch - lbs) % world == 0
    return ok


# ---------------------------------------------------------------------------
# chap_tpu's steps on a 2-device mesh
# ---------------------------------------------------------------------------

def chap_tpu_share_inputs():
    """(chap_tpu's model and initial state, the port's case running one
    iteration from the same weights on test_torch_share.py's inputs,
    encoder dropout 0)."""
    cfg = _configure(JaxConfig())
    model = jax_net_factory("acalnet", 1, C, cfg.model)
    from chap_tpu.train.step_share import create_share_state as jax_create_state
    state, _, _ = jax_create_state(model, jax.random.PRNGKey(0),
                                   jnp.zeros((8, HW, HW, 1)), cfg)
    init = _flax_sd(state)
    images, labels = _batch(1)
    port_cfg = _configure(Config())
    port_cfg.model.name = "acalnet"
    none = {"drop": [None] * 5}
    spec = ("chap_tpu_share", "run_share", (
        port_cfg, init, [{"image": torch.from_numpy(images),
                          "label": torch.from_numpy(labels)}],
        [torch.from_numpy(_replay_mask())], [[none, none, none]]))
    return (cfg, model, state), spec


def chap_tpu_share_mesh(built, world):
    """chap_tpu's joint, max and min steps on a ``world``-device mesh."""
    cfg, model, state = built
    joint, dec, enc = _jax_steps(model, cfg)
    mesh = build_mesh(num_devices=world)
    jb = _jax_batch(*_batch(1))
    image = jax.device_put(jb["image"], batch_sharding(mesh, 4))
    label = jax.device_put(jb["label"], batch_sharding(mesh, 3))
    mask = jax.device_put(jnp.asarray(_replay_mask()), batch_sharding(mesh, 3))
    s, m, k = joint(replicate(mesh, _copy(state)), {"image": image, "label": label},
                    jax.random.PRNGKey(1))
    s, f = dec(s, image, label, mask, jax.random.PRNGKey(2))
    s, g = enc(s, image, mask, jax.random.PRNGKey(3))
    return jax.device_get((s, {**m, **f, **g}, k))


def chap_tpu_ablation_inputs():
    """(chap_tpu's ablation step inputs, the port's case: one step with the
    channel dropout and VAT on, test_torch_ablation.py's draws)."""
    images, labels, perturb, vat_u = ablation_inputs()
    cfg = ablation_configure(JaxConfig(), True, True)
    model = jax_net_factory("dualdecoder", 1, C, cfg.model)
    opt = jax_make_optimizer(cfg.optim.base_lr, cfg.optim.max_iterations,
                             cfg.optim.momentum, cfg.optim.weight_decay,
                             cfg.optim.poly_power)
    state = jax_create_train_state(model, jax.random.PRNGKey(0),
                                   jnp.zeros((8, HW, HW, 1)), opt, sim_chns=CHNS)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    init = state_dict_from_flax(variables["params"], variables["batch_stats"])
    draws = {"drop": {k: [None] * 5 for k in ("main", "fp", "vat")},
             "perturb": [[torch.from_numpy(u) for u in lvl] for lvl in perturb],
             "vat_d": torch.from_numpy(vat_u)}
    spec = ("chap_tpu_ablation", "run_steps", (
        ablation_configure(Config(), True, True), init,
        [torch.zeros(c) for c in CHNS],
        [{"image": torch.from_numpy(images),
          "label": torch.from_numpy(labels.astype(np.uint8))}], [draws],
        "ablation"))
    return (cfg, model, opt, state), spec


def chap_tpu_ablation_mesh(built, world):
    cfg, model, opt, state = built
    images, labels, perturb, vat_u = ablation_inputs()
    mesh = build_mesh(num_devices=world)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_perturb, "jax", JaxFeed(RandomFeed(
            [u for lvl in perturb for u in lvl])))
        mp.setattr(jax_vat, "jax", JaxFeed(RandomFeed(
            [np.ascontiguousarray(vat_u.transpose(0, 2, 3, 1))])))
        step = jax_ablation(model, opt, cfg)
        batch = {
            "image": jax.device_put(jnp.asarray(images.transpose(0, 2, 3, 1)),
                                    batch_sharding(mesh, 4)),
            "label": jax.device_put(jnp.asarray(labels.astype(np.uint8)),
                                    batch_sharding(mesh, 3))}
        return jax.device_get(step(replicate(mesh, state), batch,
                                   jax.random.PRNGKey(1)))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def _replay_spec():
    """The decoder max-step at 8 = 4 + 4 drawing its own dropout, replayed
    rows 4."""
    cfg = _cfg(8, 4)
    return ("replay_rows", "replay_rows",
            (cfg, _init(cfg, 9), _batches(8, 10)[0], _masks(4, 11)[0]))


def _spawn(world, specs):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(dist.spawn_ranks, cases.run_cases, world, (specs,),
                        timeout=600)
    pool.shutdown(wait=False)
    return ranks


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{W: (one-process results, the ranks' results)} at W = 2, 3 and 4, and
    chap_tpu's mesh steps at W = 2."""
    tmp = tmp_path_factory.mktemp("runs")
    built_share, share_spec = chap_tpu_share_inputs()
    built_abl, abl_spec = chap_tpu_ablation_inputs()
    specs = {w: step_cases(w) for w in LAYOUTS}
    replay = _replay_spec()
    extra = {2: [share_spec, abl_spec, replay,
                 ("share_cli", "share_cli", (_share_argv(str(tmp / "two")),)),
                 ("ablation_cli", "ablation_cli",
                  (_ablation_argv(str(tmp / "two")),))]}
    for w in LAYOUTS:
        extra.setdefault(w, []).append(
            ("refused", "share_layout_refusals", (REFUSED,)))
    out = {}
    for w in LAYOUTS:       # one spawn at a time: the ranks share the cores
        ranks = _spawn(w, specs[w] + extra[w])
        one = cases.run_cases(copy.deepcopy(specs[w]) + (
            [replay,
             ("share_cli", "share_cli", (_share_argv(str(tmp / "one")),)),
             ("ablation_cli", "ablation_cli", (_ablation_argv(str(tmp / "one")),))]
            if w == 2 else []))
        out[w] = (one, ranks.result())
    out["chap_tpu"] = (chap_tpu_share_mesh(built_share, 2),
                       chap_tpu_ablation_mesh(built_abl, 2))
    return out


def _close(got, want, rtol=0.0, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def hold_share(one, ranks, name):
    """Every rank's ACAL iterations against one process's: metrics, every
    parameter, the BN running statistics, both schedule counts and the
    step, the gathered knowledge maps; the same collectives on every
    rank."""
    want = one[name]
    for got in ranks:
        got = got[name]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(g) == set(w) == set(SHARE_KEYS)
            for k in w:
                _close(g[k], w[k], RTOL, 1e-6, f"iteration {i + 1} {k}")
        for k, v in want["state"].items():
            _close(got["state"][k], v, 0.0, ATOL, k)
        for k, (m, v) in want["running"].items():
            _close(got["running"][k][0], m, 0.0, ATOL, k)
            _close(got["running"][k][1], v, 0.0, ATOL, k)
        assert got["counts"] == want["counts"] == (2 * ITERATIONS,
                                                   2 * ITERATIONS, ITERATIONS)
        for g, w in zip(got["knowledge"], want["knowledge"]):
            _close(g, w, 0.0, ATOL, "knowledge")
    # the gather is the same on every rank, exactly
    for got in ranks[1:]:
        for g, w in zip(got[name]["knowledge"], ranks[0][name]["knowledge"]):
            assert torch.equal(g, w)
    assert all(got[name]["collectives"] == ranks[0][name]["collectives"]
               for got in ranks)
    assert want["collectives"] == []


@pytest.mark.parametrize("world,name", [
    (2, "share_8_4"), (2, "share_softdice"), (4, "share_8_4"),
    (3, "share_6_2"), (4, "share_4_2")])
def test_acal_steps_match_one_process(results, world, name):
    """Two ACAL iterations (joint, max, min) at W ranks against one
    process; at W = 3 (6 = 2 + 4) rank 0 holds no labeled row, at W = 4
    (4 = 2 + 2) ranks 0 and 2 hold no row."""
    one, ranks = results[world]
    hold_share(one, ranks, name)
    batch, lbs = (int(x) for x in name.split("_")[1:]) if name[-1].isdigit() \
        else (8, 4)
    rows = [got[name]["rows"] for got in ranks]
    assert rows == [(len(range(r * lbs // world, (r + 1) * lbs // world)),
                     len(range(r * (batch - lbs) // world,
                               (r + 1) * (batch - lbs) // world)))
                    for r in range(world)]
    if name == "share_6_2":
        assert rows[0][0] == 0
    if name == "share_4_2":
        assert rows[0] == rows[2] == (0, 0)


@pytest.mark.parametrize("world,name", [
    (2, "ablation_8_4"), (4, "ablation_8_4"), (3, "ablation_6_2"),
    (4, "ablation_4_2")])
def test_ablation_steps_match_one_process(results, world, name):
    """Two ablation steps (channel dropout and VAT on, GradSim scores read)
    at W ranks against one process: metrics (the disagreement ratio a
    global mean), parameters and BN running statistics."""
    one, ranks = results[world]
    hold_steps(one, ranks, name)


def test_acal_iteration_at_two_ranks_matches_chap_tpu_on_a_two_device_mesh(results):
    """One joint + max + min iteration at W = 2 against chap_tpu's three
    programs on a 2-device mesh from the same Flax weights: metrics at rtol
    2e-3, every parameter and BN running statistic at 1e-4 (three updates,
    test_torch_share.py's bar after iterations), both counts, the knowledge
    map."""
    (want_state, want, want_k), _ = results["chap_tpu"]
    after = _flax_sd(want_state)
    for got in results[2][1]:
        got = got["chap_tpu_share"]
        for k in SHARE_KEYS:
            np.testing.assert_allclose(got["metrics"][0][k], float(want[k]),
                                       rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
        for key, value in after.items():
            if not key.endswith("num_batches_tracked"):
                _close(got["state"][key], value, 0.0, ITER_ATOL, key)
        assert got["counts"][:2] == (_counts(want_state.opt_state_g),
                                     _counts(want_state.opt_state_f)) == (2, 2)
        np.testing.assert_allclose(got["knowledge"][0].numpy(), np.asarray(want_k),
                                   rtol=METRIC_RTOL, atol=5e-4)


def test_ablation_step_at_two_ranks_matches_chap_tpu_on_a_two_device_mesh(results):
    """One ablation step (channel dropout and VAT on) at W = 2 against
    chap_tpu's on a 2-device mesh, test_torch_ablation.py's draws and
    bars."""
    _, want = results["chap_tpu"]
    after = state_dict_from_flax(want.state.params, want.state.batch_stats)
    for got in results[2][1]:
        got = got["chap_tpu_ablation"]
        for k, v in want.metrics.items():
            np.testing.assert_allclose(got["metrics"][0][k], float(v),
                                       rtol=2e-3, atol=1e-6, err_msg=k)
        for key, value in after.items():
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got["state"][key].numpy(),
                                           value.numpy(), rtol=2e-3, atol=1e-5,
                                           err_msg=key)


def test_share_cli_at_two_ranks_is_the_one_process_run(results):
    """cli.train_share_2d at W = 2 (data.num_workers=1: each rank loads
    W = 1's batches): rank 0 picks one run dir and writes it; the records
    (losses, replay metrics, both decoders' eval dice) are W = 1's within
    float32 noise; every replay draw's masks and images, and the bank's
    entries, are W = 1's, exactly, on both ranks."""
    one, ranks = results[2]
    want = one["share_cli"]
    got0, got1 = (r["share_cli"] for r in ranks)
    assert got0["result"] == got1["result"]
    assert got0["result"]["steps"] == want["result"]["steps"] == 6
    assert got0["runs"] == got1["runs"] == ["run_0"] and got1["records"] is None
    assert [r["step"] for r in got0["records"]] == [r["step"] for r in want["records"]]
    keys = SHARE_KEYS + ("model1_val_mean_dice", "model2_val_mean_dice")
    for g, w in zip(got0["records"], want["records"]):
        for k in keys:
            if k in w:
                _close(g[k], w[k], RTOL, 1e-6, f"step {w['step']} {k}")
    assert sum("dis_loss" in r for r in want["records"]) == 4
    assert len(want["replay"]) == 4
    for got in (got0, got1):
        assert len(got["replay"]) == len(want["replay"])
        for g, w in zip(got["replay"], want["replay"]):
            np.testing.assert_array_equal(g["mask"], w["mask"])
            np.testing.assert_array_equal(g["image"], w["image"])
        for k in ("images", "masks"):
            np.testing.assert_array_equal(got["bank"][k], want["bank"][k])
        _close(got["bank"]["scores"], want["bank"]["scores"], 1e-5, 1e-6,
               "bank scores")
    assert got0["bank"]["scores"] == got1["bank"]["scores"]


def test_ablation_cli_at_two_ranks_writes_the_global_ratio(results):
    """cli.train_2d --mode ablation at W = 2 (the device pool dealing each
    half on its own): one run dir; disagreement.csv, written by rank 0,
    holds W = 1's iterations and ratios (a global mean)."""
    one, ranks = results[2]
    want = one["ablation_cli"]
    got0, got1 = (r["ablation_cli"] for r in ranks)
    assert got0["result"] == got1["result"] and got1["csv"] is None
    assert got0["runs"] == ["run_0"]
    assert got0["csv"][0] == want["csv"][0] == ["iteration", "ratio"]
    assert [r[0] for r in got0["csv"]] == [r[0] for r in want["csv"]]
    assert [int(r[0]) for r in want["csv"][1:]] == [1, 2, 3, 4]
    _close([float(r[1]) for r in got0["csv"][1:]],
           [float(r[1]) for r in want["csv"][1:]], RTOL, 1e-6, "ratio")
    for g, w in zip(got0["records"], want["records"]):
        if "loss" in w:
            _close(g["loss"], w["loss"], RTOL, 1e-6, f"step {w['step']} loss")


def test_replay_steps_take_the_global_row_count_at_two_ranks(results):
    """With W > 1 ranks a replay step that draws its own dropout is told the
    global batch's rows by its caller (no collective for them): without
    them it refuses, with them it draws W = 1's dropout and gives W = 1's
    metrics."""
    one, ranks = results[2]
    assert one["replay_rows"]["refused"] is None
    for r in ranks:
        assert "pass its rows" in r["replay_rows"]["refused"]
        got, want = r["replay_rows"]["metrics"], one["replay_rows"]["metrics"]
        assert sorted(got) == sorted(want)
        for k in want:
            _close(np.array(got[k]), np.array(want[k]), rtol=RTOL, what=k)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_trainer_share_refuses_what_chap_tpu_refuses(results, world):
    """At W ranks trainer_share.train refuses each layout chap_tpu's mesh
    refuses (W | batch_size; with semi.acal also W | labeled_bs and W |
    the unlabeled rows) with that rule, and passes the others."""
    said = results[world][1][0]["refused"]
    assert all(r["refused"] == said for r in results[world][1])
    for (batch, lbs, acal), msg in zip(REFUSED, said):
        if chap_tpu_rule(batch, lbs, acal, world):
            assert msg is None, (batch, lbs, acal)
        elif batch % world:
            assert "W must divide data.batch_size" in msg, (batch, lbs, acal)
        else:
            assert "W must divide data.labeled_bs" in msg, (batch, lbs, acal)


def test_halves_rule_is_chap_tpus():
    """dist.check_halves against chap_tpu's assertions for every W up to the
    batch at acdc_share_acal.yml's 24 = 12 + 12, at 24 = 8 + 16 and at the
    CLI's 6 = 2 + 4, with and without the replay."""
    for batch, lbs in ((24, 12), (24, 8), (6, 2)):
        for acal in (True, False):
            allowed = [w for w in range(1, batch + 1)
                       if chap_tpu_rule(batch, lbs, acal, w)]
            for world in range(1, batch + 1):
                if world in allowed:
                    dist.check_halves(batch, lbs, world, "t", replay=acal)
                    continue
                with pytest.raises(ValueError, match="chap_tpu's rule") as e:
                    dist.check_halves(batch, lbs, world, "t", replay=acal)
                if acal and not batch % world:
                    assert f"here W in {allowed}" in str(e.value)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_halves_rebuild_the_global_batch_and_draws(world):
    """Each rank's ``Halves`` rows (each half dealt on its own) rebuild the
    global batch 24 = 8 + 16 from the device pool and the host sampler, and
    the ablation step's draws of every pass."""
    batch, lbs = 24, 8
    layout = dist.Halves(lbs)
    images = torch.rand(60, HW, HW, generator=torch.Generator().manual_seed(0))
    pool = DevicePool(images, (images * 4).to(torch.uint8))
    whole = build_device_batch_fn(60, 20, batch, lbs)(
        pool, torch.Generator().manual_seed(7))
    parts = [build_device_batch_fn(60, 20, batch, lbs, roles=layout, rank=r,
                                   world=world)(pool, torch.Generator().manual_seed(7))
             for r in range(world)]
    for r, p in enumerate(parts):
        assert p["image"].shape[0] == (len(range(r * lbs // world, (r + 1) * lbs // world))
                                       + len(range(r * 16 // world, (r + 1) * 16 // world)))
    for k in ("image", "label"):
        torch.testing.assert_close(gathered_rows([p[k] for p in parts], layout),
                                   whole[k], rtol=0, atol=0)

    def sampler():
        return TwoStreamBatchSampler(range(20), range(20, 60), batch,
                                     batch - lbs, seed=3)
    sparts = [list(RankBatchSampler(sampler(), layout, r, world))
              for r in range(world)]
    for i, b in enumerate(sampler()):
        got = gathered_rows([torch.tensor(p[i]) for p in sparts], layout)
        assert got.tolist() == b
    cfg = _cfg(batch, lbs, name="dualdecoder", adv="kl")
    draws = draw_ablation_uniforms(cfg, (batch, 1, HW, HW),
                                   torch.Generator().manual_seed(3))
    dparts = [shard_ablation_draws(draws, cfg, r, world) for r in range(world)]
    for name, us in draws["drop"].items():
        roles = layout if name == "main" else dist.ONE_ROLE
        for i, u in enumerate(us):
            torch.testing.assert_close(gathered_rows(
                [p["drop"][name][i] for p in dparts], roles), u, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p["vat_d"] for p in dparts]),
                               draws["vat_d"], rtol=0, atol=0)
    # the perturbed rows: the global second half of the unlabeled rows
    for lvl, us in enumerate(draws["perturb"]):
        for i, u in enumerate(us):
            torch.testing.assert_close(torch.cat([p["perturb"][lvl][i]
                                                  for p in dparts]),
                                       u, rtol=0, atol=0)
