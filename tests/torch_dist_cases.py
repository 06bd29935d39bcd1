"""What each rank runs in tests/test_torch_parallel.py,
tests/test_torch_parallel_jax.py and tests/test_torch_parallel_share.py:
the port at W ranks (gloo, CPU) on its rows of global inputs that the test
makes once and hands to every rank.
Imports torch and chap_tpu_torch only, so a spawned rank starts without JAX.

Every function here takes the global inputs and returns what a test
compares with the one-process port (or chap_tpu) on the same inputs.
"""
import copy

import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.eval.eval2d import evaluate_volumes, make_predictor, predict_volume
from chap_tpu_torch.eval.sliding_window import SlidingWindowEngine, test_all_case
from chap_tpu_torch.models.factory import net_factory, net_factory_3d
from chap_tpu_torch.models.layers import BatchNorm2d, set_compute_dtype
from chap_tpu_torch.ops.fused_losses import region_dice_ce
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
from chap_tpu_torch.train.state import TrainState, bn_running_stats, make_optimizer
from chap_tpu_torch.train.step_ablation import build_ablation_train_step
from chap_tpu_torch.train.step_chap import build_chap_train_step
from chap_tpu_torch.train.step_share import (build_acal_steps,
                                             build_share_joint_step,
                                             create_share_state)
from chap_tpu_torch.train.step_supervised import build_supervised_train_step
from chap_tpu_torch.train.trainer_3d import (build_cps3d_train_step,
                                             build_supervised3d_train_step)


def model_from(cfg, state_dict, name=None):
    """The 2D model ``cfg.model.name``, or the 3D ``name``, from
    ``state_dict`` (in float64 if it is)."""
    if name is None:
        model = net_factory(cfg.model.name, cfg.data.in_chns,
                            cfg.data.num_classes, cfg.model, device="cpu")
    else:
        model = net_factory_3d(name, cfg.data.in_chns, cfg.data.num_classes,
                               mode="train", cfg=cfg.model, device="cpu")
    if any(v.dtype == torch.float64 for v in state_dict.values()):
        model.double()      # a float64 run of the port's own ops
    model.load_state_dict(state_dict)
    return model


# mode: (3D model key or None for the 2D one, the step's factory, batch roles or
# a function of the config giving them)
STEPS = {
    "ablation": (None, lambda m, o, c: build_ablation_train_step(
        m, o, c, device="cpu"), lambda cfg: dist.Halves(cfg.data.labeled_bs)),
    "chap": (None, lambda m, o, c: build_chap_train_step(m, o, c, device="cpu"),
             dist.CHAP_ROLES),
    "supervised": (None, lambda m, o, c: build_supervised_train_step(
        m, o, c, device="cpu"), dist.ONE_ROLE),
    "chap3d": ("dualdecoder", lambda m, o, c: build_chap_train_step(
        m, o, c, level_paths=VNET_LEVEL_PATHS, device="cpu"), dist.CHAP_ROLES),
    "cps3d": ("dualdecoder", lambda m, o, c: build_cps3d_train_step(
        m, o, c, device="cpu"), dist.ONE_ROLE),
    "supervised3d": ("name_3d", lambda m, o, c: build_supervised3d_train_step(
        m, o, c, device="cpu"), dist.ONE_ROLE),
}


def run_steps(cfg, state_dict, sim, batches, draws, mode="chap"):
    """``len(batches)`` steps of ``mode`` (``STEPS``) from ``state_dict``
    (and GradSim scores ``sim``) on this rank's rows of the global
    ``batches`` with the global ``draws``. Returns per-step metrics, the
    final state (parameters, BN running stats, scores), the sequence of
    all-reduces made and this rank's rows of each batch."""
    name, build, roles = STEPS[mode]
    roles = roles(cfg) if callable(roles) else roles
    model = model_from(cfg, state_dict,
                       cfg.model.name_3d if name == "name_3d" else name)
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = TrainState(0, model, opt, [s.clone() for s in sim])
    step = build(model, opt, cfg)
    metrics, local_rows = [], []
    with dist.record_collectives() as record:
        for batch, d in zip(batches, draws):
            rows = {k: dist.shard_rows(v, roles) for k, v in batch.items()}
            local_rows.append(rows["image"].shape[0])
            out = step(state, rows, draws=copy.deepcopy(d))
            metrics.append({k: float(v) for k, v in out.metrics.items()})
    return {"metrics": metrics,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "running": {k: (m.clone(), v.clone()) for k, (m, v)
                        in bn_running_stats(model).items()},
            "sim": [s.clone() for s in state.sim_scores],
            "collectives": list(record), "rows": local_rows}


def run_share(cfg, state_dict, batches, replay_masks, draws):
    """ACAL iterations from ``state_dict`` on this rank's ``Halves`` rows of
    the global ``batches``: each the joint step, then the decoder max-step
    and the encoder min-step on the batch itself with the global replay
    mask of that iteration (its unlabeled rows' part, ``ONE_ROLE``), each
    step with its global draws (``draws[i]``: joint, max, min). Returns
    per-iteration metrics, the final state and BN running statistics, both
    schedule counts, each iteration's knowledge map gathered in global row
    order (``gather_rows``), the collectives and this rank's labeled and
    unlabeled rows."""
    layout = dist.Halves(cfg.data.labeled_bs)
    model = model_from(cfg, state_dict)
    state = create_share_state(model, cfg)
    joint = build_share_joint_step(model, state.optimizer_g, state.optimizer_f,
                                   cfg, device="cpu")
    dec, enc = build_acal_steps(model, state.optimizer_g, state.optimizer_f,
                                cfg, device="cpu")
    n_u = cfg.data.batch_size - cfg.data.labeled_bs
    metrics, knowledge = [], []
    with dist.record_collectives() as record:
        for batch, mask, d in zip(batches, replay_masks, draws):
            rows = {k: dist.shard_rows(v, layout) for k, v in batch.items()}
            m_rows = dist.shard_rows(mask)
            state, m, k = joint(state, rows, draws=copy.deepcopy(d[0]))
            knowledge.append(dist.gather_rows(k, n_u))
            state, f = dec(state, rows["image"], rows["label"], m_rows,
                           draws=copy.deepcopy(d[1]))
            state, g = enc(state, rows["image"], m_rows,
                           draws=copy.deepcopy(d[2]))
            metrics.append({k_: float(v) for k_, v in {**m, **f, **g}.items()})
    labeled = len(dist.half_rows(cfg.data.batch_size, cfg.data.labeled_bs)[0])
    return {"metrics": metrics,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "running": {k: (m.clone(), v.clone()) for k, (m, v)
                        in bn_running_stats(model).items()},
            "counts": (state.count_g, state.count_f, state.step),
            "knowledge": knowledge, "collectives": list(record),
            "rows": (labeled, rows["image"].shape[0] - labeled)}


def share_cli(argv):
    """chap_tpu_torch.cli.train_share_2d in a process group the caller
    initialised (or in one process), its memory bank recorded: the result,
    rank 0's metrics.jsonl records (None elsewhere), the run dirs beside
    the run, every replay draw's masks and images and the bank's final
    entries."""
    import json
    import os

    import numpy as np

    from chap_tpu_torch.cli import train_share_2d
    from chap_tpu_torch.semi.memory_bank import ImageMemoryBank
    from chap_tpu_torch.train import trainer_share

    draws = []

    class RecordingBank(ImageMemoryBank):
        def get_samples(self, batch_size=12):
            out = super().get_samples(batch_size)
            draws.append({k: v.copy() for k, v in out.items()})
            return out

    banks = []
    real = trainer_share.ImageMemoryBank

    def make_bank(*args, **kw):
        banks.append(RecordingBank(*args, **kw))
        return banks[-1]
    trainer_share.ImageMemoryBank = make_bank
    try:
        out = train_share_2d.main(argv)
    finally:
        trainer_share.ImageMemoryBank = real
    records = None
    if dist.is_main():
        with open(os.path.join(out["save_dir"], "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    bank = banks[0]
    return {"result": out, "records": records,
            "runs": sorted(os.listdir(os.path.dirname(out["save_dir"]))),
            "replay": draws,
            "bank": {"images": np.stack(bank._images),
                     "masks": np.stack(bank._masks),
                     "scores": list(bank._scores)}}


def ablation_cli(argv):
    """chap_tpu_torch.cli.train_2d --mode ablation: the result and rank 0's
    disagreement.csv rows and metrics.jsonl records (None elsewhere)."""
    import json
    import os

    from chap_tpu_torch.cli import train_2d

    out = train_2d.main(argv + ["--mode", "ablation"])
    rows = records = None
    if dist.is_main():
        with open(os.path.join(out["save_dir"], "disagreement.csv")) as f:
            rows = [line.strip().split(",") for line in f]
        with open(os.path.join(out["save_dir"], "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    return {"result": out, "csv": rows, "records": records,
            "runs": sorted(os.listdir(os.path.dirname(out["save_dir"])))}


def replay_rows(cfg, state_dict, batch, mask):
    """The decoder max-step on this rank's rows of ``batch`` with its draws
    drawn here from a seeded generator, from fresh states: without the
    global row count (the message where it is refused, else None), then
    with it (its metrics)."""
    layout = dist.Halves(cfg.data.labeled_bs)
    rows = {k: dist.shard_rows(v, layout) for k, v in batch.items()}
    m_rows = dist.shard_rows(mask)

    def call(**kw):
        model = model_from(cfg, state_dict)
        state = create_share_state(model, cfg)
        dec, _ = build_acal_steps(model, state.optimizer_g, state.optimizer_f,
                                  cfg, device="cpu")
        return dec(state, rows["image"], rows["label"], m_rows,
                   torch.Generator().manual_seed(5), **kw)[1]

    try:
        call()
        said = None
    except ValueError as e:
        said = str(e)
    metrics = call(rows=batch["image"].shape[0])
    return {"refused": said, "metrics": {k: float(v) for k, v in metrics.items()}}


def share_layout_refusals(cases):
    """The message of each (batch, labeled_bs, acal) of ``cases`` that
    trainer_share.train refuses at this world size, None where it passes
    the rule (and fails later, at a model it cannot build)."""
    from chap_tpu_torch.train import trainer_share

    said = []
    for batch, lbs, acal in cases:
        cfg = Config()
        cfg.data.batch_size, cfg.data.labeled_bs = batch, lbs
        cfg.semi.acal = acal
        cfg.model.feature_chns = (1,)      # net_factory fails on it
        try:
            trainer_share.train(cfg, "unused", device="cpu")
        except ValueError as e:
            said.append(str(e) if "ranks cannot share" in str(e) else None)
        except Exception:
            said.append(None)
    return said


def reductions(x, w):
    """The two reductions' forward and gradient on this rank's rows of x
    [N, F] (w: a fixed cotangent of x's shape), each rule used where it is
    right and where it is wrong:

      replicated consumer: L = sum (sum_rows x)^2, the same on every rank;
      rank-local consumer: L_r = sum w (x - mean_rows x)^2 over this
      rank's rows, the global loss being sum_r L_r.
    """
    out = {}
    for name, reduce in (("replicated", dist.all_reduce_replicated),
                         ("partial", dist.all_reduce_partial)):
        xr = dist.shard_rows(x).clone().requires_grad_(True)
        s = reduce(xr.sum(0))
        (s ** 2).sum().backward()
        out[f"sum_{name}"] = (s.detach(), xr.grad)
        xr = dist.shard_rows(x).clone().requires_grad_(True)
        mean = reduce(xr.sum(0)) / x.shape[0]
        (dist.shard_rows(w) * (xr - mean) ** 2).sum().backward()
        out[f"centred_{name}"] = (mean.detach(), xr.grad)
    return out


def batch_norm(x, w, weight, bias, dtype):
    """FlaxBatchNorm in train mode on this rank's rows of x (cotangent w):
    (output, input gradient, weight and bias gradients of this rank's part,
    reported batch mean and variance)."""
    bn = set_compute_dtype(BatchNorm2d(x.shape[1]), dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.train()
    xr = dist.shard_rows(x).to(dtype).clone().requires_grad_(True)
    stats = {}
    y = bn(xr, stats)
    (y.float() * dist.shard_rows(w)).sum().backward()
    mean, var = stats[""]
    return y.detach(), xr.grad, bn.weight.grad, bn.bias.grad, mean, var


def k1_plain(logits, labels, mask, labels2, coef):
    """K1's region dice / CE (plain path) on this rank's rows: the four
    losses and d(sum coef * losses)/dlogits of this rank's rows."""
    x = dist.shard_rows(logits).clone().requires_grad_(True)
    losses = torch.stack(region_dice_ce(x, dist.shard_rows(labels),
                                        dist.shard_rows(mask),
                                        dist.shard_rows(labels2)))
    (losses * coef).sum().backward()
    return losses.detach(), x.grad


def evaluation(cfg, state_dict, dataset, patch):
    """evaluate_volumes and the first volume's label map."""
    predict = make_predictor(model_from(cfg, state_dict), device="cpu")
    maps = [predict_volume(predict, dataset[i]["image"], patch)
            for i in range(len(dataset))]
    return evaluate_volumes(dataset, predict, cfg.data.num_classes, patch), maps


def evaluation_3d(cfg, state_dict, cases, patch, sw_batch):
    """test_all_case of the 3D model ``cfg.model.name_3d`` over ``cases``
    (its per-case metrics) and each case's label map from the engine."""
    model = model_from(cfg, state_dict, cfg.model.name_3d)
    per_case = []
    metrics = test_all_case(model, cases, cfg.data.num_classes, patch,
                            cfg.eval.stride_xy, cfg.eval.stride_z,
                            sw_batch=sw_batch, per_case=per_case,
                            device="cpu")
    engine = SlidingWindowEngine(model, patch, sw_batch, device="cpu")
    maps = [engine.predict(case["image"], cfg.eval.stride_xy,
                           cfg.eval.stride_z, cfg.data.num_classes)
            for case in cases]
    return metrics, [m for _, m in per_case], maps


def train_and_resume(argv, steps, resumed_steps, cli="train_2d"):
    """chap_tpu_torch.cli.``cli`` for ``steps`` steps, then ``--resume`` to
    ``resumed_steps``, in a process group the caller initialised (or in one
    process): the run dir and its metrics.jsonl records."""
    import importlib
    import json
    import os

    cli_train = importlib.import_module(f"chap_tpu_torch.cli.{cli}")

    first = cli_train.main(argv + ["--max_iterations", str(steps)])
    second = cli_train.main(argv + ["--max_iterations", str(resumed_steps),
                                    "--resume"])
    records = None
    if dist.is_main():      # the one rank that writes it
        with open(os.path.join(second["save_dir"], "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    return first["save_dir"], second, records


def refusals(tmp):
    """The message of each refusal at this world size."""
    from chap_tpu_torch.train import trainer_2d, trainer_3d, trainer_share

    said = {}

    def expect(name, exc, fn):
        try:
            fn()
        except exc as e:
            said[name] = str(e)
        else:
            said[name] = None

    cfg = Config()
    cfg.data.batch_size, cfg.data.labeled_bs = 3, 2
    model = net_factory("dualdecoder", 1, 4, cfg.model, device="cpu")
    opt = make_optimizer(model, 0.01)
    expect("chap_layout", ValueError,
           lambda: build_chap_train_step(model, opt, cfg, device="cpu"))
    expect("supervised_layout", ValueError,
           lambda: build_supervised_train_step(model, opt, cfg, device="cpu"))
    expect("trainer_3d_layout", ValueError,
           lambda: trainer_3d.train(cfg, tmp, device="cpu"))
    expect("sw_batch", ValueError,
           lambda: SlidingWindowEngine(model, (16, 16, 16), sw_batch=3,
                                       device="cpu"))
    cfg = Config()
    cfg.parallel.num_devices = 3
    expect("num_devices", ValueError,
           lambda: dist.init_distributed(cfg, "cpu"))
    cfg = Config()
    cfg.parallel.dcn_axis_size = 3
    expect("dcn_axis_size", ValueError,
           lambda: dist.init_distributed(cfg, "cpu"))
    cfg = Config()
    cfg.data.batch_size, cfg.data.labeled_bs = 6, 3     # W = 2 divides 6, not 3
    cfg.semi.acal = True
    expect("trainer_share", ValueError,
           lambda: trainer_share.train(cfg, tmp, device="cpu"))
    cfg = Config()
    cfg.data.batch_size, cfg.data.labeled_bs = 3, 2
    expect("ablation", ValueError,
           lambda: trainer_2d.train(cfg, tmp, mode="ablation", device="cpu"))
    return said


def run_cases(cases):
    """Each (name, function name, arguments) of ``cases`` on this rank:
    {name: result}. One spawn of the ranks serves every test of a file."""
    torch.set_num_threads(1)
    return {name: globals()[fn](*args) for name, fn, args in cases}

