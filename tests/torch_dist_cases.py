"""What each rank runs in tests/test_torch_parallel.py and
tests/test_torch_parallel_jax.py: the port at W ranks (gloo, CPU) on its
rows of global inputs that the test makes once and hands to every rank.
Imports torch and chap_tpu_torch only, so a spawned rank starts without JAX.

Every function here takes the global inputs and returns what a test
compares with the one-process port (or chap_tpu) on the same inputs.
"""
import copy

import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.eval.eval2d import evaluate_volumes, make_predictor, predict_volume
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.layers import BatchNorm2d, set_compute_dtype
from chap_tpu_torch.ops.fused_losses import region_dice_ce
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.state import TrainState, bn_running_stats, make_optimizer
from chap_tpu_torch.train.step_chap import build_chap_train_step
from chap_tpu_torch.train.step_supervised import build_supervised_train_step


def model_from(cfg, state_dict):
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device="cpu")
    model.load_state_dict(state_dict)
    return model


def run_steps(cfg, state_dict, sim, batches, draws, mode="chap"):
    """``len(batches)`` steps of ``mode`` from ``state_dict`` (and GradSim
    scores ``sim``) on this rank's rows of the global ``batches`` with the
    global ``draws``. Returns per-step metrics, the final state (parameters,
    BN running stats, scores) and the sequence of all-reduces made."""
    model = model_from(cfg, state_dict)
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = TrainState(0, model, opt, [s.clone() for s in sim])
    if mode == "chap":
        step, roles = build_chap_train_step(model, opt, cfg, device="cpu"), 4
    else:
        step, roles = build_supervised_train_step(model, opt, cfg, device="cpu"), 1
    metrics = []
    with dist.record_collectives() as record:
        for batch, d in zip(batches, draws):
            rows = {k: dist.shard_rows(v, roles) for k, v in batch.items()}
            out = step(state, rows, draws=copy.deepcopy(d))
            metrics.append({k: float(v) for k, v in out.metrics.items()})
    return {"metrics": metrics,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "running": {k: (m.clone(), v.clone()) for k, (m, v)
                        in bn_running_stats(model).items()},
            "sim": [s.clone() for s in state.sim_scores],
            "collectives": list(record)}


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


def train_and_resume(argv, steps, resumed_steps):
    """cli.train_2d for ``steps`` steps, then ``--resume`` to
    ``resumed_steps``, in a process group the caller initialised (or in one
    process): the run dir and its metrics.jsonl records."""
    import json
    import os

    from chap_tpu_torch.cli import train_2d as cli_train

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
    cfg.data.batch_size, cfg.data.labeled_bs = 4, 2     # sub_bs 1
    model = net_factory("dualdecoder", 1, 4, cfg.model, device="cpu")
    opt = make_optimizer(model, 0.01)
    expect("chap_layout", ValueError,
           lambda: build_chap_train_step(model, opt, cfg, device="cpu"))
    cfg.data.batch_size = 3
    expect("supervised_layout", ValueError,
           lambda: build_supervised_train_step(model, opt, cfg, device="cpu"))
    cfg = Config()
    cfg.parallel.num_devices = 3
    expect("num_devices", ValueError,
           lambda: dist.init_distributed(cfg, "cpu"))
    cfg = Config()
    cfg.parallel.dcn_axis_size = 3
    expect("dcn_axis_size", ValueError,
           lambda: dist.init_distributed(cfg, "cpu"))
    cfg = Config()
    expect("trainer_3d", NotImplementedError,
           lambda: trainer_3d.train(cfg, tmp, device="cpu"))
    expect("trainer_share", NotImplementedError,
           lambda: trainer_share.train(cfg, tmp, device="cpu"))
    expect("ablation", NotImplementedError,
           lambda: trainer_2d.train(cfg, tmp, mode="ablation", device="cpu"))
    return said


def run_cases(cases):
    """Each (name, function name, arguments) of ``cases`` on this rank:
    {name: result}. One spawn of the ranks serves every test of a file."""
    torch.set_num_threads(1)
    return {name: globals()[fn](*args) for name, fn, args in cases}

