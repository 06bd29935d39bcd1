"""3D semi-supervised training (port of chap_tpu/train/trainer_3d.py): the
full CHAP method in 3D, the rank-generic CHAP step over two-stream patch
batches of the DualDecoder3d, evaluated with the sliding-window engine;
plus the cross-pseudo-supervision step (mode ``cps``) and the fully
supervised step (mode ``supervised``, the BraTS protocol) of any
``net_factory_3d`` model (``model.name_3d``) but vnet_ds and resvnet.

Orchestration, as in train/trainer_2d.py:
  - patches come from the card-resident volume pool with the on-card crop
    and rot / flip (data/device_data.py, ``data.device_input=true``, the
    default) or from the threaded host loader (``data.device_input=false``);
  - the step draws its randoms from a ``torch.Generator`` on the step's
    device seeded from ``run.seed``; the batch stream's seed folds in the
    step it starts from;
  - every ``eval.eval_every`` steps, when there is a val set, the val cases
    are evaluated (``test_all_case``), the latest checkpoint is written and
    the best one on improvement; else the latest every
    ``run.checkpoint_every`` steps; and at the end. The synthetic dataset
    has no val set, as in chap_tpu (trainer_3d.py:203-210).
  - metrics.jsonl gets the step's scalars every ``run.log_every`` steps
    (the host reads them then, one copy), ``checkpoint_ms`` at every save,
    and ``eval_s`` with ``steps_per_sec_since_eval`` at every eval.

chap_tpu forces ``optim.fused_passes`` off for the 3D CHAP step without a
word (trainer_3d.py:189-192); here the CHAP step logs that option, and
``split``, once when it is built, as in 2D.

``model.dtype=bfloat16`` (every 3D config the repository ships) computes the
model in bf16 over float32 parameters (models/layers.py), with the patches
in bf16 as chap_tpu's (volume pool and host loader, trainer_3d.py:228-250);
the eval runs the engine at its default float32 input, so a bf16 model
gives bf16 logits to K3, as chap_tpu's eval does. Checkpoints hold the
float32 parameters.

Data parallel over W ranks (parallel/dist.py, in place of chap_tpu's mesh,
trainer_3d.py:152-156), as train/trainer_2d.py: under torchrun or in a
process group the caller initialised, W dividing ``data.batch_size``; every
rank builds the model from the same seed (rank 0's state broadcast, and it
must not change), cuts its rows of every global patch draw (``rank_rows``:
its pair-stream units for ``chap``, a contiguous 1/W for ``cps`` and
``supervised``) and seeds its step generator alike, so W ranks train the
one-process run; at LA's batch 4 and W = 4 two ranks hold no row and still
make every collective. The cps and supervised steps sum K1's statistics,
the cps mean and the gradients over the ranks; BatchNorm models normalise
over every rank's rows (instance and group norms are per sample). The
sliding-window eval deals its patch batches to the ranks
(eval/sliding_window.py). Rank 0 alone writes metrics.jsonl, val.csv and
the checkpoints; the best-checkpoint decision is rank 0's, broadcast.
"""
from __future__ import annotations

import functools
import logging
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.data.datasets import SyntheticVolumeDataset, Volume3dDataset
from chap_tpu_torch.data.device_data import (build_device_patch_fn,
                                             build_device_volume_pool)
from chap_tpu_torch.data.pipeline import BatchLoader, compact_batch, prefetch_to_device
from chap_tpu_torch.data.sampler import RankBatchSampler, TwoStreamBatchSampler
from chap_tpu_torch.data.transforms3d import RandomGenerator3D
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.eval.sliding_window import test_all_case
from chap_tpu_torch.losses.ce import cross_entropy_per_pixel
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.models.factory import net_factory_3d
from chap_tpu_torch.models.layers import compute_dtype, softmax
from chap_tpu_torch.models.resvnet import ResVNet
from chap_tpu_torch.models.vnet3d import VNetDS
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
from chap_tpu_torch.train.state import (TrainState, create_train_state,
                                        fold_batch_stats, make_lr_schedule,
                                        make_optimizer)
from chap_tpu_torch.train.step_chap import (StepOutput, build_chap_train_step,
                                            level_channels)
from chap_tpu_torch.train.step_supervised import (check_rank_rows,
                                                  draw_model_uniforms,
                                                  draw_supervised_uniforms)
from chap_tpu_torch.train.trainer_2d import (_NoWriter, _same_on_every_rank,
                                             _synchronize, batch_stream_seed)
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from chap_tpu_torch.utils.metrics_writer import MetricsWriter
from chap_tpu_torch.utils.ramps import sigmoid_rampup

logger = logging.getLogger(__name__)


class _PatchDataset:
    """A volume dataset as an endless patch dataset (the host loader path)."""

    def __init__(self, volumes, transform, length: int):
        self.volumes = volumes
        self.transform = transform
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return self.transform(self.volumes[idx % len(self.volumes)])


def _check_device(model: torch.nn.Module, device: torch.device) -> None:
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, the "
                         f"step on {device}")


def _sgd(state: TrainState, loss: torch.Tensor, lr_schedule, stats) -> None:
    """One SGD update from ``loss`` at the schedule's LR (the gradients
    summed over the ranks), then the pass's batch statistics into the BN
    running stats."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    dist.all_reduce_grads(state.model.parameters())
    for group in state.optimizer.param_groups:
        group["lr"] = lr_schedule(state.step)
    state.optimizer.step()
    fold_batch_stats(state.model, [stats])
    state.step += 1


def build_cps3d_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer, cfg: Config,
                           device: Optional[Union[str, torch.device]] = None):
    """Cross-pseudo-supervision step for the dual-decoder 3D model (chap_tpu
    trainer_3d.py:54-99): supervised dice+CE of each decoder on the labeled
    rows (K1, R = 1), plus each decoder's CE against the other's argmax on
    the unlabeled rows, weighted by the consistency ramp. Returns
    ``step(state, batch, generator=None, draws=None) -> StepOutput``;
    metrics loss, sup_loss, cons_loss. With W > 1 ranks the batch is this
    rank's contiguous 1/W of the global one (``rank_rows``), its labeled
    rows those below ``labeled_bs``, possibly none; the draws are the
    global batch's, and K1's statistics, the cps mean and the gradients
    are summed over the ranks."""
    device = resolve_device(device)
    _check_device(model, device)
    num_classes, lbs, semi = cfg.data.num_classes, cfg.data.labeled_bs, cfg.semi
    lr_schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                   cfg.optim.poly_power)
    world = dist.world_size()
    local_lbs = lbs
    if world > 1:
        dist.check_batch(cfg.data.batch_size, world, "cps step")
        local_lbs = sum(i < lbs for i in dist.rank_rows(cfg.data.batch_size))

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, object]] = None) -> StepOutput:
        image = batch["image"]
        label = batch["label"].to(torch.int32)
        rows = image.shape[0] if world == 1 else cfg.data.batch_size
        if rows <= lbs:
            raise ValueError(
                f"batch size {rows} must exceed labeled_bs={lbs}: "
                f"the tail of each batch is the unlabeled stream, and a mean "
                f"over an empty unlabeled slice is silently NaN")
        check_rank_rows(image, cfg, world)
        if draws is None:
            draws = draw_supervised_uniforms(cfg, (rows,) + tuple(image.shape[1:]),
                                             generator, image.device)
        model.train()
        stats: Dict = {}
        o1, o2 = model(image, drop_u=[dist.shard_rows(u) for u in draws["drop"]],
                       stats=stats)
        sup1 = dice_ce_supervised(o1[:local_lbs], label[:local_lbs], num_classes)
        sup2 = dice_ce_supervised(o2[:local_lbs], label[:local_lbs], num_classes)
        # argmax of the softmax in the logits' dtype, as chap_tpu's
        # (trainer_3d.py:77-82): in bf16 its rounding makes ties
        pseudo1 = softmax(o1[local_lbs:].detach(), 1).argmax(dim=1)
        pseudo2 = softmax(o2[local_lbs:].detach(), 1).argmax(dim=1)
        ps1 = dist.global_mean(cross_entropy_per_pixel(o1[local_lbs:], pseudo2))
        ps2 = dist.global_mean(cross_entropy_per_pixel(o2[local_lbs:], pseudo1))
        w = semi.consistency * sigmoid_rampup(state.step // 150,
                                              semi.consistency_rampup)
        total = sup1 + sup2 + w * (ps1 + ps2)
        _sgd(state, total, lr_schedule, stats)
        return StepOutput(state, {"loss": total.detach(),
                                  "sup_loss": (sup1 + sup2).detach(),
                                  "cons_loss": (ps1 + ps2).detach()})

    return step


# models whose outputs past the first are not segmentations; chap_tpu's
# supervised step feeds every output to the loss and fails on them
# (trainer_3d.py:119-124)
_NOT_SUPERVISABLE = {
    VNetDS: ("vnet_ds", "its second output is the list of four side logits "
             "at 1/16 .. 1/2 of the patch, and chap_tpu's step fails on it "
             "with a TypeError"),
    ResVNet: ("resvnet", "its second output is the decoder's first-stage "
              "features x6 (8 n_filters channels at 1/8 of the patch), and "
              "chap_tpu's step fails on it with a broadcast ValueError"),
}


def build_supervised3d_train_step(model: torch.nn.Module,
                                  optimizer: torch.optim.Optimizer,
                                  cfg: Config,
                                  device: Optional[Union[str, torch.device]] = None):
    """Fully supervised 3D step (chap_tpu trainer_3d.py:102-135): dice+CE
    over the whole batch (K1, R = 1, one launch an output); a model with
    several outputs (DualDecoder3d, unet_3D_dv_semi) averages their losses.
    Refuses vnet_ds and resvnet, whose extra outputs are no segmentations.
    With W > 1 ranks the batch is this rank's contiguous 1/W and the draws
    the global batch's, as in the cps step. Metrics loss, sup_loss."""
    for cls, (key, why) in _NOT_SUPERVISABLE.items():
        if isinstance(model, cls):
            raise ValueError(f"net_factory_3d key {key!r} cannot train in the "
                             f"supervised 3D step: {why}")
    device = resolve_device(device)
    _check_device(model, device)
    num_classes = cfg.data.num_classes
    lr_schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                   cfg.optim.poly_power)
    world = dist.world_size()
    if world > 1:
        dist.check_batch(cfg.data.batch_size, world, "supervised 3D step")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, object]] = None) -> StepOutput:
        image = batch["image"]
        label = batch["label"].to(torch.int32)
        check_rank_rows(image, cfg, world)
        if draws is None:
            rows = image.shape[0] if world == 1 else cfg.data.batch_size
            draws = draw_model_uniforms(model, (rows,) + tuple(image.shape[1:]),
                                        generator, image.device)
        model.train()
        stats: Dict = {}
        out = model(image, drop_u=[dist.shard_rows(u) for u in draws["drop"]],
                    stats=stats)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        loss = sum(dice_ce_supervised(o, label, num_classes)
                   for o in outs) / len(outs)
        _sgd(state, loss, lr_schedule, stats)
        return StepOutput(state, {"loss": loss.detach(),
                                  "sup_loss": loss.detach()})

    return step


def train(cfg: Config, snapshot_path: str, max_steps: Optional[int] = None,
          labeled_cases: int = 8, mode: str = "chap", resume: bool = False,
          device: Optional[Union[str, torch.device]] = None) -> dict:
    """mode: ``chap`` (the full method), ``cps`` or ``supervised`` (model
    ``cfg.model.name_3d``). Returns {'best_dice': float, 'steps': int}.
    ``device`` is the card unless ``device="cpu"``; with W > 1 ranks
    (module docstring) each rank trains on its own card
    (``cuda:LOCAL_RANK``)."""
    if mode not in ("chap", "cps", "supervised"):
        raise ValueError(f"unknown 3D trainer mode {mode!r} (chap | cps | "
                         f"supervised)")
    rank, world, device = dist.init_distributed(cfg, device)
    main_rank = rank == 0
    if cfg.run.prng_impl != "threefry2x32":
        logger.warning("run.prng_impl=%r selects a JAX PRNG; ignored (the "
                       "port draws from torch.Generator)", cfg.run.prng_impl)
    patch = tuple(int(p) for p in cfg.data.patch_size_3d)
    num_classes = cfg.data.num_classes
    dtype = compute_dtype(cfg.model.dtype)

    torch.manual_seed(cfg.run.seed)
    model_name = cfg.model.name_3d if mode == "supervised" else "dualdecoder"
    model = net_factory_3d(model_name, cfg.data.in_chns, num_classes,
                           mode="train", cfg=cfg.model, device=device)
    _same_on_every_rank(model, "built from run.seed")
    optimizer = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                               cfg.optim.weight_decay)
    sim_chns = level_channels(cfg, 3) if mode == "chap" else ()
    state = create_train_state(model, optimizer, sim_chns)

    ckpt = CheckpointManager(snapshot_path)
    best = 0.0
    if resume and ckpt.restore_latest(state) is not None:
        _same_on_every_rank(model, "restored from the latest checkpoint")
        # the historical best, so the first post-resume eval cannot clobber
        # the best slot (train_ours_2D.py:428-435 gating)
        best = float(ckpt.load_meta().get("best_metric", 0.0))
        logger.info("resumed from step %d (best %.4f)", state.step, best)

    if mode == "chap":
        step_fn = build_chap_train_step(model, optimizer, cfg, use_nms=True,
                                        level_paths=VNET_LEVEL_PATHS,
                                        split=cfg.optim.split_step,
                                        device=device)
    elif mode == "cps":
        step_fn = build_cps3d_train_step(model, optimizer, cfg, device=device)
    else:
        step_fn = build_supervised3d_train_step(model, optimizer, cfg,
                                                device=device)

    if cfg.data.dataset == "synthetic":
        synth = SyntheticVolumeDataset((patch[2] + 8, patch[0] + 16, patch[1] + 16),
                                       num_classes, length=12)
        volumes = []
        for i in range(len(synth)):        # [D, H, W] phantoms -> [X, Y, Z]
            v = synth[i]
            volumes.append({"image": v["image"].transpose(2, 1, 0),
                            "label": v["label"].transpose(2, 1, 0)})
        val_ds = None
    else:
        train_ds = Volume3dDataset(cfg.data.root_path, "train.list")
        volumes = [train_ds[i] for i in range(len(train_ds))]
        val_ds = Volume3dDataset(cfg.data.root_path, "test.list")

    writer = MetricsWriter(snapshot_path) if main_rank else _NoWriter()
    roles = dist.CHAP_ROLES if mode == "chap" else dist.ONE_ROLE
    max_iterations = max_steps or cfg.optim.max_iterations
    iter_num = start_iter = state.step

    if cfg.data.device_input:
        t0 = time.perf_counter()
        pool = build_device_volume_pool(volumes, patch, dtype, device)
        _synchronize(device)
        writer.write(start_iter, {"pool_build_s": time.perf_counter() - t0})
        patch_fn = build_device_patch_fn(
            len(volumes), min(labeled_cases, len(volumes)), cfg.data.batch_size,
            cfg.data.labeled_bs, patch, roles=roles, rank=rank, world=world)

        def batch_stream():
            gen = torch.Generator(device=device)
            gen.manual_seed(batch_stream_seed(cfg.run.seed, start_iter))
            while True:
                yield patch_fn(pool, gen)
    else:
        transform = RandomGenerator3D(patch, seed=cfg.run.seed)
        epoch_len = max(len(volumes) * 4, cfg.data.batch_size * 4)
        dataset = _PatchDataset(volumes, transform, epoch_len)
        labeled_idx = list(range(min(labeled_cases * 4, epoch_len // 2)))
        unlabeled_idx = list(range(len(labeled_idx), epoch_len))

        def batch_stream():
            epoch_start = start_iter
            while True:
                sampler = TwoStreamBatchSampler(
                    labeled_idx, unlabeled_idx, cfg.data.batch_size,
                    cfg.data.batch_size - cfg.data.labeled_bs,
                    seed=cfg.run.seed + epoch_start)
                if world > 1:
                    # every rank builds the same global sampler and loads
                    # only its rows
                    sampler = RankBatchSampler(sampler, roles, rank, world)
                loader = BatchLoader(dataset, sampler, cfg.data.num_workers)
                yield from prefetch_to_device(
                    loader, device, size=2,
                    transform=functools.partial(compact_batch,
                                                compute_dtype=dtype))
                epoch_start += len(sampler)

    def save_latest() -> float:
        t = time.perf_counter()
        if main_rank:
            ckpt.save_latest(state)
        return (time.perf_counter() - t) * 1e3

    step_gen = torch.Generator(device=device)
    step_gen.manual_seed(cfg.run.seed)
    stream = batch_stream()
    t_start = time.time()
    t_stretch, last_eval_iter = time.perf_counter(), iter_num
    try:
        for batch in stream:
            if iter_num >= max_iterations:
                break
            state, metrics = step_fn(state, batch, step_gen)
            iter_num += 1
            if main_rank and iter_num % cfg.run.log_every == 0:
                names = list(metrics)
                scalars = dict(zip(names, torch.stack(
                    [metrics[k].float() for k in names]).tolist()))
                scalars["steps_per_sec"] = (
                    (iter_num - start_iter) / (time.time() - t_start))
                writer.write(iter_num, scalars)
                logger.info("iter %d loss %.4f", iter_num, scalars["loss"])
            if val_ds is not None and iter_num % cfg.eval.eval_every == 0:
                _synchronize(device)
                t_eval = time.perf_counter()
                rate = (iter_num - last_eval_iter) / (t_eval - t_stretch)
                m = test_all_case(model, val_ds, num_classes, patch,
                                  cfg.eval.stride_xy, cfg.eval.stride_z,
                                  sw_batch=cfg.eval.sw_batch, nms=cfg.eval.nms,
                                  device=device)
                eval_s = time.perf_counter() - t_eval
                dice = float(m[:, 0].mean())
                writer.write(iter_num, {"val_mean_dice": dice, "eval_s": eval_s,
                                        "steps_per_sec_since_eval": rate,
                                        "checkpoint_ms": save_latest()})
                # rank 0's decision (it alone sees the best slot), broadcast
                improved = dist.broadcast_array(np.array(
                    [main_rank and (dice > best or not ckpt.has("best"))]),
                    device)[0]
                if improved:
                    best = dice
                    if main_rank:
                        ckpt.save_best(state)
                        ckpt.save_meta({"best_metric": best,
                                        "best_iteration": iter_num})
                    writer.append_csv(
                        f"{snapshot_path}/val.csv",
                        {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                         "iteration": iter_num, "val_acc": round(best, 4)})
                t_stretch, last_eval_iter = time.perf_counter(), iter_num
            elif iter_num % cfg.run.checkpoint_every == 0:
                writer.write(iter_num, {"checkpoint_ms": save_latest()})
        _synchronize(device)
        writer.write(iter_num, {"checkpoint_ms": save_latest(),
                                "wall_s": time.time() - t_start})
    finally:
        stream.close()
        writer.close()
    return {"best_dice": best, "steps": iter_num}
