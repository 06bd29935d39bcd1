"""2D training loop (port of chap_tpu/train/trainer_2d.py:36-208), the
reference's train_ours_2D.train (train_ours_2D.py:219-464).

Orchestration only; the maths lives in the step:
  - two-stream batches come from the card-resident slice pool
    (data/device_data.py, ``data.device_input=true``, the default) or from
    the threaded host BatchLoader with pinned, non-blocking copies
    (``data.device_input=false``);
  - the step draws its dropout, perturbation, BCP and VAT randoms from a
    ``torch.Generator`` on the card seeded from ``run.seed``. As in chap_tpu
    that generator is not checkpointed (a resumed run restarts it); the
    batch stream's seed folds in the step it starts from;
  - the step's metrics stay 0-d device tensors; the host reads them (one
    copy) only every ``run.log_every`` steps, and at eval steps;
  - every ``eval.eval_every`` steps the val volumes are evaluated slice-wise,
    the latest checkpoint is written, and the best one, meta.json and val.csv
    on improvement (never below the best restored on resume);
  - scalars go to metrics.jsonl (+ TensorBoard when tensorboardX is there).
    Besides chap_tpu's, each eval record carries ``steps_per_sec_since_eval``
    (device synchronised at both ends of the stretch), ``eval_s`` and
    ``checkpoint_ms``, and the device path writes ``pool_build_s`` once.

Modes: ``chap``, ``supervised`` and ``ablation`` (train/step_ablation.py;
at each log step its disagreement ratio is appended to
``<snapshot>/disagreement.csv``, as chap_tpu's trainer_2d.py:174-178 does).

Data parallel over W ranks (parallel/dist.py, in place of chap_tpu's mesh,
trainer_2d.py:46-49): ``chap`` and ``supervised`` under torchrun, or with a
process group the caller initialised. Every rank builds the model from the
same seed on its card, and rank 0's parameters and buffers are broadcast
(they must already be equal); each rank holds the whole slice pool and
takes its rows of every global batch draw (``rank_rows``: the four CHAP
roles, or a contiguous 1/W for ``supervised``), and its step generator is
seeded alike, so W ranks train the one-process run. Rank 0 alone writes
metrics.jsonl, val.csv, the log and the checkpoints; ``--resume`` restores
every rank from the same files; the best-checkpoint decision is rank 0's,
broadcast. ``steps_per_sec`` stays the global rate (a step is the global
batch). ``ablation`` runs on one rank (ROADMAP item 16c).

``model.dtype=bfloat16`` computes the model in bf16 over float32 parameters
(models/layers.py), with the batches in bf16 as chap_tpu's (pool and host
loader, trainer_2d.py:97-121); the ablation mode refuses it (ROADMAP item
21b).
"""
from __future__ import annotations

import functools
import logging
import time
from typing import Optional, Union

import numpy as np
import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.data.datasets import build_datasets, patients_to_slices
from chap_tpu_torch.data.device_data import build_device_batch_fn, build_device_pool
from chap_tpu_torch.data.pipeline import BatchLoader, compact_batch, prefetch_to_device
from chap_tpu_torch.data.sampler import RankBatchSampler, TwoStreamBatchSampler
from chap_tpu_torch.data.transforms import RandomGenerator
from chap_tpu_torch.eval.eval2d import evaluate_volumes, make_predictor
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.layers import compute_dtype
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.step_ablation import build_ablation_train_step
from chap_tpu_torch.train.step_chap import build_chap_train_step
from chap_tpu_torch.train.step_supervised import build_supervised_train_step
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from chap_tpu_torch.utils.metrics_writer import MetricsWriter

logger = logging.getLogger(__name__)


def batch_stream_seed(seed: int, start_iter: int) -> int:
    """The device batch stream's seed: a function of (run.seed, the step the
    run starts from), as chap_tpu's fold_in(PRNGKey(seed), start_iter), so a
    resumed run does not replay the batches of the first segment."""
    return int(np.random.SeedSequence([seed, start_iter]).generate_state(1, np.uint64)[0])


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _NoWriter:
    """The writer of the ranks other than 0: they write no file."""

    def write(self, step, scalars) -> None:
        pass

    def append_csv(self, path, row) -> None:
        pass

    def close(self) -> None:
        pass


def _same_on_every_rank(model: torch.nn.Module, what: str) -> None:
    """Broadcast rank 0's parameters and buffers; they must not change."""
    if dist.broadcast_state(model):
        raise RuntimeError(f"rank {dist.rank()}: the model {what} differs from "
                           f"rank 0's; every rank must build and restore the "
                           f"same state")


def train(cfg: Config, snapshot_path: str, mode: str = "chap",
          max_steps: Optional[int] = None, resume: bool = False,
          device: Optional[Union[str, torch.device]] = None) -> dict:
    """Returns {'best_dice': float, 'steps': int}. ``device`` is the card
    unless ``device="cpu"``; with W > 1 ranks (module docstring) each rank
    trains on its own card (``cuda:LOCAL_RANK``)."""
    if mode not in ("chap", "supervised", "ablation"):
        raise ValueError(f"unknown mode {mode!r} (chap | supervised | ablation)")
    rank, world, device = dist.init_distributed(cfg, device)
    if mode == "ablation":
        dist.refuse_data_parallel(cfg, "the ablation step", "16c")
    main_rank = rank == 0
    dtype = compute_dtype(cfg.model.dtype)
    if mode == "ablation" and dtype != torch.float32:
        raise ValueError(f"model.dtype={cfg.model.dtype}: the ablation step "
                         f"computes in float32 only; bf16 for it is ROADMAP "
                         f"item 21b")
    if cfg.run.prng_impl != "threefry2x32":
        logger.warning("run.prng_impl=%r selects a JAX PRNG; ignored (the "
                       "port draws from torch.Generator)", cfg.run.prng_impl)
    num_classes = cfg.data.num_classes

    torch.manual_seed(cfg.run.seed)
    model = net_factory(cfg.model.name, cfg.data.in_chns, num_classes,
                        cfg.model, device=device)
    _same_on_every_rank(model, "built from run.seed")
    optimizer = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                               cfg.optim.weight_decay)
    state = create_train_state(model, optimizer, cfg.model.feature_chns)

    ckpt = CheckpointManager(snapshot_path)
    best_performance = 0.0
    if resume and ckpt.restore_latest(state) is not None:
        _same_on_every_rank(model, "restored from the latest checkpoint")
        # the historical best, so the first post-resume eval cannot clobber
        # the best slot (train_ours_2D.py:428-435 gating)
        best_performance = float(ckpt.load_meta().get("best_metric", 0.0))
        logger.info("resumed from step %d (best %.4f)", state.step,
                    best_performance)

    if mode == "chap":
        step_fn = build_chap_train_step(model, optimizer, cfg, use_nms=True,
                                        device=device)
    elif mode == "ablation":
        step_fn = build_ablation_train_step(model, optimizer, cfg,
                                            device=device)
    else:
        step_fn = build_supervised_train_step(model, optimizer, cfg,
                                              device=device)

    transform = RandomGenerator(cfg.data.image_size, seed=cfg.run.seed)
    db_train, db_val = build_datasets(cfg.data, transform)
    total_slices = len(db_train)
    labeled_slice = patients_to_slices(cfg.data.dataset, cfg.data.labeled_num)
    logger.info("Total slices %d, labeled slices %d", total_slices, labeled_slice)

    writer = MetricsWriter(snapshot_path) if main_rank else _NoWriter()
    roles = dist.CHAP_ROLES if mode == "chap" else 1
    predictor = make_predictor(model, cfg.eval.model_type, device=device)
    max_iterations = max_steps or cfg.optim.max_iterations
    iter_num = start_iter = state.step

    if cfg.data.device_input:
        t0 = time.perf_counter()
        pool = build_device_pool(db_train, cfg.data.image_size, dtype, device)
        _synchronize(device)
        writer.write(start_iter, {"pool_build_s": time.perf_counter() - t0})
        batch_fn = build_device_batch_fn(total_slices, labeled_slice,
                                         cfg.data.batch_size, cfg.data.labeled_bs,
                                         roles=roles, rank=rank, world=world)

        def batch_stream():
            gen = torch.Generator(device=device)
            gen.manual_seed(batch_stream_seed(cfg.run.seed, start_iter))
            while True:
                yield batch_fn(pool, gen)
    else:
        def batch_stream():
            epoch_start = start_iter
            while True:
                sampler = TwoStreamBatchSampler(
                    list(range(labeled_slice)),
                    list(range(labeled_slice, total_slices)),
                    cfg.data.batch_size,
                    cfg.data.batch_size - cfg.data.labeled_bs,
                    seed=cfg.run.seed + epoch_start)
                if world > 1:
                    # every rank builds the same global sampler and loads
                    # only its rows
                    sampler = RankBatchSampler(sampler, roles, rank, world)
                loader = BatchLoader(db_train, sampler, cfg.data.num_workers)
                yield from prefetch_to_device(
                    loader, device, size=2,
                    transform=functools.partial(compact_batch,
                                                compute_dtype=dtype))
                epoch_start += len(sampler)

    step_gen = torch.Generator(device=device)
    step_gen.manual_seed(cfg.run.seed)
    stream = batch_stream()
    t_start = time.time()
    t_stretch, last_eval_iter = time.perf_counter(), iter_num
    try:
        for batch in stream:
            state, metrics = step_fn(state, batch, step_gen)
            iter_num += 1

            if main_rank and iter_num % cfg.run.log_every == 0:
                # one device->host copy for every logged scalar; the GradSim
                # score statistics are computed on the device
                names = list(metrics)
                values = [metrics[k].float() for k in names]
                if state.sim_scores:
                    flat = torch.cat([s.reshape(-1) for s in state.sim_scores])
                    names += ["sim_score_mean", "sim_score_std",
                              "sim_score_absmax"]
                    values += [flat.mean(), flat.std(correction=0),
                               flat.abs().max()]
                scalars = dict(zip(names, torch.stack(values).tolist()))
                scalars["steps_per_sec"] = (
                    (iter_num - start_iter) / (time.time() - t_start))
                writer.write(iter_num, scalars)
                if "disagreement_ratio" in scalars:
                    # per-iteration CSV like train_ablation_2D.py:183-190
                    writer.append_csv(f"{snapshot_path}/disagreement.csv",
                                      {"iteration": iter_num,
                                       "ratio": scalars["disagreement_ratio"]})
                logger.info("iteration %d : loss : %.4f", iter_num,
                            scalars["loss"])

            if iter_num > 0 and iter_num % cfg.eval.eval_every == 0:
                _synchronize(device)
                t_eval = time.perf_counter()
                train_rate = (iter_num - last_eval_iter) / (t_eval - t_stretch)
                metric_list = evaluate_volumes(db_val, predictor, num_classes,
                                               cfg.data.image_size)
                eval_s = time.perf_counter() - t_eval
                performance = float(np.mean(metric_list, axis=0)[0])
                mean_hd95 = float(np.mean(metric_list, axis=0)[1])
                t_ckpt = time.perf_counter()
                if main_rank:
                    ckpt.save_latest(state)
                checkpoint_ms = (time.perf_counter() - t_ckpt) * 1e3
                writer.write(iter_num, {"val_mean_dice": performance,
                                        "val_mean_hd95": mean_hd95,
                                        "steps_per_sec_since_eval": train_rate,
                                        "eval_s": eval_s,
                                        "checkpoint_ms": checkpoint_ms})
                # rank 0's decision (it alone sees the best slot), broadcast
                improved = dist.broadcast_array(np.array(
                    [main_rank and (performance > best_performance
                                    or not ckpt.has("best"))]), device)[0]
                if improved:
                    best_performance = performance
                    if main_rank:
                        ckpt.save_best(state)
                        ckpt.save_meta({"best_metric": best_performance,
                                        "best_iteration": iter_num})
                    writer.append_csv(
                        f"{snapshot_path}/val.csv",
                        {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                         "iteration": iter_num,
                         "val_acc": round(best_performance, 4)})
                logger.info("iteration %d : mean_dice %.4f mean_hd95 %.4f",
                            iter_num, performance, mean_hd95)
                t_stretch, last_eval_iter = time.perf_counter(), iter_num

            if iter_num >= max_iterations:
                break
    finally:
        stream.close()
        writer.close()
    return {"best_dice": best_performance, "steps": iter_num}
