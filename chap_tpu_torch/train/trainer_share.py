"""Shared-encoder (ACAL) training loop (port of
chap_tpu/train/trainer_share.py:45-152), the reference's
train_share_encoder_2D.train (:139-467).

Each iteration runs the joint CPS step; every ``semi.mb_feed_every``
iterations it feeds the hard-sample memory bank with the unlabeled images of
the host copy of the batch and the step's knowledge map (the map's copy off
the card is the iteration's one sync); after ``semi.acal_start_iter``, while
the bank holds anything, it assembles the replay batch on the card (the
batch's labeled half plus the bank's samples, and their patch masks) and
runs the decoder max-step and the encoder min-step (:366-372). Every
``eval.eval_every`` iterations both decoders are evaluated separately
(:394-458); a decoder's best slot is written when it improves, and the
latest slot every time.

Batches come from the host BatchLoader with a TwoStreamBatchSampler
re-seeded with ``run.seed + iter_num`` each epoch, as in chap_tpu (no card
pool). The steps draw their dropout from a ``torch.Generator`` on the card
seeded from ``run.seed``. Besides chap_tpu's metric keys, each log record
carries ``steps_per_sec`` and ``mb_feed_ms`` (the bank feeds' mean since the
last log, copy and host ranking included), and each eval record
``model{1,2}_eval_s`` and ``checkpoint_ms``. No resume: chap_tpu's ACAL
trainer has none. One device: ``parallel.num_devices`` 0 or 1. Float32
only: ``model.dtype=bfloat16`` is refused (ROADMAP item 21b; the only
config of this trainer, configs/acdc_share_acal.yml, is float32).
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Optional, Union

import numpy as np
import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.data.datasets import build_datasets, patients_to_slices
from chap_tpu_torch.data.pipeline import (BatchLoader, compact_batch,
                                          prefetch_to_device, to_device)
from chap_tpu_torch.data.sampler import TwoStreamBatchSampler
from chap_tpu_torch.data.transforms import RandomGenerator
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.eval.eval2d import evaluate_volumes, make_predictor
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.semi.memory_bank import ImageMemoryBank
from chap_tpu_torch.train.step_share import (build_acal_steps,
                                             build_share_joint_step,
                                             create_share_state)
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from chap_tpu_torch.utils.metrics_writer import MetricsWriter

logger = logging.getLogger(__name__)


def train(cfg: Config, snapshot_path: str, max_steps: Optional[int] = None,
          device: Optional[Union[str, torch.device]] = None) -> dict:
    """Returns {'best_dice_model1', 'best_dice_model2', 'steps'}. ``device``
    is the card unless ``device="cpu"``."""
    device = resolve_device(device)
    if cfg.parallel.num_devices not in (0, 1):
        raise NotImplementedError(
            f"parallel.num_devices={cfg.parallel.num_devices}: the port trains "
            f"on one device; data parallelism over cards (DDP) is ROADMAP "
            f"item 16")
    if cfg.model.dtype != "float32":
        raise ValueError(f"model.dtype={cfg.model.dtype}: the ACAL trainer "
                         f"computes in float32 only; bf16 for it is ROADMAP "
                         f"item 21b")
    if cfg.run.prng_impl != "threefry2x32":
        logger.warning("run.prng_impl=%r selects a JAX PRNG; ignored (the "
                       "port draws from torch.Generator)", cfg.run.prng_impl)
    num_classes = cfg.data.num_classes
    lbs = cfg.data.labeled_bs

    torch.manual_seed(cfg.run.seed)
    model = net_factory("acalnet", cfg.data.in_chns, num_classes, cfg.model,
                        device=device)
    state = create_share_state(model, cfg)
    joint_step = build_share_joint_step(model, state.optimizer_g,
                                        state.optimizer_f, cfg, device=device)
    decoder_max_step, encoder_min_step = build_acal_steps(
        model, state.optimizer_g, state.optimizer_f, cfg, device=device)

    transform = RandomGenerator(cfg.data.image_size, seed=cfg.run.seed)
    db_train, db_val = build_datasets(cfg.data, transform)
    total_slices = len(db_train)
    labeled_slice = patients_to_slices(cfg.data.dataset, cfg.data.labeled_num)

    mb = ImageMemoryBank(cfg.semi.mb_capacity, cfg.data.image_size,
                         cfg.semi.mb_patch_size, seed=cfg.run.seed)
    writer = MetricsWriter(snapshot_path)
    ckpt = CheckpointManager(snapshot_path)
    predictors = {name: make_predictor(model, name, device=device)
                  for name in ("model1", "model2")}

    max_iterations = max_steps or cfg.optim.max_iterations
    best = {"model1": 0.0, "model2": 0.0}
    step_gen = torch.Generator(device=device)
    step_gen.manual_seed(cfg.run.seed)
    iter_num = 0
    feed_ms = []
    t_start = time.time()
    try:
        while iter_num < max_iterations:
            sampler = TwoStreamBatchSampler(
                list(range(labeled_slice)),
                list(range(labeled_slice, total_slices)),
                cfg.data.batch_size, cfg.data.batch_size - lbs,
                seed=cfg.run.seed + iter_num)
            loader = BatchLoader(db_train, sampler, cfg.data.num_workers)
            # the host copies of the batches, in the order the prefetch
            # hands out their device copies
            host_batches = collections.deque()

            def keep_host(batch):
                batch = compact_batch(batch)
                host_batches.append(batch)
                return batch

            stream = prefetch_to_device(loader, device, size=2,
                                        transform=keep_host)
            try:
                for batch in stream:
                    host = host_batches.popleft()
                    state, metrics, knowledge = joint_step(state, batch,
                                                           step_gen)
                    iter_num += 1

                    # feed the hard-sample bank (train_share_encoder_2D.py:344)
                    if iter_num % cfg.semi.mb_feed_every == 0:
                        t0 = time.perf_counter()
                        mb.add(host["image"][lbs:], knowledge.cpu().numpy(), 8)
                        feed_ms.append((time.perf_counter() - t0) * 1e3)

                    if (cfg.semi.acal and iter_num > cfg.semi.acal_start_iter
                            and len(mb)):
                        replay = to_device(
                            mb.get_samples(cfg.data.batch_size - lbs), device)
                        image = torch.cat([batch["image"][:lbs],
                                           replay["image"]])
                        state, m_f = decoder_max_step(
                            state, image, batch["label"], replay["mask"],
                            step_gen)
                        state, m_g = encoder_min_step(state, image,
                                                      replay["mask"], step_gen)
                        metrics = {**metrics, **m_f, **m_g}

                    if iter_num % cfg.run.log_every == 0:
                        names = list(metrics)
                        values = torch.stack([metrics[k].float() for k in names])
                        scalars = dict(zip(names, values.tolist()))
                        scalars["steps_per_sec"] = (
                            iter_num / (time.time() - t_start))
                        if feed_ms:
                            scalars["mb_feed_ms"] = float(np.mean(feed_ms))
                            feed_ms.clear()
                        writer.write(iter_num, scalars)
                        logger.info("iteration %d : model1 %.4f model2 %.4f",
                                    iter_num, scalars["model1_loss"],
                                    scalars["model2_loss"])

                    if iter_num % cfg.eval.eval_every == 0:
                        record = {}
                        ckpt_s = 0.0
                        for name, predictor in predictors.items():
                            t0 = time.perf_counter()
                            ml = evaluate_volumes(db_val, predictor, num_classes,
                                                  cfg.data.image_size)
                            record[f"{name}_eval_s"] = time.perf_counter() - t0
                            perf = float(np.mean(ml, axis=0)[0])
                            record[f"{name}_val_mean_dice"] = perf
                            record[f"{name}_val_mean_hd95"] = float(
                                np.mean(ml, axis=0)[1])
                            if perf > best[name]:
                                best[name] = perf
                                t0 = time.perf_counter()
                                ckpt.save(f"best_{name}", state)
                                ckpt_s += time.perf_counter() - t0
                        t0 = time.perf_counter()
                        ckpt.save_latest(state)
                        record["checkpoint_ms"] = (
                            ckpt_s + time.perf_counter() - t0) * 1e3
                        writer.write(iter_num, record)
                        logger.info("iteration %d : model1 dice %.4f model2 "
                                    "dice %.4f", iter_num,
                                    record["model1_val_mean_dice"],
                                    record["model2_val_mean_dice"])
                    if iter_num >= max_iterations:
                        break
            finally:
                stream.close()
    finally:
        writer.close()
    return {"best_dice_model1": best["model1"],
            "best_dice_model2": best["model2"], "steps": iter_num}
