"""Shared-encoder (ACAL) training loop (port of
chap_tpu/train/trainer_share.py:45-152), the reference's
train_share_encoder_2D.train (:139-467).

Each iteration runs the joint CPS step; every ``semi.mb_feed_every``
iterations it feeds the hard-sample memory bank with the batch's unlabeled
images and the step's knowledge map (their copy off the card is the
iteration's one sync); after ``semi.acal_start_iter``, while the bank holds
anything, it draws the replay batch (the batch's labeled half plus the
bank's samples, and their patch masks) and runs the decoder max-step and
the encoder min-step (:366-372). Every ``eval.eval_every`` iterations both
decoders are evaluated separately (:394-458); a decoder's best slot is
written when it improves, and the latest slot every time.

Batches come from the host BatchLoader with a TwoStreamBatchSampler
re-seeded with ``run.seed + iter_num`` each epoch, as in chap_tpu (no card
pool), in the model's compute dtype (``compact_batch``). The steps draw
their dropout from a ``torch.Generator`` on the card seeded from
``run.seed``. Besides chap_tpu's metric keys, each log record carries
``steps_per_sec`` and ``mb_feed_ms`` (the bank feeds' mean since the last
log: gather, copy and host ranking), and each eval record
``model{1,2}_eval_s`` and ``checkpoint_ms``. No resume: chap_tpu's ACAL
trainer has none.

Data parallel over W ranks (parallel/dist.py, in place of chap_tpu's mesh,
trainer_share.py:54-57, 86-90, 118-124), under torchrun or in a process
group the caller initialised. W must divide ``data.batch_size``, and with
``semi.acal`` also labeled_bs and the unlabeled B - labeled_bs, chap_tpu's
rules (``dist.check_halves``). Every rank builds the model from the same
seed (rank 0's state broadcast; it must already be equal), loads the global
batch and keeps its rows of each half (``Halves``), as chap_tpu's ``shard``
device-puts the whole host batch, so at ``data.num_workers=1`` W ranks see
W = 1's batches exactly. The bank is the one process's bank on every rank:
each feed gathers the unlabeled images and knowledge maps the ranks trained
on in global row order (not the host copies, which the loader's shared
augmentation RandomState may make differ between ranks), every rank feeds
its own bank and makes the same replay draw, and takes its rows of it.
Evals run across the ranks (eval2d); the best-slot decisions are rank 0's,
broadcast, and rank 0 alone writes metrics.jsonl and the checkpoints.
``model.dtype=bfloat16`` computes in bf16 over float32 parameters; the bank
then ranks the bf16 knowledge maps in bf16 arithmetic, as chap_tpu's does,
and the replay images are cast to the batch's dtype.
"""
from __future__ import annotations

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
from chap_tpu_torch.eval.eval2d import evaluate_volumes, make_predictor
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.models.layers import compute_dtype
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi.memory_bank import ImageMemoryBank
from chap_tpu_torch.train.step_share import (build_acal_steps,
                                             build_share_joint_step,
                                             create_share_state)
from chap_tpu_torch.train.trainer_2d import _NoWriter, _same_on_every_rank
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from chap_tpu_torch.utils.metrics_writer import MetricsWriter

logger = logging.getLogger(__name__)


def train(cfg: Config, snapshot_path: str, max_steps: Optional[int] = None,
          device: Optional[Union[str, torch.device]] = None) -> dict:
    """Returns {'best_dice_model1', 'best_dice_model2', 'steps'}. ``device``
    is the card unless ``device="cpu"``; with W > 1 ranks (module
    docstring) each rank trains on its own card (``cuda:LOCAL_RANK``)."""
    rank, world, device = dist.init_distributed(cfg, device)
    main_rank = rank == 0
    num_classes = cfg.data.num_classes
    lbs = cfg.data.labeled_bs
    n_u = cfg.data.batch_size - lbs
    dist.check_halves(cfg.data.batch_size, lbs, world, "the ACAL trainer",
                      replay=cfg.semi.acal)
    layout = dist.Halves(lbs)
    # this rank's labeled rows of each batch
    n_l = len(dist.half_rows(cfg.data.batch_size, lbs)[0])
    dtype = compute_dtype(cfg.model.dtype)
    if cfg.run.prng_impl != "threefry2x32":
        logger.warning("run.prng_impl=%r selects a JAX PRNG; ignored (the "
                       "port draws from torch.Generator)", cfg.run.prng_impl)

    torch.manual_seed(cfg.run.seed)
    model = net_factory("acalnet", cfg.data.in_chns, num_classes, cfg.model,
                        device=device)
    _same_on_every_rank(model, "built from run.seed")
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
    writer = MetricsWriter(snapshot_path) if main_rank else _NoWriter()
    ckpt = CheckpointManager(snapshot_path)
    predictors = {name: make_predictor(model, name, device=device)
                  for name in ("model1", "model2")}

    def host_rows(batch):
        """The batch in the compute dtype, this rank's rows of it."""
        batch = compact_batch(batch, dtype)
        return {k: dist.shard_rows(torch.as_tensor(v), layout)
                for k, v in batch.items()}

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
                cfg.data.batch_size, n_u, seed=cfg.run.seed + iter_num)
            loader = BatchLoader(db_train, sampler, cfg.data.num_workers)
            stream = prefetch_to_device(loader, device, size=2,
                                        transform=host_rows)
            try:
                for batch in stream:
                    state, metrics, knowledge = joint_step(state, batch,
                                                           step_gen)
                    iter_num += 1

                    # feed the hard-sample bank (train_share_encoder_2D.py:
                    # 344) with the global unlabeled rows, alike on every rank
                    if iter_num % cfg.semi.mb_feed_every == 0:
                        t0 = time.perf_counter()
                        images = dist.gather_rows(batch["image"][n_l:], n_u)
                        maps = dist.gather_rows(knowledge, n_u)
                        mb.add(images.cpu(), maps.cpu(), 8)
                        feed_ms.append((time.perf_counter() - t0) * 1e3)

                    if (cfg.semi.acal and iter_num > cfg.semi.acal_start_iter
                            and len(mb)):
                        # one draw on every rank; each takes its rows
                        samples = mb.get_samples(n_u)
                        rows = lbs + len(samples["mask"])
                        replay = {k: dist.shard_rows(torch.from_numpy(v))
                                  for k, v in samples.items()}
                        replay = to_device(replay, device)
                        image = torch.cat([batch["image"][:n_l],
                                           replay["image"].to(batch["image"].dtype)])
                        state, m_f = decoder_max_step(
                            state, image, batch["label"], replay["mask"],
                            step_gen, rows=rows)
                        state, m_g = encoder_min_step(state, image,
                                                      replay["mask"], step_gen,
                                                      rows=rows)
                        metrics = {**metrics, **m_f, **m_g}

                    if iter_num % cfg.run.log_every == 0:
                        if main_rank:
                            names = list(metrics)
                            values = torch.stack([metrics[k].float()
                                                  for k in names])
                            scalars = dict(zip(names, values.tolist()))
                            scalars["steps_per_sec"] = (
                                iter_num / (time.time() - t_start))
                            if feed_ms:
                                scalars["mb_feed_ms"] = float(np.mean(feed_ms))
                            writer.write(iter_num, scalars)
                            logger.info("iteration %d : model1 %.4f model2 "
                                        "%.4f", iter_num,
                                        scalars["model1_loss"],
                                        scalars["model2_loss"])
                        feed_ms.clear()

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
                            # rank 0's decision, broadcast
                            if dist.broadcast_array(np.array(
                                    [main_rank and perf > best[name]]), device)[0]:
                                best[name] = perf
                                t0 = time.perf_counter()
                                if main_rank:
                                    ckpt.save(f"best_{name}", state)
                                ckpt_s += time.perf_counter() - t0
                        t0 = time.perf_counter()
                        if main_rank:
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
